// Long-read PairHMM forward (fp32, per-strip exponent frames) over one tile
// of 128 jobs, for Hopper (sm_90a).
//
// Replaces: genomax/kernels/pairhmm_long.py `_kernel` (wrapper
// `pairhmm_forward_pallas_long`), the strip-mined long-read PairHMM. Same
// inputs and output: rchar (K*W, 128) int8 raw read codes, row i holding
// base i-1 (pads 1); qual (6*K*W, 128) fp32, the planes qr, mmv, gapm, qi,
// qd, qg stacked; hap (NDt, 128) int8 reversed haplotype stream, H[j] at
// row anchor-1-j (pads 0); meta (8, 128) int32, row 0 read_len, row 1
// hap_len; out (128,) fp32, log10 of the forward likelihood relative to the
// 2^120 initial constant. halo (4, nhalo, 128) fp32 must be zero.
//
// Design: one block per job (lane), one thread per row of a strip of W
// rows. The block sweeps the strips one after another, as the TPU kernel
// does; strip k sweeps sweep_chunks * 256 diagonals from floor(kW/256)*256,
// one __syncthreads per diagonal. Each thread carries the TPU kernel's
// state of its row literally: its own M and Y at d-1 and the row above's
// M, X, Y at d-1 and d-2, the row above handing its values over through a
// ping-pong pair of shared-memory rows. Row 0 of a strip takes the previous
// strip's last row from the halo instead: thread W-1 writes its M, X, Y and
// the strip's rescale count at every diagonal d to halo row d, after the
// barrier of d; thread 0 of the next strip reads halo row d before its
// barrier of d, so one halo serves every strip without a race, and rows a
// strip reads past what its writer swept are the zeros it was given.
//
// The scaling scheme is the TPU kernel's: blocks of `unroll` diagonals,
// after each the peak of the live window (the JAX masks v0/v1/v2 with
// global row indices) against 2^40, a 2^80 rescale of every carried value
// capped at 2^126, and the accumulator's follow/freeze with its own count.
// A strip snaps its count to its writer's at its first diagonal, converts
// each injected value by 2^(80 (cnt - cnt_writer)) as two multiplies of
// 2^(40 clip(cnt - cnt_writer, -3, 1)), and rescales only while its count
// is below the writer's (strip 0 freely). "Peak in (0, 2^40)" and the lead
// test become three __syncthreads_or votes. The accumulator lives in every
// thread as the same scalar; the thread of row read_len hands its block
// partial over through shared memory. A block skips the strips that start
// past read_len + 1: every mask is false there, so nothing would change.
//
// Bound on this card: the per-diagonal block barrier, as in the lane-tile
// kernel, and the serial strips: a read of R rows sweeps ceil((R+2)/W)
// strips of about hap_len + 2W + 768 diagonals each, so most thread-steps
// lie outside the live band. Running the strips concurrently (a block per
// strip, the halo as a flagged queue) is the lever for a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;                 // jobs per packed tile
constexpr int kChunk = 256;                 // sweep granularity
constexpr float kTrigger = 0x1p40f;         // rescale below this peak
constexpr float kFactor = 0x1p80f;          // by this factor
constexpr float kInvFactor = 0x1p-80f;
constexpr float kInit = 0x1p120f;           // the initial constant
constexpr float kCap = 0x1p126f;            // ceiling of carried values
// log10(2^80) and log10(2^120), rounded to fp32 as the JAX constants are.
constexpr float kRescaleLog10 = static_cast<float>(80 * 0.30102999566398120);
constexpr float kInitLog10 = static_cast<float>(120 * 0.30102999566398120);
constexpr int kCodeN = 'N';

// 2^(40 e) for an integer-valued e in [-3, 1], exactly.
__device__ __forceinline__ float pow2_40(float e) {
  return ldexpf(1.0f, 40 * static_cast<int>(e));
}

__global__ void __launch_bounds__(1024)
pairhmm_long_kernel(const int8_t* __restrict__ rchar,
                    const float* __restrict__ qual,
                    const int8_t* __restrict__ hap,
                    const int32_t* __restrict__ meta,
                    float* __restrict__ halo, float* __restrict__ out,
                    int k_strips, int anchor, int sweep_chunks, int nhalo,
                    int unroll, float inv_div) {
  extern __shared__ float smem[];  // [2][3][w]: M, X, Y of each row at the
                                   // even / odd diagonal
  __shared__ float s_accb;         // block partial of the read_len row

  const int w = blockDim.x;
  const int l = blockIdx.x;
  const int i = threadIdx.x;
  const int rl = meta[l];
  const int hl = meta[kLanes + l];
  if (rl == 0) {  // an empty lane: the TPU kernel's log10(0)
    if (i == 0) out[l] = -INFINITY;
    return;
  }
  const size_t plane = static_cast<size_t>(k_strips) * w * kLanes;
  float* const hM = halo + l;
  float* const hX = hM + static_cast<size_t>(nhalo) * kLanes;
  float* const hY = hX + static_cast<size_t>(nhalo) * kLanes;
  float* const hC = hY + static_cast<size_t>(nhalo) * kLanes;
  const float y0 = kInit / static_cast<float>(max(hl, 1));

  float acc = 0.0f, acc_cnt = 0.0f;
  for (int k = 0; k < k_strips && k * w <= rl + 1; ++k) {
    // Row constants with the folds of the TPU kernel.
    const int ii = k * w + i;
    const size_t at = static_cast<size_t>(ii) * kLanes + l;
    const int code = rchar[at];
    const float qr = qual[at];
    const float mmv = qual[plane + at];
    const float gapm = qual[2 * plane + at];
    const float qi = qual[3 * plane + at];
    const float qd = qual[4 * plane + at];
    const float qg = ii == 0 ? 1.0f : qual[5 * plane + at];
    const bool dead = ii == 0 || ii > rl;
    const float pm = dead ? 0.0f : 1.0f - qr;
    const float qx = dead ? 0.0f : (code == kCodeN ? 1.0f - qr : qr * inv_div);
    const bool is0 = k == 0;
    const bool owns = k * w <= rl && rl < (k + 1) * w;  // block-uniform

    // Frame snap to the writer's count; the accumulator snaps while empty.
    float cnt = is0 ? 0.0f : hC[static_cast<size_t>(k) * w * kLanes];
    if (!(acc > 0.0f)) acc_cnt = cnt;
    const float da = fminf(fmaxf(cnt - acc_cnt, 0.0f), 3.0f);
    const float half = ldexpf(1.0f, -40 * static_cast<int>(da));
    float cmul = da < 3.0f ? half * half : 0.0f;

    float m1 = 0.0f, y1 = ii == 0 ? y0 : 0.0f;  // own row at d-1
    float m1s = 0.0f, x1s = 0.0f, y1s = 0.0f;   // row above at d-1
    float m2s = 0.0f, x2s = 0.0f, y2s = 0.0f;   // row above at d-2
    float accb = 0.0f;
    float hc_last = 0.0f;
    const int8_t* hs = hap + static_cast<size_t>(anchor + ii) * kLanes + l;
    const int d0 = (k * w / kChunk) * kChunk;
    const int d_end = d0 + sweep_chunks * kChunk;

    for (int base = d0; base < d_end; base += unroll) {
      for (int tt = 0; tt < unroll; ++tt) {
        const int d = base + tt;
        const size_t hrow = static_cast<size_t>(d) * kLanes;
        float im = 0.0f, ix = 0.0f, iy = 0.0f;  // injected row above at d
        if (i == 0) {
          const float hc = hC[hrow];
          if (tt == unroll - 1) hc_last = hc;
          if (!is0) {
            const float g = pow2_40(fminf(fmaxf(cnt - hc, -3.0f), 1.0f));
            im = (hM[hrow] * g) * g;
            ix = (hX[hrow] * g) * g;
            iy = (hY[hrow] * g) * g;
          }
        }
        const int hc8 = hs[-static_cast<ptrdiff_t>(d) * kLanes];
        const bool match = code == hc8 || hc8 == kCodeN;
        const float p = match ? pm : qx;
        const float mn = p * (mmv * m2s + gapm * (x2s + y2s));
        const float xn = m1s * qi + x1s * qg;
        const float yn = m1 * qd + y1 * qg;
        if (ii == rl && d <= rl + hl) accb += mn + xn;
        float* wr = smem + 3 * w * (d & 1);
        wr[i] = mn;
        wr[w + i] = xn;
        wr[2 * w + i] = yn;
        __syncthreads();
        if (i == w - 1) {
          hM[hrow] = mn;
          hX[hrow] = xn;
          hY[hrow] = yn;
          hC[hrow] = cnt;
        }
        m2s = m1s;
        x2s = x1s;
        y2s = y1s;
        if (i > 0) {
          m1s = wr[i - 1];
          x1s = wr[w + i - 1];
          y1s = wr[2 * w + i - 1];
        } else {
          m1s = im;
          x1s = ix;
          y1s = iy;
        }
        m1 = mn;
        y1 = yn;
      }

      // Rescale after the block ending at diagonal dl.
      const int dl = base + unroll - 1;
      const int jv = dl - ii;
      bool big = false, pos = false;
      auto admit = [&](bool in, float v) {
        if (in) {
          big |= v >= kTrigger;
          pos |= v > 0.0f;
        }
      };
      admit(ii <= rl && jv >= 0 && jv <= hl, fmaxf(m1, y1));
      admit(ii >= 1 && ii - 1 <= rl && jv >= 0 && jv <= hl,
            fmaxf(fmaxf(m1s, x1s), y1s));
      admit(ii >= 1 && ii - 1 <= rl && jv - 1 >= 0 && jv - 1 <= hl,
            fmaxf(fmaxf(m2s, x2s), y2s));
      if (owns && ii == rl) s_accb = accb;
      const bool any_big = __syncthreads_or(big);
      const bool any_pos = __syncthreads_or(pos);
      const bool lead_ok = __syncthreads_or(i == 0 && (is0 || cnt < hc_last));
      acc += (owns ? s_accb : 0.0f) * cmul;
      accb = 0.0f;
      const bool need = dl <= rl + hl + 1 && any_pos && !any_big && lead_ok;
      const float f = need ? kFactor : 1.0f;
      const bool follow = need && acc < kTrigger;
      m1 = fminf(m1 * f, kCap);
      y1 = fminf(y1 * f, kCap);
      m1s = fminf(m1s * f, kCap);
      x1s = fminf(x1s * f, kCap);
      y1s = fminf(y1s * f, kCap);
      m2s = fminf(m2s * f, kCap);
      x2s = fminf(x2s * f, kCap);
      y2s = fminf(y2s * f, kCap);
      if (follow) {
        acc *= kFactor;
        acc_cnt += 1.0f;
      } else if (need) {
        cmul *= kInvFactor;
      }
      if (need) cnt += 1.0f;
    }
  }
  if (i == 0) out[l] = log10f(acc) - acc_cnt * kRescaleLog10 - kInitLog10;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(). The caller
// allocates `halo` zeroed and `out`, and checks shapes: rchar (k_strips*w,
// 128), qual (6*k_strips*w, 128), hap rows covering anchor + k_strips*w,
// 1 <= w <= 1024, `unroll` dividing 256.
extern "C" int pairhmm_long_launch(const void* rchar, const void* qual,
                                   const void* hap, const void* meta,
                                   void* halo, void* out, int k_strips,
                                   int w, int anchor, int sweep_chunks,
                                   int unroll, float mm_div, void* stream) {
  const int nhalo_raw = (k_strips - 1) * w + (sweep_chunks + 1) * kChunk;
  const int nhalo = (nhalo_raw + kChunk - 1) / kChunk * kChunk;
  // 1/mm_div rounded once from double, as the JAX constant fold does.
  const float inv_div = static_cast<float>(1.0 / static_cast<double>(mm_div));
  const size_t smem = 6 * static_cast<size_t>(w) * sizeof(float);
  pairhmm_long_kernel<<<kLanes, w, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(rchar), static_cast<const float*>(qual),
      static_cast<const int8_t*>(hap), static_cast<const int32_t*>(meta),
      static_cast<float*>(halo), static_cast<float*>(out), k_strips, anchor,
      sweep_chunks, nhalo, unroll, inv_div);
  return static_cast<int>(cudaGetLastError());
}
