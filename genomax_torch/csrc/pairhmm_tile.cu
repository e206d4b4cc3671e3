// PairHMM forward (fp32, per-pair exponent rescale) over one packed bucket,
// for Hopper (sm_90a).
//
// Replaces: genomax/kernels/pairhmm_pallas.py `_kernel` (wrapper
// `pairhmm_forward_pallas`), the resident lane-tile PairHMM wavefront.
// Same inputs and output: rchar (NT, NXs, 128) int8 read codes with row i
// holding base i-1; qr, mmv, gapm, qi, qd, qg (NT, NXs, 128) fp32, exactly
// 0 at pad rows; hap (NT, NDs, 128) int8 reversed haplotype stream with
// H[k] at row A-1-k, A = NDs - NXs (pads 0); meta (NT, 8, 128) int32, row
// 0 read_len, row 1 hap_len; ndiag_tile (NT,) int32; out (NT, 128) fp32,
// slot-major: log10 of the forward likelihood relative to the 2^120
// initial constant.
//
// Design: one block per pair (slot t*128 + l), one thread per read row i,
// one __syncthreads per anti-diagonal, as the SW kernel (sw_tile.cu). At
// diagonal d thread i scores cell (i, j = d - i) against H[j-1], read from
// the stream at row A - d + i. Its own M and Y at d-1 stay in registers;
// the row above hands over its M, X and Y at d-1 through a ping-pong pair
// of shared-memory rows, and its values at d-2 are the ones this thread
// read one step earlier. Row 0 is the boundary: M = X = 0 and Y = 2^120 /
// max(hl, 1), which its own recurrence keeps (pm = 0, qd = 0, qg := 1), and
// it hands over zeros for diagonal -1. There is no circular roll, so the
// TPU kernel's wrapped bottom row becomes an explicit zero for thread 0.
//
// The scaling scheme is the TPU kernel's, step for step: blocks of
// rescale_period diagonals; after each block the accumulator folds its
// block partial (acc += accb * cmul), the block checks the peak of the
// live window against 2^40 and multiplies every carried value by 2^80
// where it fell below, and the accumulator follows that scale while it is
// small and freezes after (cmul, acc_log). The JAX masks v0/v1/v2 are
// written for the rolled layout; mapped onto cells they admit
//   v0: diagonal d, rows <= rl, 0 <= j <= hl, max(M, Y);
//   v1: diagonal d, rows <= rl, 1 <= j <= hl+1, max(M, X, Y);
//   v2: diagonal d-1 of the row above, rows 1..rl+1, 0 <= d-1-i <= hl,
//       max(M, X, Y),
// and "peak in (0, 2^40)" is "some admitted value > 0 and none >= 2^40",
// two __syncthreads_or reductions. The accumulator is one scalar on thread
// rl, summed in increasing j as the reference sums. Each block sweeps its
// own pair's rl+hl+1 diagonals rounded up to the period (capped by the
// tile's count, which is what the TPU kernel sweeps): past them a pair
// neither accumulates nor rescales, so the extra diagonals change nothing.
//
// Bound on this card: the per-diagonal block barrier and the shared-memory
// hand-over. A cell costs about 15 fp32 operations, one stream byte and
// three shared loads and stores; blocks of 160 threads (151bp reads) keep
// few warps per barrier, and a pair's sweep runs rl+hl diagonals with half
// of its threads idle in the wavefront's triangles. A warp per pair with
// register shuffles (gpuPairHMM), the stream in shared memory and fused
// expansion are the levers for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;                 // pairs per packed tile
constexpr float kTrigger = 0x1p40f;         // rescale below this peak
constexpr float kFactor = 0x1p80f;          // by this factor
constexpr float kInvFactor = 0x1p-80f;
constexpr float kInit = 0x1p120f;           // the initial constant
// log10(2^80) and log10(2^120), rounded to fp32 as the JAX constants are.
constexpr float kRescaleLog10 = static_cast<float>(80 * 0.30102999566398120);
constexpr float kInitLog10 = static_cast<float>(120 * 0.30102999566398120);
constexpr int kCodeN = 'N';
constexpr int kBitmaskN = 15;

__global__ void __launch_bounds__(512)
pairhmm_tile_kernel(const int8_t* __restrict__ rchar,
                    const float* __restrict__ qr_in,
                    const float* __restrict__ mmv_in,
                    const float* __restrict__ gapm_in,
                    const float* __restrict__ qi_in,
                    const float* __restrict__ qd_in,
                    const float* __restrict__ qg_in,
                    const int8_t* __restrict__ hap,
                    const int32_t* __restrict__ meta,
                    const int32_t* __restrict__ ndiag_tile,
                    float* __restrict__ out, int nxs, int nds, int period,
                    float inv_div, int bitmask) {
  extern __shared__ float smem[];  // [2][3][nxs]: M, X, Y of each row at
                                   // the even / odd diagonal

  const int slot = blockIdx.x;
  const int t = slot / kLanes;
  const int l = slot % kLanes;
  const int i = threadIdx.x;
  const int rl = meta[(t * 8 + 0) * kLanes + l];
  const int hl = meta[(t * 8 + 1) * kLanes + l];
  const int anchor = nds - nxs;

  // Row constants with the three folds of phmm_make_consts.
  const size_t at = (static_cast<size_t>(t) * nxs + i) * kLanes + l;
  const int code = rchar[at];
  const float qr = qr_in[at];
  const float mmv = mmv_in[at];
  const float gapm = gapm_in[at];
  const float qi = qi_in[at];
  const float qd = qd_in[at];
  const float qg = i == 0 ? 1.0f : qg_in[at];
  const bool dead = i == 0 || i > rl;
  const bool read_n = code == (bitmask ? kBitmaskN : kCodeN);
  const float pm = dead ? 0.0f : 1.0f - qr;
  const float qx = dead ? 0.0f : (read_n ? 1.0f - qr : qr * inv_div);
  const int8_t* hs = hap + static_cast<size_t>(t) * nds * kLanes + l;

  // Own values at d-1 (Y of row 0 is the boundary constant) and the row
  // above's at d-2; accumulator state on thread rl.
  float m = 0.0f, x = 0.0f;
  float y = i == 0 ? kInit / static_cast<float>(max(hl, 1)) : 0.0f;
  float am = 0.0f, ax = 0.0f, ay = 0.0f;
  float fs = 1.0f;  // rescale factor still owed by the shared row
  float acc = 0.0f, accb = 0.0f, cmul = 1.0f, acc_log = 0.0f;

  float* odd = smem + 3 * nxs;  // diagonal -1: all zeros
  odd[i] = 0.0f;
  odd[nxs + i] = 0.0f;
  odd[2 * nxs + i] = 0.0f;

  const int nd_pair = rl + hl + 1;
  const int steps = min((nd_pair + period - 1) / period,
                        (ndiag_tile[t] + period - 1) / period) * period;
  __syncthreads();

  for (int d = 0; d < steps; ++d) {
    const float* rd = smem + 3 * nxs * ((d + 1) & 1);  // diagonal d-1
    float nm = 0.0f, nx = 0.0f, ny = 0.0f;             // row above at d-1
    if (i > 0) {
      nm = rd[i - 1] * fs;
      nx = rd[nxs + i - 1] * fs;
      ny = rd[2 * nxs + i - 1] * fs;
    }
    fs = 1.0f;
    const int hc = __ldg(hs + static_cast<size_t>(anchor - d + i) * kLanes);
    const bool match = bitmask ? (code & hc) != 0
                               : (code == hc || hc == kCodeN);
    const float p = match ? pm : qx;
    const float mn = p * (mmv * am + gapm * (ax + ay));
    const float xn = nm * qi + nx * qg;
    const float yn = m * qd + y * qg;
    if (i == rl && d <= rl + hl) accb += mn + xn;
    float* wr = smem + 3 * nxs * (d & 1);
    wr[i] = mn;
    wr[nxs + i] = xn;
    wr[2 * nxs + i] = yn;
    am = nm;
    ax = nx;
    ay = ny;
    m = mn;
    x = xn;
    y = yn;
    __syncthreads();

    if ((d + 1) % period == 0) {
      const int c = d - i;
      bool big = false, pos = false;
      auto admit = [&](bool in, float v) {
        if (in) {
          big |= v >= kTrigger;
          pos |= v > 0.0f;
        }
      };
      admit(i <= rl && c >= 0 && c <= hl, fmaxf(m, y));
      admit(i <= rl && c >= 1 && c <= hl + 1, fmaxf(fmaxf(m, x), y));
      admit(i >= 1 && i - 1 <= rl && c - 1 >= 0 && c - 1 <= hl,
            fmaxf(fmaxf(am, ax), ay));
      const bool any_big = __syncthreads_or(big);
      const bool any_pos = __syncthreads_or(pos);
      const bool need = d <= nd_pair && any_pos && !any_big;
      if (i == rl) {
        acc += accb * cmul;
        accb = 0.0f;
        const bool follow = need && acc < kTrigger;
        if (follow) {
          acc *= kFactor;
          acc_log -= kRescaleLog10;
        } else if (need) {
          cmul *= kInvFactor;
        }
      }
      if (need && i > 0) {
        m *= kFactor;
        x *= kFactor;
        y *= kFactor;
        am *= kFactor;
        ax *= kFactor;
        ay *= kFactor;
        fs = kFactor;
      }
    }
  }
  if (i == rl) out[slot] = log10f(acc) + acc_log - kInitLog10;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): a launch
// the device refuses (too many threads, too much shared memory) reports
// here and nowhere else. The caller allocates `out` and checks shapes:
// 2 <= nxs <= 512, nds > nxs, rescale_period one of 1, 2, 4, 8, 16, 32,
// and A = nds - nxs >= every pair's rl + hl + 1 + 32 (the pack's slack).
extern "C" int pairhmm_tile_launch(
    const void* rchar, const void* qr, const void* mmv, const void* gapm,
    const void* qi, const void* qd, const void* qg, const void* hap,
    const void* meta, const void* ndiag_tile, void* out, int nt, int nxs,
    int nds, int rescale_period, float mm_div, int bitmask, void* stream) {
  if (nt <= 0) return 0;
  // 1/mm_div rounded once from double, as the JAX constant fold does.
  const float inv_div = static_cast<float>(1.0 / static_cast<double>(mm_div));
  const size_t smem = 6 * static_cast<size_t>(nxs) * sizeof(float);
  pairhmm_tile_kernel<<<nt * kLanes, nxs, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(rchar), static_cast<const float*>(qr),
      static_cast<const float*>(mmv), static_cast<const float*>(gapm),
      static_cast<const float*>(qi), static_cast<const float*>(qd),
      static_cast<const float*>(qg), static_cast<const int8_t*>(hap),
      static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(ndiag_tile), static_cast<float*>(out), nxs,
      nds, rescale_period, inv_div, bitmask);
  return static_cast<int>(cudaGetLastError());
}
