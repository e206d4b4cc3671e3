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
// 2^120 initial constant. halo (4, nhalo, 128) fp32 is scratch, no initial
// value needed.
//
// The function is the TPU kernel's: the read axis in K strips of W rows,
// each rescaling in its own 2^80 frame; strip k adopts its writer's (strip
// k-1's) count at diagonal kW, takes the writer's last row as its row
// above, converted by 2^(80 (cnt - cnt_writer)) as two multiplies of
// 2^(40 clip(cnt - cnt_writer, -3, 1)) with the reader's count at the start
// of the block, and rescales only while its count is below the writer's
// (strip 0 freely); blocks of `unroll` diagonals, the v0/v1/v2 peak against
// 2^40, values capped at 2^126 after every block (a rescaled T is formed
// from its scaled inputs, phmm_cell.cuh), the accumulator's follow/freeze
// with its own count.
//
// Design: one block a job (lane), one warp a strip, R rows a thread in
// registers (R a template argument; the strip's ts = ceil(W/R) <= 32
// threads, the rest of the warp carry zeros), up to 8 strip warps at once.
// The strips run in one wavefront: strip k sweeps block b of diagonals
// while strip k-1 sweeps block b+1, one __syncthreads a block of `unroll`
// steps for all strips together. Inside a strip the rows talk as in
// pairhmm_tile.cu: bottom up in a thread, the row above a thread's first
// row by __shfl_up_sync, the haplotype code travelling down the rows (only
// the strip's row 0 reads the stream, 32 steps a chunk ahead). The seam
// row passes to the next strip through shared memory, indexed by diagonal
// (two blocks a ring), with the writer's count of each block beside it;
// the reader converts each value with that block's factor as it reads it,
// a block after it was written, so every value and count it reads is
// final. A job with more strips than warps runs them in rounds of 8; the
// last strip of a round hands its seam to the first of the next through
// `halo` in global memory.
//
// Sweeping strips at once changes no step of the function. Strip k's cells
// are 0 before diagonal kW (column < 0) and it cannot rescale there, so it
// starts at the block holding kW, where it snaps to its writer's count. It
// stops after the block holding rl + hl + 1: past it no strip rescales and
// nothing accumulates. Strips past rl + 1 have no live row and do not run.
// The accumulator belongs to the strip holding row rl (the owner): strips
// before it leave it 0 and their counts are snapped away at the owner's
// start. The one strip after it (when rl ends a strip) only rescales: the
// reference lets the accumulator follow each of those rescales while it is
// below 2^40, after the owner has finished, so the kernel counts them and
// applies them at the end.
//
// Bound on this card: fp32 issue and the per-step latency of one warp a
// strip. A 1,000bp x 1,200bp job is 4 strip warps over about 2,250 steps
// (the sequential strips swept 4 x 9 x 256 = 9,216 barrier steps).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phmm_cell.cuh"

namespace {

constexpr int kLanes = 128;      // jobs per packed tile
constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;     // strips swept at once
constexpr int kMaxUnroll = 32;   // diagonals a rescale block
constexpr unsigned kFull = 0xffffffffu;

// 2^(40 e) for an integer-valued e in [-3, 1], exactly: the bits of a
// normal float (biased exponent 7 to 167).
__device__ __forceinline__ float pow2_40(float e) {
  return __int_as_float((127 + 40 * static_cast<int>(e)) << 23);
}

// a[k] for a k known only at run time.
template <int R>
__device__ __forceinline__ float pick(const float (&a)[R], int k) {
  float v = a[0];
#pragma unroll
  for (int i = 1; i < R; ++i)
    if (k == i) v = a[i];
  return v;
}

template <int R>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
pairhmm_long_kernel(const int8_t* __restrict__ rchar,
                    const float* __restrict__ qual,
                    const int8_t* __restrict__ hap,
                    const int32_t* __restrict__ meta, float* halo,
                    float* __restrict__ out, int k_strips, int w, int ts,
                    int anchor, int ndt, int nhalo, int unroll,
                    float inv_div) {
  // The seam entering strip warp s, by diagonal (M, X, Y), and its
  // writer's count of each block, two blocks a ring: warp s reads ring[s]
  // and writes ring[s + 1]. ring[0] holds zeros in the first round and
  // the global seam's current block in later ones. Then the rescales of
  // the strip after the owner.
  __shared__ float ring[kMaxWarps + 1][2 * kMaxUnroll][3];
  __shared__ float ring_cnt[kMaxWarps + 1][2];
  __shared__ int s_after;

  const int S = blockDim.x / kWarp;
  const int l = blockIdx.x;
  const int wl = threadIdx.x % kWarp, wp = threadIdx.x / kWarp;
  const int rl = meta[l];
  const int hl = meta[kLanes + l];
  if (rl == 0) {  // an empty lane: the TPU kernel's log10(0)
    if (threadIdx.x == 0) out[l] = -INFINITY;
    return;
  }
  const int k_active = min(k_strips, (rl + 1) / w + 1);
  const int b_end = (rl + hl + 1) / unroll;  // the last block that counts
  const int k_own = rl / w;
  const int k_after = (k_own + 1) * w <= rl + 1 ? k_own + 1 : -1;
  const int t_rl = (rl - k_own * w) / R, k_rl = (rl - k_own * w) % R;
  const int seam_t = (w - 1) / R, seam_k = (w - 1) % R;
  const int ring_mask = 2 * unroll - 1;
  const size_t plane = static_cast<size_t>(k_strips) * w * kLanes;
  float* const hM = halo + l;
  float* const hX = hM + static_cast<size_t>(nhalo) * kLanes;
  float* const hY = hX + static_cast<size_t>(nhalo) * kLanes;
  float* const hC = hY + static_cast<size_t>(nhalo) * kLanes;
  const float y0 = kPhmmInit / static_cast<float>(max(hl, 1));
  const int8_t* const hs = hap + l;

  for (int i = threadIdx.x; i < (kMaxWarps + 1) * 2 * kMaxUnroll * 3;
       i += blockDim.x)
    (&ring[0][0][0])[i] = 0.0f;
  for (int i = threadIdx.x; i < (kMaxWarps + 1) * 2; i += blockDim.x)
    (&ring_cnt[0][0])[i] = 0.0f;
  if (threadIdx.x == 0) s_after = 0;
  __syncthreads();

  // The accumulator, meaningful on the owner's thread of row rl.
  float acc = 0.0f, acc_cnt = 0.0f, cmul = 1.0f;
  int n_after = 0;

  for (int k0 = 0; k0 < k_active; k0 += S) {
    const int k = k0 + wp;  // this warp's strip in the round
    const int n_round = min(S, k_active - k0);
    const bool live = k < k_active;
    const int ii0 = k * w;  // global row of the strip's row 0
    const int b_lo = ii0 / unroll;
    // The last strip of a round whose seam a later round reads.
    const bool to_halo = k + 1 < k_active && wp + 1 == n_round;
    const bool owner = k == k_own;
    const bool row0 = k == 0 && wl == 0;  // global row 0

    PhmmRow c[R];
    int hc[R];
    float M[R], X[R], Y[R], T[R];
    bool row_in[R], roll_in[R];  // rows of the read; ... with a row below
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
      const int local = wl * R + kk, ii = ii0 + local;
      const bool in = live && wl < ts && local < w;
      if (in) {
        const size_t at = static_cast<size_t>(ii) * kLanes + l;
        c[kk] = phmm_row(rchar[at], qual[at], qual[plane + at],
                         qual[2 * plane + at], qual[3 * plane + at],
                         qual[4 * plane + at], qual[5 * plane + at], ii, rl,
                         inv_div, false);
      } else {
        c[kk] = phmm_row_zero();
      }
      row_in[kk] = in && ii <= rl;
      roll_in[kk] = row_in[kk] && local < w - 1;
      hc[kk] = 0;
      M[kk] = X[kk] = Y[kk] = T[kk] = 0.0f;
    }
    float uM = 0.0f, uX = 0.0f, uY = 0.0f;  // the writer's row at d-1, in
                                            // this strip's frame
    float cnt = 0.0f, hcb = 0.0f;           // own count, writer's count
    int cur = 0, nxt = 0, ci = 0;           // row 0's stream codes
    auto load_code = [&](int e) -> int {
      const int row = min(max(anchor + ii0 - e, 0), ndt - 1);
      return hs[static_cast<size_t>(row) * kLanes];
    };

    const int tau_hi = b_end + n_round - 1;
    for (int tau = k0 * w / unroll; tau <= tau_hi; ++tau) {
      const int b = tau - wp;
      if (live && b >= b_lo && b <= b_end) {  // warp-uniform
        const int d0 = b * unroll;
        if (wp == 0 && k > 0) {  // the global seam's block b into ring[0]
          for (int i = wl; i < unroll; i += kWarp) {
            const size_t at = static_cast<size_t>(d0 + i) * kLanes;
            float* e = ring[0][(d0 + i) & ring_mask];
            e[0] = hM[at];
            e[1] = hX[at];
            e[2] = hY[at];
          }
          if (wl == 0) ring_cnt[0][b & 1] = hC[static_cast<size_t>(d0) *
                                               kLanes];
          __syncwarp();
        }
        hcb = ring_cnt[wp][b & 1];
        if (b == b_lo) {  // strip start: snap to the writer's count
          cnt = k > 0 ? hcb : 0.0f;
          if (owner) {  // the accumulator is still 0 here
            acc_cnt = cnt;
            cmul = 1.0f;
          }
          ci = d0 % kWarp;
          cur = load_code(d0 - ci + wl);
          nxt = load_code(d0 - ci + kWarp + wl);
        }
        if (wl == 0) ring_cnt[wp + 1][b & 1] = cnt;
        const float gw =
            k > 0 ? pow2_40(fminf(fmaxf(cnt - hcb, -3.0f), 1.0f)) : 0.0f;
        bool big = false, pos = false;
        float Ts[R], accr[R];
#pragma unroll
        for (int kk = 0; kk < R; ++kk) accr[kk] = 0.0f;

        // One step at diagonal d; the block's last one (`last`) also takes
        // v2 on the values of d-1 and forms Ts.
        auto step = [&](const int d, const bool last) {
          float aM = __shfl_up_sync(kFull, M[R - 1], 1);
          float aX = __shfl_up_sync(kFull, X[R - 1], 1);
          float aY = __shfl_up_sync(kFull, Y[R - 1], 1);
          int ac = __shfl_up_sync(kFull, hc[R - 1], 1);
          const int sc = __shfl_sync(kFull, cur, ci);
          if (wl == 0) {
            aM = uM;
            aX = uX;
            aY = uY;
            ac = sc;
          }
          if (++ci == kWarp) {
            ci = 0;
            cur = nxt;
            nxt = load_code(d + 1 + kWarp + wl);
          }
          if (last) {
#pragma unroll
            for (int kk = 0; kk < R; ++kk)
              phmm_admit_v2(roll_in[kk], d - (ii0 + wl * R + kk), hl, M[kk],
                            X[kk], Y[kk], big, pos);
            // the writer's last row, row ii0 - 1, at d-1
            phmm_admit_v2(wl == 0 && k > 0, d - (ii0 - 1), hl, uM, uX, uY,
                          big, pos);
          }
#pragma unroll
          for (int kk = R - 1; kk > 0; --kk) hc[kk] = hc[kk - 1];
          hc[0] = ac;
          if (last) {
#pragma unroll
            for (int kk = R - 1; kk > 0; --kk) {
              phmm_cell_end(c[kk], phmm_match<false>(c[kk].code, hc[kk]),
                            M[kk - 1], X[kk - 1], Y[kk - 1], M[kk], X[kk],
                            Y[kk], T[kk], Ts[kk]);
            }
            phmm_cell_end(c[0], phmm_match<false>(c[0].code, hc[0]), aM, aX,
                          aY, M[0], X[0], Y[0], T[0], Ts[0]);
          } else {
#pragma unroll
            for (int kk = R - 1; kk > 0; --kk) {
              phmm_cell(c[kk], phmm_match<false>(c[kk].code, hc[kk]),
                        M[kk - 1], X[kk - 1], Y[kk - 1], M[kk], X[kk], Y[kk],
                        T[kk]);
            }
            phmm_cell(c[0], phmm_match<false>(c[0].code, hc[0]), aM, aX, aY,
                      M[0], X[0], Y[0], T[0]);
          }
          if (row0 && d == 0) Y[0] = y0;

          // The seam row at d out, the writer's row at d in (for d+1):
          // every lane does the arithmetic, one lane stores.
          float sM = M[R - 1], sX = X[R - 1], sY = Y[R - 1];
          if (seam_k != R - 1) {  // warp-uniform
            sM = pick(M, seam_k);
            sX = pick(X, seam_k);
            sY = pick(Y, seam_k);
          }
          float* const eo = ring[wp + 1][d & ring_mask];
          if (wl == seam_t) {
            eo[0] = sM;
            eo[1] = sX;
            eo[2] = sY;
          }
          const float* const ei = ring[wp][d & ring_mask];
          uM = (ei[0] * gw) * gw;
          uX = (ei[1] * gw) * gw;
          uY = (ei[2] * gw) * gw;
          // The owner's block partial, a sum a row, so that no step picks
          // row rl out of the registers; only rl's sum is read (at the
          // block's end), the others may hold anything.
          if (owner && d <= rl + hl) {
#pragma unroll
            for (int kk = 0; kk < R; ++kk) accr[kk] += M[kk] + X[kk];
          }
        };
        for (int tt = 0; tt < unroll - 1; ++tt) step(d0 + tt, false);
        const int dl = d0 + unroll - 1;  // the block's last diagonal
        step(dl, true);

        // Rescale after the block.
#pragma unroll
        for (int kk = 0; kk < R; ++kk) {
          const int ii = ii0 + wl * R + kk;
          phmm_admit_v0(row_in[kk], dl - ii, hl, M[kk], Y[kk], big, pos);
          phmm_admit_v1(roll_in[kk], dl - ii, hl, M[kk], X[kk], Y[kk], big,
                        pos);
        }
        phmm_admit_v1(wl == 0 && k > 0, dl - (ii0 - 1), hl, uM, uX, uY, big,
                      pos);
        const bool any_big = __any_sync(kFull, big);
        const bool any_pos = __any_sync(kFull, pos);
        const bool lead_ok = k == 0 || cnt < hcb;
        const bool need = dl <= rl + hl + 1 && any_pos && !any_big && lead_ok;
        const float f = need ? kPhmmFactor : 1.0f;
#pragma unroll
        for (int kk = 0; kk < R; ++kk) {
          M[kk] = fminf(M[kk] * f, kPhmmCap);
          X[kk] = fminf(X[kk] * f, kPhmmCap);
          Y[kk] = fminf(Y[kk] * f, kPhmmCap);
          T[kk] = fminf(need ? Ts[kk] : T[kk], kPhmmCap);
        }
        uM = fminf(uM * f, kPhmmCap);
        uX = fminf(uX * f, kPhmmCap);
        uY = fminf(uY * f, kPhmmCap);
        if (owner) {
          const float accb = pick(accr, k_rl);  // meaningful on lane t_rl
          acc += accb * cmul;
          const bool follow = need && acc < kPhmmTrigger;
          if (follow) {
            acc *= kPhmmFactor;
            acc_cnt += 1.0f;
          } else if (need) {
            cmul *= kPhmmInvFactor;
          }
        }
        if (k == k_after && need) ++n_after;
        if (to_halo) {  // this block of the seam to the next round
          __syncwarp();
          for (int i = wl; i < unroll; i += kWarp) {
            const size_t at = static_cast<size_t>(d0 + i) * kLanes;
            const float* e = ring[wp + 1][(d0 + i) & ring_mask];
            hM[at] = e[0];
            hX[at] = e[1];
            hY[at] = e[2];
          }
          if (wl == 0) hC[static_cast<size_t>(d0) * kLanes] = cnt;
        }
        if (need) cnt += 1.0f;
      }
      __syncthreads();
    }
  }
  if (k_after >= 0 && threadIdx.x == (k_after % S) * kWarp) s_after = n_after;
  __syncthreads();
  if ((k_own % S) * kWarp + t_rl == static_cast<int>(threadIdx.x)) {
    if (acc > 0.0f) {
      for (int n = s_after; n > 0 && acc < kPhmmTrigger; --n) {
        acc *= kPhmmFactor;
        acc_cnt += 1.0f;
      }
    }
    out[l] = log10f(acc) - acc_cnt * kPhmmRescaleLog10 - kPhmmInitLog10;
  }
}

template <int R>
int launch(const void* rchar, const void* qual, const void* hap,
           const void* meta, void* halo, void* out, int k_strips, int w,
           int anchor, int ndt, int nhalo, int unroll, float inv_div,
           int warps, cudaStream_t stream) {
  const int ts = (w + R - 1) / R;
  pairhmm_long_kernel<R><<<kLanes, warps * kWarp, 0, stream>>>(
      static_cast<const int8_t*>(rchar), static_cast<const float*>(qual),
      static_cast<const int8_t*>(hap), static_cast<const int32_t*>(meta),
      static_cast<float*>(halo), static_cast<float*>(out), k_strips, w, ts,
      anchor, ndt, nhalo, unroll, inv_div);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for an R the build does not make or a geometry
// outside the kernel's: ceil(w / R) <= 32, 1 <= warps <= 8, `unroll` a
// power of two up to 32. The caller allocates `halo` (4 x nhalo x 128
// floats, nhalo past every job's rl + hl + 1 + unroll; read only where
// written) and `out`, and checks shapes: rchar (k_strips*w, 128), qual
// (6*k_strips*w, 128), hap (ndt, 128), every rl <= k_strips*w - 2.
extern "C" int pairhmm_long_launch(const void* rchar, const void* qual,
                                   const void* hap, const void* meta,
                                   void* halo, void* out, int k_strips,
                                   int w, int anchor, int ndt, int nhalo,
                                   int unroll, float mm_div,
                                   int rows_per_thread, int warps,
                                   void* stream) {
  if (w < 1 || (w + rows_per_thread - 1) / rows_per_thread > kWarp ||
      warps < 1 || warps > kMaxWarps || unroll < 1 || unroll > kMaxUnroll ||
      (unroll & (unroll - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // 1/mm_div rounded once from double, as the JAX constant fold does.
  const float inv_div = static_cast<float>(1.0 / static_cast<double>(mm_div));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GX_LONG_R(RR)                                                     \
  case RR:                                                               \
    return launch<RR>(rchar, qual, hap, meta, halo, out, k_strips, w,    \
                      anchor, ndt, nhalo, unroll, inv_div, warps, s);
  switch (rows_per_thread) {
    GX_LONG_R(1)
    GX_LONG_R(2)
    GX_LONG_R(4)
    GX_LONG_R(8)
    GX_LONG_R(16)
    GX_LONG_R(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GX_LONG_R
}
