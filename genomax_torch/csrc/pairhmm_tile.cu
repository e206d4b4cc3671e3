// PairHMM forward (fp32, per-pair exponent rescale) over one packed bucket,
// for Hopper (sm_90a).
//
// Replaces: genomax/kernels/pairhmm_pallas.py `_kernel` (wrapper
// `pairhmm_forward_pallas`), the resident lane-tile PairHMM wavefront, and
// its `_kernel_streamed` (the stream is read from global memory at any
// length). Same inputs and output: rchar (NT, NXs, 128) int8 read codes
// with row i holding base i-1; qr, mmv, gapm, qi, qd, qg (NT, NXs, 128)
// fp32, exactly 0 at pad rows; hap (NT, NDs, 128) int8 reversed haplotype
// stream with H[k] at row A-1-k, A = NDs - NXs (pads 0); meta (NT, 8, 128)
// int32, row 0 read_len, row 1 hap_len; ndiag_tile (NT,) int32; out (NT,
// 128) fp32, slot-major: log10 of the forward likelihood relative to the
// 2^120 initial constant.
//
// Design: a group of G <= 32 threads of one warp a pair, R read rows a
// thread in registers (R a template argument, G*R >= NXs), floor(32/G)
// pairs a warp, each with its own shuffle segment and vote mask, 8 warps of
// neighbouring lanes of one tile a block (the warp form: buckets of at most
// 32R rows, 512 at R = 16). A taller bucket gives a pair a block of W =
// ceil(NXs / 32R) <= 32 warps, G = 32W threads, one pair a block (the block
// form, R = 4, 5, 6, 8: NXs up to 8,192 rows, 32 warps at R = 8; R = 4 stops
// at 4,096). Its instances come in three launch bounds a R, the warps of a
// 2,048-row block (8 at R = 8, 16 at R = 4), 16 and 32, and a launch takes
// the smallest that holds its block: a bound of 1,024 threads holds a
// thread to 64 registers, which the shorter blocks need not pay. The rows
// are placed
// so that the read's last row rl is the last row of the group's last
// thread: thread g holds rows r0 + g*R .. r0 + g*R + R-1, r0 = rl - G*R + 1
// <= -1. Rows below 0 carry no read (zero constants, zero state) and stay
// 0; row 0 is the boundary (M = X = 0, Y = 2^120 / max(hl, 1)); rows past
// rl are not swept, because nothing they hold reaches a cell the result or
// a rescale reads. A row keeps its M, X, Y of diagonal d-1 and T, the row
// above's transition sum for diagonal d (phmm_cell.cuh). In a step a thread
// updates its rows bottom up, so that row k reads row k-1's values at d-1
// before they are overwritten; its first row takes the row above from the
// previous thread by __shfl_up_sync at the top of the step. In the warp
// form there is no shared memory and no block barrier: a warp never waits
// for another. In the block form lane 0 of warp w > 0 takes the row above
// from warp w-1's lane 31 through a seam in shared memory by step parity:
// lane 31 stores its last row's M, X, Y and code at the end of each step,
// one __syncthreads a step, and lane 0 reads them at the top of the next.
//
// The haplotype code travels down the rows: cell (i, j) at diagonal d
// compares H[j-1], which (i-1, j) compared at d-1, so row k takes row k-1's
// code of the previous step and the group's first row reads the stream,
// the code of stream row A - d + r0. The warp loads those codes a chunk of
// C = 32 / pairs steps ahead, one lane a code, and hands one out a step by
// a shuffle. Each row starts with the code it would have had at diagonal
// -1 (stream row A + 1 + r, clamped into the stream: a clamped code only
// ever reaches a column past A, where no cell is read).
//
// The scaling scheme is the TPU kernel's, step for step: blocks of
// rescale_period diagonals; after each block the accumulator folds its
// block partial (acc += accb * cmul), the pair checks the peak of the live
// window against 2^40 (the masks v0/v1/v2 of phmm_cell.cuh, v2 evaluated
// at the top of the block's last step on the values of d-1) by two warp
// votes over its segment (in the block form two __syncthreads_or over the
// block, so that every warp scales at the same diagonal), and multiplies
// every carried value by 2^80 where it fell below (T by taking Ts,
// phmm_cell.cuh), the accumulator following that scale while it is small
// and freezing after (cmul, acc_log). The values a thread takes from the
// row above are read after the rescale (the block form's seam is stored
// after it), so each is scaled exactly once.
// The accumulator is one scalar on the group's last thread, summed in
// increasing j as the reference sums. A warp runs its pairs' longest sweep;
// past its own rl+hl+1 diagonals rounded up to the period (capped by the
// tile's count, what the TPU kernel sweeps) a pair neither accumulates nor
// rescales, so the extra steps change nothing.
//
// Bound on this card: fp32 issue. A cell is 11 flops (4 multiplies, 3
// fused multiply-adds, 1 add) plus its match test, select and code move;
// a step adds 5 shuffles a thread, and in the block form a barrier and the
// seam. At 151bp x 300bp a pair is one warp of 32 threads x 5 rows
// sweeping 480 diagonals, 92% of its rows live; at 1,000bp x 1,200bp a
// block of 4 warps x 32 threads x 8 rows (1,024 rows for 1,008).

#include <cuda_runtime.h>
#include <stdint.h>

#include "phmm_cell.cuh"

namespace {

constexpr int kLanes = 128;    // pairs per packed tile
constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;    // warps a block of the warp form
constexpr int kMaxRows = 8192;  // rows of the tallest bucket (NXs)
constexpr int kBlockMaxWarps = 32;  // a CUDA block's 1,024 threads
constexpr unsigned kFull = 0xffffffffu;

// Warps a pair of `rows` rows takes at R rows a thread.
__host__ __device__ constexpr int warps_for(int rows, int R) {
  return (rows + kWarp * R - 1) / (kWarp * R);
}
// The most warps a pair of the block form takes at R: 32, or fewer where
// 32 warps would pass kMaxRows.
__host__ __device__ constexpr int block_warps(int R) {
  return warps_for(kMaxRows, R) < kBlockMaxWarps ? warps_for(kMaxRows, R)
                                                 : kBlockMaxWarps;
}
// The smallest launch bound of the block form at R: the warps of a block
// of 2,048 rows (16 at R = 4, 8 at R = 8).
constexpr int block_bound0(int R) { return warps_for(2048, R); }
// R of the block form: register pressure past 8 rows a thread.
constexpr bool block_r(int R) {
  return R == 4 || R == 5 || R == 6 || R == 8;
}

// kBlockWarps 0: the warp form, G = group threads a pair, P = 32 / G pairs
// a warp. kBlockWarps > 0: one pair a block of G = blockDim.x threads, at
// most kBlockWarps warps (P = 1), the seam in 2 * (G / 32) float4 of
// dynamic shared memory.
template <int R, bool kBitmask, int kBlockWarps>
__global__ void __launch_bounds__(kBlockWarps > 0 ? kWarp * kBlockWarps
                                                  : kMaxWarps * kWarp)
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
                    float inv_div, int G, int P) {
  constexpr bool kBlock = kBlockWarps > 0;
  extern __shared__ float4 seam[];  // block form: [step parity][warp]
  const int wl = threadIdx.x % kWarp;
  const int wp = threadIdx.x / kWarp;
  int t, l0, p, g;
  unsigned segmask;
  if constexpr (kBlock) {
    t = blockIdx.x / kLanes;
    l0 = blockIdx.x % kLanes;
    p = 0;
    g = threadIdx.x;
    segmask = kFull;
  } else {
    const int lanes_per_block = (blockDim.x / kWarp) * P;
    const int blocks_per_tile =
        (kLanes + lanes_per_block - 1) / lanes_per_block;
    t = blockIdx.x / blocks_per_tile;
    l0 = (blockIdx.x % blocks_per_tile) * lanes_per_block + wp * P;
    p = wl / G;  // pair of this thread in the warp
    g = wl - p * G;  // thread in the pair's group
    segmask = G == kWarp ? kFull : ((1u << G) - 1u) << min(p * G, kWarp - 1);
  }
  const int l = l0 + p;
  const bool active = p < P && l < kLanes;

  int rl = 0, hl = 0, steps = 0;
  if (active) {
    rl = meta[(t * 8 + 0) * kLanes + l];
    hl = meta[(t * 8 + 1) * kLanes + l];
    const int nd = ndiag_tile[t];
    steps = min((rl + hl + 1 + period - 1) / period,
                (nd + period - 1) / period) * period;
  }
  // The same for every warp of a block-form pair, so the block leaves as
  // one and no barrier is missed.
  const int steps_warp = __reduce_max_sync(kFull, steps);
  if (steps_warp == 0) return;  // no pair in this warp
  const int anchor = nds - nxs;
  const int acc_last = min(rl + hl, steps - 1);
  const int need_last = min(rl + hl + 1, steps - 1);
  const int r0 = rl - G * R + 1;  // row of the group's first position
  const int rb = r0 + g * R;      // row of this thread's first position
  const int8_t* const hs = hap + static_cast<size_t>(t) * nds * kLanes;

  PhmmRow c[R];
  int hc[R];                 // haplotype code each row compares
  float M[R], X[R], Y[R], T[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = rb + k;
    if (active && r >= 0 && r < nxs) {
      const size_t at = (static_cast<size_t>(t) * nxs + r) * kLanes + l;
      c[k] = phmm_row(rchar[at], qr_in[at], mmv_in[at], gapm_in[at],
                      qi_in[at], qd_in[at], qg_in[at], r, rl, inv_div,
                      kBitmask);
    } else {
      c[k] = phmm_row_zero();
    }
    const int row = min(max(anchor + 1 + r, 0), nds - 1);
    hc[k] = active ? hs[static_cast<size_t>(row) * kLanes + l] : 0;
    M[k] = X[k] = Y[k] = T[k] = 0.0f;
  }
  const float y0 = kPhmmInit / static_cast<float>(max(hl, 1));

  // The first row's stream codes: lane wl loads pair wl / C's code for step
  // (chunk base) + wl % C, one chunk ahead (in the block form warp 0 only,
  // the warp of the first row).
  const int C = kWarp / P;
  const int lp = min(wl / C, P - 1);
  const int r0_lp = __shfl_sync(kFull, r0, lp * G);
  const bool ld = wl / C < P && l0 + lp < kLanes && (!kBlock || wp == 0);
  auto load_code = [&](int e) -> int {
    if (!ld) return 0;
    const int row = max(anchor - e + r0_lp, 0);
    return hs[static_cast<size_t>(row) * kLanes + l0 + lp];
  };
  int cur = load_code(wl % C), nxt = load_code(C + wl % C), ci = 0;

  // Block form: lane 31 hands its last row at diagonal d (its values after
  // any rescale of d) to the next warp's lane 0, through the seam of d's
  // parity; the barrier orders the store before that read at d + 1 and
  // the read of d - 1's seam before d + 1's store over it.
  auto hand = [&](const int d) {
    if constexpr (kBlock) {
      if (wl == kWarp - 1)
        seam[(d & 1) * (G / kWarp) + wp] = make_float4(
            M[R - 1], X[R - 1], Y[R - 1], __int_as_float(hc[R - 1]));
      __syncthreads();
    }
  };

  float accb = 0.0f, acc = 0.0f, cmul = 1.0f, acc_log = 0.0f;
  bool big = false, pos = false;
  float Ts[R];
  // One step at diagonal d; a block's last one (`last`) also takes v2 on
  // the values of d-1 and forms Ts.
  auto step = [&](const int d, const bool last) {
    // The row above this thread's first row at d-1, and the code it took.
    float aM = __shfl_up_sync(kFull, M[R - 1], 1);
    float aX = __shfl_up_sync(kFull, X[R - 1], 1);
    float aY = __shfl_up_sync(kFull, Y[R - 1], 1);
    int ac = __shfl_up_sync(kFull, hc[R - 1], 1);
    const int sc = __shfl_sync(kFull, cur, (p * C + ci) & (kWarp - 1));
    if constexpr (kBlock) {
      if (wl == 0 && wp > 0) {
        const float4 a = seam[((d - 1) & 1) * (G / kWarp) + wp - 1];
        aM = a.x;
        aX = a.y;
        aY = a.z;
        ac = __float_as_int(a.w);
      }
    }
    if (g == 0) {
      aM = aX = aY = 0.0f;
      ac = sc;
    }
    if (++ci == C) {
      ci = 0;
      cur = nxt;
      nxt = load_code(d + 1 + C + wl % C);
    }
    if (last) {
#pragma unroll
      for (int k = 0; k < R; ++k)
        phmm_admit_v2(true, d - (rb + k), hl, M[k], X[k], Y[k], big, pos);
    }
#pragma unroll
    for (int k = R - 1; k > 0; --k) hc[k] = hc[k - 1];
    hc[0] = ac;
    if (last) {
#pragma unroll
      for (int k = R - 1; k > 0; --k) {
        phmm_cell_end(c[k], phmm_match<kBitmask>(c[k].code, hc[k]), M[k - 1],
                      X[k - 1], Y[k - 1], M[k], X[k], Y[k], T[k], Ts[k]);
      }
      phmm_cell_end(c[0], phmm_match<kBitmask>(c[0].code, hc[0]), aM, aX, aY,
                    M[0], X[0], Y[0], T[0], Ts[0]);
    } else {
#pragma unroll
      for (int k = R - 1; k > 0; --k) {
        phmm_cell(c[k], phmm_match<kBitmask>(c[k].code, hc[k]), M[k - 1],
                  X[k - 1], Y[k - 1], M[k], X[k], Y[k], T[k]);
      }
      phmm_cell(c[0], phmm_match<kBitmask>(c[0].code, hc[0]), aM, aX, aY,
                M[0], X[0], Y[0], T[0]);
    }
    if (g == G - 1 && d <= acc_last) accb += M[R - 1] + X[R - 1];
  };

  hand(-1);  // every row's state at d = -1: zeros and its first code
  for (int d0 = 0; d0 < steps_warp; d0 += period) {
    big = pos = false;
    for (int tt = 0; tt < period - 1; ++tt) {
      step(d0 + tt, false);
      if (d0 + tt == 0) {  // row 0's Y: 0 as the row below saw it at d = -1
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (rb + k == 0) Y[k] = y0;
      }
      hand(d0 + tt);
    }
    const int d = d0 + period - 1;  // the block's last diagonal
    step(d, true);
    if (d == 0) {
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (rb + k == 0) Y[k] = y0;
    }

    // Rescale after the block.
#pragma unroll
    for (int k = 0; k < R; ++k) {
      phmm_admit_v0(true, d - (rb + k), hl, M[k], Y[k], big, pos);
      phmm_admit_v1(true, d - (rb + k), hl, M[k], X[k], Y[k], big, pos);
    }
    bool any_big, any_pos;
    if constexpr (kBlock) {  // the pair's every warp decides alike
      any_big = __syncthreads_or(big) != 0;
      any_pos = __syncthreads_or(pos) != 0;
    } else {
      any_big = (__ballot_sync(kFull, big) & segmask) != 0;
      any_pos = (__ballot_sync(kFull, pos) & segmask) != 0;
    }
    const bool need = d <= need_last && any_pos && !any_big;
    acc += accb * cmul;
    accb = 0.0f;
    const bool follow = need && acc < kPhmmTrigger;
    if (follow) {
      acc *= kPhmmFactor;
      acc_log -= kPhmmRescaleLog10;
    } else if (need) {
      cmul *= kPhmmInvFactor;
    }
    if (need) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        M[k] *= kPhmmFactor;
        X[k] *= kPhmmFactor;
        Y[k] *= kPhmmFactor;
        T[k] = Ts[k];
      }
    }
    hand(d);
  }
  if (active && g == G - 1)
    out[t * kLanes + l] = log10f(acc) + acc_log - kPhmmInitLog10;
}

// The block form: one pair a block of G / 32 warps, at most kBound.
template <int R, bool kBitmask, int kBound>
int launch_block(const int8_t* rc, const float* const* f, const int8_t* h,
                 const int32_t* m, const int32_t* nd, float* o, int nt,
                 int nxs, int nds, int period, float inv_div, int G,
                 cudaStream_t stream) {
  pairhmm_tile_kernel<R, kBitmask, kBound>
      <<<nt * kLanes, G, 2 * (G / kWarp) * sizeof(float4), stream>>>(
          rc, f[0], f[1], f[2], f[3], f[4], f[5], h, m, nd, o, nxs, nds,
          period, inv_div, G, 1);
  return static_cast<int>(cudaGetLastError());
}

template <int R, bool kBitmask>
int launch(const void* rchar, const void* const* q, const void* hap,
           const void* meta, const void* ndiag_tile, void* out, int nt,
           int nxs, int nds, int period, float inv_div, int G, int warps,
           cudaStream_t stream) {
  const int8_t* rc = static_cast<const int8_t*>(rchar);
  const float* f[6];
  for (int i = 0; i < 6; ++i) f[i] = static_cast<const float*>(q[i]);
  const int8_t* h = static_cast<const int8_t*>(hap);
  const int32_t* m = static_cast<const int32_t*>(meta);
  const int32_t* nd = static_cast<const int32_t*>(ndiag_tile);
  float* o = static_cast<float*>(out);
  if (G > kWarp) {  // the block form, the instance of the smallest bound
    if constexpr (block_r(R)) {
      constexpr int b0 = block_bound0(R);
      if (warps <= b0)
        return launch_block<R, kBitmask, b0>(rc, f, h, m, nd, o, nt, nxs,
                                             nds, period, inv_div, G, stream);
      if (warps <= kBlockMaxWarps / 2)
        return launch_block<R, kBitmask, kBlockMaxWarps / 2>(
            rc, f, h, m, nd, o, nt, nxs, nds, period, inv_div, G, stream);
      return launch_block<R, kBitmask, kBlockMaxWarps>(
          rc, f, h, m, nd, o, nt, nxs, nds, period, inv_div, G, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = kWarp / G;
  const int lanes_per_block = warps * P;
  const int blocks = nt * ((kLanes + lanes_per_block - 1) / lanes_per_block);
  pairhmm_tile_kernel<R, kBitmask, 0><<<blocks, warps * kWarp, 0, stream>>>(
      rc, f[0], f[1], f[2], f[3], f[4], f[5], h, m, nd, o, nxs, nds, period,
      inv_div, G, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for an R the build does not make or a geometry
// outside the kernel's: the warp form 1 <= group <= 32, 1 <= warps <= 8;
// the block form group = 32 * warps > 32, R in 4, 5, 6, 8 and warps at
// most block_warps(R) (32; 32 at R = 4 holds 4,096 rows); group * R >=
// nxs. The caller allocates `out` and checks shapes: 2 <= nxs <= 8192,
// nds > nxs, rescale_period one of 1, 2,
// 4, 8, 16, 32, every pair's rl <= nxs - 2 and A = nds - nxs >= rl + hl +
// 1 + 32 (the pack's slack).
extern "C" int pairhmm_tile_launch(
    const void* rchar, const void* qr, const void* mmv, const void* gapm,
    const void* qi, const void* qd, const void* qg, const void* hap,
    const void* meta, const void* ndiag_tile, void* out, int nt, int nxs,
    int nds, int rescale_period, float mm_div, int bitmask,
    int rows_per_thread, int group, int warps, void* stream) {
  const bool block = group > kWarp;
  if (group < 1 || group * rows_per_thread < nxs || nxs > kMaxRows ||
      warps < 1 ||
      (block ? group != warps * kWarp || warps > block_warps(rows_per_thread)
             : warps > kMaxWarps))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt <= 0) return 0;
  // 1/mm_div rounded once from double, as the JAX constant fold does.
  const float inv_div = static_cast<float>(1.0 / static_cast<double>(mm_div));
  const void* q[6] = {qr, mmv, gapm, qi, qd, qg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bm = bitmask != 0;
#define GX_TILE_R(RR)                                                      \
  case RR:                                                                \
    return bm ? launch<RR, true>(rchar, q, hap, meta, ndiag_tile, out, nt, \
                                 nxs, nds, rescale_period, inv_div, group, \
                                 warps, s)                                 \
              : launch<RR, false>(rchar, q, hap, meta, ndiag_tile, out, nt,\
                                  nxs, nds, rescale_period, inv_div, group,\
                                  warps, s);
  switch (rows_per_thread) {
    GX_TILE_R(1)
    GX_TILE_R(2)
    GX_TILE_R(4)
    GX_TILE_R(5)
    GX_TILE_R(6)
    GX_TILE_R(8)
    GX_TILE_R(10)
    GX_TILE_R(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GX_TILE_R
}
