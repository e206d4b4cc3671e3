// Sublane-stacked Smith-Waterman (Gotoh, score only) for short pairs, for
// Hopper (sm_90a).
//
// Replaces: genomax/kernels/sw_stacked.py `_kernel` (wrapper
// `sw_forward_pallas_stacked`), the kernel that stacks S tiles of a
// packed bucket along the sublanes of one lane. Same inputs and output:
// sx (NT, S*h, 128) int8, rows [q*h, (q+1)*h) region q, row q*h + s
// holding x_q[s-1] (pads 1); sy (NT, a0 + S*h, 128) int8 staggered
// reversed streams, y_q[k] at row a0 + q*h - 1 - k for k < h (pads 0);
// ndt (NT,) int32, the largest diagonal count over a stacked tile's S
// regions; out (NT*S, 128) int32, row t*S + q the largest D of each pair
// of region q (bucket tile t*S + q), so the flat slot order is the
// bucket's. The host re-stack is kernels/sw_stacked.prep_bucket_stacked.
//
// Design: the S regions of a stack (stacked tile t, lane l) are packed
// into warps' rows with sw_rows.cuh's step: R rows a thread in registers
// (R = 2-16, a template argument), the row above by __shfl_up_sync, the
// y code travelling down the rows, the DPX cell. Region q's rows s = 1 ..
// h-1 take lq = ceil((h-1) / R) consecutive lanes of one warp (lane k of
// the region rows 1 + kR .. kR + R; rows past h-1 are pad rows), so a
// warp holds up to floor(32 / lq) regions side by side, gq of them, and a
// stack takes ceil(S / gq) warps that share nothing: no shared memory and
// no block barrier (at h = 72, S = 4 and R = 9 a stack is one warp of
// 4 x 8 lanes). A region always fits one warp: S >= 2 and S*h <= 1024
// give h - 1 <= 511 = 32 * 16 - 1. kernels/sw_stacked.geometry picks R
// and gq.
// The TPU kernel's three rules, each where its circular sublane roll and
// -KILL pins put it:
//  - row s = 0 of every region is the first-column boundary (D = 0,
//    Q = -inf) and never reads the row above, which is the bottom row of
//    the region before: here it is the value that the region's first
//    lane takes in place of the shuffle, as lane 0 of sw_tile.cu does;
//  - cells with j <= 0 are the first-row boundary (D = 0, P = -inf);
//  - the ghost-read mask: row s = 1 at diagonal d reads column j = d - 1
//    of its own stream, row a0 + q*h - j, only for 1 <= j <= h and takes
//    PAD_STREAM (0) past h, where that row belongs to the region before.
//    Row s = 1's load is the only stream read of a region (rows below take
//    the code a step later), so the mask lies on that one load. The
//    region's lanes load the codes of lq columns at a time, lq steps
//    ahead, and its first lane takes each step's code by __shfl_sync.
// Every step runs unmasked, as the plain version and the TPU kernel do:
// under SWConfig.validate's scoring (mismatch and gap_extend below 0,
// gap_open at most 0) the pads decay. Rows past a pair's length, the pad
// rows past h - 1 and columns past its y hold pad codes that mismatch
// everything, so those cells never exceed the pair's real maximum, and
// the extra diagonals of a shorter region meet only pad codes; a cell
// with j <= 0 (its y code the pad) comes out D = 0 with P and Q at most
// gap_open + gap_extend, which gives its row's first real cell the
// first-row boundary's values. Each region's best is reduced over its
// lanes by shuffles.
//
// Contract: S*h <= 1024 (the launch refuses more; the TPU kernel's limit,
// kept), a0 >= h (every masked read lies in the buffer) and ndt[t] <= a0
// (the plain version's window). A tile whose ndt breaks it writes -1 to
// its S slots of the lane, below any score, and reads nothing else; the
// wrapper checks the static part on the host and raises before it
// launches.
//
// Bound on this card: operations, as in sw_tile.cu: a step is R DPX cells
// a thread and a fixed part (the three shuffles of the hand-over, the
// stream shuffle, the loop); the triangle waste of the lane tile is
// unchanged (each region sweeps its h rows over the stack's diagonals).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sw_rows.cuh"

namespace {

constexpr int kLanes = 128;         // pairs per packed tile
constexpr int kNeg = kSwNeg;        // -inf of P and Q (sw_cell.cuh)
constexpr int kMaxRows = 1024;      // stack * h, the launch contract
constexpr int kWarpsPerBlock = 4;   // independent warps a block
constexpr int kPadX = 1;            // the pack's x pad code

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_stacked_kernel(const int8_t* __restrict__ sx, const int8_t* __restrict__ sy,
                  const int32_t* __restrict__ ndt, int32_t* __restrict__ out,
                  int n_warps, int stack, int h, int nds, int lq, int gq,
                  int wps, SwScoring sc) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= n_warps) return;  // the whole warp
  const int st = warp / wps;    // the stack: t * 128 + l
  const int t = st / kLanes;
  const int l = st % kLanes;
  const int rg = lane / lq;        // the region's place in the warp
  const int sl = lane - rg * lq;   // the lane's place in its region
  const int q = (warp - st * wps) * gq + rg;
  const bool active = rg < gq && q < stack;  // idle lanes sit at the end
  const int nxs = stack * h;
  const int a0 = nds - nxs;
  const int nd = ndt[t];
  int32_t* const slot =
      out + (static_cast<size_t>(t) * stack + q) * kLanes + l;
  if (h > a0 || nd > a0) {  // uniform over the stack, so over the warp
    if (active && sl == 0) *slot = -1;
    return;
  }
  // Region q's row 0 of x, and its stream: column j's code at ys[-j*128].
  const int8_t* const xs =
      sx + (static_cast<size_t>(t) * nxs + static_cast<size_t>(q) * h) *
               kLanes + l;
  const int8_t* const ys =
      sy + (static_cast<size_t>(t) * nds + a0 + static_cast<size_t>(q) * h) *
               kLanes + l;

  SwRows<R> rows;
  const int pf = 1 + sl * R;  // this lane's first row of the region
#pragma unroll
  for (int i = 0; i < R; ++i)
    rows.X[i] = active && pf + i < h
                    ? xs[static_cast<ptrdiff_t>(pf + i) * kLanes]
                    : kPadX;
  rows.reset();
  // Stream code of column j, the ghost-read mask applied.
  auto code = [&](int j) {
    return active && j >= 1 && j <= h
               ? static_cast<int>(
                     __ldg(ys - static_cast<ptrdiff_t>(j) * kLanes))
               : 0;
  };
  // Lane k of a region holds the code of column c + k of the chunk that
  // starts at column c: cur the chunk in use, nxt the one after it.
  const int first = rg * lq;  // the region's first lane
  int cur = code(1 + sl), nxt = code(1 + lq + sl);
  int next_chunk = 1 + 2 * lq;
  int ci = 1;  // the index in cur of the code the next step takes
  int aD = 0, aQ = kNeg, aY = __shfl_sync(kSwFullMask, cur, first);
  if (sl > 0) aY = 0;
  int best = 0;

  // After diagonal d: the row above each lane's row 0 for d + 1 (lane
  // k-1's row R-1; for a region's first lane the first-column boundary
  // and the code of column d).
  auto advance = [&]() {
    rows.hand_down(aD, aQ, aY);
    if (ci == lq) {  // the same step for every region of the warp
      cur = nxt;
      nxt = code(next_chunk + sl);
      next_chunk += lq;
      ci = 0;
    }
    const int yn = __shfl_sync(kSwFullMask, cur, first + ci);
    ++ci;
    if (sl == 0) {
      aD = 0;
      aQ = kNeg;
      aY = yn;
    }
  };
  for (int d = 2; d < nd; ++d) {
    rows.template step<false>(d, pf, aD, aQ, aY, kSwNoEnd, kSwNoEnd, sc,
                              best);
    advance();
  }
  // The region's best, gathered into its first lane.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_down_sync(kSwFullMask, best, off);
    if (sl + off < lq) best = max(best, o);
  }
  if (active && sl == 0) *slot = best;
}

template <int R>
int launch(const void* sx, const void* sy, const void* ndt, void* out,
           int nt, int stack, int h, int nds, int gq, SwScoring sc,
           cudaStream_t stream) {
  const int lq = h > 1 ? (h - 1 + R - 1) / R : 1;
  if (gq < 1 || gq > stack || gq * lq > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wps = (stack + gq - 1) / gq;
  const int n_warps = nt * kLanes * wps;
  sw_stacked_kernel<R>
      <<<(n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock,
         0, stream>>>(
          static_cast<const int8_t*>(sx), static_cast<const int8_t*>(sy),
          static_cast<const int32_t*>(ndt), static_cast<int32_t*>(out),
          n_warps, stack, h, nds, lq, gq, wps, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue without launching for a stack the kernel does
// not take (2 <= stack, 1 <= h, stack * h <= 1024), an R the build does
// not make, or regions a warp that its lanes cannot hold (1 <=
// `regions_per_warp` <= stack, regions_per_warp * ceil((h-1) / R) <= 32).
// The caller allocates `out` (nt * stack * 128 int32) and checks shapes:
// sx (nt, stack*h, 128), sy (nt, nds, 128) with nds - stack*h >= h, ndt
// (nt,); and picks R (`rows_per_thread`) and the regions a warp
// (kernels/sw_stacked.geometry).
extern "C" int sw_stacked_launch(const void* sx, const void* sy,
                                 const void* ndt, void* out, int nt,
                                 int stack, int h, int nds,
                                 int rows_per_thread, int regions_per_warp,
                                 int match, int mismatch, int gap_open,
                                 int gap_extend, void* stream) {
  if (stack < 2 || h < 1 || stack * h > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt <= 0) return 0;
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread) {
#define GENOMAX_STACKED_CASE(r)                                  \
  case r:                                                        \
    return launch<r>(sx, sy, ndt, out, nt, stack, h, nds,        \
                     regions_per_warp, sc, s);
    GENOMAX_STACKED_CASE(2)
    GENOMAX_STACKED_CASE(3)
    GENOMAX_STACKED_CASE(4)
    GENOMAX_STACKED_CASE(5)
    GENOMAX_STACKED_CASE(6)
    GENOMAX_STACKED_CASE(8)
    GENOMAX_STACKED_CASE(9)
    GENOMAX_STACKED_CASE(10)
    GENOMAX_STACKED_CASE(12)
    GENOMAX_STACKED_CASE(16)
#undef GENOMAX_STACKED_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
