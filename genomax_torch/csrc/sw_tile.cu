// Smith-Waterman (Gotoh, score only) over one packed bucket, for Hopper
// (sm_90a).
//
// Replaces: genomax/kernels/sw_pallas.py `_kernel` (wrapper
// `sw_forward_pallas`), the resident lane-tile wavefront, and `:125`
// `_kernel_streamed`, the same with the stream in slabs from HBM (here
// every stream is read from device memory). Same inputs and output: sx
// (NT, NXs, 128) int8 codes with row p holding x[p-1] (pads 1), sy (NT,
// NDs, 128) int8 reversed diagonal stream with y[k] at row A-1-k, A = NDs
// - NXs (pads 0), ndiag_tile (NT,) int32; out (NT, 128) int32,
// slot-major, the largest D of each pair's matrix.
//
// Design: R rows a thread in registers (R = 2, 3, 4, 5, 6, 8, a template
// argument) with sw_rows.cuh's step (the row above by __shfl_up_sync, the
// y code travelling down the rows, the DPX cell). Rows 1 .. NXs - 1 are
// swept (row 0 is the first-column boundary), in groups of H = 32 * R
// rows, one warp a group; rows past NXs - 1 are pad rows. Two forms:
//  - a pair of at most H rows is one warp (up to 256 rows at R = 8), and
//    a block holds several pairs with no barrier: the buckets of 72-143
//    rows that the default route sends here;
//  - a taller pair is a block of W <= 32 warps (8,193 rows at R = 8, a
//    CUDA block's 1,024 threads; the engine's tallest bucket is 8,192
//    rows, and past it routes to strips or sw_long.cu), warp w rows
//    1 + w*H ..; lane 0 of warp w takes the row above from warp w-1's
//    lane 31 through a shared seam by step parity, one __syncthreads a
//    step for all rows (the form of sw_long.cu). A warp skips the cells of
//    the diagonals on which its rows have none (its first row's j < 1);
//    the block still takes the step's barrier. Blocks of 2-16 warps and
//    of 17-32 warps are separate instances: a launch bound of 1,024
//    threads holds a thread to 64 registers, which the smaller blocks'
//    bound of 512 (128 registers) does not impose on them.
// A tile's pairs sweep its diagonals 2 .. ndiag - 1. Rows past a pair's
// length and columns past its y hold pad codes that mismatch everything
// (under a matrix, score at most 0 against anything: scoring.py), so
// those cells never exceed the pair's real maximum; the kernel needs
// no per-pair length. Only j >= 1 is masked (the first-row boundary), and
// a warp takes the unmasked step once its last row's j >= 1, for the whole
// warp at once (one warp a pair: a masked loop, then an unmasked one).
// Sub-strips in order with a ring (sw_strips.cu's form) are
// not used here: a tile's ring would need 8 bytes a diagonal a pair, and
// a lane-tile bucket's diagonals reach max_device_diags (2^20), past any
// block's shared memory; the block form needs a fixed 768 bytes.
//
// The y codes enter at the first row only: lanes of warp 0 load the
// stream codes of the 32 columns after the next 32 through __ldg, one
// column a lane, and lane 0 takes its step's code from them by
// __shfl_sync, so the load has 32 steps to land.
//
// Bound on this card: operations, as in sw_strips.cu; a step's fixed part
// is the three shuffles of the hand-over, the stream shuffle and, for a
// block, the barrier and the seam.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sw_rows.cuh"

namespace {

constexpr int kLanes = 128;        // pairs per packed tile
constexpr int kMaxWarps = 32;      // warps a block
constexpr int kNeg = kSwNeg;       // -inf of P and Q (sw_cell.cuh)
constexpr int kPadX = 1;           // the pack's x pad code

// kForm 0: blockDim.x / 32 pairs a block, one warp each. kForm 1 and 2:
// one pair a block of blockDim.x / 32 warps, at most 16 (kForm 1) or 32
// (kForm 2), the launch bound of the instance. kMat: the matrix
// instantiation (sw_rows.cuh), its code table in static shared memory.
template <int R, int kForm, bool kMat>
__global__ void __launch_bounds__(kForm == 2 ? kMaxWarps * 32
                                             : kMaxWarps * 32 / 2)
sw_tile_kernel(const int8_t* __restrict__ sx, const int8_t* __restrict__ sy,
               const int32_t* __restrict__ ndiag_tile,
               int32_t* __restrict__ out, int n_slots, int nxs, int nds,
               SwScoring sc, const int32_t* __restrict__ table) {
  constexpr int H = 32 * R;
  constexpr bool kBlock = kForm != 0;
  __shared__ int32_t seam[2][3][kMaxWarps];  // D, Q, code of each warp's
                                             // last row, by step parity
  __shared__ int32_t block_best;
  const int lane = threadIdx.x & 31;
  const int wp = threadIdx.x >> 5;
  const int slot = kBlock ? blockIdx.x : blockIdx.x * (blockDim.x >> 5) + wp;
  SwRows<R, kMat> rows;
  if constexpr (kMat) {
    __shared__ int32_t tab[kSubEntries];
    sw_load_table(tab, table);
    __syncthreads();
    rows.tab = tab;
  }
  if (!kBlock && slot >= n_slots) return;  // the whole warp
  const int gw = kBlock ? wp : 0;          // the warp's group in its pair
  const int t = slot / kLanes;
  const int l = slot % kLanes;
  const int nd = ndiag_tile[t];
  const int anchor = nds - nxs;
  const int8_t* const ys = sy + static_cast<size_t>(t) * nds * kLanes + l;
  const int8_t* const xs = sx + static_cast<size_t>(t) * nxs * kLanes + l;

  const int row0 = 1 + gw * H;
  const int pf = row0 + lane * R;  // this lane's first row
#pragma unroll
  for (int i = 0; i < R; ++i)
    rows.X[i] = sw_x_code<kMat>(
        pf + i < nxs ? xs[static_cast<size_t>(pf + i) * kLanes] : kPadX);
  rows.reset();
  // Stream code of column j (row 1's cell j is on diagonal j + 1).
  auto code = [&](int j) {
    return j < nd ? static_cast<int>(
                        __ldg(ys + static_cast<size_t>(anchor - j) * kLanes))
                  : 0;
  };
  int cur = 0, nxt = 0;  // warp 0: codes of columns 32c + 1 + lane, c + 1
  if (gw == 0) {
    cur = code(1 + lane);
    nxt = code(33 + lane);
  }
  int aD = 0, aQ = kNeg, aY = __shfl_sync(kSwFullMask, cur, 0);
  if (lane > 0) aY = 0;
  if (kBlock) {
    if (threadIdx.x == 0) block_best = 0;
    __syncthreads();
  }
  int best = 0;

  // After diagonal d's cells: the row above each lane's row 0 for d + 1
  // (lane t-1's row R-1; for lane 0 of warp 0 the first-column boundary
  // and the stream code of column d, for lane 0 of another warp the seam).
  auto advance = [&](int d) {
    rows.hand_down(aD, aQ, aY);
    // Warp 0: the code of the next step's column, e + 2 with e = d - 2.
    int yn = 0;
    if (gw == 0) {
      const int ei = (d - 2) & 31;
      yn = __shfl_sync(kSwFullMask, ei == 31 ? nxt : cur, (ei + 1) & 31);
      if (ei == 31) {
        cur = nxt;
        nxt = code(d + 32 + lane);  // columns 32(c + 2) + 1 + lane
      }
    }
    if (kBlock) {
      const int par = d & 1;
      if (lane == 31) {
        seam[par][0][wp] = rows.D[R - 1];
        seam[par][1][wp] = rows.Q[R - 1];
        seam[par][2][wp] = rows.Y[R - 1];
      }
      __syncthreads();
      if (lane == 0 && wp > 0) {
        aD = seam[par][0][wp - 1];
        aQ = seam[par][1][wp - 1];
        aY = seam[par][2][wp - 1];
      }
    }
    if (lane == 0 && gw == 0) {  // the first-column boundary above row 1
      aD = 0;
      aQ = kNeg;
      aY = yn;
    }
  };
  if (kBlock) {
    // One loop, one barrier a step for every warp of the pair.
    for (int d = 2; d < nd; ++d) {
      if (d > row0) {  // the warp has cells with j >= 1
        if (d >= row0 + H) {
          rows.template step<false>(d, pf, aD, aQ, aY, kSwNoEnd, kSwNoEnd,
                                    sc, best);
        } else {
          rows.template step<true>(d, pf, aD, aQ, aY, kSwNoEnd, kSwNoEnd, sc,
                                   best);
        }
      }
      advance(d);
    }
  } else {
    // The start triangle (the last row's j < 1), then no masks.
    const int d_fast = min(row0 + H, nd);
    for (int d = 2; d < d_fast; ++d) {
      rows.template step<true>(d, pf, aD, aQ, aY, kSwNoEnd, kSwNoEnd, sc,
                               best);
      advance(d);
    }
    for (int d = d_fast; d < nd; ++d) {
      rows.template step<false>(d, pf, aD, aQ, aY, kSwNoEnd, kSwNoEnd, sc,
                                best);
      advance(d);
    }
  }
  best = __reduce_max_sync(kSwFullMask, best);
  if (!kBlock) {
    if (lane == 0) out[slot] = best;
    return;
  }
  if (lane == 0) atomicMax(&block_best, best);
  __syncthreads();
  if (threadIdx.x == 0) out[slot] = block_best;
}

template <int R, bool kMat>
int launch(const void* sx, const void* sy, const void* ndiag_tile, void* out,
           int nt, int nxs, int nds, int warps, int pairs, SwScoring sc,
           const void* table, cudaStream_t stream) {
  const int n_slots = nt * kLanes;
  const int8_t* x = static_cast<const int8_t*>(sx);
  const int8_t* y = static_cast<const int8_t*>(sy);
  const int32_t* nd = static_cast<const int32_t*>(ndiag_tile);
  int32_t* o = static_cast<int32_t*>(out);
  const int32_t* tab = static_cast<const int32_t*>(table);
  if (warps == 1) {
    sw_tile_kernel<R, 0, kMat><<<(n_slots + pairs - 1) / pairs, pairs * 32,
                                 0, stream>>>(x, y, nd, o, n_slots, nxs, nds,
                                              sc, tab);
  } else if (warps <= kMaxWarps / 2) {
    sw_tile_kernel<R, 1, kMat><<<n_slots, warps * 32, 0, stream>>>(
        x, y, nd, o, n_slots, nxs, nds, sc, tab);
  } else {
    sw_tile_kernel<R, 2, kMat><<<n_slots, warps * 32, 0, stream>>>(
        x, y, nd, o, n_slots, nxs, nds, sc, tab);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for an R the build does not make or a geometry
// out of range. The caller allocates `out` and checks shapes: 2 <= nxs,
// nds > nxs, and A = nds - nxs >= every ndiag_tile[t]; and picks R
// (`rows_per_thread`), the warps a pair (1, or 2 <= W <= 32 with W * 32 *
// R >= nxs - 1: up to 8,193 rows at R = 8) and, for one warp a pair, the
// pairs a block (1-16). `table` null scores by match and mismatch; else
// it is the code table on the device (kSubEntries int32) and match and
// mismatch are not read.
extern "C" int sw_tile_launch(const void* sx, const void* sy,
                              const void* ndiag_tile, void* out, int nt,
                              int nxs, int nds, int rows_per_thread,
                              int warps, int pairs, int match, int mismatch,
                              int gap_open, int gap_extend, const void* table,
                              void* stream) {
  if (nt <= 0) return 0;
  if (warps < 1 || warps > kMaxWarps || pairs < 1 ||
      pairs > kMaxWarps / 2 || warps * 32 * rows_per_thread < nxs - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread) {
#define GENOMAX_TILE_CASE(r)                                                 \
  case r:                                                                    \
    return table ? launch<r, true>(sx, sy, ndiag_tile, out, nt, nxs, nds,    \
                                   warps, pairs, sc, table, s)               \
                 : launch<r, false>(sx, sy, ndiag_tile, out, nt, nxs, nds,   \
                                    warps, pairs, sc, table, s);
    GENOMAX_TILE_CASE(2)
    GENOMAX_TILE_CASE(3)
    GENOMAX_TILE_CASE(4)
    GENOMAX_TILE_CASE(5)
    GENOMAX_TILE_CASE(6)
    GENOMAX_TILE_CASE(8)
#undef GENOMAX_TILE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
