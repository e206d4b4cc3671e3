// Strip-mined Smith-Waterman (Gotoh, score only) over one packed bucket,
// for Hopper (sm_90a).
//
// Replaces: genomax/kernels/sw_strips.py `_kernel` (wrapper
// `sw_forward_pallas_strips`), the batched strip-mined wavefront. Same
// inputs and output, with each pair's lengths in place of the per-tile
// diagonal counts: sx (NT, K*W, 128) int8 codes, row p holding x[p-1]
// (pads 1); sy (NT, NDs, 128) int8 reversed stream, y[j-1] at row
// anchor - j, where anchor = NDs - NXs of the bucket before its x was
// re-padded to K*W rows (pads 0); nx, ny (NT*128,) int32 matrix
// dimensions len + 1 (1 on empty slots); out (NT, 128) int32, slot-major,
// the largest D of each pair's matrix. The pack's strip width W does not
// shape the kernel: it walks the pack's K*W rows in sub-strips of its own
// height H.
//
// Design: one warp per pair (slot), several pairs a block and no block
// barrier. A sub-strip is H = 32 * R rows (R = 2, 3, 4, 5, 6, 8, a
// template argument): sub-strip s holds rows [1 + s*H, 1 + s*H + H) (row
// 0 is the first-column boundary and is not swept), lane t rows
// 1 + s*H + t*R .. + R - 1 in registers (sw_rows.cuh's step: the row
// above by __shfl_up_sync, the y code travelling down the rows, the DPX
// cell). The sub-strips run one after another in the warp, each over its
// live diagonals only, [row0 + 1, min(row0 + H - 1, len x) + len y], and a
// pair stops at its own last live sub-strip, so the triangles of the
// lane-tile kernel (every row over the tile's whole diagonal count)
// shrink to bands H wide.
//
// The warp stages its pair's y codes in shared memory once (ycode[j] =
// y[j-1], 1 <= j <= len y); lane 0 hands its first row the code of
// column j from there, so inside the sweep the warp reads device memory
// only for its x codes, once a sub-strip.
//
// The seam between sub-strips is a ring of ny_max (D, Q) entries per warp
// in shared memory, entry j the previous sub-strip's last row at column
// j. With kH the first row of a sub-strip: its lane 0 reads the entry of
// column j for row kH, which needs it on diagonal kH + j (the warp loads
// it one step ahead, on kH + j - 1, every lane at the same address, and
// lane 0 keeps it); its lane 31 overwrites that entry from
// row kH + H - 1 on diagonal kH + H - 1 + j, live cells only, for the
// next sub-strip. One ring serves every sub-strip without a race:
//  - within a sub-strip the read of entry j comes H steps before its
//    overwrite, and a __syncwarp ends every step, so the read is ordered
//    before the write;
//  - a live first-row cell (kH, j) has j <= len y, and the previous
//    sub-strip's last row is live (it lies above kH <= len x), so that
//    sub-strip wrote every entry 1 .. len y on its own diagonals, before
//    it ended (a __syncwarp ends its last step);
//  - entries past len y are never read: lane 0 takes the boundary there.
// The ring needs no initial value: the first sub-strip reads none of it
// (its row above is the first-column boundary). The TPU kernel's two
// zeroed halo slots and its pad-decay argument (sw_strips.py:14-23) have
// no part here.
//
// Masks are written out, as in sw_long.cu: a cell is live iff
// 1 <= p <= len x and 1 <= j <= len y; every other cell is D = 0,
// P = Q = kSwNeg. A sub-strip is swept in three loops, each the same
// for every lane of the warp: the start triangle (masked), the diagonals
// on which every cell of the warp is live (row0 + H <= d <= row0 + len y,
// on a sub-strip whose last row is live; no masks) and the end triangle
// (masked; the whole of the pair's last sub-strip where its last row is
// dead).
//
// Shared memory per pair (strips_pair_bytes): 8 * ny_max bytes of ring
// and ny_max bytes of y codes rounded up to 16; a block of P pairs takes
// P times that. Past 48 KB the launch raises the kernel's dynamic limit
// with cudaFuncSetAttribute; kernels/sw_strips.py derives the same sum,
// picks P and declines a bucket whose one pair passes the card's 227 KB
// a block.
//
// Bound on this card: operations. A cell costs sw_cell_dpx's five
// integer instructions, the substitution's compare and select, the
// diagonal's add and half a running max, and the moves of the rows'
// diagonal neighbour and y code; a step adds a fixed part for the warp
// (three shuffles, the two shared loads, lane 31's ring store, the loop),
// which R rows a thread spread over R cells. A pair's last sub-strip
// sweeps all of y however few rows it holds, which favours the R whose
// H leaves no short last sub-strip (kernels/sw_strips.geometry).
// Occupancy is set by the ring's shared memory on long y.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sw_rows.cuh"

namespace {

constexpr int kLanes = 128;        // pairs per packed tile
constexpr int kMaxPairs = 8;       // warps (pairs) a block
constexpr int kNeg = kSwNeg;       // -inf of P and Q (sw_cell.cuh)
constexpr int kPadX = 1;           // the pack's x pad code

__host__ __device__ size_t strips_pair_bytes(int ring) {
  return static_cast<size_t>(ring) * sizeof(int2) +
         ((static_cast<size_t>(ring) + 15) / 16) * 16;
}

// kMat: the matrix instantiation (sw_rows.cuh), its code table the first
// kSubEntries int32 of the shared memory, the pairs' regions after it.
template <int R, bool kMat>
__global__ void __launch_bounds__(kMaxPairs * 32)
sw_strips_kernel(const int8_t* __restrict__ sx, const int8_t* __restrict__ sy,
                 const int32_t* __restrict__ nx,
                 const int32_t* __restrict__ ny, int32_t* __restrict__ out,
                 int n_slots, int n_rows, int nds, int anchor, int ring,
                 SwScoring sc, const int32_t* __restrict__ table) {
  constexpr int H = 32 * R;
  extern __shared__ int4 smem4[];  // 16-byte aligned
  const int lane = threadIdx.x & 31;
  const int wp = threadIdx.x >> 5;
  const int slot = blockIdx.x * (blockDim.x >> 5) + wp;
  char* pairs_smem = reinterpret_cast<char*>(smem4);
  SwRows<R, kMat> rows;
  if constexpr (kMat) {
    int* const tab = reinterpret_cast<int*>(smem4);
    sw_load_table(tab, table);
    __syncthreads();
    rows.tab = tab;
    pairs_smem += kSubEntries * sizeof(int);
  }
  if (slot >= n_slots) return;  // the whole warp: no barrier follows
  int2* const seam = reinterpret_cast<int2*>(
      pairs_smem + wp * strips_pair_bytes(ring));
  int8_t* const ycode = reinterpret_cast<int8_t*>(seam + ring);

  const int t = slot / kLanes;
  const int l = slot % kLanes;
  const int lx = nx[slot] - 1;  // len(x)
  const int ly = ny[slot] - 1;  // len(y)
  // A slot whose lengths break the launch contract (the ring or the rows
  // too short for it) scores -1, below any score, and touches no memory;
  // the wrapper checks the contract on the host where it can.
  if (ly >= ring || lx >= n_rows || ly > anchor) {
    if (lane == 0) out[slot] = -1;
    return;
  }
  const int8_t* const xs =
      sx + static_cast<size_t>(t) * n_rows * kLanes + l;
  const int8_t* const ys = sy + static_cast<size_t>(t) * nds * kLanes + l;
  for (int j = 1 + lane; j <= ly; j += 32)
    ycode[j] = ys[static_cast<size_t>(anchor - j) * kLanes];
  __syncwarp();

  int best = 0;
  // Sub-strip s holds rows [row0, row0 + H), row0 = 1 + s*H; it has a
  // live row iff row0 <= len x. The bounds are the same for every lane.
  for (int row0 = 1; ly > 0 && row0 <= lx; row0 += H) {
    const int pf = row0 + lane * R;  // this lane's first row
#pragma unroll
    for (int i = 0; i < R; ++i)
      rows.X[i] = sw_x_code<kMat>(
          pf + i < n_rows ? xs[static_cast<size_t>(pf + i) * kLanes] : kPadX);
    rows.reset();
    const int p_last = row0 + H - 1;  // the sub-strip's last row
    const bool last_live = p_last <= lx;
    const int d_end = min(p_last, lx) + ly;  // last live diagonal
    // Diagonals on which every cell of the warp is live: the last row's
    // j >= 1 and the first row's j <= len y, every row live.
    const int fast_lo = row0 + H;
    const int fast_hi = last_live ? row0 + ly : -1;

    // The row above row0 at column 1, for diagonal row0 + 1.
    int aD = 0, aQ = kNeg, aY = 0;
    if (lane == 0) {
      if (row0 > 1) {  // the ring holds the row above
        const int2 h = seam[1];
        aD = h.x;
        aQ = h.y;
      }
      aY = ycode[1];
    }
    // Diagonals d_lo .. d_hi, masked or not. Every lane loads the entry
    // and the code of column j1 = d + 1 - row0 (the same address: a
    // broadcast, no branch; clamped to len y) for the row above row0 at
    // diagonal d + 1, and lane 0 keeps them, or the boundary past len y
    // and on the first sub-strip.
    auto sweep = [&](auto masked, int d_lo, int d_hi) {
      for (int d = d_lo; d <= d_hi; ++d) {
        const int j1 = d + 1 - row0;
        const int jc = min(j1, ly);
        const int2 h = seam[jc];
        const int hy = ycode[jc];
        rows.template step<decltype(masked)::value>(d, pf, aD, aQ, aY, lx,
                                                     ly, sc, best);
        rows.hand_down(aD, aQ, aY);
        // The seam, live cells only: the last row's column d - p_last.
        if (lane == 31 &&
            (!decltype(masked)::value ||
             (last_live && static_cast<unsigned>(d - p_last - 1) <
                               static_cast<unsigned>(ly))))
          seam[d - p_last] = make_int2(rows.D[R - 1], rows.Q[R - 1]);
        if (lane == 0) {
          const bool in = j1 <= ly, above = in && row0 > 1;
          aD = above ? h.x : 0;
          aQ = above ? h.y : kNeg;
          aY = in ? hy : 0;
        }
        __syncwarp();
      }
    };
    // The start triangle, the band where every cell of the warp is live
    // (no masks), the end triangle.
    const int d_start = row0 + 1;
    sweep(std::true_type{}, d_start, min(fast_lo - 1, d_end));
    sweep(std::false_type{}, fast_lo, fast_hi);
    sweep(std::true_type{}, max(fast_lo, fast_hi + 1), d_end);
  }
  best = __reduce_max_sync(kSwFullMask, best);
  if (lane == 0) out[slot] = best;
}

template <int R, bool kMat>
int launch(const void* sx, const void* sy, const void* nx, const void* ny,
           void* out, int nt, int n_rows, int pairs, int nds, int anchor,
           int ring, SwScoring sc, const void* table, cudaStream_t stream) {
  const int n_slots = nt * kLanes;
  const size_t smem = pairs * strips_pair_bytes(ring) +
                      (kMat ? kSubEntries * sizeof(int) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_strips_kernel<R, kMat>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sw_strips_kernel<R, kMat><<<(n_slots + pairs - 1) / pairs, pairs * 32,
                              smem, stream>>>(
      static_cast<const int8_t*>(sx), static_cast<const int8_t*>(sy),
      static_cast<const int32_t*>(nx), static_cast<const int32_t*>(ny),
      static_cast<int32_t*>(out), n_slots, n_rows, nds, anchor, ring, sc,
      static_cast<const int32_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns the first CUDA error (0 on
// success): raising the dynamic shared-memory limit, or the launch that
// cudaGetLastError() reports; cudaErrorInvalidValue for an R the build
// does not make or a block of other than 1-8 pairs. The caller allocates
// `out` (nt * 128 int32) and checks shapes: sx (nt, n_rows, 128), sy (nt,
// nds, 128), nx, ny (nt*128); ring >= every ny; every nx <= n_rows;
// ny <= anchor < nds; and picks R (`rows_per_thread`) and `pairs`.
// `table` null scores by match and mismatch; else it is the code table
// on the device (kSubEntries int32), match and mismatch are not read,
// and a block takes kSubEntries * 4 bytes more shared memory.
extern "C" int sw_strips_launch(const void* sx, const void* sy,
                                const void* nx, const void* ny, void* out,
                                int nt, int n_rows, int rows_per_thread,
                                int pairs, int nds, int anchor, int ring,
                                int match, int mismatch, int gap_open,
                                int gap_extend, const void* table,
                                void* stream) {
  if (nt <= 0) return 0;
  if (pairs < 1 || pairs > kMaxPairs)
    return static_cast<int>(cudaErrorInvalidValue);
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread) {
#define GENOMAX_STRIPS_CASE(r)                                              \
  case r:                                                                   \
    return table ? launch<r, true>(sx, sy, nx, ny, out, nt, n_rows, pairs,  \
                                   nds, anchor, ring, sc, table, s)         \
                 : launch<r, false>(sx, sy, nx, ny, out, nt, n_rows, pairs, \
                                    nds, anchor, ring, sc, table, s);
    GENOMAX_STRIPS_CASE(2)
    GENOMAX_STRIPS_CASE(3)
    GENOMAX_STRIPS_CASE(4)
    GENOMAX_STRIPS_CASE(5)
    GENOMAX_STRIPS_CASE(6)
    GENOMAX_STRIPS_CASE(8)
#undef GENOMAX_STRIPS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
