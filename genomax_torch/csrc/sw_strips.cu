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
// the largest D of each pair's matrix.
//
// Design: one block per pair (slot t*128 + l), W = blockDim.x rows per
// strip, the K strips swept one after another inside the block: the sweep
// of the long-pair kernel (sw_long.cu) at the scale of a bucket. Within a
// strip, thread r owns row p = k*W + r, keeps its D and P of diagonal d-1
// in registers, takes D, Q and the y code of the row above from ping-pong
// rows in shared memory (one __syncthreads per diagonal) and hands its
// own down. Strip k sweeps only the diagonals [kW + 1,
// min(kW + W - 1, len x) + len y], and a pair stops at its own last strip,
// so the triangles of the lane-tile kernel (sw_tile.cu: every row of the
// bucket over the tile's whole diagonal count) shrink to a band W wide.
//
// The pair's y codes are staged in shared memory once (ycode[j] = y[j-1]);
// row 0 of a strip reads them there, so inside the sweep no thread reads
// device memory, but for its x code once a strip.
//
// The seam lives in shared memory: a ring of R = ny_max entries holding
// D and Q of the strip's last row, entry e (diagonal e) in slot e mod R.
// Thread W-1 writes entry d after the barrier of diagonal d. Thread 0
// (row kW) needs entry d-1 at diagonal d: it reads entry d during diagonal
// d, before that barrier, and keeps it for d+1; its diagonal neighbour,
// entry d-2, is the value it used one step earlier. One ring serves every
// strip without a race:
//  - within a strip, entry e is read (during diagonal e) before the same
//    strip writes it (after the barrier of e), so a read sees the
//    previous strip's value;
//  - a live cell (kW, j) reads entry kW + j - 1 <= kW + len y - 1, and the
//    strip writes entries from kW + 1 on; a write of entry e' lands on the
//    slot of a later read e only if R divides e - e', but
//    e - e' <= len y - 2 < R;
//  - strip k-1 writes its entries in order up to kW - 1 + len y, and the
//    last R of them, which the ring keeps, cover the len y entries
//    kW .. kW + len y - 1 that strip k reads for live cells;
//  - the __syncthreads that opens each strip orders it after the last.
// Reads for dead cells may see anything, and a dead cell uses nothing, so
// the ring needs no initial value. The TPU kernel's two zeroed halo slots
// and its pad-decay argument (sw_strips.py:14-23) have no part here.
//
// Boundaries are written out, as in sw_long.cu: a cell is live iff
// 1 <= p <= len x and 1 <= j <= len y; every other cell is D = 0,
// P = Q = kSwNeg. Strip 0's row above is the first-column boundary.
//
// Shared memory per block (strips_smem_bytes): 6W int32 (ping-pong D, Q
// and y code) + 8R bytes (the ring) + R bytes of y codes rounded up to 16.
// Past 48 KB the launch raises the kernel's dynamic limit with
// cudaFuncSetAttribute; kernels/sw_strips.py derives the same sum and
// declines a bucket past the card's 227 KB a block.
//
// Bound on this card: the per-diagonal block barrier and the shared-memory
// round trip of each step, as in the other SW kernels; a cell costs about
// a dozen integer operations and reads nothing from device memory. A step
// also has a fixed part per block (the barrier, thread 0's seam read and
// y code, thread W-1's seam write), so wider strips pay on long pairs,
// and blocks of one warp (W = 32) cap an SM at 32 warps;
// kernels/sw_strips.pick_strip_w weighs both. Several rows per thread in
// registers, warp shuffles in place of the shared rows, and DPX max-plus
// intrinsics are the levers for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sw_cell.cuh"

namespace {

constexpr int kLanes = 128;        // pairs per packed tile
constexpr int kNeg = kSwNeg;       // -inf of P and Q (sw_cell.cuh)

size_t strips_smem_bytes(int w, int ring) {
  return 6 * static_cast<size_t>(w) * sizeof(int32_t) +
         static_cast<size_t>(ring) * sizeof(int2) +
         ((static_cast<size_t>(ring) + 15) / 16) * 16;
}

__global__ void __launch_bounds__(1024)
sw_strips_kernel(const int8_t* __restrict__ sx, const int8_t* __restrict__ sy,
                 const int32_t* __restrict__ nx,
                 const int32_t* __restrict__ ny, int32_t* __restrict__ out,
                 int k_strips, int nds, int anchor, int ring, int match,
                 int mismatch, int gap_open, int gap_extend) {
  extern __shared__ int4 smem4[];  // 16-byte aligned
  const int w = blockDim.x;
  int32_t* const dsh = reinterpret_cast<int32_t*>(smem4);  // [2][w] D
  int32_t* const qsh = dsh + 2 * w;                        // [2][w] Q
  int32_t* const ysh = dsh + 4 * w;                        // [2][w] y code
  int2* const halo = reinterpret_cast<int2*>(dsh + 6 * w);  // [ring]
  int8_t* const ycode = reinterpret_cast<int8_t*>(halo + ring);  // [ring]
  __shared__ int32_t block_best;

  const int slot = blockIdx.x;
  const int t = slot / kLanes;
  const int l = slot % kLanes;
  const int r = threadIdx.x;
  const int lx = nx[slot] - 1;  // len(x)
  const int ly = ny[slot] - 1;  // len(y)
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};
  const int8_t* const xs =
      sx + static_cast<size_t>(t) * k_strips * w * kLanes + l;
  const int8_t* const ys = sy + static_cast<size_t>(t) * nds * kLanes + l;

  // A slot whose lengths break the launch contract (the ring or the
  // strips too short for it) scores -1, below any score, and touches no
  // memory; the wrapper checks the contract on the host where it can.
  if (ly >= ring || lx >= k_strips * w || ly > anchor) {
    if (r == 0) out[slot] = -1;
    return;
  }
  if (r == 0) block_best = 0;
  for (int j = 1 + r; j <= ly; j += w)
    ycode[j] = ys[static_cast<size_t>(anchor - j) * kLanes];

  int best = 0;
  // Strip k holds rows [kW, kW + W); it has a live row iff kW <= len x.
  // The bounds are the same for every thread of the block.
  const bool any_live = lx > 0 && ly > 0;
  for (int k = 0; any_live && k < k_strips && k * w <= lx; ++k) {
    const int row0 = k * w;
    const int p = row0 + r;
    const int xc = xs[static_cast<size_t>(p) * kLanes];
    const bool row_live = p >= 1 && p <= lx;
    const int d_start = row0 + 1;                     // row0's cell j = 1
    const int d_end = min(row0 + w - 1, lx) + ly;     // last live diagonal

    // Diagonal d_start - 1: every cell of the strip is first-column
    // boundary or above it.
    __syncthreads();  // the y codes; the previous strip's reads and writes
    const int ib = ((d_start - 1) & 1) * w;
    dsh[ib + r] = 0;
    qsh[ib + r] = kNeg;
    ysh[ib + r] = 0;
    int rd = (d_start - 1) % ring;   // slot of the entry thread 0 read last
    int wr = d_start % ring;         // slot thread W-1 writes next
    int2 above = make_int2(0, kNeg);  // row0-1's D and Q at d-1 (thread 0)
    if (r == 0 && k > 0) above = halo[rd];
    int d1 = 0;      // D of (p, j-1)
    int p1 = kNeg;   // P of (p, j-1)
    int up2 = 0;     // D of (p-1, j-1), the diagonal neighbour
    __syncthreads();

    for (int d = d_start; d <= d_end; ++d) {
      const int rb = ((d - 1) & 1) * w;
      int up_d, up_q, yc;
      if (r > 0) {
        up_d = dsh[rb + r - 1];   // D of (p-1, j) at d-1
        up_q = qsh[rb + r - 1];   // Q of (p-1, j) at d-1
        yc = ysh[rb + r - 1];     // y[j-1], as (p-1, j) used it at d-1
      } else {
        up_d = above.x;
        up_q = above.y;
        const int j0 = d - row0;
        yc = j0 <= ly ? ycode[j0] : 0;
        if (++rd == ring) rd = 0;
        if (k > 0) above = halo[rd];  // entry d, for diagonal d+1
      }
      const int j = d - p;
      int dn = 0, pn = kNeg, qn = kNeg;
      if (row_live && j >= 1 && j <= ly)
        dn = sw_cell(d1, p1, up_d, up_q, up2, xc == yc, sc, pn, qn, best);
      const int wb = (d & 1) * w;
      dsh[wb + r] = dn;
      qsh[wb + r] = qn;
      ysh[wb + r] = yc;
      d1 = dn;
      p1 = pn;
      up2 = up_d;
      __syncthreads();
      if (r == w - 1) halo[wr] = make_int2(dn, qn);
      if (++wr == ring) wr = 0;
    }
  }
  __syncthreads();
  atomicMax(&block_best, best);
  __syncthreads();
  if (r == 0) out[slot] = block_best;
}

}  // namespace

// Launches the kernel on `stream` and returns the first CUDA error (0 on
// success): raising the dynamic shared-memory limit, or the launch that
// cudaGetLastError() reports. The caller allocates `out` (nt * 128 int32)
// and checks shapes: sx (nt, k_strips*w, 128), sy (nt, nds, 128),
// nx, ny (nt*128); 1 <= w <= 1024; ring >= every ny; every nx <= k_strips*w;
// ny <= anchor and anchor + w <= nds (the pack's anchor with W <= NXs).
extern "C" int sw_strips_launch(const void* sx, const void* sy,
                                const void* nx, const void* ny, void* out,
                                int nt, int k_strips, int w, int nds,
                                int anchor, int ring, int match,
                                int mismatch, int gap_open, int gap_extend,
                                void* stream) {
  if (nt <= 0) return 0;
  const size_t smem = strips_smem_bytes(w, ring);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_strips_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sw_strips_kernel<<<nt * kLanes, w, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(sx), static_cast<const int8_t*>(sy),
      static_cast<const int32_t*>(nx), static_cast<const int32_t*>(ny),
      static_cast<int32_t*>(out), k_strips, nds, anchor, ring, match,
      mismatch, gap_open, gap_extend);
  return static_cast<int>(cudaGetLastError());
}
