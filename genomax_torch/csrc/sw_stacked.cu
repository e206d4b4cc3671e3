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
// Design: one block per (stacked tile t, lane l), S*h threads; thread
// g = q*h + s scores row s of region q, i.e. the pair of bucket tile
// t*S + q in lane l, with the cell of the lane-tile kernel (sw_tile.cu):
// at diagonal d it scores cell (s, j = d - s), keeps its own D and P of
// d-1 in registers, and takes the row above's D and Q of d-1 from a
// ping-pong pair of shared rows; one __syncthreads a diagonal orders the
// hand-over. On the TPU the stack spreads one per-step issue over S
// pairs; here it spreads one block barrier (and one block's share of an
// SM) over S pairs, and fills whole warps where the lane tile's 72-row
// blocks leave a warp a quarter full.
//
// The S regions sweep in phase, ndt[t] diagonals for all. Three rules
// keep them apart, each written out where the TPU kernel relied on its
// circular sublane roll and -KILL pins (they have no counterpart here):
//  - row s = 0 of every region is the first-column boundary (D = 0,
//    Q = -inf) and never reads the row above, which is the bottom row of
//    the region before;
//  - cells with j <= 0 are the first-row boundary (D = 0, P = -inf);
//  - the ghost-read mask: the thread reads its stream byte, at row
//    a0 - d + g = a0 + q*h - j, only for 1 <= j <= h, and takes PAD_STREAM
//    (0) past j = h, where that row belongs to the region before. Without
//    it a region would read its neighbour's bases and score a false
//    alignment. Rows past a pair's length and columns past its y hold pad
//    codes that mismatch everything, so those cells never exceed the
//    pair's real maximum, and the extra diagonals of a shorter region
//    meet only pad codes.
// Each region's maximum is reduced in shared memory at the end.
//
// Contract: S*h <= 1024 threads (the launch refuses more), a0 >= h (every
// masked read lies in the buffer) and ndt[t] <= a0 (the plain version's
// window). A tile whose ndt breaks it writes -1 to its S slots of the lane,
// below any score, and reads nothing else; the wrapper checks the static
// part on the host and raises before it launches.
//
// Bound on this card: the per-diagonal block barrier and the shared-memory
// round trip, as in sw_tile.cu; a cell costs about a dozen integer
// operations and reads one stream byte (from L1: thread g reads at d+1 the
// byte thread g-1 read at d). The triangle waste of the lane tile is
// unchanged (each region sweeps its h rows over the stack's diagonals).
// Several rows per thread, warp shuffles in place of the shared rows and
// DPX max-plus intrinsics (__viaddmax_s32) are the levers for later.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sw_cell.cuh"

namespace {

constexpr int kLanes = 128;        // pairs per packed tile
constexpr int kNeg = kSwNeg;       // -inf of P and Q (sw_cell.cuh)
constexpr int kMaxThreads = 1024;  // threads in a block

__global__ void __launch_bounds__(kMaxThreads)
sw_stacked_kernel(const int8_t* __restrict__ sx, const int8_t* __restrict__ sy,
                  const int32_t* __restrict__ ndt, int32_t* __restrict__ out,
                  int stack, int h, int nds, int match, int mismatch,
                  int gap_open, int gap_extend) {
  extern __shared__ int32_t smem[];
  const int nxs = blockDim.x;      // stack * h
  int32_t* const dsh = smem;              // [2][nxs]: D of each row
  int32_t* const qsh = smem + 2 * nxs;    // [2][nxs]: Q of each row
  int32_t* const rbest = smem + 4 * nxs;  // [stack]: each region's best

  const int t = blockIdx.x / kLanes;
  const int l = blockIdx.x % kLanes;
  const int g = threadIdx.x;
  const int q = g / h;
  const int s = g - q * h;
  const int nd = ndt[t];
  const int a0 = nds - nxs;
  int32_t* const slot =
      out + (static_cast<size_t>(t) * stack + q) * kLanes + l;
  if (h > a0 || nd > a0) {
    if (s == 0) *slot = -1;
    return;
  }
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};
  const int8_t xc = sx[(static_cast<size_t>(t) * nxs + g) * kLanes + l];
  // Row a0 - d + g of this tile's stream, at lane l, is ys[(g - d) * 128].
  const int8_t* const ys =
      sy + (static_cast<size_t>(t) * nds + a0) * kLanes + l;

  int d1 = 0;      // D of (s, j-1)
  int p1 = kNeg;   // P of (s, j-1)
  int up2 = 0;     // D of (s-1, j-1), the diagonal neighbour
  int best = 0;
  dsh[nxs + g] = 0;   // diagonal 1: every cell is boundary
  qsh[nxs + g] = kNeg;
  if (s == 0) rbest[q] = 0;
  __syncthreads();

  for (int d = 2; d < nd; ++d) {
    const int rb = ((d - 1) & 1) * nxs;
    const int up_d = s > 0 ? dsh[rb + g - 1] : 0;     // D of (s-1, j)
    const int up_q = s > 0 ? qsh[rb + g - 1] : kNeg;  // Q of (s-1, j)
    const int j = d - s;
    int dn = 0, pn = kNeg, qn = kNeg;
    if (s > 0 && j > 0) {
      const int8_t yc =
          j <= h ? __ldg(ys + static_cast<ptrdiff_t>(g - d) * kLanes) : 0;
      dn = sw_cell(d1, p1, up_d, up_q, up2, xc == yc, sc, pn, qn, best);
    }
    const int wb = (d & 1) * nxs;
    dsh[wb + g] = dn;
    qsh[wb + g] = qn;
    d1 = dn;
    p1 = pn;
    up2 = up_d;
    __syncthreads();
  }
  atomicMax(&rbest[q], best);
  __syncthreads();
  if (s == 0) *slot = rbest[q];
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue without launching when stack * h is not a block
// the kernel takes (2 <= stack, 1 <= h, stack * h <= 1024). The caller
// allocates `out` (nt * stack * 128 int32) and checks shapes: sx (nt,
// stack*h, 128), sy (nt, nds, 128) with nds - stack*h >= h, ndt (nt,).
extern "C" int sw_stacked_launch(const void* sx, const void* sy,
                                 const void* ndt, void* out, int nt,
                                 int stack, int h, int nds, int match,
                                 int mismatch, int gap_open, int gap_extend,
                                 void* stream) {
  if (stack < 2 || h < 1 || stack * h > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt <= 0) return 0;
  const int nxs = stack * h;
  const size_t smem =
      (4 * static_cast<size_t>(nxs) + stack) * sizeof(int32_t);
  sw_stacked_kernel<<<nt * kLanes, nxs, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(sx), static_cast<const int8_t*>(sy),
      static_cast<const int32_t*>(ndt), static_cast<int32_t*>(out), stack, h,
      nds, match, mismatch, gap_open, gap_extend);
  return static_cast<int>(cudaGetLastError());
}
