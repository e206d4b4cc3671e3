// Long-pair Smith-Waterman (Gotoh, score only) over one tile of up to 128
// pairs with x of any length, for Hopper (sm_90a).
//
// Replaces: genomax/kernels/sw_long.py `_kernel` (wrapper
// `sw_forward_pallas_long`), the strip-mined long-pair wavefront. Same
// inputs and output: sx (K*W, 128) int8 codes, row p holding x[p-1]
// (pads 1); sy (NDt, 128) int8 reversed stream, y[j-1] at row anchor - j
// (pads 0), `anchor` the one of the pack's layout; out (128,) int32, the
// largest D of each pair's matrix. nx, ny (128,) int32 are the matrix
// dimensions len + 1 of each pair (1 on empty lanes), which the pack
// carries.
//
// Design: one block per pair, W = blockDim.x rows per strip, the K strips
// swept one after another inside the block. Within a strip it is the
// lane-tile kernel (sw_tile.cu): thread r owns global row p = k*W + r, keeps
// its own D and P of diagonal d-1 in registers, and takes D and Q of the
// row above from a ping-pong pair of shared-memory rows, one __syncthreads
// per diagonal; the row above's D of d-2 is what it read one step earlier.
// The y code travels the same way: cell (p, j) of diagonal d compares the
// code that cell (p-1, j) used at d-1, so only the strip's first row reads
// the stream, and no thread strides through global memory per step.
//
// The seam: thread W-1 writes its D and Q of diagonal d to the pair's halo
// in global memory, entry d, after the barrier of d. Row 0 of the next
// strip (global row (k+1)*W) needs entry d-1 at diagonal d, and keeps d-2.
// Warp 0 fetches halo entries and stream codes 32 diagonals at a time into
// a double-buffered shared chunk, one chunk ahead of their use. One halo
// serves every strip without a race: the strips run in order in one block,
// and the chunk holding entry e is read at least 32 diagonals (so at least
// one barrier) before this strip's thread W-1 overwrites entry e.
//
// Boundaries are written out, not left to pad decay: a cell is live iff
// 1 <= p <= len(x) and 1 <= j <= len(y); every other cell is D = 0,
// P = Q = kNeg. A live first-row cell reads only halo entries that the
// previous strip wrote from cells of the same column range, so the halo
// needs no initial value (torch.empty), and what a chunk fetches past the
// written range is never used. The TPU kernel's zero-initialised halo and
// its "zeros past the matrix only lower dead cells" argument have no part
// here.
//
// kNeg is safe at any length: P and Q are recomputed every step as
// max(D + open + extend, . + extend) with D >= 0, so they never drift
// below open + extend once live, and dead cells reset them to kNeg.
//
// Bound on this card: the per-diagonal block barrier and shared-memory
// round trip, and occupancy: a tile is 128 blocks on 132 SMs, each block
// one strip wide. A strip sweeps W + len(y) diagonals for W * len(y) live
// cells, so at W = 1024 and 50kbp about 98% of thread-steps are live.
// More rows per thread (registers instead of shared memory), DPX
// max-plus intrinsics and several strips in flight per pair are the
// levers for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sw_cell.cuh"

namespace {

constexpr int kLanes = 128;        // pairs per packed tile
constexpr int kChunk = 32;         // diagonals per seam prefetch (one warp)
constexpr int kNeg = kSwNeg;       // -inf of P and Q (sw_cell.cuh)

__global__ void __launch_bounds__(1024)
sw_long_kernel(const int8_t* __restrict__ sx, const int8_t* __restrict__ sy,
               const int32_t* __restrict__ nx, const int32_t* __restrict__ ny,
               int2* halo, int32_t* __restrict__ out, int k_strips,
               int anchor, int nh, int match, int mismatch, int gap_open,
               int gap_extend) {
  extern __shared__ int32_t smem[];
  const int w = blockDim.x;
  int32_t* dsh = smem;             // [2][w]: D of each row at d-1 / d
  int32_t* qsh = smem + 2 * w;     // [2][w]: Q of each row at d-1 / d
  int32_t* ysh = smem + 4 * w;     // [2][w]: y code each row used at d-1 / d
  __shared__ int2 hin[2][kChunk];      // halo entries of the row above row 0
  __shared__ int32_t yin[2][kChunk];   // stream codes of row 0
  __shared__ int32_t block_best;

  const int l = blockIdx.x;
  const int r = threadIdx.x;
  const int lx = nx[l] - 1;  // len(x)
  const int ly = ny[l] - 1;  // len(y)
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};
  const int8_t* ys = sy + l;
  int2* const hl = halo + static_cast<size_t>(l) * nh;

  int best = 0;
  if (r == 0) block_best = 0;

  // Strip k holds rows [k*w, k*w + w); it has a live row iff k*w <= lx.
  // The bounds are the same for every thread of the block.
  const bool any_live = lx > 0 && ly > 0;
  for (int k = 0; any_live && k < k_strips && k * w <= lx; ++k) {
    const int row0 = k * w;
    const int p = row0 + r;
    const int xc = sx[static_cast<size_t>(p) * kLanes + l];
    const bool row_live = p >= 1 && p <= lx;
    const int d_start = row0 + 1;                     // row0's cell j = 1
    const int d_end = min(row0 + w - 1, lx) + ly;     // last live diagonal

    // Seam chunk c covers diagonals d_start + 32c ... + 31: for each, the
    // halo entry d-1 (row0-1's D and Q at d-1) and row0's y code y[j-1],
    // j = d - row0. Fetched by warp 0, lane i the i-th diagonal.
    auto fetch = [&](int c) {
      const int e = c * kChunk + r;                   // d - d_start
      hin[c & 1][r] = k > 0 ? hl[row0 + e] : make_int2(0, kNeg);
      yin[c & 1][r] =
          ys[static_cast<size_t>(anchor - (1 + e)) * kLanes];
    };

    // Diagonal d_start - 1: every cell of the strip is first-column
    // boundary or above it.
    __syncthreads();  // the previous strip's last reads of dsh/qsh/ysh
    const int ib = ((d_start - 1) & 1) * w;
    dsh[ib + r] = 0;
    qsh[ib + r] = kNeg;
    ysh[ib + r] = 0;
    if (r < kChunk) fetch(0);
    int d1 = 0;      // D of (p, j-1)
    int p1 = kNeg;   // P of (p, j-1)
    int up2 = 0;     // D of (p-1, j-1), the diagonal neighbour
    __syncthreads();

    for (int d = d_start; d <= d_end; ++d) {
      const int e = d - d_start;
      const int c = e / kChunk, i = e % kChunk;
      if (i == 0 && r < kChunk) fetch(c + 1);  // one chunk ahead
      const int rb = ((d - 1) & 1) * w;
      int up_d, up_q, yc;
      if (r > 0) {
        up_d = dsh[rb + r - 1];   // D of (p-1, j) at d-1
        up_q = qsh[rb + r - 1];   // Q of (p-1, j) at d-1
        yc = ysh[rb + r - 1];     // y[j-1], as (p-1, j) used it at d-1
      } else {
        const int2 h = hin[c & 1][i];
        up_d = h.x;
        up_q = h.y;
        yc = yin[c & 1][i];
      }
      const int j = d - p;
      int dn = 0, pn = kNeg, qn = kNeg;
      if (row_live && j >= 1 && j <= ly) {
        dn = sw_cell(d1, p1, up_d, up_q, up2, xc == yc, sc, pn, qn, best);
      }
      const int wb = (d & 1) * w;
      dsh[wb + r] = dn;
      qsh[wb + r] = qn;
      ysh[wb + r] = yc;
      d1 = dn;
      p1 = pn;
      up2 = up_d;
      __syncthreads();
      if (r == w - 1) hl[d] = make_int2(dn, qn);
    }
  }
  __syncthreads();
  atomicMax(&block_best, best);
  __syncthreads();
  if (r == 0) out[l] = block_best;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(). The
// caller allocates `halo` (128 * nh int2, no initial value needed) and
// `out`, and checks shapes: sx (k_strips*w, 128), sy rows covering
// anchor + w with anchor >= w + max(ny) + 64, w a multiple of 32 in
// [32, 1024], nh >= k_strips*w + max(ny) + 64, 1 <= nx <= k_strips*w.
extern "C" int sw_long_launch(const void* sx, const void* sy, const void* nx,
                              const void* ny, void* halo, void* out,
                              int k_strips, int w, int anchor, int nh,
                              int match, int mismatch, int gap_open,
                              int gap_extend, void* stream) {
  const size_t smem = 6 * static_cast<size_t>(w) * sizeof(int32_t);
  sw_long_kernel<<<kLanes, w, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(sx), static_cast<const int8_t*>(sy),
      static_cast<const int32_t*>(nx), static_cast<const int32_t*>(ny),
      static_cast<int2*>(halo), static_cast<int32_t*>(out), k_strips, anchor,
      nh, match, mismatch, gap_open, gap_extend);
  return static_cast<int>(cudaGetLastError());
}
