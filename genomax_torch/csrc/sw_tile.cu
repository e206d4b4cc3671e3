// Smith-Waterman (Gotoh, score only) over one packed bucket, for Hopper
// (sm_90a).
//
// Replaces: genomax/kernels/sw_pallas.py `_kernel` (wrapper
// `sw_forward_pallas`), the resident lane-tile wavefront. Same inputs and
// output: sx (NT, NXs, 128) int8 codes with row p holding x[p-1] (pads 1),
// sy (NT, NDs, 128) int8 reversed diagonal stream with y[k] at row
// A-1-k, A = NDs - NXs (pads 0), ndiag_tile (NT,) int32; out (NT, 128)
// int32, slot-major, the largest D of each pair's matrix.
//
// Design: one block per pair (slot t*128 + l), one thread per x row p,
// the anti-diagonal wavefront of the reference's alignGPU kernel. At
// diagonal d thread p scores cell (x = p, y = j = d - p). Its own row's
// D and P at d-1 stay in registers (P is the gap along y); the row above
// (p - 1) hands over its D and Q at d-1 (Q is the gap along x) through a
// ping-pong pair of shared-memory rows, and its D at d-2 (the diagonal
// neighbour) is the value this thread read one step earlier. One
// __syncthreads per diagonal orders the hand-over. Row 0 is the first-
// column boundary (D = 0, Q = -inf) and j <= 0 the first-row boundary
// (D = 0, P = -inf), written out explicitly: the TPU kernel's circular
// sublane roll and its -KILL pins have no counterpart here. Rows past a
// pair's length and columns past its y hold pad codes that mismatch
// everything, so those cells never exceed the pair's real maximum; the
// block needs no per-pair length and sweeps its tile's diagonal count.
//
// Bound on this card: the per-diagonal block barrier and the shared-
// memory round trip. A cell costs about a dozen integer operations and
// reads one stream byte (from L1: thread p reads at d+1 the byte thread
// p-1 read at d), far below the card's operation and byte rates. Larger
// pairs per block (more rows per thread), DPX max-plus intrinsics
// (__viaddmax_s32) and strip sweeps are the levers for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sw_cell.cuh"

namespace {

constexpr int kLanes = 128;        // pairs per packed tile
constexpr int kNeg = kSwNeg;       // -inf of P and Q (sw_cell.cuh)

__global__ void __launch_bounds__(1024)
sw_tile_kernel(const int8_t* __restrict__ sx, const int8_t* __restrict__ sy,
               const int32_t* __restrict__ ndiag_tile,
               int32_t* __restrict__ out, int nxs, int nds, int match,
               int mismatch, int gap_open, int gap_extend) {
  extern __shared__ int32_t smem[];
  int32_t* dsh = smem;             // [2][nxs]: D of each row at d-1 / d
  int32_t* qsh = smem + 2 * nxs;   // [2][nxs]: Q of each row at d-1 / d
  __shared__ int32_t block_best;

  const int slot = blockIdx.x;
  const int t = slot / kLanes;
  const int l = slot % kLanes;
  const int p = threadIdx.x;
  const int nd = ndiag_tile[t];
  const int anchor = nds - nxs;
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};
  const int8_t xc = sx[(static_cast<size_t>(t) * nxs + p) * kLanes + l];
  const int8_t* ys = sy + static_cast<size_t>(t) * nds * kLanes + l;

  int d1 = 0;      // D of (p, j-1)
  int p1 = kNeg;   // P of (p, j-1)
  int up2 = 0;     // D of (p-1, j-1), the diagonal neighbour
  int best = 0;
  dsh[nxs + p] = 0;   // diagonal 1: every cell is boundary
  qsh[nxs + p] = kNeg;
  if (p == 0) block_best = 0;
  __syncthreads();

  for (int d = 2; d < nd; ++d) {
    const int rb = ((d - 1) & 1) * nxs;
    const int up_d = p > 0 ? dsh[rb + p - 1] : 0;     // D of (p-1, j)
    const int up_q = p > 0 ? qsh[rb + p - 1] : kNeg;  // Q of (p-1, j)
    const int j = d - p;
    int dn = 0, pn = kNeg, qn = kNeg;
    if (p > 0 && j > 0) {
      const int8_t yc = __ldg(ys + static_cast<size_t>(anchor - j) * kLanes);
      dn = sw_cell(d1, p1, up_d, up_q, up2, xc == yc, sc, pn, qn, best);
    }
    const int wb = (d & 1) * nxs;
    dsh[wb + p] = dn;
    qsh[wb + p] = qn;
    d1 = dn;
    p1 = pn;
    up2 = up_d;
    __syncthreads();
  }
  atomicMax(&block_best, best);
  __syncthreads();
  if (p == 0) out[slot] = block_best;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): a launch
// the device refuses (too many threads, too much shared memory) reports
// here and nowhere else. The caller allocates `out` and checks shapes:
// 2 <= nxs <= 1024, nds > nxs, and A = nds - nxs >= every ndiag_tile[t].
extern "C" int sw_tile_launch(const void* sx, const void* sy,
                              const void* ndiag_tile, void* out, int nt,
                              int nxs, int nds, int match, int mismatch,
                              int gap_open, int gap_extend, void* stream) {
  if (nt <= 0) return 0;
  const size_t smem = 4 * static_cast<size_t>(nxs) * sizeof(int32_t);
  sw_tile_kernel<<<nt * kLanes, nxs, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(sx), static_cast<const int8_t*>(sy),
      static_cast<const int32_t*>(ndiag_tile), static_cast<int32_t*>(out),
      nxs, nds, match, mismatch, gap_open, gap_extend);
  return static_cast<int>(cudaGetLastError());
}
