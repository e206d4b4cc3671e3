// Conveyor-packed Smith-Waterman (Gotoh, score only) for short pairs, for
// Hopper (sm_90a).
//
// Replaces: genomax/kernels/sw_conveyor.py `_kernel` (wrapper
// `sw_forward_pallas_conveyor`). Same inputs and output: sched (NT, SR,
// 128) int8, row d the x code that the switching row r* = (d-1) mod T
// adopts at step d (pads 1); sy (NT, NB, 128) int8, the stream, row a0 - m
// the y code of coordinate m (pads 0); out (NT, P8, 128) int32, row q of a
// tile's block the score of queue slot q, rows P..P8-1 written as 0 (the
// JAX kernel leaves them unwritten). The host pack is
// kernels/sw_conveyor.pack_sw_conveyor.
//
// Each lane of a tile is a queue of P pairs chained through one window of
// nxs rows with period T >= nxs: pair q's cell (row r, column j) is
// computed at step d = qT + r + j, and row r* = (d-1) mod T (none when
// r* >= nxs) switches to the next pair at step d. The function is the TPU
// kernel's, step for step, on the same (nxs)-row frame:
//   P' = max(D1, P1 + ge)        (P' = P - open - extend; 0 at the switch)
//   Q' = max(D1s, Q1s + gev)     (row r-1's D and Q' of the step before)
//   D  = max(max(P', Q') + ogev, max(D2 + sub, 0))   (D2 = 0 at the switch)
//   mx = max(mx, D)              (0 at the switch, after `done` takes it)
// with the -KILL pins of the TPU kernel: sub and ogev at row nxs-1 (its D
// is always 0), gev at row 0. Row 0 reads row nxs-1 as the circular roll
// does; the pins make that wrap inert. At each period boundary d = qT with
// 2 <= q < P + 2, before that step's collect, the rows' `done` hold pair
// q-2's row maxima (every row switched out of it during (q-1)T .. qT-1, row
// T-1 being the pinned row or absent): their block max is slot q-2's
// score, and `done` restarts at 0. The steps run to (P+1)T + 8, the end of
// the TPU kernel's last block of UNROLL = 8 steps. The TPU's unroll
// blocks, its pltpu.roll and its VMEM scratch are its layout, with no part
// here. The cell is the TPU kernel's (P' and Q' stored without open +
// extend, the pins in the constants), not sw_cell.cuh's, so that the
// kernel and the plain version match operation for operation.
//
// Design: one block per queue (tile t, lane l), one thread per window row
// (nxs <= 1024 threads). Thread r keeps its row's P', D, the D it read a
// step ago (the diagonal), mx, done and x code in registers; row r-1's D
// and Q' of the step before come through a ping-pong pair of shared rows,
// one __syncthreads a step. The lane's sched column and stream column sit
// in device memory at a stride of 128 bytes: every kChunk steps the block
// stages the sched rows and the stream window rows those steps read into
// shared memory, so the step loop reads no device memory. The harvest is
// one __reduce_max_sync a warp, a shared word a warp, and thread 0's max
// of those after the step's barrier.
//
// Bound on this card: the per-step chain (shared load, a dozen dependent
// integer operations, shared store, block barrier), as in sw_tile.cu. A
// queue runs its (P+1)T + 8 steps one after another, and on an H100 at
// 700 W 25,000 pairs of 64bp take the same 0.61 ms at 4, 16 and 64 slots
// (PERF.md): few long queues wait on the chain's latency, many short ones
// on the SM's rate of the same work. Several queues a block, several rows
// a thread, warp shuffles in place of the shared rows and DPX max-plus
// intrinsics (__viaddmax_s32) are the levers for later.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;         // queues per tile
constexpr int kMaxRows = 1024;      // threads in a block: nxs <= 1024
constexpr int kUnroll = 8;          // the TPU kernel's block of steps
constexpr int kChunk = 256;         // steps staged at once
constexpr int kKill = 1 << 28;      // the boundary pin (wavefront.KILL)
constexpr int kPadX = 1;            // x pad code (layout.PAD_X)
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kMaxRows)
sw_conveyor_kernel(const int8_t* __restrict__ sched,
                   const int8_t* __restrict__ sy, int32_t* __restrict__ out,
                   int sr, int nb, int P, int T, int a0, int p8, int match,
                   int mismatch, int gap_open, int gap_extend) {
  extern __shared__ int32_t smem[];
  const int nxs = blockDim.x;
  int32_t* const dsh = smem;                // [2][nxs]: D of each row
  int32_t* const qsh = smem + 2 * nxs;      // [2][nxs]: Q' of each row
  int32_t* const wmax = smem + 4 * nxs;     // [32]: each warp's harvest
  int8_t* const ysh = reinterpret_cast<int8_t*>(wmax + 32);  // [kChunk+nxs]
  int8_t* const ssh = ysh + kChunk + nxs;                     // [kChunk]

  const int t = blockIdx.x / kLanes;
  const int l = blockIdx.x % kLanes;
  const int r = threadIdx.x;
  int32_t* const o = out + static_cast<size_t>(t) * p8 * kLanes + l;
  const int steps = (P + 1) * T + kUnroll;

  // Rows past P are 0, as the plain version's.
  if (r < p8 - P) o[static_cast<size_t>(P + r) * kLanes] = 0;
  // A launch that breaks the contract (a period below the window or not a
  // multiple of the block, buffers too short for the sweep) scores -1 in
  // every slot of its queues and reads nothing; the wrapper checks it on
  // the host.
  if (P < 1 || p8 < P || T < nxs || T % kUnroll || a0 < steps - 1 ||
      a0 + nxs > nb || sr < steps) {
    for (int q = r; q < min(P, p8); q += nxs)
      o[static_cast<size_t>(q) * kLanes] = -1;
    return;
  }
  const int8_t* const sc = sched + static_cast<size_t>(t) * sr * kLanes + l;
  const int8_t* const ys = sy + static_cast<size_t>(t) * nb * kLanes + l;

  const int ge = gap_extend;
  const bool last = r == nxs - 1;
  const int subm = last ? -kKill : match;
  const int subx = last ? -kKill : mismatch;
  const int gev = r == 0 ? -kKill : ge;
  const int ogev = last ? -kKill : gap_open + gap_extend;
  const int left = r == 0 ? nxs - 1 : r - 1;  // the roll's source row
  const int nwarps = (nxs + 31) / 32;
  const int wlanes = min(32, nxs - (r & ~31));  // threads of this warp
  const unsigned wmask = wlanes == 32 ? kFull : (1u << wlanes) - 1;

  int p1 = 0, d1 = 0, d2s = 0, mx = 0, done = 0, xc = kPadX;
  dsh[nxs + r] = 0;  // the state before step 0 (read from buffer 1)
  qsh[nxs + r] = 0;

  int dm = 0, q = 0;  // d mod T, d div T
  for (int c0 = 0; c0 < steps; c0 += kChunk) {
    const int kk = min(kChunk, steps - c0);
    // Steps c0 .. c0+kk-1 read sched rows [c0, c0+kk) and stream rows
    // [ybase, a0 - c0 + nxs).
    const int ybase = a0 - (c0 + kk - 1);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = r; i < kk + nxs - 1; i += nxs)
      ysh[i] = ys[static_cast<size_t>(ybase + i) * kLanes];
    for (int i = r; i < kk; i += nxs)
      ssh[i] = sc[static_cast<size_t>(c0 + i) * kLanes];
    __syncthreads();
    for (int k = 0; k < kk; ++k) {
      const int d = c0 + k;
      bool harvest = false;
      if (dm == 0) {  // a period boundary: harvest pair q-2, then restart
        if (q >= 2 && q - 2 < P) {
          const int v = __reduce_max_sync(wmask, done);
          if ((r & 31) == 0) wmax[r >> 5] = v;
          harvest = true;
        }
        done = 0;
      }
      const bool sw = r == (dm ? dm - 1 : T - 1);
      if (sw) {
        done = mx;
        xc = ssh[k];
      }
      const int yc = ysh[kk - 1 - k + r];  // stream row a0 - d + r
      const int rb = ((d + 1) & 1) * nxs;  // written at step d-1
      const int wb = (d & 1) * nxs;
      const int d1s = dsh[rb + left];
      const int q1s = qsh[rb + left];
      const int pn = sw ? 0 : max(d1, p1 + ge);
      const int qn = max(d1s, q1s + gev);
      const int sub = yc == xc ? subm : subx;
      const int dn = max(max(pn, qn) + ogev, max((sw ? 0 : d2s) + sub, 0));
      mx = max(sw ? 0 : mx, dn);
      dsh[wb + r] = dn;
      qsh[wb + r] = qn;
      p1 = pn;
      d1 = dn;
      d2s = d1s;
      __syncthreads();
      if (harvest && r == 0) {
        int v = 0;
        for (int w = 0; w < nwarps; ++w) v = max(v, wmax[w]);
        o[static_cast<size_t>(q - 2) * kLanes] = v;
      }
      if (++dm == T) {
        dm = 0;
        ++q;
      }
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue without launching when nxs is not a block the
// kernel takes (1 <= nxs <= 1024). The caller allocates `out` (nt * p8 *
// 128 int32, p8 = round_up(P, 8)) and checks the contract: sched (nt, sr,
// 128), sy (nt, nb, 128); nxs a multiple of 8; T a multiple of 8 and
// >= nxs; P >= 1; a0 >= (P+1)T + 7, a0 + nxs <= nb, sr >= (P+1)T + 8.
extern "C" int sw_conveyor_launch(const void* sched, const void* sy,
                                  void* out, int nt, int sr, int nb, int nxs,
                                  int P, int T, int a0, int p8, int match,
                                  int mismatch, int gap_open, int gap_extend,
                                  void* stream) {
  if (nxs < 1 || nxs > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt <= 0) return 0;
  const size_t smem = (4 * static_cast<size_t>(nxs) + 32) * sizeof(int32_t) +
                      2 * kChunk + nxs;
  sw_conveyor_kernel<<<nt * kLanes, nxs, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(sched), static_cast<const int8_t*>(sy),
      static_cast<int32_t*>(out), sr, nb, P, T, a0, p8, match, mismatch,
      gap_open, gap_extend);
  return static_cast<int>(cudaGetLastError());
}
