// Column-stationary ("rotor") Smith-Waterman (Gotoh, score only) over
// queues of short pairs, for Hopper (sm_90a).
//
// Replaces: genomax/kernels/sw_rotor.py `_kernel` (wrappers
// `sw_forward_pallas_rotor` and `sw_forward_pallas_rotor_bucket`). Same
// inputs and output: xrev (NT, NB, 128) int8, xrev[A - (qT + r)] = x_q[r-1]
// (pads 1, also at r = 0); ybuf (NT, NY, 128) int8, ybuf[qT + p] = y_q[p]
// (pads 0); out (NT, out_rows, 128) int32, row q of a tile the score of
// queue slot q (q < P), the largest D of that pair's matrix. Each lane of
// a tile is one queue of P pairs with period T; the pads mismatch
// everything, so the kernel needs no lengths: a pair's cells outside its
// matrix never exceed its real maximum and never feed a real cell.
//
// Design: one warp per queue (tile t, lane l), no block barrier. Matrix
// column c (1 <= c <= T-1) lives in lane (c-1) / C, register (c-1) % C,
// C = ceil((T-1) / 32) <= 5 (a template argument: periods up to 160).
// Pair q's cell (r, c) is computed at step d = qT + r + c, so at every
// step each column computes one cell, of one pair or another: column c's
// row r = (d - c) mod T of pair q = (d - c) div T. Row r = 0 is the
// boundary slot between two pairs of the queue: there the column forces
// D = 0 and P = Q = -inf (the top boundary of pair q; no chain of pair
// q-1's pad rows crosses it), moves its running max of pair q-1 to `harv`,
// and takes its y code of pair q. A cell reads
//  - D and Q of (r-1, c): its own registers from the step before;
//  - D and P of (r, c-1): the left column's from the step before, a
//    register of this lane, or lane k-1's last column by __shfl_up_sync;
//  - D of (r-1, c-1): the left D it read one step earlier;
//  - the x code of row r: the left column's x code from the step before
//    (x codes move right one column a step, as y codes move down the rows
//    in sw_long.cu); column 1 takes xrev[A - (d-1)], column 0 being the
//    left boundary (D = 0, P = -inf).
// The only column that wraps at step d is c = d mod T, and its y code is
// ybuf[qT + c - 1] = ybuf[d - 1]: x and y each arrive as one stream indexed
// by d - 1, loaded 32 steps at a time (one byte a lane, the next chunk in
// flight while this one is used) and handed out by __shfl_sync. Pair q is
// complete in every column after step (q+1)T + T - 2; at the step after
// it, (q+2)T - 1, column T-1 has just wrapped and every column's `harv`
// holds its max of pair q: one warp max and lane 0 writes slot q.
// The lanes' columns past T-1 sweep too (a warp holds 32C columns), with
// y code 0 (they would read the next pair's codes) and outside the
// harvest (their rows run a period out of step with the live columns').
// The TPU kernel's sublane roll, its -KILL pins of row T-1 and its unroll
// blocks are its layout: none has a part here; `unroll` only sizes NB and
// NY, and the wrapper checks that it divides T.
//
// Bound on this card: a warp issues some 20 integer operations per column
// and four shuffles a step, on a chain of shuffle and cell latency; it
// reads two bytes of device memory a step. A tile of 128 queues gives 128
// warps, so small buckets fill the card only with small queues
// (EngineConfig.rotor_max_slots). Several queues a warp and DPX max-plus
// intrinsics are the levers for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sw_cell.cuh"

namespace {

constexpr int kLanes = 128;        // queues per rotor tile
constexpr int kNeg = kSwNeg;       // -inf of P and Q (sw_cell.cuh)
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;  // four independent queues a block
constexpr int kMaxCols = 5;        // columns a lane holds: T <= 160
constexpr unsigned kFull = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
sw_rotor_kernel(const int8_t* __restrict__ xrev,
                const int8_t* __restrict__ ybuf, int32_t* __restrict__ out,
                int nt, int nb, int ny, int T, int P, int A, int out_rows,
                int match, int mismatch, int gap_open, int gap_extend) {
  const int lane = threadIdx.x % kWarp;
  const int queue = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (queue >= nt * kLanes) return;
  const int t = queue / kLanes;
  const int l = queue % kLanes;
  int32_t* const o = out + static_cast<size_t>(t) * out_rows * kLanes + l;
  const int steps = (P + 1) * T;  // the sweep runs steps 1 .. steps - 1

  // A launch that breaks the contract (a period the warp cannot hold,
  // buffers too short for the sweep) scores -1 in every slot of its
  // queues and reads nothing; the wrapper checks it on the host.
  if (T < 2 || T - 1 > kWarp * C || P < 1 || P > out_rows || A < steps ||
      A >= nb || ny < steps) {
    if (lane == 0)
      for (int q = 0; q < min(P, out_rows); ++q) o[q * kLanes] = -1;
    return;
  }
  const int8_t* const xs = xrev + static_cast<size_t>(t) * nb * kLanes + l;
  const int8_t* const ys = ybuf + static_cast<size_t>(t) * ny * kLanes + l;
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};

  const int c0 = lane * C + 1;  // this lane's first column
  int D[C], Pg[C], Q[C], X[C], Y[C], up2[C], mx[C], harv[C];
  bool live[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    D[j] = 0;
    Pg[j] = kNeg;
    Q[j] = kNeg;
    X[j] = 1;  // PAD_X: the cells before pair 0 stay 0
    Y[j] = 0;
    up2[j] = 0;
    mx[j] = 0;
    harv[j] = 0;
    live[j] = c0 + j <= T - 1;
  }
  int r0 = ((1 - c0) % T + T) % T;  // (d - c0) mod T: column j wraps iff r0 == j
  int dm = 1 % T;                   // d mod T
  int slot = 0;                     // the next slot to harvest

  // Entry i = d - 1 of both streams, the x code in the low byte, the y
  // code in the next; lane k of a chunk holds entry base + k.
  auto load = [&](int base) {
    const int i = base + lane;
    const int xc = i <= A ? static_cast<uint8_t>(
                                 xs[static_cast<size_t>(A - i) * kLanes])
                          : 1;
    const int yc =
        i < ny ? static_cast<uint8_t>(ys[static_cast<size_t>(i) * kLanes]) : 0;
    return xc | (yc << 8);
  };

  int next = load(0);
  for (int base = 0; base < steps - 1; base += kWarp) {
    const int cur = next;
    if (base + kWarp < steps - 1) next = load(base + kWarp);
    const int n = min(kWarp, steps - 1 - base);
    for (int k = 0; k < n; ++k) {
      const int d = base + k + 1;
      const int w = __shfl_sync(kFull, cur, k);
      const int xw = w & 0xff, yw = w >> 8;
      int dL = __shfl_up_sync(kFull, D[C - 1], 1);
      int pL = __shfl_up_sync(kFull, Pg[C - 1], 1);
      int xL = __shfl_up_sync(kFull, X[C - 1], 1);
      if (lane == 0) {  // column 0: the left boundary and the x stream
        dL = 0;
        pL = kNeg;
        xL = xw;
      }
      // Right to left, so that column j-1 still holds the step before.
#pragma unroll
      for (int j = C - 1; j >= 0; --j) {
        const int dl = j ? D[j - 1] : dL;
        const int pl = j ? Pg[j - 1] : pL;
        const int xl = j ? X[j - 1] : xL;
        const int diag = up2[j];
        up2[j] = dl;
        X[j] = xl;
        const bool wrap = r0 == j;
        if (wrap && live[j]) Y[j] = yw;
        int pn, qn, unused = 0;
        int dn = sw_cell(dl, pl, D[j], Q[j], diag, xl == Y[j], sc, pn, qn,
                         unused);
        if (wrap) {
          harv[j] = mx[j];
          mx[j] = 0;
          dn = 0;
          pn = kNeg;
          qn = kNeg;
        }
        mx[j] = max(mx[j], dn);
        D[j] = dn;
        Pg[j] = pn;
        Q[j] = qn;
      }
      if (++r0 == T) r0 = 0;
      // Step (slot + 2)T - 1: column T-1 has just wrapped, and every live
      // column's harv holds its max of pair `slot`.
      if (dm == T - 1 && d >= 2 * T - 1) {
        int v = 0;
#pragma unroll
        for (int j = 0; j < C; ++j)
          if (live[j]) v = max(v, harv[j]);
#pragma unroll
        for (int off = kWarp / 2; off > 0; off /= 2)
          v = max(v, __shfl_xor_sync(kFull, v, off));
        if (lane == 0) o[static_cast<size_t>(slot) * kLanes] = v;
        ++slot;
      }
      if (++dm == T) dm = 0;
    }
  }
}

template <int C>
int launch_cols(const void* xrev, const void* ybuf, void* out, int nt, int nb,
                int ny, int T, int P, int A, int out_rows, int match,
                int mismatch, int gap_open, int gap_extend,
                cudaStream_t stream) {
  const int blocks = (nt * kLanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sw_rotor_kernel<C><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
      static_cast<const int8_t*>(xrev), static_cast<const int8_t*>(ybuf),
      static_cast<int32_t*>(out), nt, nb, ny, T, P, A, out_rows, match,
      mismatch, gap_open, gap_extend);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns the first CUDA error (0 on
// success). The caller allocates `out` (nt * out_rows * 128 int32, rows P..
// zeroed if it wants them zero) and checks the contract: xrev (nt, nb, 128),
// ybuf (nt, ny, 128); 8 <= T <= 160; 1 <= P <= out_rows; (P+1)T <= A < nb;
// (P+1)T <= ny. A period past 160 launches the widest kernel, whose queues
// then score -1.
extern "C" int sw_rotor_launch(const void* xrev, const void* ybuf, void* out,
                               int nt, int nb, int ny, int T, int P, int A,
                               int out_rows, int match, int mismatch,
                               int gap_open, int gap_extend, void* stream) {
  if (nt <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols = (T - 1 + kWarp - 1) / kWarp;
  switch (cols < 1 ? 1 : cols) {
    case 1:
      return launch_cols<1>(xrev, ybuf, out, nt, nb, ny, T, P, A, out_rows,
                            match, mismatch, gap_open, gap_extend, s);
    case 2:
      return launch_cols<2>(xrev, ybuf, out, nt, nb, ny, T, P, A, out_rows,
                            match, mismatch, gap_open, gap_extend, s);
    case 3:
      return launch_cols<3>(xrev, ybuf, out, nt, nb, ny, T, P, A, out_rows,
                            match, mismatch, gap_open, gap_extend, s);
    case 4:
      return launch_cols<4>(xrev, ybuf, out, nt, nb, ny, T, P, A, out_rows,
                            match, mismatch, gap_open, gap_extend, s);
    default:
      return launch_cols<kMaxCols>(xrev, ybuf, out, nt, nb, ny, T, P, A,
                                   out_rows, match, mismatch, gap_open,
                                   gap_extend, s);
  }
}
