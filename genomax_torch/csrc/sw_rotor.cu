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
// everything (under a matrix, score at most 0: scoring.py), so the kernel needs no lengths: a pair's cells outside its
// matrix never exceed its real maximum and never feed a real cell.
//
// Design: G queues a warp (G = 1, 2, 4), each a segment of L = 32 / G
// lanes, and C columns a lane in registers (G and C template arguments,
// L*C >= T - 1; kernels/sw_rotor.geometry picks them). Queue (tile t, lane
// l) is segment (t*128 + l) % G of warp (t*128 + l) / G. Matrix column c
// (1 <= c <= T-1) lives in lane (c-1) / C of the segment, register
// (c-1) % C. Pair q's cell (r, c) is computed at step d = qT + r + c, so
// at every step each column computes one cell, of one pair or another:
// column c's row r = (d - c) mod T of pair q = (d - c) div T. Row r = 0 is
// the boundary slot between two pairs of the queue: there the column
// forces D = 0 and Q = -inf (the top boundary of pair q; no chain of pair
// q-1's pad rows crosses it) and takes its y code of pair q; its P feeds
// only the next column's row 0, which is forced in turn. A cell reads
//  - D and Q of (r-1, c): its own registers from the step before;
//  - D and P of (r, c-1): the left column's from the step before, a
//    register of this lane, or lane k-1's last column by __shfl_up_sync
//    within the segment;
//  - D of (r-1, c-1): the left D it read one step earlier;
//  - the x code of row r: the left column's x code from the step before
//    (x codes move right one column a step); column 1 takes xrev[A -
//    (d-1)], column 0 being the left boundary (D = 0, P = -inf).
// The cell is sw_cell.cuh's `sw_cell_dpx`, every column of a step
// unmasked. The only column that wraps at step d is c = d mod T, whose y
// code is ybuf[qT + c - 1] = ybuf[d - 1]: x and y each arrive as one
// stream indexed by d - 1, loaded L steps at a time (one byte a lane, the
// next chunk in flight while this one is used) and handed out by
// __shfl_sync within the segment. So the wrap leaves the common step: the
// sweep runs a loop by period, in it a loop by lane k of the segment, in
// that the C steps whose wrapping column lies in lane k unrolled, so that
// the wrapping register j is known at compile time; lane k forces it by
// predicate (a handful of moves, no branch and no divergence) and every
// other lane keeps its values.
// The running best takes two columns a __vimax3_s32: an accumulator a
// column pair, moved to `hv` and cleared at the wrap of the pair's last
// live column (the pair's other column then holds the next pair's row 1,
// which the step adds after the move). Pair q is complete in every column
// after step (q+1)T + T - 2; at the step after it, (q+2)T - 1, column T-1
// has just wrapped and every accumulator's `hv` holds its max of pair q:
// one max over the segment and its first lane writes slot q.
// The columns past T-1 (a segment holds L*C) sweep too, with scoring
// constants of their own (mismatch, gap open and extend -inf), so they
// stay D = 0 and never wrap: they feed no live column and add nothing to
// the harvest (their rows would run a period out of step with the live
// columns').
// The TPU kernel's sublane roll, its -KILL pins of row T-1 and its unroll
// blocks are its layout: none has a part here; `unroll` only sizes NB and
// NY, and the wrapper checks that it divides T.
//
// Bound on this card: operations. A step of a warp is C DPX cells a lane
// (about 10 integer instructions each with the x and diagonal moves) and
// a fixed part: the stream shuffle, three shuffles of the hand-over, the
// lane-0 boundary and the wrap's moves, shared by G queues. It reads two
// bytes of device memory a queue a step. A step of a lone warp waits on
// its shuffles and cells, so a bucket with too few queues to fill the
// card's schedulers runs fewer queues a warp (geometry).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sw_cell.cuh"

namespace {

constexpr int kLanes = 128;           // queues per rotor tile
constexpr int kNeg = kSwNeg;          // -inf of P and Q (sw_cell.cuh)
constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 4;  // independent warps a block
constexpr int kMaxCols = 10;          // columns a lane the build makes
constexpr unsigned kFull = 0xffffffffu;

// One step d of a segment: every column's cell, then the wrap of register
// J in the lane that holds the wrapping column (`mine`; J < 0 where no
// live column wraps, d mod T == 0), taken by predicate, no branch; then
// the running best. The x and y codes of entry d - 1 come in `w`.
// kMat: the matrix instantiation: X holds x codes times kSubStride
// (sw_x_code), a cell scores tab[X + Y] (sw_cell_dpx_sub), and a dead
// column's Y is kSubDead, -inf against any x.
template <int C, int J, bool kMat>
__device__ __forceinline__ void rotor_step(
    int (&D)[C], int (&Pg)[C], int (&Q)[C], int (&X)[C], int (&Y)[C],
    int (&U2)[C], int (&mx)[(C + 1) / 2], int (&hv)[(C + 1) / 2],
    const SwScoring (&cs)[C], int w, int sl, int L, bool mine, int n_live,
    const int* tab) {
  int dL = __shfl_up_sync(kFull, D[C - 1], 1, L);
  int pL = __shfl_up_sync(kFull, Pg[C - 1], 1, L);
  int xL = __shfl_up_sync(kFull, X[C - 1], 1, L);
  if (sl == 0) {  // column 0: the left boundary and the x stream
    dL = 0;
    pL = kNeg;
    xL = sw_x_code<kMat>(w & 0xff);
  }
  // Right to left, so that column j-1 still holds the step before.
#pragma unroll
  for (int j = C - 1; j >= 0; --j) {
    const int dl = j ? D[j - 1] : dL;
    const int pl = j ? Pg[j - 1] : pL;
    const int xl = j ? X[j - 1] : xL;
    int pn, qn;
    int dn;
    if constexpr (kMat) {
      dn = sw_cell_dpx_sub(dl, pl, D[j], Q[j], U2[j], tab[xl + Y[j]], cs[j],
                           pn, qn);
    } else {
      dn = sw_cell_dpx(dl, pl, D[j], Q[j], U2[j], xl == Y[j], cs[j], pn, qn);
    }
    U2[j] = dl;
    X[j] = xl;
    D[j] = dn;
    Pg[j] = pn;
    Q[j] = qn;
  }
  if constexpr (J >= 0) {
    if (mine) {  // row 0 of the next pair, its y code
      D[J] = 0;
      Q[J] = kNeg;
      Y[J] = w >> 8;
      // the move of column pair J/2's accumulator at its last live column
      if (J % 2 == 1 || J == C - 1 || J == n_live - 1) {
        hv[J / 2] = mx[J / 2];
        mx[J / 2] = 0;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < C / 2; ++g)
    mx[g] = __vimax3_s32(mx[g], D[2 * g], D[2 * g + 1]);
  if (C % 2) mx[(C + 1) / 2 - 1] = max(mx[(C + 1) / 2 - 1], D[C - 1]);
}

template <int G, int C, bool kMat>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock)
sw_rotor_kernel(const int8_t* __restrict__ xrev,
                const int8_t* __restrict__ ybuf, int32_t* __restrict__ out,
                int nt, int nb, int ny, int T, int P, int A, int out_rows,
                SwScoring sc, const int32_t* __restrict__ table) {
  constexpr int L = kWarp / G;  // lanes a queue
  constexpr int NG = (C + 1) / 2;  // column pairs a lane
  static_assert(C >= 1 && C <= kMaxCols, "C columns a lane");
  const int lane = threadIdx.x % kWarp;
  const int sl = lane % L;  // the lane's place in its queue's segment
  const int warp = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int* tab = nullptr;
  if constexpr (kMat) {
    __shared__ int32_t tab_s[kSubEntries];
    sw_load_table(tab_s, table);
    __syncthreads();
    tab = tab_s;
  }
  if (warp * G >= nt * kLanes) return;  // the whole warp: 128 % G == 0
  const int queue = warp * G + lane / L;
  const int t = queue / kLanes;
  const int l = queue % kLanes;
  int32_t* const o = out + static_cast<size_t>(t) * out_rows * kLanes + l;
  const int steps = (P + 1) * T;  // the sweep runs steps 1 .. steps - 1

  // A launch that breaks the contract (a period the segment cannot hold,
  // buffers too short for the sweep) scores -1 in every slot of its
  // queues and reads nothing; the wrapper checks it on the host.
  if (T < 2 || T - 1 > L * C || P < 1 || P > out_rows || A < steps ||
      A >= nb || ny < steps) {
    if (sl == 0)
      for (int q = 0; q < min(P, out_rows); ++q) o[q * kLanes] = -1;
    return;
  }
  const int8_t* const xs = xrev + static_cast<size_t>(t) * nb * kLanes + l;
  const int8_t* const ys = ybuf + static_cast<size_t>(t) * ny * kLanes + l;

  const int c0 = sl * C + 1;  // this lane's first column
  const int n_live = min(max(T - c0, 0), C);  // its columns <= T - 1
  const SwScoring dead{sc.match, kNeg, kNeg, kNeg};
  int D[C], Pg[C], Q[C], X[C], Y[C], U2[C], mx[NG], hv[NG];
  SwScoring cs[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    D[j] = 0;
    Pg[j] = kNeg;
    Q[j] = kNeg;
    X[j] = sw_x_code<kMat>(1);  // PAD_X: the cells before pair 0 stay 0
    Y[j] = kMat && j >= n_live ? kSubDead : 0;
    U2[j] = 0;
    cs[j] = j < n_live ? sc : dead;
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    mx[g] = 0;
    hv[g] = 0;
  }

  // Entry i = d - 1 of both streams, the x code in the low byte, the y
  // code in the next; lane k of a segment's chunk holds entry base + k.
  auto load = [&](int base) {
    const int i = base + sl;
    const int xc = i <= A ? static_cast<uint8_t>(
                                 xs[static_cast<size_t>(A - i) * kLanes])
                          : 1;
    const int yc =
        i < ny ? static_cast<uint8_t>(ys[static_cast<size_t>(i) * kLanes]) : 0;
    return xc | (yc << 8);
  };
  int cur = load(0), next = load(L);
  // The word of entry d - 1; after the chunk's last entry the next chunk
  // comes in and the one after it is loaded (the same step for the warp,
  // entries base .. base + L - 1 a chunk).
  auto word = [&](int d) {
    const int k = (d - 1) & (L - 1);
    const int w = __shfl_sync(kFull, cur, k, L);
    if (k == L - 1) {
      cur = next;
      next = load(d + L);
    }
    return w;
  };
  // Step d = mT + e: e = 0 wraps no live column; e = 1 + kC + j wraps
  // register j of lane k. The harvest of slot m - 1 follows e = T - 1.
  for (int m = 0; m <= P; ++m) {
    const int d0 = m * T;
    if (m > 0)
      rotor_step<C, -1, kMat>(D, Pg, Q, X, Y, U2, mx, hv, cs, word(d0), sl,
                              L, false, n_live, tab);
    for (int k = 0; k * C < T - 1; ++k) {
      const bool mine = sl == k;
      const int e0 = 1 + k * C;
#define GENOMAX_ROTOR_STEP(j)                                             \
  if (j < C && e0 + j < T)                                                \
    rotor_step<C, (j < C ? j : -1), kMat>(D, Pg, Q, X, Y, U2, mx, hv, cs, \
                                          word(d0 + e0 + j), sl, L, mine, \
                                          n_live, tab);
      GENOMAX_ROTOR_STEP(0)
      GENOMAX_ROTOR_STEP(1)
      GENOMAX_ROTOR_STEP(2)
      GENOMAX_ROTOR_STEP(3)
      GENOMAX_ROTOR_STEP(4)
      GENOMAX_ROTOR_STEP(5)
      GENOMAX_ROTOR_STEP(6)
      GENOMAX_ROTOR_STEP(7)
      GENOMAX_ROTOR_STEP(8)
      GENOMAX_ROTOR_STEP(9)
#undef GENOMAX_ROTOR_STEP
    }
    // Step (m + 1)T - 1: column T-1 has just wrapped, and every
    // accumulator's hv holds its max of pair m - 1.
    if (m > 0) {
      int v = hv[0];
#pragma unroll
      for (int g = 1; g < NG; ++g) v = max(v, hv[g]);
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2)
        v = max(v, __shfl_xor_sync(kFull, v, off, L));
      if (sl == 0) o[static_cast<size_t>(m - 1) * kLanes] = v;
    }
  }
}

template <int G, int C>
int launch_geo(const void* xrev, const void* ybuf, void* out, int nt, int nb,
               int ny, int T, int P, int A, int out_rows, int wpb,
               SwScoring sc, const void* table, cudaStream_t stream) {
  const int warps = nt * kLanes / G;
  const int blocks = (warps + wpb - 1) / wpb;
  const int8_t* x = static_cast<const int8_t*>(xrev);
  const int8_t* y = static_cast<const int8_t*>(ybuf);
  int32_t* o = static_cast<int32_t*>(out);
  if (table) {
    sw_rotor_kernel<G, C, true><<<blocks, kWarp * wpb, 0, stream>>>(
        x, y, o, nt, nb, ny, T, P, A, out_rows, sc,
        static_cast<const int32_t*>(table));
  } else {
    sw_rotor_kernel<G, C, false><<<blocks, kWarp * wpb, 0, stream>>>(
        x, y, o, nt, nb, ny, T, P, A, out_rows, sc, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns the first CUDA error (0 on
// success), or cudaErrorInvalidValue without launching for a geometry the
// build does not make: G = `queues_per_warp` in 1, 2, 4 with C = `cols`
// in 1 .. 5 (G = 1) or 1 .. 10 (G = 2, 4), and 1 .. 4 warps a block. The
// caller allocates `out` (nt * out_rows * 128 int32, rows P.. zeroed if
// it wants them zero) and checks the contract: xrev (nt, nb, 128), ybuf
// (nt, ny, 128); 8 <= T <= 160 and T - 1 <= (32 / G) * C; 1 <= P <=
// out_rows; (P+1)T <= A < nb; (P+1)T <= ny. A launch past the contract
// scores -1 in each slot of its queues. `table` null scores by match and
// mismatch; else it is the code table on the device (kSubEntries int32)
// and match and mismatch are not read.
extern "C" int sw_rotor_launch(const void* xrev, const void* ybuf, void* out,
                               int nt, int nb, int ny, int T, int P, int A,
                               int out_rows, int queues_per_warp, int cols,
                               int warps_per_block, int match, int mismatch,
                               int gap_open, int gap_extend,
                               const void* table, void* stream) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarpsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt <= 0) return 0;
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GENOMAX_ROTOR_CASE(g, c)                                           \
  if (queues_per_warp == g && cols == c)                                   \
    return launch_geo<g, c>(xrev, ybuf, out, nt, nb, ny, T, P, A, out_rows, \
                            warps_per_block, sc, table, s);
  GENOMAX_ROTOR_CASE(1, 1)
  GENOMAX_ROTOR_CASE(1, 2)
  GENOMAX_ROTOR_CASE(1, 3)
  GENOMAX_ROTOR_CASE(1, 4)
  GENOMAX_ROTOR_CASE(1, 5)
  GENOMAX_ROTOR_CASE(2, 1)
  GENOMAX_ROTOR_CASE(2, 2)
  GENOMAX_ROTOR_CASE(2, 3)
  GENOMAX_ROTOR_CASE(2, 4)
  GENOMAX_ROTOR_CASE(2, 5)
  GENOMAX_ROTOR_CASE(2, 6)
  GENOMAX_ROTOR_CASE(2, 7)
  GENOMAX_ROTOR_CASE(2, 8)
  GENOMAX_ROTOR_CASE(2, 9)
  GENOMAX_ROTOR_CASE(2, 10)
  GENOMAX_ROTOR_CASE(4, 1)
  GENOMAX_ROTOR_CASE(4, 2)
  GENOMAX_ROTOR_CASE(4, 3)
  GENOMAX_ROTOR_CASE(4, 4)
  GENOMAX_ROTOR_CASE(4, 5)
  GENOMAX_ROTOR_CASE(4, 6)
  GENOMAX_ROTOR_CASE(4, 7)
  GENOMAX_ROTOR_CASE(4, 8)
  GENOMAX_ROTOR_CASE(4, 9)
  GENOMAX_ROTOR_CASE(4, 10)
#undef GENOMAX_ROTOR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
