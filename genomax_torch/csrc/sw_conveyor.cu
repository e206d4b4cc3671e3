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
// The function. Each lane of a tile is a queue of P pairs chained through
// one window of nxs rows with period T >= nxs: pair q's cell (row r,
// column j) is computed at step d = qT + r + j, and row r* = (d-1) mod T
// switches to the next pair at step d: it adopts sched[d] as its x code,
// its P' and diagonal D restart at the left boundary and its running best
// goes to the harvest. Row r's y code at step d is sy[a0 - d + r], the
// code row r-1 used a step earlier: the y codes travel down the rows and
// only row 0 reads the stream. At each period boundary d = qT with 2 <= q
// < P + 2, before that step's switch, every row has handed over its best
// of pair q-2: their max is slot q-2's score. The cell is the TPU
// kernel's, P' and Q' kept before the gap open (sw_cell.cuh's
// `sw_cell_dpx_preopen`):
//   P' = max(D1, P1 + ge), Q' = max(D1s, Q1s + ge)
//   D  = max(max(P', Q') + open + extend, D2 + sub, 0)
// with the TPU kernel's -KILL pins: sub and open + extend at row nxs-1
// (its D is always 0) and the gap extend of row 0's Q' (so that its
// circular roll carries zeros from row nxs-1 to row 0).
//
// Design: G queues a warp (G = 1, 2, 4), each a segment of L = 32 / G
// lanes, and R window rows a lane in registers (G and R template
// arguments, L * R >= nxs; R = 1-16 at G = 1, 1-10 at G = 2, 4;
// kernels/sw_conveyor.geometry picks them).
// Queue (tile t, lane l) is segment (t*128 + l) % G of warp
// (t*128 + l) / G; window row r lives in lane r / R of the segment,
// register r % R. A row keeps its D, P' and Q' of the step before, the D
// it read from the row above a step earlier (the diagonal), its y and x
// codes, and its scoring constants. A step computes the R cells of a
// lane bottom row first, each reading the row above from its own
// registers or, for register 0, lane k-1's last register by
// __shfl_up_sync within the segment, handed down as soon as lane k-1's
// last row of the step before was done (its shuffles in flight while
// the other rows compute); lane 0 of a segment takes what the pins give
// the TPU's row 0 (D = 0, Q' = -inf, and the stream's y code), so there
// is no roll. The rows past nxs-1 (a segment holds L*R) take the pinned
// constants of row nxs-1 (sub and open + extend -inf): they stay D = 0,
// feed nothing and add nothing. x and y arrive as one stream indexed by
// d (sched[d] in the low byte, sy[a0 - d] in the next), loaded L steps
// at a time (one entry a lane through a moving pointer, the next chunk
// in flight while this one is used) and handed out by __shfl_sync within
// the segment, a step ahead. No shared memory and no barrier.
// The switch: one row a step, so the sweep runs a loop by period, in it a
// loop by lane k of the segment, in that the R steps whose switching row
// lies in lane k unrolled (no test between them but for the lane that
// holds row T-2), so that the switching register J is known at compile
// time; lane k forces it by predicate (D and P' of the left boundary,
// the diagonal 0, the x code from the stream) and every other lane keeps
// its values. Step e = 0 of a period switches row T-1, which
// is pinned or absent, so it switches nothing; the steps of rows L*R ..
// T-2 (T - 1 > L*R) switch no register either. The running best takes
// two rows a __vimax3_s32, an accumulator a register pair (2g, 2g+1):
// at row 2g's switch its accumulator holds row 2g's old pair whole and
// row 2g+1's but for its last cell, which that same step computes; the
// lane moves both into `done`, one register a lane, and restarts the
// accumulator at row 2g's new cell. At row 2g+1's switch the step adds
// as usual. At a period boundary `done` of every lane holds its rows'
// best of the pair: one max over the segment, its first lane writes the
// slot, then `done` restarts. The TPU kernel's last block runs 8 steps
// past the last harvest; they change no output and are not run.
// Windows taller than a warp's 32 * 16 rows (nxs <= 1,024): a queue is a
// block of W = 3-4 warps at R = 8, warp w the rows 32Rw .. 32R(w+1)-1
// (sixteen rows a lane took 1.8 times as long on a 1,024-row window on
// one H100); lane 0 of warp w > 0 takes warp w-1's last row of the step
// before from a shared seam by step parity, one __syncthreads a step
// (sw_tile.cu's block form); the switch loops by lane of the block, the
// harvest adds a shared word a warp.
//
// Bound on this card: operations. A step of a warp is R DPX cells a lane
// (the preopen cell's seven integer instructions, half a three-way max,
// the y and diagonal moves) and a fixed part shared by its G queues: the
// stream shuffle, three shuffles of the hand-over, lane 0's boundary and
// the switch's moves. It reads two bytes of device memory a queue a
// step. Many queues keep every scheduler's integer pipe busy (the warp
// step's instructions bind); a bucket with few, deep queues runs a warp
// a scheduler or fewer, where the step's latency binds, so the geometry
// weighs both and spreads the warps over the SMs.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sw_cell.cuh"

namespace {

constexpr int kLanes = 128;    // queues per tile
constexpr int kWarp = 32;
constexpr int kUnroll = 8;     // the TPU kernel's block of steps
constexpr int kPadX = 1;       // x pad code (layout.PAD_X)
constexpr int kNeg = kSwNeg;   // -inf of P' and Q', and the pins (-KILL)
constexpr int kMaxWarps = 4;   // warps a block, in either form
constexpr int kMinBlockWarps = 3;  // the fewest that pass 512 rows at R = 8
constexpr int kMaxRows = 16;   // rows a lane the build makes
constexpr unsigned kFull = 0xffffffffu;

// The last row of warp w-1 at a step, for lane 0 of warp w (block form).
struct Seam {
  int d, q, y;
};

// One lane's rows of a queue and the stream cursor: the warp form (G
// queues a warp, a queue a segment of L lanes) or the block form (a queue
// a block of W warps).
template <int G, int R, bool kBlock>
struct Lane {
  static constexpr int kW = kBlock ? kWarp : kWarp / G;  // shuffle width
  static constexpr int kNG = (R + 1) / 2;                // row pairs

  int D[R], P[R], Q[R], X[R], Y[R], U2[R], acc[kNG], done;
  SwScoring cs[R];
  int cur, next;  // the stream chunk in use and the next one
  int wn;          // the word of the step's entry, fetched a step ahead
  int hD, hQ, hY;  // lane k-1's last row of the step before
  // This lane's entry of the chunk after `next`: its sched and sy bytes
  // and how many entries are left before each runs out of its buffer.
  const int8_t* xp;
  const int8_t* yp;
  int nx, ny;
  int sh;   // lane within its shuffle group (segment, or warp of a block)
  int wib;  // warp within the block (block form)
  int nw;   // warps a queue (block form)
  Seam (*seam)[2];
  int* hv;

  // This lane's entry i of the next chunk to load: sched[i] in the low
  // byte, sy[a0 - i] in the next (lane k of a group holds entry base + k
  // of a chunk); then the cursor moves a chunk on.
  __device__ __forceinline__ int load() {
    const int xc = nx > 0 ? static_cast<uint8_t>(*xp) : kPadX;
    const int yc = ny > 0 ? static_cast<uint8_t>(*yp) : 0;
    xp += kW * kLanes;
    yp -= kW * kLanes;
    nx -= kW;
    ny -= kW;
    return xc | (yc << 8);
  }

  // The word of entry d.
  __device__ __forceinline__ int word(int d) const {
    return __shfl_sync(kFull, cur, d & (kW - 1), kW);
  }

  // After the word of the chunk's last entry d, the next chunk comes in
  // and the one after it is loaded (the same step for the whole warp).
  __device__ __forceinline__ void advance(int d) {
    if ((d & (kW - 1)) == kW - 1) {
      cur = next;
      next = load();
    }
  }

  // Step d: every row's cell, register J of the lane `mine` switching to
  // the next pair (J < 0: no register switches), then the running best.
  template <int J>
  __device__ __forceinline__ void step(int d, bool mine) {
    const int w = wn;
    // The row above register 0 at step d-1: lane k-1's last register.
    int aD = hD, aQ = hQ, aY = hY;
    if (sh == 0) {
      if (kBlock && wib > 0) {
        const Seam z = seam[wib][(d + 1) & 1];
        aD = z.d;
        aQ = z.q;
        aY = z.y;
      } else {  // row 0: what the pins of row nxs-1 and of row 0 give
        aD = 0;
        aQ = kNeg;
        aY = w >> 8;
      }
    }
    // Bottom row first, so that row i-1 still holds step d-1.
#pragma unroll
    for (int i = R - 1; i >= 0; --i) {
      const int ud = i ? D[i - 1] : aD;
      const int uq = i ? Q[i - 1] : aQ;
      const int yc = i ? Y[i - 1] : aY;
      int dl = D[i], pl = P[i], dg = U2[i];
      if (i == J && mine) {  // the next pair's column 1: the left boundary
        dl = 0;
        pl = kNeg;
        dg = 0;
        X[i] = w & 0xff;
      }
      int pn, qn;
      const int dn =
          sw_cell_dpx_preopen(dl, pl, ud, uq, dg, X[i] == yc, cs[i], pn, qn);
      U2[i] = ud;
      Y[i] = yc;
      D[i] = dn;
      P[i] = pn;
      Q[i] = qn;
      if (i == R - 1) {
        // The last row is done: hand it down for step d+1 and fetch that
        // step's word while the other rows compute.
        hD = __shfl_up_sync(kFull, D[R - 1], 1, kW);
        hQ = __shfl_up_sync(kFull, Q[R - 1], 1, kW);
        hY = __shfl_up_sync(kFull, Y[R - 1], 1, kW);
        wn = word(d + 1);
      }
    }
#pragma unroll
    for (int g = 0; g < kNG; ++g) {
      const int lo = D[2 * g];
      const int hi = 2 * g + 1 < R ? D[min(2 * g + 1, R - 1)] : 0;
      const int added = __vimax3_s32(acc[g], lo, hi);
      if (2 * g == J) {
        // Row 2g switched: the old pair's rows 2g, 2g+1 (its last cell
        // just computed) go to `done`; the accumulator restarts at row
        // 2g's new cell.
        const int moved = __vimax3_s32(done, acc[g], hi);
        done = mine ? moved : done;
        acc[g] = mine ? lo : added;
      } else {
        acc[g] = added;
      }
    }
    advance(d + 1);
    if constexpr (kBlock) {
      if (sh == kWarp - 1 && wib + 1 < nw)
        seam[wib + 1][d & 1] = Seam{D[R - 1], Q[R - 1], Y[R - 1]};
      __syncthreads();
    }
  }

  // Steps d + J, d + J + 1, ... of registers J, J+1, ... of lane `mine`:
  // all R (kAll), or while fewer than `left`.
  template <int J, bool kAll>
  __device__ __forceinline__ void lane_steps(int d, int left, bool mine) {
    if constexpr (J < R) {
      if (kAll || J < left) {
        step<J>(d + J, mine);
        lane_steps<J + 1, kAll>(d, left, mine);
      }
    }
  }

  // Slot `slot` of the queue: the max of `done` over its lanes.
  __device__ __forceinline__ void harvest(int32_t* o, int slot, int sl) {
    int v = done;
#pragma unroll
    for (int off = kW / 2; off > 0; off /= 2)
      v = max(v, __shfl_xor_sync(kFull, v, off, kW));
    if constexpr (kBlock) {
      if (sh == 0) hv[wib] = v;
      __syncthreads();  // hv is written again a period later
      if (sl == 0) {
        for (int w = 1; w < nw; ++w) v = max(v, hv[w]);
        o[static_cast<size_t>(slot) * kLanes] = v;
      }
    } else if (sl == 0) {
      o[static_cast<size_t>(slot) * kLanes] = v;
    }
  }
};

template <int G, int R, bool kBlock>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
sw_conveyor_kernel(const int8_t* __restrict__ sched,
                   const int8_t* __restrict__ sy, int32_t* __restrict__ out,
                   int nt, int sr, int nb, int nxs, int P, int T, int a0,
                   int p8, SwScoring sc) {
  static_assert(!kBlock || G == 1, "the block form runs a queue a block");
  static_assert(R >= 1 && R <= kMaxRows, "R rows a lane");
  __shared__ Seam seam[kBlock ? kMaxWarps : 1][2];
  __shared__ int hv[kBlock ? kMaxWarps : 1];
  Lane<G, R, kBlock> s;
  const int lane = threadIdx.x % kWarp;
  int queue, sl, nl;  // the queue, the lane's place in it, its lanes
  if constexpr (kBlock) {
    queue = blockIdx.x;
    sl = threadIdx.x;
    nl = blockDim.x;
    s.sh = lane;
    s.wib = threadIdx.x / kWarp;
    s.nw = blockDim.x / kWarp;
  } else {
    constexpr int L = kWarp / G;
    const int warp = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
    if (warp * G >= nt * kLanes) return;  // the whole warp: 128 % G == 0
    queue = warp * G + lane / L;
    sl = lane % L;
    nl = L;
    s.sh = sl;
    s.wib = 0;
    s.nw = 1;
  }
  const int t = queue / kLanes;
  const int l = queue % kLanes;
  int32_t* const o = out + static_cast<size_t>(t) * p8 * kLanes + l;
  const int steps = (P + 1) * T + kUnroll;  // the TPU kernel's sweep

  // Rows past P are 0, as the plain version's.
  for (int q = P + sl; q < p8; q += nl) o[static_cast<size_t>(q) * kLanes] = 0;
  // A launch that breaks the contract (a window the queue's lanes cannot
  // hold, a period below the window or not a multiple of the block,
  // buffers too short for the sweep) scores -1 in every slot of its
  // queues and reads nothing; the wrapper checks it on the host.
  if (P < 1 || p8 < P || nxs < 1 || nxs > nl * R || T < nxs ||
      T % kUnroll || a0 < steps - 1 || a0 + nxs > nb || sr < steps) {
    for (int q = sl; q < min(P, p8); q += nl)
      o[static_cast<size_t>(q) * kLanes] = -1;
    return;
  }
  const int sh = s.sh;
  s.xp = sched + (static_cast<size_t>(t) * sr + sh) * kLanes + l;
  s.yp = sy + (static_cast<size_t>(t) * nb + a0 - sh) * kLanes + l;
  s.nx = sr - sh;      // entries i < sr
  s.ny = a0 + 1 - sh;  // entries i <= a0
  s.seam = seam;
  s.hv = hv;

  const SwScoring pin{kNeg, kNeg, kNeg, sc.ge};  // row nxs-1 and past it
#pragma unroll
  for (int j = 0; j < R; ++j) {
    s.D[j] = 0;
    s.P[j] = 0;
    s.Q[j] = 0;
    s.X[j] = kPadX;
    s.Y[j] = 0;
    s.U2[j] = 0;
    s.cs[j] = sl * R + j < nxs - 1 ? sc : pin;
  }
#pragma unroll
  for (int g = 0; g < Lane<G, R, kBlock>::kNG; ++g) s.acc[g] = 0;
  s.done = 0;
  s.cur = s.load();
  s.next = s.load();
  s.wn = s.word(0);  // entry 0 is no chunk's last
  s.hD = s.hQ = s.hY = 0;
  if constexpr (kBlock) {
    if (threadIdx.x < kMaxWarps) seam[threadIdx.x][1] = Seam{0, 0, 0};
    __syncthreads();
  }

  // Period m: step mT (row T-1, pinned or absent: no switch), then steps
  // mT + 1 + kR + j switching register j of lane k (rows 0 .. T-2 the
  // lanes hold: `full` lanes whole, then part of one), then the rows past
  // the lanes' (no switch). The harvest of slot m-2 comes first.
  const int full = min(nl, (T - 1) / R);
  const int part = full < nl ? min(T - 1 - full * R, R) : 0;
  for (int m = 0;; ++m) {
    if (m >= 2) s.harvest(o, m - 2, sl);
    s.done = 0;
    if (m > P) break;
    const int d0 = m * T;
    s.template step<-1>(d0, false);
    for (int k = 0; k < full; ++k)
      s.template lane_steps<0, true>(d0 + 1 + k * R, R, sl == k);
    if (part > 0)
      s.template lane_steps<0, false>(d0 + 1 + full * R, part, sl == full);
    for (int e = nl * R + 1; e < T; ++e) s.template step<-1>(d0 + e, false);
  }
}

template <int G, int R, bool kBlock>
int launch_geo(const void* sched, const void* sy, void* out, int nt, int sr,
               int nb, int nxs, int P, int T, int a0, int p8, int warps,
               SwScoring sc, cudaStream_t stream) {
  // warps: a queue's (block form) or a block's independent ones
  const int blocks =
      kBlock ? nt * kLanes : (nt * kLanes / G + warps - 1) / warps;
  sw_conveyor_kernel<G, R, kBlock><<<blocks, kWarp * warps, 0, stream>>>(
      static_cast<const int8_t*>(sched), static_cast<const int8_t*>(sy),
      static_cast<int32_t*>(out), nt, sr, nb, nxs, P, T, a0, p8, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns the first CUDA error (0 on
// success), or cudaErrorInvalidValue without launching for a geometry the
// build does not make: the warp form, `warps_per_queue` 1, G =
// `queues_per_warp` 1 with R = `rows` in 1 .. 16 or G = 2, 4 with R in
// 1 .. 10, and 1 .. 4 independent warps a block (`warps_per_block`); the
// block form, `warps_per_queue` W in 3 .. 4 (= `warps_per_block`), G = 1,
// R = 8. The caller allocates `out` (nt * p8 * 128 int32, p8 =
// round_up(P, 8)) and checks the contract: sched (nt, sr, 128), sy (nt,
// nb, 128); nxs a multiple of 8 with L * R * W >= nxs; T a multiple of 8
// and >= nxs; P >= 1; a0 >= (P+1)T + 7, a0 + nxs <= nb, sr >= (P+1)T + 8.
// A launch past the contract scores -1 in each slot of its queues.
extern "C" int sw_conveyor_launch(const void* sched, const void* sy,
                                  void* out, int nt, int sr, int nb, int nxs,
                                  int P, int T, int a0, int p8,
                                  int queues_per_warp, int rows,
                                  int warps_per_queue, int warps_per_block,
                                  int match, int mismatch, int gap_open,
                                  int gap_extend, void* stream) {
  const bool block = warps_per_queue > 1;
  if (warps_per_queue < 1 || warps_per_queue > kMaxWarps ||
      warps_per_block < 1 || warps_per_block > kMaxWarps ||
      (block && (warps_per_block != warps_per_queue ||
                 warps_per_queue < kMinBlockWarps)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt <= 0) return 0;
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GENOMAX_CONVEYOR_CASE(g, r, b)                                      \
  if (queues_per_warp == g && rows == r && block == b)                      \
    return launch_geo<g, r, b>(sched, sy, out, nt, sr, nb, nxs, P, T, a0,   \
                               p8, warps_per_block, sc, s);
#define GENOMAX_CONVEYOR_ROWS(g)                                            \
  GENOMAX_CONVEYOR_CASE(g, 1, false)                                        \
  GENOMAX_CONVEYOR_CASE(g, 2, false)                                        \
  GENOMAX_CONVEYOR_CASE(g, 3, false)                                        \
  GENOMAX_CONVEYOR_CASE(g, 4, false)                                        \
  GENOMAX_CONVEYOR_CASE(g, 5, false)                                        \
  GENOMAX_CONVEYOR_CASE(g, 6, false)                                        \
  GENOMAX_CONVEYOR_CASE(g, 7, false)                                        \
  GENOMAX_CONVEYOR_CASE(g, 8, false)                                        \
  GENOMAX_CONVEYOR_CASE(g, 9, false)                                        \
  GENOMAX_CONVEYOR_CASE(g, 10, false)
  GENOMAX_CONVEYOR_ROWS(1)
  GENOMAX_CONVEYOR_CASE(1, 11, false)
  GENOMAX_CONVEYOR_CASE(1, 12, false)
  GENOMAX_CONVEYOR_CASE(1, 13, false)
  GENOMAX_CONVEYOR_CASE(1, 14, false)
  GENOMAX_CONVEYOR_CASE(1, 15, false)
  GENOMAX_CONVEYOR_CASE(1, 16, false)
  GENOMAX_CONVEYOR_ROWS(2)
  GENOMAX_CONVEYOR_ROWS(4)
  GENOMAX_CONVEYOR_CASE(1, 8, true)
#undef GENOMAX_CONVEYOR_ROWS
#undef GENOMAX_CONVEYOR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
