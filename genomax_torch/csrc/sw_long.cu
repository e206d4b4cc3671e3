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
// carries. The pack's strip width W does not shape the kernel: it walks
// the pack's K*W rows in sub-strips of its own height H.
//
// Design: one block per pair, T threads, R rows a thread in registers (R =
// 4, 8, 16, a template argument; H = T*R <= 4096). Sub-strip s holds rows
// [s*H, s*H + H) and sweeps its diagonals d (cell (p, j) lies on d = p + j)
// one step each; the sub-strips run one after another in the block. Thread
// t owns rows p = s*H + t*R + i, i < R, and keeps for each its D, P and Q
// of diagonal d-1, the y code it compared there and its diagonal
// neighbour D(p-1, j-1). In a step it computes its R cells bottom row
// first, each from its own registers and those of the row above: row i-1
// of the same thread, lane t-1's row R-1 for row 0 (__shfl_up_sync), and
// for lane 0 of a warp the previous warp's lane 31 through a shared seam,
// by step parity: one __syncthreads a step for all H rows. The y code
// travels down the rows the same way, cell (p, j) comparing the code that
// (p-1, j) used a step earlier, so only the sub-strip's first row reads
// the stream. The cell is sw_cell.cuh's `sw_cell_dpx`: P and Q by
// __viaddmax_s32, D by __vimax3_s32_relu; the running best takes two cells
// a __vimax3_s32.
//
// The seam between sub-strips: the last row of sub-strip s writes its D
// and Q of column j to the pair's halo in global memory, entry j, on its
// live cells; row 0 of sub-strip s+1 takes entry j as its row above at
// column j. Warp 0 fetches halo entries and stream codes 32 columns at a
// time, loading one chunk ahead into registers and storing it to a
// double-buffered shared chunk 16 steps later. One halo serves every
// sub-strip without a race: sub-strip s+1 reads entry j at least 32 steps
// (so past a barrier) before its own last row overwrites entry j, on
// diagonal s*H + H + H - 1 + j.
//
// Boundaries are written out, not left to pad decay: a cell is live iff
// 1 <= p <= len(x) and 1 <= j <= len(y); every other cell is D = 0,
// P = Q = kNeg. A thread whose R rows are all live on a diagonal takes a
// path without the masks (most steps of a long pair); the others mask each
// cell. A live first-row cell reads only halo entries that the previous
// sub-strip wrote from live cells of the same column (entries 1 to len(y);
// the fetch reads no other and feeds the boundary past them), so the halo
// needs no initial value (torch.empty). The TPU kernel's zero-initialised
// halo and its "zeros past the matrix only lower dead cells" argument have
// no part here.
//
// kNeg is safe at any length: P and Q are recomputed every step as
// max(D + open + extend, . + extend) with D >= 0, so they never drift
// below open + extend once live, and dead cells reset them to kNeg.
//
// Bound on this card: operations, about 9 integer instructions a cell
// (sw_cell_dpx's five, the substitution's compare and select, the
// diagonal's add, half a running max). What holds it above that: the block
// barrier a step (now one for H rows, so 13 sub-strips of a 50kbp pair in
// place of 49 strips of one thread a row), the register moves of the rows'
// state between steps, and 128 blocks on 132 SMs (a lone pair runs on one
// SM).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sw_cell.cuh"

namespace {

constexpr int kLanes = 128;        // pairs per packed tile
constexpr int kChunk = 32;         // columns per seam prefetch (one warp)
constexpr int kMaxRows = 4096;     // rows of a sub-strip: threads x R
constexpr int kMaxWarps = 32;
constexpr int kNeg = kSwNeg;       // -inf of P and Q (sw_cell.cuh)
constexpr unsigned kFull = 0xffffffffu;

// kMat: the matrix instantiation, its code table in static shared memory
// (sw_cell.cuh), x codes premultiplied by kSubStride.
template <int R, bool kMat>
__global__ void __launch_bounds__(kMaxRows / R)
sw_long_kernel(const int8_t* __restrict__ sx, const int8_t* __restrict__ sy,
               const int32_t* __restrict__ nx, const int32_t* __restrict__ ny,
               int2* halo, int32_t* __restrict__ out, int n_rows, int anchor,
               int nh, SwScoring sc, const int32_t* __restrict__ table) {
  __shared__ int32_t seam[2][3][kMaxWarps];  // D, Q, code of each warp's
                                             // last row, by step parity
  __shared__ int2 hin[2][kChunk];      // halo entries of the row above row 0
  __shared__ int32_t yin[2][kChunk];   // stream codes of row 0
  __shared__ int32_t block_best;

  const int T = blockDim.x;
  const int H = T * R;
  const int l = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, wp = t >> 5;
  const int lx = nx[l] - 1;  // len(x)
  const int ly = ny[l] - 1;  // len(y)
  const int8_t* const ys = sy + l;
  int2* const hl = halo + static_cast<size_t>(l) * nh;

  int best = 0;
  if (t == 0) block_best = 0;
  const int* tab = nullptr;
  if constexpr (kMat) {
    __shared__ int32_t tab_s[kSubEntries];
    sw_load_table(tab_s, table);
    tab = tab_s;  // the first sub-strip's barriers come before a lookup
  }

  // Sub-strip s has a live row iff s*H <= lx. The bounds are the same for
  // every thread of the block.
  const bool any_live = lx > 0 && ly > 0;
  for (int row0 = 0; any_live && row0 < n_rows && row0 <= lx; row0 += H) {
    const int pf = row0 + t * R;  // this thread's first row
    int xc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      xc[i] = sw_x_code<kMat>(
          pf + i < n_rows ? sx[static_cast<size_t>(pf + i) * kLanes + l] : 1);
    }
    const int d_start = row0 + 1;                   // row0's cell j = 1
    const int d_end = min(row0 + H - 1, lx) + ly;   // last live diagonal
    // Diagonals on which all R rows of this thread are live.
    const int fast_lo = pf + R;
    const int fast_hi = pf >= 1 && pf + R - 1 <= lx ? pf + ly : -1;
    const bool last_thread = t == T - 1;
    const int p_last = pf + R - 1;

    // The row above row 0 at column j: entry j of the previous sub-strip's
    // halo, and y[j-1]; past len(y), and on the first sub-strip, the
    // boundary. Step e (diagonal d_start + e) is column e + 1.
    auto entry = [&](int j) {
      return row0 > 0 && j <= ly ? hl[j] : make_int2(0, kNeg);
    };
    auto code = [&](int j) {
      return j <= ly ? static_cast<int>(
                           ys[static_cast<size_t>(anchor - j) * kLanes])
                     : 0;
    };

    // Diagonal d_start - 1: every cell of the sub-strip is dead.
    int D[R], P[R], Q[R], Y[R], U2[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      D[i] = 0;
      P[i] = kNeg;
      Q[i] = kNeg;
      Y[i] = 0;
      U2[i] = 0;
    }
    __syncthreads();  // the previous sub-strip's halo writes, chunk reads
    if (wp == 0) {
      hin[0][lane] = entry(1 + lane);
      yin[0][lane] = code(1 + lane);
    }
    __syncthreads();
    int aD = 0, aQ = kNeg, aY = 0;  // the row above this thread's row 0
    if (t == 0) {
      aD = hin[0][0].x;
      aQ = hin[0][0].y;
      aY = yin[0][0];
    }
    int2 pre_h = make_int2(0, kNeg);  // warp 0: the next chunk in flight
    int pre_y = 0;

    for (int d = d_start; d <= d_end; ++d) {
      const int e = d - d_start;
      const int c = e / kChunk, ei = e % kChunk;
      if (wp == 0 && ei == 0) {
        const int j = (c + 1) * kChunk + 1 + lane;
        pre_h = entry(j);
        pre_y = code(j);
      }
      if (wp == 0 && ei == kChunk / 2) {
        hin[(c + 1) & 1][lane] = pre_h;
        yin[(c + 1) & 1][lane] = pre_y;
      }
      // Row i's cell from the row above (ud, uq, yc): row i-1 of this
      // thread, or (aD, aQ, aY) for row 0; bottom row first, so that row
      // i-1's registers still hold diagonal d-1.
      const bool fast = d >= fast_lo && d <= fast_hi;
      auto cell = [&](int i, int ud, int uq, int yc) {
        int pn, qn;
        int dn;
        if constexpr (kMat) {
          dn = sw_cell_dpx_sub(D[i], P[i], ud, uq, U2[i], tab[xc[i] + yc],
                               sc, pn, qn);
        } else {
          dn = sw_cell_dpx(D[i], P[i], ud, uq, U2[i], yc == xc[i], sc, pn,
                           qn);
        }
        const int p = pf + i, j = d - p;
        const bool live =
            fast || (static_cast<unsigned>(p - 1) < static_cast<unsigned>(lx)
                     && static_cast<unsigned>(j - 1) <
                            static_cast<unsigned>(ly));
        U2[i] = ud;
        D[i] = live ? dn : 0;
        P[i] = live ? pn : kNeg;
        Q[i] = live ? qn : kNeg;
        Y[i] = yc;
      };
      // The two bodies are the same text on purpose: inside `if (fast)`
      // the compiler knows `fast` is true, folds `live` to true and drops
      // the masks (the unmasked path); the else body keeps them.
      if (fast) {
#pragma unroll
        for (int i = R - 1; i > 0; --i) cell(i, D[i - 1], Q[i - 1], Y[i - 1]);
        cell(0, aD, aQ, aY);
      } else {
#pragma unroll
        for (int i = R - 1; i > 0; --i) cell(i, D[i - 1], Q[i - 1], Y[i - 1]);
        cell(0, aD, aQ, aY);
      }
#pragma unroll
      for (int i = 0; i + 1 < R; i += 2) best = __vimax3_s32(best, D[i], D[i + 1]);

      aD = __shfl_up_sync(kFull, D[R - 1], 1);
      aQ = __shfl_up_sync(kFull, Q[R - 1], 1);
      aY = __shfl_up_sync(kFull, Y[R - 1], 1);
      const int par = e & 1;
      if (lane == 31) {
        seam[par][0][wp] = D[R - 1];
        seam[par][1][wp] = Q[R - 1];
        seam[par][2][wp] = Y[R - 1];
      }
      if (last_thread) {  // the seam to the next sub-strip, live cells only
        const int j = d - p_last;
        if (p_last <= lx && j >= 1 && j <= ly) hl[j] = make_int2(D[R - 1],
                                                                 Q[R - 1]);
      }
      __syncthreads();
      if (lane == 0) {
        if (wp > 0) {
          aD = seam[par][0][wp - 1];
          aQ = seam[par][1][wp - 1];
          aY = seam[par][2][wp - 1];
        } else {
          const int e1 = e + 1;
          const int2 h = hin[(e1 / kChunk) & 1][e1 % kChunk];
          aD = h.x;
          aQ = h.y;
          aY = yin[(e1 / kChunk) & 1][e1 % kChunk];
        }
      }
    }
  }
  __syncthreads();
  atomicMax(&block_best, best);
  __syncthreads();
  if (t == 0) out[l] = block_best;
}

template <int R, bool kMat>
int launch(const void* sx, const void* sy, const void* nx, const void* ny,
           void* halo, void* out, int n_rows, int threads, int anchor, int nh,
           SwScoring sc, const void* table, cudaStream_t stream) {
  sw_long_kernel<R, kMat><<<kLanes, threads, 0, stream>>>(
      static_cast<const int8_t*>(sx), static_cast<const int8_t*>(sy),
      static_cast<const int32_t*>(nx), static_cast<const int32_t*>(ny),
      static_cast<int2*>(halo), static_cast<int32_t*>(out), n_rows, anchor,
      nh, sc, static_cast<const int32_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for an R the build does not make. The caller
// allocates `halo` (128 * nh int2, no initial value needed, nh >
// max(ny) - 1) and `out`, and checks shapes: sx (n_rows, 128), sy rows
// covering anchor - max(ny) + 1 .. anchor - 1, 1 <= nx <= n_rows; and
// picks `threads` (a multiple of 32, at most 4096 / R) and R
// (`rows_per_thread`: 4, 8, 16). `table` null scores by match and
// mismatch; else it is the code table on the device (kSubEntries int32)
// and match and mismatch are not read.
extern "C" int sw_long_launch(const void* sx, const void* sy, const void* nx,
                              const void* ny, void* halo, void* out,
                              int n_rows, int rows_per_thread, int threads,
                              int anchor, int nh, int match, int mismatch,
                              int gap_open, int gap_extend, const void* table,
                              void* stream) {
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread) {
#define GENOMAX_LONG_CASE(r)                                                 \
  case r:                                                                    \
    return table ? launch<r, true>(sx, sy, nx, ny, halo, out, n_rows,        \
                                   threads, anchor, nh, sc, table, s)        \
                 : launch<r, false>(sx, sy, nx, ny, halo, out, n_rows,       \
                                    threads, anchor, nh, sc, table, s);
    GENOMAX_LONG_CASE(4)
    GENOMAX_LONG_CASE(8)
    GENOMAX_LONG_CASE(16)
#undef GENOMAX_LONG_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
