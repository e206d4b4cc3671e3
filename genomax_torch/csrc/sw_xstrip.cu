// One skewed block of the cross-device Smith-Waterman wavefront (Gotoh,
// score only): U anti-diagonal steps of one rank's strip of w rows of x, for
// the 128 lanes of a tile, from the carried state, for Hopper (sm_90a).
//
// Replaces: genomax/dist/xsharded.py `_strip_block_pallas`. Same function:
// sxb (w, 128) int8 x codes of the strip; slab (w+U, 128) int8 stream rows,
// the window of in-block step tt being slab[U-tt : U-tt+w); hD, hQ (U, 128)
// int32, the left neighbour's last-row D and Q of each step (zeros on rank
// 0); the state P1, D1, D1s, Q1s, D2s, mx, six (w, 128) int32 in and out;
// bD, bQ (U, 128) int32 out, this strip's last-row Dn and Qn of each step.
// Per step:
//   Pn = max(D1, P1 + ge)          Qn = max(D1s, Q1s + ge)
//   Dn = max(max(Pn, Qn) + go + ge, max(D2s + sub, 0))     mx = max(mx, Dn)
// then D2s <- D1s, and D1s, Q1s <- Dn, Qn of the row above (row 0: hD, hQ
// of the step, where the TPU kernel's roll would wrap the last row round).
// There are no boundary pins and no masks: the pack's pad codes make the
// cells outside a pair's matrix decay, as in the TPU kernel. The cell is
// sw_cell.cuh's `sw_cell_dpx_preopen`, three DPX instructions and a max.
//
// The live-row window [g_lo, g_hi). The kernel reads and writes only the
// rows of the window; row g_lo takes zeros as its row above when g_lo > 0,
// and bD, bQ are zeros when g_hi < w. The forward (dist/xsharded.py
// `live_rows`) passes, at block b of rank k (diagonals d of [(b-k)U,
// (b-k+1)U), global row G = k*w + g, cell column j = d - G):
//   g_hi = min(w, (b-k+1)U - k*w). Above it every cell of the block has
//     j <= 0. From a zero state such a row stays zero: sub is a mismatch
//     (stream pad), so Pn = max(0, 0 + ge) = 0, Qn = 0, Dn = max(oge,
//     mismatch, 0) = 0, and its row above (j <= 0 too) hands it zeros. So
//     skipping those rows, and writing zeros as the last row's halo, is
//     exact for the state itself.
//   g_lo = max(0, (b-k)U - ly_max - k*w), ly_max the tile's longest y.
//     Below it every row is done: all its cells in this block and later
//     have j > ly_max, past every pair's y. Such dead cells feed only dead
//     cells (a cell feeds j and j+1 of its own and the next row). And a
//     dead cell cannot pass the pair's best: its D is the max of 0, a
//     predecessor's D plus the mismatch (< 0), and P' or Q' plus open +
//     extend (< 0), where P' and Q' are a predecessor's D less extends;
//     so by induction it is at most the best live D (or 0). With zeros in
//     place of the done row's values, the dead cells of row g_lo and of
//     the rows it feeds only fall (the recurrence is monotone, and every
//     D, P', Q' of a zero-started sweep is >= 0), so every lane's max of
//     mx is unchanged. The rows skipped keep their state, whose mx already
//     holds all their live cells. The state itself differs from the full
//     sweep's there; the scores do not.
//
// Design: one block a lane (128 blocks on 132 SMs), T threads, R rows a
// thread in registers (R = 4, 8, 16, a template argument; T <= 4096 / R).
// The window is walked in sub-strips of H = T*R rows; a sub-strip loads its
// rows' state once, runs all U steps, and stores it once, so the state
// costs 48 / U bytes a cell. In a step thread t computes its R cells, each
// from its own registers (the row above is row i-1 of the same thread),
// and row 0 takes the row above from lane t-1's row R-1 by __shfl_up_sync;
// lane 0 of each warp takes it from the previous warp's lane 31 through a
// shared seam, by step parity, so a step has one __syncthreads for all H
// rows. The stream code travels the same way: row i at step tt+1 compares
// the code row i-1 compared at tt, so only the sub-strip's first row reads
// the slab (its U codes staged in shared memory with the sub-strip's
// state). Sub-strip j's last row leaves its Dn and Qn of each step in a
// U-entry shared buffer that sub-strip j+1's row 0 reads in place of hD
// and hQ.
//
// The state lives in device memory between launches (6 x w x 128 x 4 B =
// 153.6 MB at 50kbp), at any strides the wrapper passes: the forward keeps it
// lane-major, so that one lane's rows are contiguous. It may be updated in
// place (out == in): each element is read and then written by the one
// thread that owns its row. Where the lane-major arrays are 16-byte aligned
// at a lane stride of whole int4 (`vector`), a thread moves its rows as
// int4, and where shared memory holds it (`prefetch`) it copies the next
// sub-strip's rows in by cp.async while this one steps; otherwise it moves
// one int at a time. The wrapper decides both.
//
// Bound on this card: operations. A launch does 8 integer instructions a
// cell as compiled (sw_cell_dpx_preopen's four, the substitution's
// compare, select and add, the running max) over the window's cells and
// moves 48 B a row and lane of state plus the codes. What holds it above
// that bound: the block barrier a step (now one for H rows), the register
// shifts of the rows' state between steps, and 128 blocks on 132 SMs.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sw_cell.cuh"

namespace {

constexpr int kLanes = 128;    // pairs per packed tile
constexpr int kMaxRows = 4096;  // rows of a sub-strip: threads x R
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoCode = 1 << 16;  // an x code no (int8) stream code equals

// R consecutive int32 of one lane's rows, 16-byte aligned, as int4 moves.
template <int R>
__device__ __forceinline__ void load_rows(const int32_t* p, int (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const int4 q = *reinterpret_cast<const int4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}

// The same R int32 copied asynchronously into shared memory.
template <int R>
__device__ __forceinline__ void prefetch_rows(int32_t* dst, const int32_t* p) {
#pragma unroll
  for (int i = 0; i < R; i += 4) __pipeline_memcpy_async(dst + i, p + i, 16);
}

template <int R>
__device__ __forceinline__ void shared_rows(const int32_t* p, int (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const int4 q = *reinterpret_cast<const int4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}

template <int R>
__device__ __forceinline__ void store_rows(int32_t* p, const int (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    *reinterpret_cast<int4*>(p + i) = make_int4(v[i], v[i + 1], v[i + 2],
                                                v[i + 3]);
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxRows / R)
sw_xstrip_kernel(const int8_t* __restrict__ sxb,
                 const int8_t* __restrict__ slab,
                 const int32_t* __restrict__ hD, const int32_t* __restrict__ hQ,
                 const int32_t* P1i, const int32_t* D1i, const int32_t* D1si,
                 const int32_t* Q1si, const int32_t* D2si, const int32_t* mxi,
                 int32_t* P1o, int32_t* D1o, int32_t* D1so, int32_t* Q1so,
                 int32_t* D2so, int32_t* mxo, int32_t* __restrict__ bD,
                 int32_t* __restrict__ bQ, int w, int U, int g_lo, int g_hi,
                 bool vector, bool prefetch, long long srow, long long slane,
                 SwScoring sc) {
  extern __shared__ int32_t smem[];
  const int T = blockDim.x;
  const int H = T * R;
  const int n_warps = T / 32;
  // [6][H], with prefetch only: the next sub-strip's state, thread t's R
  // rows of array a at a*H + t*R, copied in while this sub-strip steps
  int32_t* const nxt = smem;
  int32_t* hin = smem + (prefetch ? 6 * H : 0);  // [2][U]: D, Q of the row
                                                 // above row 0
  int32_t* hout = hin + 2 * U;      // [2][U]: D, Q of the sub-strip's last row
  int32_t* const ytop = hin + 4 * U;   // [U]: row g0's code of step tt + 1
  int32_t* const seam = hin + 5 * U;   // [2][3][n_warps]: D, Q, code of each
                                       // warp's last row, by step parity
  const int32_t* const ins[6] = {P1i, D1i, D1si, Q1si, D2si, mxi};

  const int l = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, wp = t >> 5;
  const int8_t* const ycol = slab + l;
  for (int i = t; i < U; i += T) {
    const size_t at = static_cast<size_t>(i) * kLanes + l;
    hin[i] = g_lo == 0 ? hD[at] : 0;
    hin[U + i] = g_lo == 0 ? hQ[at] : 0;
    if (g_hi < w) {
      bD[at] = 0;
      bQ[at] = 0;
    }
  }

  // Sub-strips start at g_lo rounded down to 4 rows, so that with
  // `vector` (the lane-major layout, srow 1, at a lane stride of whole int4
  // and 16-byte aligned arrays) a thread's R rows are 16-byte aligned and
  // move as R/4 int4 loads and stores. The rows in [g0, g_lo) are pads:
  // zero state and an x code no stream code equals, so that they stay
  // zero and hand row g_lo the zeros it takes as its row above (hin is
  // zeros when g_lo > 0, and there are no pads when g_lo = 0). They carry
  // the stream codes down like any row, and are never stored.
  bool fetched = false;  // this thread's rows of the sub-strip prefetched
  for (int g0 = g_lo & ~3; g0 < g_hi; g0 += H) {
    const int gt = g0 + t * R;  // this thread's first row
    int P1[R], D1[R], D1s[R], Q1s[R], D2s[R], mx[R], xc[R], yc[R];
    // All R rows in the window, with `vector`: int4 moves of the state,
    // from the copy the previous sub-strip prefetched where it did.
    const bool vec = vector && gt >= g_lo && gt + R <= g_hi;
    if (vec && fetched) {
      __pipeline_wait_prior(0);  // this thread's own copies: no barrier
      int32_t* const mine = nxt + t * R;
      shared_rows<R>(mine, P1);
      shared_rows<R>(mine + H, D1);
      shared_rows<R>(mine + 2 * H, D1s);
      shared_rows<R>(mine + 3 * H, Q1s);
      shared_rows<R>(mine + 4 * H, D2s);
      shared_rows<R>(mine + 5 * H, mx);
    } else if (vec) {
      const long long at = gt + l * slane;
      load_rows<R>(P1i + at, P1);
      load_rows<R>(D1i + at, D1);
      load_rows<R>(D1si + at, D1s);
      load_rows<R>(Q1si + at, Q1s);
      load_rows<R>(D2si + at, D2s);
      load_rows<R>(mxi + at, mx);
    }
    // The next sub-strip's rows of this thread are copied in while this
    // one steps, from the first step's barrier on (by then this thread's
    // reads of its slots are done): they are none of this sub-strip's
    // rows, so the in-place stores of this one cannot overtake the copy.
    const int gn = gt + H;
    fetched = prefetch && gn >= g_lo && gn + R <= g_hi;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int g = gt + i;
      if (!vec) P1[i] = D1[i] = D1s[i] = Q1s[i] = D2s[i] = mx[i] = 0;
      xc[i] = g < g_lo ? kNoCode : 0;
      yc[i] = 0;
      if (g < g_hi) {
        yc[i] = ycol[static_cast<size_t>(g + U) * kLanes];
        if (g >= g_lo) {
          xc[i] = sxb[static_cast<size_t>(g) * kLanes + l];
          if (!vec) {
            const long long at = g * srow + l * slane;
            P1[i] = P1i[at];
            D1[i] = D1i[at];
            D1s[i] = D1si[at];
            Q1s[i] = Q1si[at];
            D2s[i] = D2si[at];
            mx[i] = mxi[at];
          }
        }
      }
    }
    // The last row of the strip writes bD, bQ; at most one thread owns it.
    const int last = g_hi == w ? w - 1 - gt : -1;
    const bool owns_last = last >= 0 && last < R;
    __syncthreads();  // the previous sub-strip's reads of ytop done
    for (int i = t; i < U; i += T) {
      ytop[i] = ycol[static_cast<size_t>(g0 + U - i - 1) * kLanes];
    }
    __syncthreads();  // hin and ytop written

    for (int tt = 0; tt < U; ++tt) {
      int pn[R], qn[R], dn[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        dn[i] = sw_cell_dpx_preopen(D1[i], P1[i], D1s[i], Q1s[i], D2s[i],
                                    yc[i] == xc[i], sc, pn[i], qn[i]);
        mx[i] = max(mx[i], dn[i]);
      }
      int aD = __shfl_up_sync(kFull, dn[R - 1], 1);
      int aQ = __shfl_up_sync(kFull, qn[R - 1], 1);
      int aY = __shfl_up_sync(kFull, yc[R - 1], 1);
      int32_t* const sb = seam + (tt & 1) * 3 * n_warps;
      if (lane == 31) {
        sb[wp] = dn[R - 1];
        sb[n_warps + wp] = qn[R - 1];
        sb[2 * n_warps + wp] = yc[R - 1];
      }
      if (t == T - 1) {
        hout[tt] = dn[R - 1];
        hout[U + tt] = qn[R - 1];
      }
      if (owns_last) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (i == last) {
            bD[static_cast<size_t>(tt) * kLanes + l] = dn[i];
            bQ[static_cast<size_t>(tt) * kLanes + l] = qn[i];
          }
        }
      }
      __syncthreads();
      if (tt == 0 && fetched) {
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          prefetch_rows<R>(nxt + a * H + t * R, ins[a] + gn + l * slane);
        }
        __pipeline_commit();
      }
      if (lane == 0) {
        if (wp > 0) {
          aD = sb[wp - 1];
          aQ = sb[n_warps + wp - 1];
          aY = sb[2 * n_warps + wp - 1];
        } else {
          aD = hin[tt];
          aQ = hin[U + tt];
          aY = ytop[tt];
        }
      }
#pragma unroll
      for (int i = R - 1; i > 0; --i) {
        D2s[i] = D1s[i];
        D1s[i] = dn[i - 1];
        Q1s[i] = qn[i - 1];
        yc[i] = yc[i - 1];
      }
      D2s[0] = D1s[0];
      D1s[0] = aD;
      Q1s[0] = aQ;
      yc[0] = aY;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        P1[i] = pn[i];
        D1[i] = dn[i];
      }
    }
    if (vec) {
      const long long at = gt + l * slane;
      store_rows<R>(P1o + at, P1);
      store_rows<R>(D1o + at, D1);
      store_rows<R>(D1so + at, D1s);
      store_rows<R>(Q1so + at, Q1s);
      store_rows<R>(D2so + at, D2s);
      store_rows<R>(mxo + at, mx);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int g = gt + i;
        if (g >= g_lo && g < g_hi) {
          const long long at = g * srow + l * slane;
          P1o[at] = P1[i];
          D1o[at] = D1[i];
          D1so[at] = D1s[i];
          Q1so[at] = Q1s[i];
          D2so[at] = D2s[i];
          mxo[at] = mx[i];
        }
      }
    }
    int32_t* const swap = hin;  // the next sub-strip's row above: this one's
    hin = hout;                 // last row; its reads follow the barrier at
    hout = swap;                // the top of the next sub-strip
  }
}

template <int R>
int launch(const void* sxb, const void* slab, const void* hD, const void* hQ,
           const void* P1i, const void* D1i, const void* D1si,
           const void* Q1si, const void* D2si, const void* mxi, void* P1o,
           void* D1o, void* D1so, void* Q1so, void* D2so, void* mxo, void* bD,
           void* bQ, int w, int U, int g_lo, int g_hi, int threads,
           bool vector, bool prefetch, long long srow, long long slane,
           SwScoring sc, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>((prefetch ? 6 * threads * R : 0) + 5 * U +
                          6 * (threads / 32)) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_xstrip_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sw_xstrip_kernel<R><<<kLanes, threads, smem, stream>>>(
      static_cast<const int8_t*>(sxb), static_cast<const int8_t*>(slab),
      static_cast<const int32_t*>(hD), static_cast<const int32_t*>(hQ),
      static_cast<const int32_t*>(P1i), static_cast<const int32_t*>(D1i),
      static_cast<const int32_t*>(D1si), static_cast<const int32_t*>(Q1si),
      static_cast<const int32_t*>(D2si), static_cast<const int32_t*>(mxi),
      static_cast<int32_t*>(P1o), static_cast<int32_t*>(D1o),
      static_cast<int32_t*>(D1so), static_cast<int32_t*>(Q1so),
      static_cast<int32_t*>(D2so), static_cast<int32_t*>(mxo),
      static_cast<int32_t*>(bD), static_cast<int32_t*>(bQ), w, U, g_lo, g_hi,
      vector, prefetch, srow, slane, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for an R the build does not make. The caller
// checks shapes (sxb (w, 128), slab (w+U, 128) contiguous int8; hD, hQ,
// bD, bQ (U, 128) contiguous int32; the 12 state arrays (w, 128) int32 at
// the strides srow, slane, each output either its input or disjoint from
// every input), the window (0 <= g_lo < g_hi <= w) and picks `threads` (a
// multiple of 32, at most 4096 / R), R (`rows_per_thread`: 4, 8, 16),
// `vector` (nonzero only where srow is 1, slane a multiple of 4 and the 12
// state arrays 16-byte aligned) and `prefetch` (nonzero only with `vector`
// and where 6 * threads * R + 5U + 6 * threads / 32 ints fit the block's
// shared memory).
extern "C" int sw_xstrip_launch(
    const void* sxb, const void* slab, const void* hD, const void* hQ,
    const void* P1i, const void* D1i, const void* D1si, const void* Q1si,
    const void* D2si, const void* mxi, void* P1o, void* D1o, void* D1so,
    void* Q1so, void* D2so, void* mxo, void* bD, void* bQ, int w, int U,
    int g_lo, int g_hi, int rows_per_thread, int threads, int vector,
    int prefetch, long long srow, long long slane, int match, int mismatch,
    int gap_open, int gap_extend, void* stream) {
  const SwScoring sc{match, mismatch, gap_open + gap_extend, gap_extend};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GENOMAX_XSTRIP_LAUNCH(R)                                            \
  launch<R>(sxb, slab, hD, hQ, P1i, D1i, D1si, Q1si, D2si, mxi, P1o, D1o,  \
            D1so, Q1so, D2so, mxo, bD, bQ, w, U, g_lo, g_hi, threads,       \
            vector != 0, prefetch != 0, srow, slane, sc, s)
  switch (rows_per_thread) {
    case 4: return GENOMAX_XSTRIP_LAUNCH(4);
    case 8: return GENOMAX_XSTRIP_LAUNCH(8);
    case 16: return GENOMAX_XSTRIP_LAUNCH(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GENOMAX_XSTRIP_LAUNCH
}
