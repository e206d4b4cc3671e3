// The step of a warp that keeps R consecutive x rows a thread in
// registers, shared by sw_tile.cu, sw_strips.cu and sw_stacked.cu.
//
// A warp sweeps a sub-strip of H = 32 * R rows along its anti-diagonals d
// (cell (p, j) lies on d = p + j), one step a diagonal. Lane t owns rows
// pf = row0 + t*R .. pf + R - 1 and keeps for each its D, P and Q of
// diagonal d-1, the y code it compared there, its diagonal neighbour
// D(p-1, j-1) and its x code. In a step it computes its R cells bottom
// row first, each from its own registers and those of the row above: row
// i-1 of the same thread, or for row 0 the values (aD, aQ, aY) that the
// caller hands it, lane t-1's row R-1 at d-1 by __shfl_up_sync (taken
// after the step, before anything overwrites them) and for lane 0 the
// caller's own (a seam, a ring or the first-row boundary). The y code
// travels down the rows, cell (p, j) comparing the code that (p-1, j)
// used a step earlier, so only a sub-strip's first row reads y. The cell
// is sw_cell.cuh's `sw_cell_dpx`; the running best takes two cells a
// __vimax3_s32.
//
// Masks: a cell is live iff 1 <= p <= lx and 1 <= j <= ly; every other
// cell is D = 0, P = Q = kSwNeg. The caller takes `step<false>` (no mask)
// on the diagonals where every cell of the warp is live, decided for the
// whole warp so that the warp never runs both bodies, and `step<true>` at
// the edges.

#pragma once

#include "sw_cell.cuh"

constexpr unsigned kSwFullMask = 0xffffffffu;
// lx or ly of a sweep that masks no rows or columns past the matrix
// (the lane tile, whose pads decay).
constexpr int kSwNoEnd = 0x7fffffff;

// kMat: the matrix instantiation. X holds each row's x code times
// kSubStride (sw_x_code), `tab` the code table in shared memory, and a
// cell scores tab[X + y] through sw_cell_dpx_sub; the equality
// instantiation reads neither and is the code it was.
template <int R, bool kMat = false>
struct SwRows {
  int D[R], P[R], Q[R], Y[R], U2[R], X[R];
  const int* tab;

  // Diagonal row0 of a sub-strip: every cell is boundary or above it.
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      D[i] = 0;
      P[i] = kSwNeg;
      Q[i] = kSwNeg;
      Y[i] = 0;
      U2[i] = 0;
    }
  }

  // The R cells of diagonal d, rows pf .. pf + R - 1; raises best to each D.
  template <bool kMasked>
  __device__ __forceinline__ void step(int d, int pf, int aD, int aQ, int aY,
                                       int lx, int ly, const SwScoring& sc,
                                       int& best) {
#pragma unroll
    for (int i = R - 1; i >= 0; --i) {
      // Row i-1's registers still hold diagonal d-1 (bottom row first).
      const int ud = i ? D[i - 1] : aD;
      const int uq = i ? Q[i - 1] : aQ;
      const int yc = i ? Y[i - 1] : aY;
      int pn, qn;
      int dn;
      if constexpr (kMat) {
        dn = sw_cell_dpx_sub(D[i], P[i], ud, uq, U2[i], tab[X[i] + yc], sc,
                             pn, qn);
      } else {
        dn = sw_cell_dpx(D[i], P[i], ud, uq, U2[i], yc == X[i], sc, pn, qn);
      }
      U2[i] = ud;
      Y[i] = yc;
      if (kMasked) {
        const int p = pf + i, j = d - p;
        const bool live =
            static_cast<unsigned>(p - 1) < static_cast<unsigned>(lx) &&
            static_cast<unsigned>(j - 1) < static_cast<unsigned>(ly);
        D[i] = live ? dn : 0;
        P[i] = live ? pn : kSwNeg;
        Q[i] = live ? qn : kSwNeg;
      } else {
        D[i] = dn;
        P[i] = pn;
        Q[i] = qn;
      }
    }
#pragma unroll
    for (int i = 0; i + 1 < R; i += 2) best = __vimax3_s32(best, D[i], D[i + 1]);
    if (R & 1) best = max(best, D[R - 1]);
  }

  // The row above lane t's row 0 at the next step: lane t-1's row R-1
  // (lane 0 gets its own, which the caller replaces).
  __device__ __forceinline__ void hand_down(int& aD, int& aQ, int& aY) const {
    aD = __shfl_up_sync(kSwFullMask, D[R - 1], 1);
    aQ = __shfl_up_sync(kSwFullMask, Q[R - 1], 1);
    aY = __shfl_up_sync(kSwFullMask, Y[R - 1], 1);
  }
};
