// One cell of the Smith-Waterman (Gotoh, score only) recurrence, shared by
// the SW kernels of this directory (sw_tile.cu, sw_long.cu, sw_strips.cu,
// sw_rotor.cu, sw_stacked.cu).
//
// Cell (p, j) of pair x, y:
//   P = max(D(p, j-1) + open + extend, P(p, j-1) + extend)    gap along y
//   Q = max(D(p-1, j) + open + extend, Q(p-1, j) + extend)    gap along x
//   D = max(P, Q, D(p-1, j-1) + (x[p-1] == y[j-1] ? match : mismatch), 0)
// and the running best takes D. The caller decides which cells are live
// and what their neighbours are; a dead cell is D = 0, P = Q = kSwNeg.
// Semantics: antidiagonalSmithWaterman.c:82-92 of the reference.

#pragma once

// -inf of P and Q: far below any score, and kSwNeg + extend cannot wrap.
// P and Q are rebuilt every step from D >= 0, so they never drift below
// open + extend once live.
constexpr int kSwNeg = -(1 << 28);

struct SwScoring {
  int match, mismatch, oge, ge;  // oge = gap_open + gap_extend
};

// Returns D of the cell and writes its P and Q; raises best to D.
__device__ __forceinline__ int sw_cell(int d_left, int p_left, int d_up,
                                       int q_up, int d_diag, bool same,
                                       const SwScoring& s, int& p, int& q,
                                       int& best) {
  p = max(d_left + s.oge, p_left + s.ge);
  q = max(d_up + s.oge, q_up + s.ge);
  const int d = max(max(p, q), max(d_diag + (same ? s.match : s.mismatch), 0));
  best = max(best, d);
  return d;
}
