// One cell of the Smith-Waterman (Gotoh, score only) recurrence, shared by
// the SW kernels of this directory in Hopper's DPX form: `sw_cell_dpx` by
// sw_long.cu, sw_rotor.cu and, through sw_rows.cuh's step, sw_tile.cu,
// sw_strips.cu and sw_stacked.cu; `sw_cell_dpx_sub`, its form under a
// substitution matrix, by the first four's matrix instantiations;
// `sw_cell_dpx_preopen` by sw_xstrip.cu and sw_conveyor.cu.
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

// The cell with Hopper's DPX max-plus instructions (sm_90: one
// instruction each for add-then-max and for a three-way max with 0):
//   P = __viaddmax_s32(d_left, oge, p_left + ge)  = max(d_left + oge, p_left + ge)
//   Q = __viaddmax_s32(d_up, oge, q_up + ge)
//   D = __vimax3_s32_relu(P, Q, d_diag + sub)     = max(P, Q, d_diag + sub, 0)
// The caller takes the running best with a plain max (or a three-way max
// over two cells).
__device__ __forceinline__ int sw_cell_dpx(int d_left, int p_left, int d_up,
                                           int q_up, int d_diag, bool same,
                                           const SwScoring& s, int& p,
                                           int& q) {
  p = __viaddmax_s32(d_left, s.oge, p_left + s.ge);
  q = __viaddmax_s32(d_up, s.oge, q_up + s.ge);
  return __vimax3_s32_relu(p, q, d_diag + (same ? s.match : s.mismatch));
}

// The cell under a substitution matrix (genomax_torch/scoring.py): the
// caller passes the table's entry of its x and y codes in place of
// `same`. The matrix instantiations of sw_long.cu, sw_rotor.cu and,
// through sw_rows.cuh, sw_tile.cu and sw_strips.cu call it; the equality
// instantiations keep `sw_cell_dpx`, so their code is unchanged.
__device__ __forceinline__ int sw_cell_dpx_sub(int d_left, int p_left,
                                               int d_up, int q_up, int d_diag,
                                               int sub, const SwScoring& s,
                                               int& p, int& q) {
  p = __viaddmax_s32(d_left, s.oge, p_left + s.ge);
  q = __viaddmax_s32(d_up, s.oge, q_up + s.ge);
  return __vimax3_s32_relu(p, q, d_diag + sub);
}

// The code table in shared memory (scoring.code_table): the score of x
// code x against y code y at kSubStride * x + y, kSubEntries int32 in
// all. A matrix kernel keeps its x codes premultiplied by kSubStride
// (`sw_x_code`), so a cell's lookup is one add and one shared load. The
// stride is 33, so the lanes of a warp, each at its own (x, y), spread
// over the 32 banks by x + y. y code kSubDead scores -inf against any x.
constexpr int kSubStride = 33;
constexpr int kSubCodes = 32;
constexpr int kSubEntries = kSubCodes * kSubStride;
constexpr int kSubDead = kSubCodes - 1;

template <bool kMat>
__device__ __forceinline__ int sw_x_code(int code) {
  return kMat ? code * kSubStride : code;
}

// Every thread of the block copies its share of the table from device
// memory; the caller puts a __syncthreads after it, before any thread
// leaves the kernel.
__device__ __forceinline__ void sw_load_table(int* dst,
                                              const int* __restrict__ src) {
  for (int i = threadIdx.x; i < kSubEntries; i += blockDim.x) dst[i] = src[i];
}

// The form of the cross-device strip and conveyor kernels (sw_xstrip.cu,
// sw_conveyor.cu), whose P and Q are kept before the gap open (P' = P -
// open - extend, Q' likewise):
//   P' = max(D_left, P'_left + ge)             = __viaddmax_s32(P'_left, ge, D_left)
//   Q' = max(D_up, Q'_up + ge)                 = __viaddmax_s32(Q'_up, ge, D_up)
//   D  = max(max(P', Q') + oge, D_diag + sub, 0)
//      = __viaddmax_s32_relu(max(P', Q'), oge, D_diag + sub)
__device__ __forceinline__ int sw_cell_dpx_preopen(int d_left, int p_left,
                                                   int d_up, int q_up,
                                                   int d_diag, bool same,
                                                   const SwScoring& s, int& p,
                                                   int& q) {
  p = __viaddmax_s32(p_left, s.ge, d_left);
  q = __viaddmax_s32(q_up, s.ge, d_up);
  return __viaddmax_s32_relu(max(p, q), s.oge,
                             d_diag + (same ? s.match : s.mismatch));
}
