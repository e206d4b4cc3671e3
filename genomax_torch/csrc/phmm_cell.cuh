// The PairHMM cell and rescale constants shared by pairhmm_tile.cu and
// pairhmm_long.cu (sm_90a).
//
// Both kernels keep R read rows a thread in registers and sweep
// anti-diagonals. A row carries its own M, X and Y of the previous diagonal
// and T, the row above's transition sum of the diagonal before that:
//   T(i, d) = mmv_i * M(i-1, d-2) + gapm_i * (X(i-1, d-2) + Y(i-1, d-2)),
// formed one step early from the row above's values at d-1 (so a row needs
// no copy of the row above's d-2 values) and multiplied by p at d:
//   M(i, d) = p * T,  X(i, d) = M(i-1, d-1) qi + X(i-1, d-1) qg,
//   Y(i, d) = M(i, d-1) qd + Y(i, d-1) qg.
// This is the reference's recurrence with its operations in its order
// (genomax_torch/kernels/wavefront.py `phmm_step`). A rescale after diagonal
// d multiplies the inputs of T(i, d+1) by 2^80 in the reference; scaling T
// instead would round differently where they are subnormal, which decides
// the deepest pairs. So the last step of a rescale block also forms Ts from
// the inputs times 2^80 (phmm_cell_end), and a rescale takes it for T.

#pragma once

#include <stdint.h>

// Rescale below this peak, by this factor; the initial constant; the
// long-read kernel's ceiling of carried values.
constexpr float kPhmmTrigger = 0x1p40f;
constexpr float kPhmmFactor = 0x1p80f;
constexpr float kPhmmInvFactor = 0x1p-80f;
constexpr float kPhmmInit = 0x1p120f;
constexpr float kPhmmCap = 0x1p126f;
// log10(2^80) and log10(2^120), rounded to fp32 as the JAX constants are.
constexpr float kPhmmRescaleLog10 =
    static_cast<float>(80 * 0.30102999566398120);
constexpr float kPhmmInitLog10 =
    static_cast<float>(120 * 0.30102999566398120);
constexpr int kPhmmCodeN = 'N';    // the raw wildcard
constexpr int kPhmmBitmaskN = 15;  // the pack's one-hot N

// Loop-invariant values of one read row, with the three folds of
// phmm_make_consts (kernels/wavefront.py): pm = qx = 0 at row 0 and past
// the read, so every M there is exactly 0; the read's 'N' folded into qx;
// qg = 1 at row 0, so the row-0 Y boundary persists.
struct PhmmRow {
  int code;
  float pm, qx, mmv, gapm, qi, qd, qg;
};

// `row` is the global read row, `rl` the read length; `bitmask` selects
// which code is the read's N.
__device__ __forceinline__ PhmmRow phmm_row(int code, float qr, float mmv,
                                            float gapm, float qi, float qd,
                                            float qg, int row, int rl,
                                            float inv_div, bool bitmask) {
  const bool dead = row == 0 || row > rl;
  const bool read_n = code == (bitmask ? kPhmmBitmaskN : kPhmmCodeN);
  PhmmRow c;
  c.code = code;
  c.pm = dead ? 0.0f : 1.0f - qr;
  c.qx = dead ? 0.0f : (read_n ? 1.0f - qr : qr * inv_div);
  c.mmv = mmv;
  c.gapm = gapm;
  c.qi = qi;
  c.qd = qd;
  c.qg = row == 0 ? 1.0f : qg;
  return c;
}

// A row with no read behind it: every value it carries stays 0.
__device__ __forceinline__ PhmmRow phmm_row_zero() {
  return PhmmRow{0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
}

// Read code against haplotype code: one-hot bitmasks, or raw bytes with the
// haplotype's N a wildcard.
template <bool kBitmask>
__device__ __forceinline__ bool phmm_match(int rc, int hc) {
  if (kBitmask) return (rc & hc) != 0;
  return rc == hc || hc == kPhmmCodeN;
}

// One cell at diagonal d. In: the row's own M, Y at d-1 and T; the row
// above's M, X, Y at d-1 (aM, aX, aY). Out: M, X, Y at d in place, and T
// for d+1.
__device__ __forceinline__ void phmm_cell(const PhmmRow& c, bool match,
                                          float aM, float aX, float aY,
                                          float& M, float& X, float& Y,
                                          float& T) {
  const float p = match ? c.pm : c.qx;
  const float mn = p * T;
  const float xn = aM * c.qi + aX * c.qg;
  const float yn = M * c.qd + Y * c.qg;
  T = c.mmv * aM + c.gapm * (aX + aY);
  M = mn;
  X = xn;
  Y = yn;
}

// The same on the last step of a rescale block, with Ts, the T a rescale
// after this step gives.
__device__ __forceinline__ void phmm_cell_end(const PhmmRow& c, bool match,
                                              float aM, float aX, float aY,
                                              float& M, float& X, float& Y,
                                              float& T, float& Ts) {
  Ts = c.mmv * (aM * kPhmmFactor) +
       c.gapm * (aX * kPhmmFactor + aY * kPhmmFactor);
  phmm_cell(c, match, aM, aX, aY, M, X, Y, T);
}

// The admit test of the JAX masks v0/v1/v2 for one value: "the window's
// peak lies in (0, 2^40)" is "some admitted value > 0 and none >= 2^40".
// Written without branches (bitwise & and |), so that a warp evaluating
// it never diverges.
__device__ __forceinline__ void phmm_admit(bool in, float v, bool& big,
                                           bool& pos) {
  big |= in & (v >= kPhmmTrigger);
  pos |= in & (v > 0.0f);
}

// The three masks for read row r at the end of a block on diagonal d, in
// terms of the row's own values (c = d - r its column at d):
//   v0: its M, Y at d with 0 <= c <= hl;
//   v1: its M, X, Y at d with 1 <= c <= hl + 1;
//   v2: its M, X, Y at d-1 with 1 <= c - 1 <= hl + 1.
// The reference writes v1 and v2 on the rolled copies, row r's values at
// row r+1, so they take rows whose r+1 lies in the tile or strip (the pack
// keeps rl <= NXs - 2); rows past rl take no part in any. `row` says
// whether the row takes part at all.
__device__ __forceinline__ void phmm_admit_v0(bool row, int c, int hl,
                                              float M, float Y, bool& big,
                                              bool& pos) {
  phmm_admit(row & (c >= 0) & (c <= hl), fmaxf(M, Y), big, pos);
}

__device__ __forceinline__ void phmm_admit_v1(bool row, int c, int hl,
                                              float M, float X, float Y,
                                              bool& big, bool& pos) {
  phmm_admit(row & (c >= 1) & (c <= hl + 1), fmaxf(fmaxf(M, X), Y), big,
             pos);
}

__device__ __forceinline__ void phmm_admit_v2(bool row, int c, int hl,
                                              float M, float X, float Y,
                                              bool& big, bool& pos) {
  phmm_admit_v1(row, c - 1, hl, M, X, Y, big, pos);
}
