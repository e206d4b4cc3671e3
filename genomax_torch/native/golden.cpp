// Native golden models: fp64 full-precision scoring used by the parity
// harness and as the high-speed CPU oracle for differential tests.
//
// Fresh row-wise implementations of the same contracts the reference's C
// programs satisfy (semantics documented in SURVEY.md §2.1 and
// kernels/oracle.py) — NOT the reference's anti-diagonal layout: here each
// DP matrix is swept row-major with two rolling rows, which is the
// natural cache-friendly CPU formulation and keeps this code an
// independent implementation for differential testing.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cfloat>
#include <vector>
#include <algorithm>

namespace {

constexpr int64_t kNegInf = INT32_MIN;

inline int64_t sat_add(int64_t a, int64_t b) {
  // INT_MIN-absorbing add (matches sum_with_infinity semantics).
  return (a == kNegInf || b == kNegInf) ? kNegInf : a + b;
}

}  // namespace

extern "C" {

// Affine-gap local alignment score (Gotoh, score-only), int32 semantics.
// sx = columns (shorter), sy = rows. Bytes compared raw (the '\n' quirk
// is the caller's packing concern).
int32_t gx_sw_score(const uint8_t* sx, int32_t sx_len, const uint8_t* sy,
                    int32_t sy_len, int32_t match, int32_t mismatch,
                    int32_t gap_open, int32_t gap_extend) {
  const int32_t nx = sx_len + 1;
  const int64_t og_e = gap_open + gap_extend;

  std::vector<int64_t> P0(nx), Q0(nx), D0(nx), P1(nx), Q1(nx), D1(nx);
  // Row 0: P=-inf, Q=0, D=0 (row boundary wins at (0,0)).
  for (int32_t j = 0; j < nx; ++j) {
    P0[j] = kNegInf;
    Q0[j] = 0;
    D0[j] = 0;
  }
  int64_t best = 0;
  for (int32_t i = 1; i <= sy_len; ++i) {
    // Column 0: P=0, Q=-inf, D=0.
    P1[0] = 0;
    Q1[0] = kNegInf;
    D1[0] = 0;
    const uint8_t cy = sy[i - 1];
    for (int32_t j = 1; j < nx; ++j) {
      const int64_t p = std::max(sat_add(D0[j], og_e), sat_add(P0[j], gap_extend));
      const int64_t q = std::max(sat_add(D1[j - 1], og_e), sat_add(Q1[j - 1], gap_extend));
      const int64_t sub = (cy == sx[j - 1]) ? match : mismatch;
      const int64_t d = std::max({p, q, D0[j - 1] + sub, int64_t{0}});
      P1[j] = p;
      Q1[j] = q;
      D1[j] = d;
      if (d > best) best = d;
    }
    P0.swap(P1);
    Q0.swap(Q1);
    D0.swap(D1);
  }
  return static_cast<int32_t>(best);
}

// Batch SW over concatenated sequences. offsets arrays have n+1 entries.
void gx_sw_scores_batch(const uint8_t* sx_data, const int64_t* sx_off,
                        const uint8_t* sy_data, const int64_t* sy_off,
                        int64_t n_pairs, int32_t match, int32_t mismatch,
                        int32_t gap_open, int32_t gap_extend, int32_t* out) {
  for (int64_t k = 0; k < n_pairs; ++k) {
    out[k] = gx_sw_score(sx_data + sx_off[k],
                         static_cast<int32_t>(sx_off[k + 1] - sx_off[k]),
                         sy_data + sy_off[k],
                         static_cast<int32_t>(sy_off[k + 1] - sy_off[k]),
                         match, mismatch, gap_open, gap_extend);
  }
}

// The same score under a substitution matrix: sx and sy hold residue
// codes (genomax_torch/scoring.py), and a cell scores
// table[stride * sx[j-1] + sy[i-1]] in place of match / mismatch.
int32_t gx_sw_score_matrix(const uint8_t* sx, int32_t sx_len,
                           const uint8_t* sy, int32_t sy_len,
                           const int32_t* table, int32_t stride,
                           int32_t gap_open, int32_t gap_extend) {
  const int32_t nx = sx_len + 1;
  const int64_t og_e = gap_open + gap_extend;

  std::vector<int64_t> P0(nx), Q0(nx), D0(nx), P1(nx), Q1(nx), D1(nx);
  for (int32_t j = 0; j < nx; ++j) {
    P0[j] = kNegInf;
    Q0[j] = 0;
    D0[j] = 0;
  }
  int64_t best = 0;
  for (int32_t i = 1; i <= sy_len; ++i) {
    P1[0] = 0;
    Q1[0] = kNegInf;
    D1[0] = 0;
    const int32_t cy = sy[i - 1];
    for (int32_t j = 1; j < nx; ++j) {
      const int64_t p = std::max(sat_add(D0[j], og_e), sat_add(P0[j], gap_extend));
      const int64_t q = std::max(sat_add(D1[j - 1], og_e), sat_add(Q1[j - 1], gap_extend));
      const int64_t sub = table[stride * sx[j - 1] + cy];
      const int64_t d = std::max({p, q, D0[j - 1] + sub, int64_t{0}});
      P1[j] = p;
      Q1[j] = q;
      D1[j] = d;
      if (d > best) best = d;
    }
    P0.swap(P1);
    Q0.swap(Q1);
    D0.swap(D1);
  }
  return static_cast<int32_t>(best);
}

void gx_sw_scores_batch_matrix(const uint8_t* sx_data, const int64_t* sx_off,
                               const uint8_t* sy_data, const int64_t* sy_off,
                               int64_t n_pairs, const int32_t* table,
                               int32_t stride, int32_t gap_open,
                               int32_t gap_extend, int32_t* out) {
  for (int64_t k = 0; k < n_pairs; ++k) {
    out[k] = gx_sw_score_matrix(
        sx_data + sx_off[k], static_cast<int32_t>(sx_off[k + 1] - sx_off[k]),
        sy_data + sy_off[k], static_cast<int32_t>(sy_off[k + 1] - sy_off[k]),
        table, stride, gap_open, gap_extend);
  }
}

// Residue bytes to codes through a 256-entry table in which 0 marks a byte
// outside the alphabet: out[i] = lut[in[i]]. Returns the index of the
// first byte outside it, or -1.
int64_t gx_encode(const uint8_t* __restrict in, int64_t n,
                  const uint8_t* __restrict lut, uint8_t* __restrict out) {
  // The minimum of the codes is 0 iff a byte lies outside the alphabet;
  // no branch in the loop.
  uint8_t least = 255;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t c = lut[in[i]];
    out[i] = c;
    least = c < least ? c : least;
  }
  const bool any_bad = least == 0;
  if (!any_bad) return -1;
  for (int64_t i = 0; i < n; ++i)
    if (out[i] == 0) return i;
  return -1;
}

// PairHMM forward log10 likelihood, fp64, DBL_MAX/16 scaling.
// Quality arrays are pre-decoded error probabilities (len rl).
// mm_div: mismatch-emission divisor — 1.0 reproduces the reference's
// plain-Qr emission (pairHMMmatrix.c:32-34), 3.0 the true GATK Qr/3.
double gx_pairhmm(const uint8_t* read, int32_t rl, const double* qr,
                  const double* qi, const double* qd, const double* qg,
                  const uint8_t* hap, int32_t hl, double mm_div) {
  const double init = (DBL_MAX / 16.0) / static_cast<double>(hl);
  const int32_t w = hl + 1;

  std::vector<double> M0(w, 0.0), X0(w, 0.0), Y0(w, init);
  std::vector<double> M1(w), X1(w), Y1(w);
  Y0[0] = init;  // Y row 0 is `init` across all columns (pairHMMmatrix.c:43-46)

  double lh = 0.0;
  for (int32_t i = 1; i <= rl; ++i) {
    const double e_r = qr[i - 1];
    const double t_mm = 1.0 - (qi[i - 1] + qd[i - 1]);
    const double t_gm = 1.0 - qg[i - 1];
    const double e_i = qi[i - 1];
    const double e_d = qd[i - 1];
    const double e_g = qg[i - 1];
    const uint8_t rb = read[i - 1];
    M1[0] = X1[0] = Y1[0] = 0.0;
    for (int32_t j = 1; j <= hl; ++j) {
      const uint8_t hb = hap[j - 1];
      const bool eq = (rb == hb) || rb == 'N' || hb == 'N';
      const double p = eq ? (1.0 - e_r) : e_r / mm_div;
      M1[j] = p * (t_mm * M0[j - 1] + t_gm * (X0[j - 1] + Y0[j - 1]));
      X1[j] = M0[j] * e_i + X0[j] * e_g;
      Y1[j] = M1[j - 1] * e_d + Y1[j - 1] * e_g;
    }
    M0.swap(M1);
    X0.swap(X1);
    Y0.swap(Y1);
  }
  for (int32_t j = 1; j <= hl; ++j) lh += M0[j] + X0[j];
  return log10(lh) - log10(DBL_MAX / 16.0);
}

// Batch PairHMM over pre-decoded, concatenated reads/haps and an explicit
// (read_idx, hap_idx) job list; out has n_jobs entries.
void gx_pairhmm_batch(const uint8_t* read_data, const int64_t* read_off,
                      const double* qr, const double* qi, const double* qd,
                      const double* qg, const uint8_t* hap_data,
                      const int64_t* hap_off, const int64_t* job_read,
                      const int64_t* job_hap, int64_t n_jobs, double* out,
                      double mm_div) {
  for (int64_t k = 0; k < n_jobs; ++k) {
    const int64_t r = job_read[k], h = job_hap[k];
    const int64_t ro = read_off[r];
    out[k] = gx_pairhmm(read_data + ro,
                        static_cast<int32_t>(read_off[r + 1] - ro), qr + ro,
                        qi + ro, qd + ro, qg + ro, hap_data + hap_off[h],
                        static_cast<int32_t>(hap_off[h + 1] - hap_off[h]),
                        mm_div);
  }
}

// ---------------------------------------------------------------------------
// Packing fills — the native data-loader path (the reference's host mains
// are C; our engine's only per-pair host loop is this fill, so it is
// native too). Outputs are the kernels' TILE layout (NT, rows, 128)
// directly: slot r writes lane r%128 of tile r/128 with a 128-byte row
// stride. Consecutive slots hit the same tile slab (sx ~66 KB, sy a few
// hundred KB), so the strided stores stay L2-resident — this replaced a
// slot-major fill + numpy transposed copy that cost 10.6 s (~90 MB/s)
// on a 400k-pair workload.
// ---------------------------------------------------------------------------

// order[r] = original pair index packed into slot r (r < n).
void gx_pack_sw_fill(const uint8_t* sx_data, const int64_t* sx_off,
                     const uint8_t* sy_data, const int64_t* sy_off,
                     const int64_t* order, int64_t n, int64_t nxs,
                     int64_t nds, int64_t anchor, int8_t* sx_out,
                     int8_t* sy_out, int32_t* nx, int32_t* ny) {
  for (int64_t r = 0; r < n; ++r) {
    const int64_t g = order[r];
    const int64_t t = r >> 7, lane = r & 127;
    const int64_t lx = sx_off[g + 1] - sx_off[g];
    const int64_t ly = sy_off[g + 1] - sy_off[g];
    const uint8_t* sx = sx_data + sx_off[g];
    int8_t* sxp = sx_out + t * nxs * 128 + lane;
    for (int64_t k = 0; k < lx; ++k) sxp[(k + 1) * 128] = (int8_t)sx[k];
    // reversed stream: buf[anchor-1-k] = sy[k]
    const uint8_t* sy = sy_data + sy_off[g];
    int8_t* syp = sy_out + t * nds * 128 + lane;
    for (int64_t k = 0; k < ly; ++k) syp[(anchor - 1 - k) * 128] = (int8_t)sy[k];
    nx[r] = static_cast<int32_t>(lx) + 1;
    ny[r] = static_cast<int32_t>(ly) + 1;
  }
}

// PairHMM fill: raw phred+33 quality bytes decoded through a 256-entry
// LUT; jobs = (read index, hap index) cross-product entries, order[r] =
// job packed into slot r.
void gx_pack_phmm_fill(const uint8_t* read_data, const int64_t* read_off,
                       const uint8_t* bq, const uint8_t* iq,
                       const uint8_t* dq, const uint8_t* gq,
                       const uint8_t* hap_data, const int64_t* hap_off,
                       const int64_t* job_r, const int64_t* job_h,
                       const int64_t* order, int64_t n, int64_t nxs,
                       int64_t nds, int64_t anchor, double phred_offset,
                       int8_t* rchar, float* qr, float* mmv, float* gapm,
                       float* qi, float* qd, float* qg, int8_t* hap,
                       int32_t* rl, int32_t* hl) {
  double tab[256];
  for (int c = 0; c < 256; ++c)
    tab[c] = pow(10.0, -((double)c - phred_offset) / 10.0);
  for (int64_t r = 0; r < n; ++r) {
    const int64_t g = order[r];
    const int64_t t = r >> 7, lane = r & 127;
    const int64_t ri = job_r[g], hi = job_h[g];
    const int64_t ro = read_off[ri];
    const int64_t L = read_off[ri + 1] - ro;
    int8_t* rcp = rchar + t * nxs * 128 + lane;
    const uint8_t* rb = read_data + ro;
    for (int64_t k = 0; k < L; ++k) rcp[(k + 1) * 128] = (int8_t)rb[k];
    const int64_t fb = t * nxs * 128 + lane;  // float tile base
    for (int64_t k = 0; k < L; ++k) {
      const double Qr = tab[bq[ro + k]];
      const double Qi = tab[iq[ro + k]];
      const double Qd = tab[dq[ro + k]];
      const double Qg = tab[gq[ro + k]];
      const int64_t o = fb + (k + 1) * 128;
      qr[o] = static_cast<float>(Qr);
      mmv[o] = static_cast<float>(1.0 - (Qi + Qd));
      gapm[o] = static_cast<float>(1.0 - Qg);
      qi[o] = static_cast<float>(Qi);
      qd[o] = static_cast<float>(Qd);
      qg[o] = static_cast<float>(Qg);
    }
    const int64_t ho = hap_off[hi];
    const int64_t H = hap_off[hi + 1] - ho;
    int8_t* hp = hap + t * nds * 128 + lane;
    for (int64_t k = 0; k < H; ++k) hp[(anchor - 1 - k) * 128] = (int8_t)hap_data[ho + k];
    rl[r] = static_cast<int32_t>(L);
    hl[r] = static_cast<int32_t>(H);
  }
}

// Byte-qual fill: identical tile layout to gx_pack_phmm_fill but ships
// the RAW phred+33 quality bytes (qb: (4, NXs, 128) int8 planes per
// tile: base/ins/del/gcp) instead of six decoded fp32 tables — the
// engine expands them on DEVICE through a 256-entry LUT
// (pairhmm_pallas.expand_byte_quals), cutting host->device bytes ~5.6x
// per batch. No phred decode here at all: pure strided byte scatter.
void gx_pack_phmm_fill_bytes(
    const uint8_t* read_data, const int64_t* read_off, const uint8_t* bq,
    const uint8_t* iq, const uint8_t* dq, const uint8_t* gq,
    const uint8_t* hap_data, const int64_t* hap_off, const int64_t* job_r,
    const int64_t* job_h, const int64_t* order, int64_t n, int64_t nxs,
    int64_t nds, int64_t anchor, int8_t* rchar, int8_t* qb, int8_t* hap,
    int32_t* rl, int32_t* hl) {
  for (int64_t r = 0; r < n; ++r) {
    const int64_t g = order[r];
    const int64_t t = r >> 7, lane = r & 127;
    const int64_t ri = job_r[g], hi = job_h[g];
    const int64_t ro = read_off[ri];
    const int64_t L = read_off[ri + 1] - ro;
    int8_t* rcp = rchar + t * nxs * 128 + lane;
    const uint8_t* rb = read_data + ro;
    for (int64_t k = 0; k < L; ++k) rcp[(k + 1) * 128] = (int8_t)rb[k];
    int8_t* qbp = qb + t * 4 * nxs * 128 + lane;
    const uint8_t* plane[4] = {bq + ro, iq + ro, dq + ro, gq + ro};
    for (int p = 0; p < 4; ++p) {
      int8_t* dst = qbp + p * nxs * 128;
      const uint8_t* src = plane[p];
      for (int64_t k = 0; k < L; ++k) dst[(k + 1) * 128] = (int8_t)src[k];
    }
    const int64_t ho = hap_off[hi];
    const int64_t H = hap_off[hi + 1] - ho;
    int8_t* hp = hap + t * nds * 128 + lane;
    for (int64_t k = 0; k < H; ++k)
      hp[(anchor - 1 - k) * 128] = (int8_t)hap_data[ho + k];
    rl[r] = static_cast<int32_t>(L);
    hl[r] = static_cast<int32_t>(H);
  }
}

// Factored fill: the unique-row layout of a factored pack (PairHMMPacked
// rchar_u/qb_u/hap_u), one row per unique read u_r[k] and haplotype
// u_h[k], bases and haplotype bytes written through code[] (the identity
// for raw codes, the match-bitmask table for bitmask codes), quality
// bytes raw. The caller fills the pads (code[] of each pad byte, qb_u
// zeros) and the extra all-pad row past the last unique row.
void gx_pack_phmm_fill_factored(
    const uint8_t* read_data, const int64_t* read_off, const uint8_t* bq,
    const uint8_t* iq, const uint8_t* dq, const uint8_t* gq,
    const uint8_t* hap_data, const int64_t* hap_off, const int64_t* u_r,
    int64_t nru, const int64_t* u_h, int64_t nhu, int64_t nxs, int64_t nds,
    int64_t anchor, const int8_t* code, int8_t* rchar_u, int8_t* qb_u,
    int8_t* hap_u) {
  for (int64_t k = 0; k < nru; ++k) {
    const int64_t ro = read_off[u_r[k]];
    const int64_t L = read_off[u_r[k] + 1] - ro;
    int8_t* rc = rchar_u + k * nxs + 1;
    for (int64_t i = 0; i < L; ++i) rc[i] = code[read_data[ro + i]];
    int8_t* qrow = qb_u + k * 4 * nxs + 1;
    const uint8_t* plane[4] = {bq + ro, iq + ro, dq + ro, gq + ro};
    for (int p = 0; p < 4; ++p) memcpy(qrow + p * nxs, plane[p], L);
  }
  for (int64_t k = 0; k < nhu; ++k) {
    const int64_t ho = hap_off[u_h[k]];
    const int64_t H = hap_off[u_h[k] + 1] - ho;
    int8_t* hp = hap_u + k * nds + anchor - 1;
    for (int64_t i = 0; i < H; ++i) hp[-i] = code[hap_data[ho + i]];
  }
}

// ok_row[k] = 1 when every byte of row k (data[off[k], off[k + 1])) is
// one that ok[] admits, else 0.
void gx_rows_ok(const uint8_t* data, const int64_t* off, int64_t n,
                const uint8_t* ok, uint8_t* ok_row) {
  for (int64_t k = 0; k < n; ++k) {
    uint8_t all = 1;
    for (int64_t i = off[k]; i < off[k + 1]; ++i) all &= ok[data[i]];
    ok_row[k] = all;
  }
}

}  // extern "C"
