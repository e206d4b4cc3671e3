"""Full-matrix numpy golden models of the port (the soak's oracle), the
counterpart of ``genomax.kernels.oracle``: the same four functions and
semantics, written apart from the kernels and from ``native/golden.cpp``.

Each matrix is swept one anti-diagonal at a time with numpy vector ops: a
cell's P and Q (PairHMM: X and Y) read the previous diagonal, its D (M) the
diagonal two back. Each cell's expression keeps the order of the JAX
oracle's per-cell loop, so PairHMM is bitwise equal to it in fp64 and SW
exact.

Semantics sources:
  SW     — antidiagonalSmithWaterman.c:82-92 (saturating -inf algebra),
           :290-306 (boundary rows), :309-335 (P/Q/D recurrence + max).
  PairHMM— pairHMMmatrix.c:32-38 (emission/transition), :41-56 (forward),
           :43-46 (Y0 init DBL_MAX/16/hap_len), :59-66 (likelihood).
"""

from __future__ import annotations

import functools

import numpy as np

from genomax_torch import scoring
from genomax_torch.config import PairHMMConfig, SWConfig
from genomax_torch.io.phred import phred_to_error_prob

# The reference's -inf (antidiagonalSmithWaterman.c), absorbing in _sat_add.
NEG_INF_I32 = -(2**31)
_DBL_MAX_16 = np.finfo(np.float64).max / 16.0


def _sat_add(a: np.ndarray, b: int) -> np.ndarray:
    """sum_with_infinity elementwise: -inf absorbing, never wraps
    (antidiagonalSmithWaterman.c:86-88)."""
    if b == NEG_INF_I32:
        return np.full_like(a, NEG_INF_I32)
    return np.where(a == NEG_INF_I32, NEG_INF_I32, a + b)


@functools.lru_cache(maxsize=None)
def _byte_table(name: str) -> np.ndarray:
    """(256, 256) int64 scores of residue bytes under matrix ``name``,
    from its letters (not the kernels' codes); the bytes outside its
    alphabet, which ``sw_score`` refuses, score 0."""
    alphabet, scores = scoring.matrix(name)
    t = np.zeros((256, 256), np.int64)
    a = np.frombuffer(alphabet, np.uint8)
    t[a[:, None], a[None, :]] = scores
    return t


def sw_score(sx: bytes, sy: bytes, cfg: SWConfig = SWConfig()) -> int:
    """Affine-gap local alignment score of one pair (sx = columns). Under
    ``cfg.matrix`` a cell scores the matrix's entry of its two residues
    (a byte outside the alphabet raises ValueError), else ``match`` for
    equal bytes and ``mismatch`` for others.

    Row i of the (len(sy)+1, len(sx)+1) matrix is index i of each
    diagonal's arrays; diagonal d holds the cells (i, d - i)."""
    nx, ny = len(sx) + 1, len(sy) + 1
    x = np.frombuffer(sx, np.uint8)
    y = np.frombuffer(sy, np.uint8)
    og_e, ge = cfg.gap_open + cfg.gap_extend, cfg.gap_extend
    table = None
    name = scoring.matrix_of(cfg)
    if name is not None:
        table = _byte_table(name)
        alpha = np.frombuffer(scoring.matrix(name)[0], np.uint8)
        for s in (x, y):
            bad = s[~np.isin(s, alpha)]
            if len(bad):
                raise ValueError(f"byte {bytes(bad[:1])!r} is not a residue "
                                 f"of {name}")
    # (P, Q, D) of diagonals d, d-1 and D of d-2; entries off a diagonal
    # are never read. Diagonal 0 is the (0,0) cell, which takes the
    # row-boundary values (the reference's order): P=-inf, Q=0, D=0.
    P, Q, D = (np.zeros(ny, np.int64) for _ in range(3))
    P1, Q1, D1 = (np.zeros(ny, np.int64) for _ in range(3))
    D2 = np.zeros(ny, np.int64)
    P1[0] = NEG_INF_I32
    best = 0
    for d in range(1, nx + ny - 1):
        if d < nx:  # first row: P=-inf, Q=0, D=0
            P[0], Q[0], D[0] = NEG_INF_I32, 0, 0
        if d < ny:  # first column: P=0, Q=-inf, D=0
            P[d], Q[d], D[d] = 0, NEG_INF_I32, 0
        lo, hi = max(1, d - nx + 1), min(ny - 1, d - 1)
        if lo <= hi:
            i, up = slice(lo, hi + 1), slice(lo - 1, hi)
            P[i] = np.maximum(_sat_add(D1[up], og_e), _sat_add(P1[up], ge))
            Q[i] = np.maximum(_sat_add(D1[i], og_e), _sat_add(Q1[i], ge))
            # y[i-1] against x[j-1], j = d - i
            yv, xv = y[lo - 1: hi], x[d - hi - 1: d - lo][::-1]
            if table is None:
                sub = np.where(yv == xv, cfg.match, cfg.mismatch)
            else:
                sub = table[xv, yv]
            D[i] = np.maximum(np.maximum(P[i], Q[i]),
                              np.maximum(D2[up] + sub, 0))
            best = max(best, int(D[i].max()))
        P, Q, D, P1, Q1, D1, D2 = P1, Q1, D2, P, Q, D, D1
    return best


def sw_scores_pairs(pairs, cfg: SWConfig = SWConfig()) -> np.ndarray:
    return np.array([sw_score(p.sx, p.sy, cfg) for p in pairs], dtype=np.int32)


def pairhmm_log10(
    read_bases: bytes,
    base_q: bytes,
    ins_q: bytes,
    del_q: bytes,
    gcp_q: bytes,
    hap: bytes,
    cfg: PairHMMConfig = PairHMMConfig(),
) -> float:
    """log10 likelihood of one read×haplotype pair, fp64 full matrix.

    Matches pairHMMmatrix.c exactly, including the plain-Qr mismatch
    emission (Qr/3 with ``gatk_emission``), 'N' matching everything and the
    DBL_MAX/16 scaling. Row i of the (rl+1, hl+1) matrices is index i of
    each diagonal's arrays."""
    rl, hl = len(read_bases), len(hap)
    qr = phred_to_error_prob(np.frombuffer(base_q, np.uint8), cfg.phred_offset)
    qi = phred_to_error_prob(np.frombuffer(ins_q, np.uint8), cfg.phred_offset)
    qd = phred_to_error_prob(np.frombuffer(del_q, np.uint8), cfg.phred_offset)
    qg = phred_to_error_prob(np.frombuffer(gcp_q, np.uint8), cfg.phred_offset)

    r = np.frombuffer(read_bases, np.uint8)
    h = np.frombuffer(hap, np.uint8)
    N = ord("N")
    mmdiv = 3.0 if cfg.gatk_emission else 1.0
    p_match, p_mismatch = 1.0 - qr, qr / mmdiv
    mmv = 1.0 - (qi + qd)
    gapm = 1.0 - qg
    with np.errstate(divide="ignore"):
        y0 = _DBL_MAX_16 / float(hl)

    # (M, X, Y) of diagonals d, d-1 and d-2; diagonal 0 is the (0,0) cell
    M, X, Y, M1, X1, Y1, M2, X2, Y2 = (np.zeros(rl + 1) for _ in range(9))
    Y1[0] = y0
    last_m, last_x = np.zeros(hl + 1), np.zeros(hl + 1)
    for d in range(1, rl + hl + 1):
        if d <= hl:  # first row: M=0, X=0, Y=DBL_MAX/16/hl
            M[0], X[0], Y[0] = 0.0, 0.0, y0
        if d <= rl:  # first column: all 0
            M[d], X[d], Y[d] = 0.0, 0.0, 0.0
        lo, hi = max(1, d - hl), min(rl, d - 1)
        if lo <= hi:
            i, up, k = slice(lo, hi + 1), slice(lo - 1, hi), slice(lo - 1, hi)
            rb, hb = r[k], h[d - hi - 1: d - lo][::-1]  # r[i-1], h[j-1]
            match = (rb == hb) | (rb == N) | (hb == N)
            p = np.where(match, p_match[k], p_mismatch[k])
            M[i] = p * (mmv[k] * M2[up] + gapm[k] * (X2[up] + Y2[up]))
            X[i] = M1[up] * qi[k] + X1[up] * qg[k]
            Y[i] = M1[i] * qd[k] + Y1[i] * qg[k]
            if lo <= rl <= hi:
                last_m[d - rl], last_x[d - rl] = M[rl], X[rl]
        M, X, Y, M1, X1, Y1, M2, X2, Y2 = M2, X2, Y2, M, X, Y, M1, X1, Y1

    # likelihood(): sum over last row j = 1..hl in order (pairHMMmatrix.c:59-66)
    l = 0.0
    for j in range(1, hl + 1):
        l += last_m[j] + last_x[j]
    with np.errstate(divide="ignore"):
        return float(np.log10(l) - np.log10(_DBL_MAX_16))


def pairhmm_batch_log10(batch, cfg: PairHMMConfig = PairHMMConfig()) -> np.ndarray:
    """Read-major (read outer, haplotype inner) per-pair log10 likelihoods,
    matching the reference output order (pairHMMmatrix.c:207-258)."""
    out = []
    for rd in batch.reads:
        for hp in batch.haplotypes:
            out.append(
                pairhmm_log10(rd.bases, rd.base_q, rd.ins_q, rd.del_q, rd.gcp_q, hp, cfg)
            )
    return np.array(out, dtype=np.float64)
