"""Plain int32 Smith-Waterman with affine gaps (Gotoh), score only, under a
substitution matrix: protein database search's scoring (BLAST+ blastp,
MMseqs2, SWIPE, CUDASW++).

The recurrence of ``sw_gotoh.py`` with the match / mismatch score replaced
by the matrix's entry of the two residues, g(k) = open + k * extend:

    P[i][j] = max(D[i-1][j] + open + extend, P[i-1][j] + extend)
    Q[i][j] = max(D[i][j-1] + open + extend, Q[i][j-1] + extend)
    D[i][j] = max(P[i][j], Q[i][j], D[i-1][j-1] + S[x[j]][y[i]], 0)

D is 0 on row 0 and column 0, P and Q start from minus infinity, and the
score is the largest D. A block of pairs advances one anti-diagonal
d = i + j at a time over the columns that the diagonal crosses, in plain
torch integer operations, S gathered from the table by the residues'
indices. The table is this module's own copy of NCBI's file.
"""

from __future__ import annotations

import numpy as np
import torch

# NCBI's BLOSUM62 (ftp.ncbi.nlm.nih.gov/blast/matrices/BLOSUM62).
BLOSUM62 = """\
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
R -1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
N -2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
D -2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
C  0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
Q -1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
E -1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
G  0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
H -2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
I -1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
L -1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
K -1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
M -1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
F -2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
P -1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
S  1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
T  0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
W -3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
Y -2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
V  0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
B -2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
Z -1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
X  0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
* -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""
MATRICES = {"BLOSUM62": BLOSUM62}

# Minus infinity: far below any score, and far from int32's end after the
# few additions a cell makes.
NEG = -(1 << 30)
CHECK = "score_mismatches"
# The controls: saturating int8 and int16 (SWIPE's and CUDASW++'s first
# and second passes; a self-hit of a protein of a few hundred residues
# passes 127, and none of the query set's reaches 32,767), the band of bwa
# mem's width (-w 100), and the matrix replaced by its own diagonal for
# equal residues and -1 for unequal ones: what a kernel that kept the
# equality score would compute.
CONTROLS = {"int16": {"clamp": (-(1 << 15), (1 << 15) - 1)},
            "int8": {"clamp": (-(1 << 7), (1 << 7) - 1)},
            "band100": {"band": 100},
            "equality": {"equality": True}}
# Work of a diagonal's fixed part (a score of torch operations launched),
# in padded cells: the weight by which ``_blocks`` trades fewer blocks
# (fewer diagonals) against padding (cells computed past a pair's end).
DIAGONAL_CELLS = 1 << 20
# Distinct (len x, len y) groups a block may span.
SPAN = 64


def table(name: str):
    """(alphabet, scores) of matrix ``name``: the header's letters and the
    square int64 table in their order."""
    lines = [ln.split() for ln in MATRICES[name].splitlines() if ln.strip()]
    letters = "".join(lines[0])
    scores = np.array([[int(v) for v in r[1:]] for r in lines[1:]], np.int64)
    assert [r[0] for r in lines[1:]] == list(letters)
    return letters.encode(), scores


def _indices(seqs, lut):
    """Each sequence's residues as table indices; raises on a byte outside
    the alphabet."""
    out = []
    for k, s in enumerate(seqs):
        idx = lut[np.frombuffer(s, np.uint8)]
        if len(idx) and idx.min() < 0:
            raise ValueError(f"sequence {k} holds a byte outside the "
                             "matrix's alphabet")
        out.append(idx)
    return out


def _blocks(lx, ly, max_elems):
    """Index blocks of the pairs, sorted by (len x, len y): runs of
    consecutive length groups chosen by dynamic programming to cost least,
    a block costing DIAGONAL_CELLS a diagonal (len x + len y of its
    longest) and a cell for each of B * LX * LY it sweeps, with
    B * (LX + 1) at most max_elems."""
    order = np.lexsort((ly, lx))
    keys = np.stack([lx[order], ly[order]], 1)
    starts = np.flatnonzero(np.r_[True, (keys[1:] != keys[:-1]).any(1)])
    ends = np.r_[starts[1:], len(order)]
    g = len(starts)
    best = np.full(g + 1, np.inf)
    cut = np.zeros(g + 1, np.int64)
    best[0] = 0.0
    for e in range(1, g + 1):
        LX = LY = 0
        for s in range(e - 1, max(-1, e - 1 - SPAN), -1):
            LX = max(LX, int(keys[starts[s], 0]))
            LY = max(LY, int(keys[starts[s], 1]))
            b = int(ends[e - 1] - starts[s])
            if s < e - 1 and b * (LX + 1) > max_elems:
                break
            c = best[s] + DIAGONAL_CELLS * (LX + LY) + b * LX * LY
            if c < best[e]:
                best[e], cut[e] = c, s
    out, e = [], g
    while e > 0:
        s = cut[e]
        out.append(order[starts[s]:ends[e - 1]])
        e = s
    return out[::-1]


def _block_scores(xi, yi, scores, scoring, device, band, clamp, equality):
    B = len(xi)
    lx = np.array([len(s) for s in xi], np.int64)
    ly = np.array([len(s) for s in yi], np.int64)
    LX, LY = int(lx.max()), int(ly.max())
    K = LX + LY
    n = scores.shape[0]
    pad = n  # the pad index: its row and column score the table's least
    full = np.full((n + 1, n + 1), scores.min(), np.int64)
    full[:n, :n] = scores
    if equality:
        full[:n, :n] = np.where(np.eye(n, dtype=bool),
                                np.diag(scores)[:, None], -1)
    X = np.full((B, LX + 1), pad, np.int64)
    R = np.full((B, K + LX + 2), pad, np.int64)
    for b in range(B):
        X[b, 1:lx[b] + 1] = xi[b]
        # R[K - t] = y[t]: the rows a diagonal crosses, read left to right.
        R[b, K - ly[b] + 1:K + 1] = yi[b][::-1]
    S = torch.from_numpy(full.reshape(-1).astype(np.int32)).to(device)
    X = torch.from_numpy(X * (n + 1)).to(device)
    R = torch.from_numpy(R).to(device)
    tlx = torch.from_numpy(lx).to(device)[:, None]
    tly = torch.from_numpy(ly).to(device)[:, None]
    oe, e = int(scoring["gap_open"]) + int(scoring["gap_extend"]), int(
        scoring["gap_extend"])
    low = clamp[0] if clamp else NEG

    def fill(v):
        return torch.full((B, LX + 1), v, dtype=torch.int32, device=device)

    D = [fill(0), fill(0), fill(0)]  # diagonals d, d-1, d-2
    P = [fill(low), fill(low)]  # d, d-1
    Q = [fill(low), fill(low)]
    best = torch.zeros(B, dtype=torch.int32, device=device)
    cols = torch.arange(LX + 1, device=device)
    for d in range(2, LX + LY + 1):
        lo, hi = max(1, d - LY), min(LX, d - 1)
        sl, sm = slice(lo, hi + 1), slice(lo - 1, hi)
        ys_d = R[:, K - d + 1 + lo:K - d + 2 + hi]
        sub = S[X[:, sl] + ys_d]
        p = torch.maximum(D[1][:, sl] + oe, P[1][:, sl] + e)
        q = torch.maximum(D[1][:, sm] + oe, Q[1][:, sm] + e)
        h = torch.maximum(torch.maximum(p, q),
                          (D[2][:, sm] + sub).clamp_min(0))
        j = cols[sl]
        if band is not None:
            inside = ((d - 2 * j).abs() <= band)[None, :]
            h = torch.where(inside, h, 0)
            p = torch.where(inside, p, low)
            q = torch.where(inside, q, low)
        if clamp:
            h, p, q = (t.clamp(*clamp) for t in (h, p, q))
        live = (j[None, :] <= tlx) & ((d - j)[None, :] <= tly)
        best = torch.maximum(best, torch.where(live, h, 0).amax(1))
        D[0][:, sl], P[0][:, sl], Q[0][:, sl] = h, p, q
        D = [D[2], D[0], D[1]]
        P = [P[1], P[0]]
        Q = [Q[1], Q[0]]
    return best.cpu().numpy()


def scores(xs, ys, scoring, device, *, band=None, clamp=None,
           equality=False, max_elems=1 << 25) -> np.ndarray:
    """int32 local-alignment scores of xs[i] against ys[i] under the
    matrix ``scoring["matrix"]``."""
    alphabet, tab = table(scoring["matrix"])
    lut = np.full(256, -1, np.int64)
    lut[np.frombuffer(alphabet, np.uint8)] = np.arange(len(alphabet))
    xi, yi = _indices(xs, lut), _indices(ys, lut)
    lx = np.array([len(s) for s in xi], np.int64)
    ly = np.array([len(s) for s in yi], np.int64)
    out = np.zeros(len(xs), np.int32)
    idx = np.nonzero((lx > 0) & (ly > 0))[0]
    if not len(idx):
        return out
    for blk in _blocks(lx[idx], ly[idx], max_elems):
        sel = idx[blk]
        out[sel] = _block_scores([xi[i] for i in sel], [yi[i] for i in sel],
                                 tab, scoring, device, band, clamp, equality)
    return out


def expected(traffic, cfg, device) -> np.ndarray:
    return scores(traffic.x, traffic.y, cfg["sw"], device)


def control(traffic, cfg, device, which: str) -> np.ndarray:
    return scores(traffic.x, traffic.y, cfg["sw"], device, **CONTROLS[which])


def judge(outputs, exps, limit):
    """(the number of scores, over every call, that differ from the
    reference's of that call's inputs (``exps``, one a call); whether each
    call's count keeps within the limit)."""
    wrong, ok = 0, []
    for out, exp in zip(outputs, exps, strict=True):
        out = np.asarray(out)
        n = len(exp) if out.shape != exp.shape else int(
            (out.astype(np.int64) != exp).sum())
        wrong += n
        ok.append(n <= limit)
    return wrong, ok
