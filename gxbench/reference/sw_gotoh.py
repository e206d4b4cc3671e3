"""Plain int32 Smith-Waterman with affine gaps (Gotoh), score only.

The recurrence of the reference project (smithWaterman/
antidiagonalSmithWaterman.c), with g(k) = open + k * extend:

    P[i][j] = max(D[i-1][j] + open + extend, P[i-1][j] + extend)
    Q[i][j] = max(D[i][j-1] + open + extend, Q[i][j-1] + extend)
    D[i][j] = max(P[i][j], Q[i][j], D[i-1][j-1] + s(x[j], y[i]), 0)

D is 0 on row 0 and column 0, P and Q start from minus infinity, and the
score is the largest D. x runs along the columns j, y along the rows i.
A block of pairs advances one anti-diagonal d = i + j at a time, over the
columns that the diagonal crosses, in plain torch integer operations.
"""

from __future__ import annotations

import numpy as np
import torch

# Minus infinity: far below any score, and far from int32's end after the
# few additions a cell makes.
NEG = -(1 << 30)
CHECK = "score_mismatches"
# The controls: the nearest integer widths below int32, as saturating
# arithmetic (int8 is the first pass of Farrar-style striped SW), and the
# band of bwa mem's default width (-w 100), the approximation that cuts
# most of the cells. A narrow width fails only where scores pass its end:
# int8 past 127 (the related long pairs), int16 only past 32,767, beyond
# any pair of the cells here.
CONTROLS = {"int16": {"clamp": (-(1 << 15), (1 << 15) - 1)},
            "int8": {"clamp": (-(1 << 7), (1 << 7) - 1)},
            "band100": {"band": 100}}
_PAD_X, _PAD_Y = 0, 255


def _blocks(lx, ly, max_elems):
    """Index blocks of pairs sorted by length, each at most max_elems
    cells of a diagonal buffer."""
    order = np.lexsort((ly, lx))
    out, start = [], 0
    while start < len(order):
        stop = start + 1
        while stop < len(order) and (stop + 1 - start) * (
                int(lx[order[stop]]) + 1) <= max_elems:
            stop += 1
        out.append(order[start:stop])
        start = stop
    return out


def _block_scores(xs, ys, scoring, device, band, clamp):
    lx = np.array([len(s) for s in xs], np.int64)
    ly = np.array([len(s) for s in ys], np.int64)
    B, LX, LY = len(xs), int(lx.max()), int(ly.max())
    K = LX + LY
    X = np.full((B, LX + 1), _PAD_X, np.uint8)
    R = np.full((B, K + LX + 2), _PAD_Y, np.uint8)
    for b in range(B):
        X[b, 1:lx[b] + 1] = np.frombuffer(xs[b], np.uint8)
        # R[K - t] = y[t]: the rows a diagonal crosses, read left to right.
        R[b, K - ly[b] + 1:K + 1] = np.frombuffer(ys[b], np.uint8)[::-1]
    X = torch.from_numpy(X).to(device)
    R = torch.from_numpy(R).to(device)
    tlx = torch.from_numpy(lx).to(device)[:, None]
    tly = torch.from_numpy(ly).to(device)[:, None]
    match, mismatch = int(scoring["match"]), int(scoring["mismatch"])
    oe, e = int(scoring["gap_open"]) + int(scoring["gap_extend"]), int(
        scoring["gap_extend"])
    low = clamp[0] if clamp else NEG

    def full(v):
        return torch.full((B, LX + 1), v, dtype=torch.int32, device=device)

    D = [full(0), full(0), full(0)]  # diagonals d, d-1, d-2
    P = [full(low), full(low)]  # d, d-1
    Q = [full(low), full(low)]
    best = torch.zeros(B, dtype=torch.int32, device=device)
    cols = torch.arange(LX + 1, device=device)
    for d in range(2, LX + LY + 1):
        lo, hi = max(1, d - LY), min(LX, d - 1)
        sl, sm = slice(lo, hi + 1), slice(lo - 1, hi)
        ys_d = R[:, K - d + 1 + lo:K - d + 2 + hi]
        sub = torch.where(X[:, sl] == ys_d, match, mismatch).to(torch.int32)
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
           max_elems=1 << 25) -> np.ndarray:
    """int32 local-alignment scores of xs[i] against ys[i]."""
    lx = np.array([len(s) for s in xs], np.int64)
    ly = np.array([len(s) for s in ys], np.int64)
    out = np.zeros(len(xs), np.int32)
    empty = (lx == 0) | (ly == 0)
    idx = np.nonzero(~empty)[0]
    for blk in _blocks(lx[idx], ly[idx], max_elems):
        sel = idx[blk]
        out[sel] = _block_scores([xs[i] for i in sel], [ys[i] for i in sel],
                                 scoring, device, band, clamp)
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
