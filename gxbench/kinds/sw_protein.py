"""Protein database search: one call of MMseqs2's alignment stage, each
query against its prefilter hits, every pair scored by local SW (SWIPE,
CUDASW++ and MMseqs2 search UniProtKB/Swiss-Prot so).

Parameters of the mix (``traffic/<mix>.json``):

``queries``, ``hits``  queries a call, and prefilter hits a query: MMseqs2's
                       ``--max-seqs`` default is 300.
``len_median``, ``len_sigma``, ``len_clip``
                       protein lengths: the n quantile midpoints of a
                       log-normal of that median and sigma, clipped to
                       [lo, hi], one set for the queries (n = queries) and
                       one for the hits (n = queries x hits); hits go to
                       queries by a fixed permutation (seed 0), as
                       ``generate.sw_lengths`` pairs lengths. Median 300,
                       sigma 0.6: a mean of about 358 residues, near
                       Swiss-Prot's roughly 360 (an assumed shape).
``homolog_share``      the share of a query's hits that are homologs of it,
                       at a fixed pattern and not by the seed (0.5: hits 0,
                       2, 4, ...); the others are unrelated draws from the
                       composition.
``identity``           [lo, hi], spread evenly over a query's homologs: each
                       residue of the query is replaced, with probability
                       1 - identity, by a draw from the composition, so
                       that a share identity + (1 - identity) * sum(f^2) of
                       the positions stays the same.
``indel_rate``, ``indel_mean``
                       insertion and deletion events a residue (each event
                       one or the other, with even odds), their lengths
                       geometric with that mean. The homologous core is
                       then cut, or flanked with random residues, to the
                       hit's length, at an offset drawn from the seed.

Residues are the 20 standard amino acids, upper case, at UniProtKB/
Swiss-Prot's composition (``COMPOSITION``): no X, B, Z, ``*``, newline or
code byte 0 or 1. A pair is x, the shorter of query and hit (the query on
a tie), against y, the longer. The seed draws the residues, the
substitutions, the indels and offsets, and the order of the queries, each
with its hits; every seed scores the same (len x, len y) pairs.

Of these, ``hits`` and the composition have a source. The length shape,
the queries a call, the homolog share, the identities and the indels are
the mix's own assumptions, and a mix names each such parameter under its
``assumed`` key; a cell may run no mix whose lengths are assumed.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

from gxbench import generate

# Amino acid composition of UniProtKB/Swiss-Prot, in percent (the release
# statistics, https://web.expasy.org/docs/relnotes/relstat.html).
COMPOSITION = {"L": 9.65, "A": 8.25, "G": 7.07, "V": 6.86, "E": 6.72,
               "S": 6.64, "I": 5.91, "K": 5.80, "R": 5.53, "D": 5.46,
               "T": 5.35, "P": 4.74, "N": 4.06, "Q": 3.93, "F": 3.86,
               "Y": 2.92, "M": 2.41, "H": 2.27, "C": 1.38, "W": 1.10}
LETTERS = np.frombuffer("".join(COMPOSITION).encode(), np.uint8)
FREQ = np.array(list(COMPOSITION.values())) / sum(COMPOSITION.values())
# A residue a 16-bit draw: each letter's share of the table is its
# frequency to within 2^-16.
_TABLE = LETTERS[np.searchsorted(np.cumsum(FREQ),
                                 (np.arange(1 << 16) + 0.5) / (1 << 16))]


def residues(rng, n: int) -> np.ndarray:
    """n residues drawn independently at the composition."""
    return _TABLE[rng.integers(0, 1 << 16, n, dtype=np.uint16)]


def lengths(median: float, sigma: float, clip, n: int) -> np.ndarray:
    """The n quantile midpoints of the log-normal, rounded and clipped."""
    z = np.array([NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)),
                   *clip).astype(np.int64)


def homologs(hits: int, share: float) -> np.ndarray:
    """Which of a query's hits are its homologs: a fixed, even pattern
    that starts at hit 0."""
    j = np.arange(hits)
    return np.ceil((j + 1) * share) > np.ceil(j * share)


def _segments(lens):
    """(segment of each element, its place in the segment, segment starts)
    of segments of these lengths laid end to end."""
    starts = np.cumsum(lens) - lens
    seg = np.repeat(np.arange(len(lens)), lens)
    return seg, np.arange(int(np.sum(lens))) - starts[seg], starts


def _indels(core, seg, place, n_seg, rng, rate, mean):
    """The cores with insertion and deletion events, laid end to end;
    (residues, each core's new length). A deletion stops at its core's
    end; an insertion puts its residues before the residue it is at."""
    n = len(core)
    at = np.flatnonzero(rng.random(n) < rate)
    ins = rng.random(len(at)) < 0.5
    size = rng.geometric(1.0 / mean, len(at))
    seg_end = (at - place[at] + np.bincount(seg, minlength=n_seg)[seg[at]])
    cut = np.zeros(n + 1, np.int64)
    np.add.at(cut, at[~ins], 1)
    np.add.at(cut, np.minimum(at[~ins] + size[~ins], seg_end[~ins]), -1)
    keep = np.cumsum(cut[:n]) == 0
    before = np.zeros(n, np.int64)
    before[at[ins]] = size[ins]
    emit = before + keep
    src = np.repeat(np.arange(n), emit)
    rank = np.arange(len(src)) - np.repeat(np.cumsum(emit) - emit, emit)
    own = rank == before[src]
    out = np.empty(len(src), np.uint8)
    out[own] = core[src[own]]
    out[~own] = residues(rng, int((~own).sum()))
    return out, np.bincount(seg[src], minlength=n_seg)


def make(mix: dict, rng) -> generate.SWPairs:
    """One call's pairs of the mix, drawn from rng."""
    nq, nh = int(mix["queries"]), int(mix["hits"])
    shape = (float(mix["len_median"]), float(mix["len_sigma"]),
             [int(v) for v in mix["len_clip"]])
    lq = lengths(*shape, nq)
    lh = lengths(*shape, nq * nh)[
        np.random.default_rng(0).permutation(nq * nh)].reshape(nq, nh)
    hom = homologs(nh, float(mix["homolog_share"]))
    lo, hi = (float(v) for v in mix["identity"])
    n_hom = int(hom.sum())
    ident = lo + (np.arange(n_hom) + 0.5) * (hi - lo) / n_hom
    order = rng.permutation(nq)
    lq, lh = lq[order], lh[order]

    q_all = residues(rng, int(lq.sum()))
    q_start = np.cumsum(lq) - lq
    # Homologs, query-major: each starts as its query's residues.
    hq = np.repeat(np.arange(nq), n_hom)
    h_len = lh[:, hom].ravel()
    h_id = np.tile(ident, nq)
    seg, place, _ = _segments(lq[hq])
    core = q_all[q_start[hq][seg] + place]
    sub = np.flatnonzero(rng.random(len(core)) < (1.0 - h_id)[seg])
    core[sub] = residues(rng, len(sub))
    core_len = lq[hq]
    if float(mix["indel_rate"]) > 0:
        core, core_len = _indels(core, seg, place, len(hq), rng,
                                 float(mix["indel_rate"]),
                                 float(mix["indel_mean"]))

    # Every hit, in (query, hit) order, drawn as an unrelated one; each
    # homolog's core then written over its hit, cut or flanked to the
    # hit's length at an offset from the seed.
    flat = lh.ravel()
    hits = residues(rng, int(flat.sum()))
    slack = core_len - h_len
    off = rng.integers(0, np.abs(slack) + 1)
    shift = np.where(slack >= 0, off, -off)
    seg, place, _ = _segments(h_len)
    ci = place + shift[seg]
    inside = (ci >= 0) & (ci < core_len[seg])
    dest = (np.cumsum(flat) - flat)[np.tile(hom, nq)][seg] + place
    hits[dest[inside]] = core[
        ((np.cumsum(core_len) - core_len)[seg] + ci)[inside]]

    queries = generate.split(q_all.tobytes(), lq)
    xs, ys = [], []
    for k, h in enumerate(generate.split(hits.tobytes(), flat)):
        q = queries[k // nh]
        x, y = (q, h) if len(q) <= len(h) else (h, q)
        xs.append(x)
        ys.append(y)
    return generate.SWPairs(x=xs, y=ys)
