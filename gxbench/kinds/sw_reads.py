"""Reads against the sequence they came from, every draw made over the
whole call at once: short-read and amplicon batches, where a read scores
close to its length against its source.

Parameters of the mix (``traffic/<mix>.json``), as the built-in
``sw_related`` takes them:

``pairs``, ``x_len``, ``y_extra``
                 pairs a call and their lengths, as ``generate.sw_lengths``
                 spreads them: x over [lo, hi], y = x plus an extra spread
                 over ``y_extra``; every seed scores the same (len x,
                 len y) pairs.
``sub_rate``     each base of the read's copy replaced, at that rate, by a
                 base drawn from ACGT (the same base a quarter of the time).
``indel_rate``   one-base deletions at that rate a base, and in each copy
                 as many one-base insertions of random bases, each before a
                 base of the read drawn uniformly or at the end: the copy
                 keeps the read's length.

x is the read, random ACGT; y is its copy between random flanks that make
up y's extra length, at an offset drawn from the seed. ``sw_related``
draws the same shape pair by pair in Python; here a call of 25,000 pairs
of 512bp is a few numpy calls.
"""

from __future__ import annotations

import numpy as np

from gxbench import generate

_BASES = np.frombuffer(b"ACGT", np.uint8)


def bases(rng, n: int) -> np.ndarray:
    return _BASES[rng.integers(0, 4, n, dtype=np.uint8)]


def _indels(core, seg, lens, starts, rng, rate):
    """The copies, laid end to end, with one-base deletions at ``rate`` a
    base and as many one-base insertions of random bases in each: every
    copy keeps its length."""
    gone = np.flatnonzero(rng.random(len(core), dtype=np.float32) < rate)
    d = np.bincount(seg[gone], minlength=len(lens))
    iseg = np.repeat(np.arange(len(lens)), d)
    # Insertion k goes before base at[k] of its copy (after the copy's last
    # base where at[k] is its length), counted among the bases kept.
    at = starts[iseg] + rng.integers(0, lens[iseg] + 1)
    return np.insert(np.delete(core, gone), at - np.searchsorted(gone, at),
                     bases(rng, len(at)))


def make(mix: dict, rng) -> generate.SWPairs:
    """One call's pairs of the mix, drawn from rng."""
    lx, ly = generate.sw_lengths(mix, rng)
    x = bases(rng, int(lx.sum()))
    xstart = np.cumsum(lx) - lx
    core = x.copy()
    sub = np.flatnonzero(rng.random(len(x), dtype=np.float32)
                         < float(mix["sub_rate"]))
    core[sub] = bases(rng, len(sub))
    if float(mix["indel_rate"]) > 0:
        core = _indels(core, np.repeat(np.arange(len(lx)), lx), lx, xstart,
                       rng, float(mix["indel_rate"]))
    # Each copy's left flank, then its right, as np.insert keeps them.
    extra = ly - lx
    left = rng.integers(0, extra + 1)
    at = np.repeat(np.stack([xstart, xstart + lx], 1).ravel(),
                   np.stack([left, extra - left], 1).ravel())
    y = np.insert(core, at, bases(rng, int(extra.sum())))
    return generate.SWPairs(x=generate.split(x.tobytes(), lx),
                            y=generate.split(y.tobytes(), ly))
