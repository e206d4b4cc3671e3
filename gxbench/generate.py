"""The one traffic generator of the benchmark.

A traffic mix is a data file, ``traffic/<mix>.json``: its ``kind`` picks
one of the shapes below and the rest are that shape's parameters, with the
engine ``entry`` the timed window calls (and its ``entry_args``). Inputs
come out in plain types (bytes), never in the program's: the harness hands
the program its own types built from them, and the reference reads these.

Every seed gets the same set of sizes, in another order, so that a seed
changes which bases are scored and not how much work a call is. A run
draws several such sets from its seed, one after another (``sets``), and
the timed window turns through them, so that no two calls in a row are
handed the same inputs.

Kinds:

``sw_pairs``      ``pairs`` SW pairs of random ATGC bases, x lengths spread
                  evenly over ``x_len`` = [lo, hi] and y = x plus an extra
                  spread evenly over ``y_extra``, paired by a fixed
                  permutation; no trailing newline.
``sw_related``    as ``sw_pairs``, but y is x copied with ``sub_rate``
                  substitutions and, at ``indel_rate`` each, as many
                  one-base insertions as deletions, between random
                  flanks that make up its extra length: a read or a
                  window aligned against the sequence it came from.
``phmm_regions``  ``regions`` HaplotypeCaller-shaped regions, as
                  ``genomax_torch.io.generator.generate_pairhmm_batch(
                  from_haps=True)`` makes one, vectorised: ``haps``
                  haplotypes, SNP variants (``snp_rate``) of one random
                  locus of ``hap_len`` bases, and ``reads`` reads of
                  ``read_len`` bases cut from them at random with
                  ``error_rate`` substitutions; base qualities uniform over
                  ``base_q``, insertion and deletion qualities over
                  ``indel_q``, gap continuation ``gcp_q`` (phred, +33).
``phmm_file``     the batches of a PairHMM input file under this folder
                  (``file``), in an order drawn from the seed, and the
                  reads of each batch in an order drawn from it too.

Any other kind, a name of lower-case letters, digits and ``_`` that starts
with a letter, is a file of its own, ``kinds/<kind>.py``, whose
``make(mix, rng)`` returns an :class:`SWPairs` or a :class:`PHMMRegions`
(``kinds/__init__.py``). A new shape of traffic is then a new file, and
the kinds above never change.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re

import numpy as np

from gxbench import counts

HERE = os.path.dirname(os.path.abspath(__file__))
_ATGC = np.frombuffer(b"ATGC", np.uint8)
_ACGT = np.frombuffer(b"ACGT", np.uint8)


@dataclasses.dataclass
class SWPairs:
    """SW jobs: x[i] against y[i] (x the columns, the shorter)."""

    x: list
    y: list

    def __len__(self):
        return len(self.x)

    def cells(self) -> int:
        return counts.sw_cells(map(len, self.x), map(len, self.y))

    def bound_s(self) -> float:
        return counts.sw_bound_s([len(s) for s in self.x],
                                 [len(s) for s in self.y])


@dataclasses.dataclass
class Region:
    """One PairHMM batch: every read against every haplotype. A read is
    (bases, base_q, ins_q, del_q, gcp_q), qualities as phred+33 bytes."""

    reads: list
    haps: list


@dataclasses.dataclass
class PHMMRegions:
    """PairHMM jobs, read-major within a region, regions in order."""

    regions: list

    def __len__(self):
        return sum(len(r.reads) * len(r.haps) for r in self.regions)

    def _lengths(self):
        return [([len(rd[0]) for rd in r.reads], [len(h) for h in r.haps])
                for r in self.regions]

    def cells(self) -> int:
        return counts.phmm_cells(self._lengths())

    def bound_s(self) -> float:
        return counts.phmm_bound_s(self._lengths())


def load_mix(name: str) -> dict:
    """The parameters of traffic mix ``name`` (``traffic/<name>.json``)."""
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def rng_of(seed: int) -> np.random.Generator:
    """The generator of a run's seed: any whole number, negative ones and
    those past 64 bits folded in."""
    return np.random.default_rng(int(seed) % (1 << 64))


def kind_files() -> list:
    """The kinds that files of ``kinds/`` define."""
    return sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "kinds"))
                  if _KIND.match(f[:-3]) and f.endswith(".py"))


def maker(kind):
    """The function that draws one input set of traffic kind ``kind``: a
    built-in one, or ``make`` of ``kinds/<kind>.py``."""
    if kind in _BUILT_IN:
        return _BUILT_IN[kind]
    if not (isinstance(kind, str) and _KIND.match(kind)
            and kind in kind_files()):
        raise ValueError(f"traffic kind {kind!r}: want one of "
                         f"{sorted(_BUILT_IN)}, or of the files of kinds/: "
                         f"{kind_files()}")
    return importlib.import_module("gxbench.kinds." + kind).make


def sets(mix: dict, seed: int, k: int) -> list:
    """k input sets of one call of the mix each, drawn one after another
    from the seed: the same sizes, other bases and order."""
    make = maker(mix.get("kind"))
    rng = rng_of(seed)
    out = [make(mix, rng) for _ in range(k)]
    for t in out:
        if not isinstance(t, (SWPairs, PHMMRegions)):
            raise TypeError(f"traffic kind {mix['kind']!r} made a "
                            f"{type(t).__name__}, not SWPairs or PHMMRegions")
    return out


def generate(mix: dict, seed: int):
    """The inputs of one call of the mix, from the seed: the first set."""
    return sets(mix, seed, 1)[0]


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n whole numbers spread evenly over [lo, hi]: the midpoints of n equal
    parts, the same set for every seed."""
    k = np.arange(n, dtype=np.float64)
    return lo + np.floor((k + 0.5) * (hi - lo + 1) / n).astype(np.int64)


def split(buf: bytes, lens) -> list:
    """buf cut into consecutive pieces of these lengths."""
    ends = np.cumsum(lens)
    return [buf[e - n:e] for e, n in zip(ends.tolist(), list(lens))]


def sw_lengths(mix, rng):
    n = int(mix["pairs"])
    lx = spread(*mix["x_len"], n)
    # The pairing of x and y lengths is fixed (seed 0), so every seed scores
    # the same set of (len(x), len(y)) and the same cells.
    ly = lx + spread(*mix["y_extra"], n)[np.random.default_rng(0).permutation(n)]
    order = rng.permutation(n)
    return lx[order], ly[order]


def _sw_pairs(mix, rng):
    lx, ly = sw_lengths(mix, rng)
    bases = _ATGC[rng.integers(0, 4, int(lx.sum() + ly.sum()), dtype=np.uint8)]
    buf = bases.tobytes()
    xs = split(buf[:int(lx.sum())], lx)
    ys = split(buf[int(lx.sum()):], ly)
    return SWPairs(x=xs, y=ys)


def _mutated(x, rng, sub_rate, indel_rate):
    """x with substitutions at sub_rate, then n one-base deletions and n
    one-base insertions (n ~ Binomial(len(x), indel_rate)): as long as x."""
    sub = rng.random(len(x)) < sub_rate
    y = np.where(sub, _ACGT[rng.integers(0, 4, len(x))], x)
    n = int(rng.binomial(len(x), indel_rate))
    y = np.delete(y, rng.choice(len(y), n, replace=False))
    at = np.sort(rng.integers(0, len(y) + 1, n))
    return np.insert(y, at, _ACGT[rng.integers(0, 4, n)])


def _sw_related(mix, rng):
    lx, ly = sw_lengths(mix, rng)
    sub, indel = float(mix["sub_rate"]), float(mix["indel_rate"])
    xs, ys = [], []
    for nx, ny in zip(lx.tolist(), ly.tolist()):
        x = _ATGC[rng.integers(0, 4, nx, dtype=np.uint8)]
        core = _mutated(x, rng, sub, indel)
        left = int(rng.integers(0, ny - nx + 1))
        flank = _ATGC[rng.integers(0, 4, ny - nx, dtype=np.uint8)]
        xs.append(x.tobytes())
        ys.append(np.concatenate([flank[:left], core, flank[left:]]).tobytes())
    return SWPairs(x=xs, y=ys)


def _phred(rng, lo, hi, shape):
    return (rng.integers(lo, hi + 1, shape) + 33).astype(np.uint8)


def _phmm_regions(mix, rng):
    n_reg, n_read, n_hap = int(mix["regions"]), int(mix["reads"]), int(mix["haps"])
    rl, hl = int(mix["read_len"]), int(mix["hap_len"])
    if rl > hl:
        raise ValueError(f"read_len {rl} past hap_len {hl}: reads are cut "
                         "from the haplotypes")
    locus = _ATGC[rng.integers(0, 4, (n_reg, 1, hl))]
    snp = rng.random((n_reg, n_hap, hl)) < float(mix["snp_rate"])
    haps = np.where(snp, _ACGT[rng.integers(0, 4, (n_reg, n_hap, hl))], locus)
    src = rng.integers(0, n_hap, (n_reg, n_read))
    off = rng.integers(0, hl - rl + 1, (n_reg, n_read))
    cols = off[..., None] + np.arange(rl)
    reads = haps[np.arange(n_reg)[:, None, None], src[..., None], cols]
    err = rng.random(reads.shape) < float(mix["error_rate"])
    reads = np.where(err, _ACGT[rng.integers(0, 4, reads.shape)], reads)
    bq = _phred(rng, *mix["base_q"], reads.shape)
    iq = _phred(rng, *mix["indel_q"], reads.shape)
    dq = _phred(rng, *mix["indel_q"], reads.shape)
    gq = np.full(reads.shape, int(mix["gcp_q"]) + 33, np.uint8)
    regions = []
    for r in range(n_reg):
        rows = [tuple(a[r, k].tobytes() for a in (reads, bq, iq, dq, gq))
                for k in range(n_read)]
        regions.append(Region(reads=rows,
                              haps=[h.tobytes() for h in haps[r]]))
    return PHMMRegions(regions=regions)


def parse_pairhmm(path: str) -> list:
    """Regions of a PairHMM input file (pairHMM/pairHMMmatrix.c's format:
    a "num_reads num_haplotypes" line, that many read lines of five
    fields, bases and four quality strings, then the haplotype lines)."""
    with open(path, "rb") as f:
        lines = [ln.rstrip(b"\r") for ln in f.read().split(b"\n")]
    regions, i = [], 0
    while i < len(lines):
        head = lines[i].split()
        i += 1
        if not head:
            continue
        n_read, n_hap = int(head[0]), int(head[1])
        if i + n_read + n_hap > len(lines):
            raise ValueError(f"{path}: region {len(regions)} ends early")
        reads = []
        for ln in lines[i:i + n_read]:
            fields = ln.split()
            if len(fields) != 5 or len({len(f) for f in fields}) != 1:
                raise ValueError(f"{path}: a read line of region "
                                 f"{len(regions)} is not five fields of "
                                 "one length")
            reads.append(tuple(fields))
        haps = lines[i + n_read:i + n_read + n_hap]
        i += n_read + n_hap
        regions.append(Region(reads=reads, haps=haps))
    return regions


def _phmm_file(mix, rng):
    regions = parse_pairhmm(os.path.join(HERE, mix["file"]))
    out = []
    for k in rng.permutation(len(regions)):
        r = regions[k]
        out.append(Region(reads=[r.reads[i]
                                 for i in rng.permutation(len(r.reads))],
                          haps=r.haps))
    return PHMMRegions(regions=out)


_BUILT_IN = {"sw_pairs": _sw_pairs, "sw_related": _sw_related,
             "phmm_regions": _phmm_regions, "phmm_file": _phmm_file}
_KIND = re.compile(r"[a-z][a-z0-9_]*\Z")
