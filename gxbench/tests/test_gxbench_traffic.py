"""The traffic generator: deterministic by seed, the same sizes for every
seed, the cells each cell's mix is written for."""

import numpy as np
import pytest

from gxbench import generate

MIXES = ["sw-512bp", "phmm-hc-151x300", "sw-4-8kbp", "phmm-10s-replay"]
# Cells a call: 25,000 x 512 x 512; 128 x 64 x 8 x 151 x 300; the sum
# of read x haplotype lengths of 10s.in.
CELLS = {"sw-512bp": 6_553_600_000, "phmm-hc-151x300": 2_968_780_800,
         "phmm-10s-replay": 62_380_634}


def _flat(tr):
    if isinstance(tr, generate.SWPairs):
        return tr.x + tr.y
    return [b for r in tr.regions for rd in r.reads for b in rd] + [
        h for r in tr.regions for h in r.haps]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_inputs(mix):
    m = generate.load_mix(mix)
    big = 2**31 + 12345
    assert _flat(generate.generate(m, big)) == _flat(generate.generate(m, big))


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_change_bases_not_work(mix):
    m = generate.load_mix(mix)
    a, b = generate.generate(m, 3), generate.generate(m, 4)
    assert a.cells() == b.cells() and len(a) == len(b)
    assert sorted(map(len, _flat(a))) == sorted(map(len, _flat(b)))
    assert _flat(a) != _flat(b)


@pytest.mark.parametrize("mix", sorted(CELLS))
def test_cells_a_call(mix):
    assert generate.generate(generate.load_mix(mix), 1).cells() == CELLS[mix]


def test_long_pairs_spread():
    tr = generate.generate(generate.load_mix("sw-4-8kbp"), 9)
    lx = np.array([len(s) for s in tr.x])
    ly = np.array([len(s) for s in tr.y])
    assert len(lx) == 512 and lx.min() >= 4100 and lx.max() <= 8190
    assert (ly >= lx).all() and (ly - lx).max() <= 1000
    assert abs(tr.cells() / 21.6e9 - 1) < 0.01


@pytest.mark.parametrize("mix", MIXES)
def test_sets_differ_in_bases_not_work(mix):
    """A run's input sets: the first is the seed's one set, each has the
    same sizes and cells, and no two are the same inputs."""
    m = generate.load_mix(mix)
    if mix != "phmm-10s-replay":
        m = dict(m, **({"pairs": 40} if "pairs" in m else {"regions": 3}))
    sets = generate.sets(m, 2**31 + 99, 3)
    assert _flat(sets[0]) == _flat(generate.generate(m, 2**31 + 99))
    assert len({s.cells() for s in sets}) == 1
    assert len({tuple(sorted(map(len, _flat(s)))) for s in sets}) == 1
    assert len({tuple(_flat(s)) for s in sets}) == 3


def test_long_pairs_are_related():
    """y holds a mutated copy of x: most of x's 12-mers are found in it,
    and none in an unrelated sequence of the same length."""
    m = dict(generate.load_mix("sw-4-8kbp"), pairs=4)
    tr = generate.generate(m, 7)
    for x, y in zip(tr.x, tr.y):
        kmers = {x[i:i + 12] for i in range(0, len(x) - 12, 12)}
        found = sum(k in y for k in kmers) / len(kmers)
        assert found > 0.4
    other = generate.generate(dict(m, kind="sw_pairs"), 7)
    x, y = other.x[0], other.y[0]
    assert sum(x[i:i + 12] in y for i in range(0, len(x) - 12, 12)) < 5


def test_haplotype_regions():
    m = dict(generate.load_mix("phmm-hc-151x300"), regions=4)
    tr = generate.generate(m, 5)
    assert len(tr) == 4 * 64 * 8
    for r in tr.regions:
        assert len(r.haps) == 8 and {len(h) for h in r.haps} == {300}
        for rd in r.reads:
            assert {len(f) for f in rd} == {151}
            bq = np.frombuffer(rd[1], np.uint8) - 33
            assert bq.min() >= 20 and bq.max() <= 40
            assert set(rd[4]) == {10 + 33}
        # Reads are cut from the haplotypes: nearly every base matches one.
        best = max(sum(a == b for a, b in zip(r.reads[0][0], h[o:o + 151]))
                   for h in r.haps for o in range(150))
        assert best >= 140


def test_file_regions_are_the_file():
    tr = generate.generate(generate.load_mix("phmm-10s-replay"), 1)
    assert len(tr.regions) == 7 and len(tr) == 3550
    rl = [len(rd[0]) for r in tr.regions for rd in r.reads]
    assert min(rl) == 10 and max(rl) == 247
