"""The traffic generator: deterministic by seed, the same sizes for every
seed, the cells each cell's mix is written for; the kinds that files of
``kinds/`` define."""

import hashlib

import numpy as np
import pytest

from gxbench import generate
from gxbench.kinds import sw_protein
from gxbench.reference import sw_gotoh

MIXES = ["sw-512bp", "phmm-hc-151x300", "sw-4-8kbp", "phmm-10s-replay",
         "prot-search-64x300", "sw-512bp-reads"]
# Cells a call: 25,000 x 512 x 512 (twice); 128 x 64 x 8 x 151 x 300; the
# sum of read x haplotype lengths of 10s.in; the sum of query x hit
# lengths of 64 queries against 300 hits each.
CELLS = {"sw-512bp": 6_553_600_000, "phmm-hc-151x300": 2_968_780_800,
         "phmm-10s-replay": 62_380_634, "prot-search-64x300": 2_464_242_538,
         "sw-512bp-reads": 6_553_600_000}


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
    small = {"pairs": 40, "queries": 2, "regions": 3}
    m = dict(m, **{k: v for k, v in small.items() if k in m})
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


# sha256 of the first two input sets of each built-in mix at two seeds,
# each piece of bytes after its length, as the generator made them before
# kinds could live in files: the built-in kinds may not drift.
DIGESTS = {
    ("sw-512bp", 1): "f9a3d6bd0c0cd14e8d9ba24214a16105",
    ("sw-512bp", 2**31 + 12345): "36531ba18501023a4d925c5ee069260f",
    ("sw-4-8kbp", 1): "72b897467d9106eed1637acfb8645210",
    ("sw-4-8kbp", 2**31 + 12345): "b23ae18aa41054684ec9e28a8b72954a",
    ("phmm-hc-151x300", 1): "97c8b9d5cdcaa23a1934cb228f00235e",
    ("phmm-hc-151x300", 2**31 + 12345): "244258d78275e3afbfa792af1d2540c8",
    ("phmm-10s-replay", 1): "25916c62949e2f0906660fdd15a19472",
    ("phmm-10s-replay", 2**31 + 12345): "b9d74b3d98eca438f0e76a78fd605ba8",
}


@pytest.mark.parametrize("mix,seed", sorted(DIGESTS))
def test_built_in_mixes_keep_their_bytes(mix, seed):
    h = hashlib.sha256()
    for tr in generate.sets(generate.load_mix(mix), seed, 2):
        for b in _flat(tr):
            h.update(len(b).to_bytes(8, "little"))
            h.update(b)
    assert h.hexdigest()[:32] == DIGESTS[(mix, seed)]


@pytest.mark.parametrize("kind", ["no_such_kind", "../harness", "kinds/x",
                                  "sw_protein.py", "Sw_protein", "", None])
def test_unknown_kind_raises(kind):
    m = dict(generate.load_mix("prot-search-64x300"), kind=kind)
    with pytest.raises(ValueError, match="sw_pairs.*sw_protein"):
        generate.sets(m, 1, 1)


def test_kind_files_are_found():
    assert {"sw_protein", "sw_reads"} <= set(generate.kind_files())
    assert generate.maker("sw_pairs") is generate._sw_pairs


PROT = generate.load_mix("prot-search-64x300")


@pytest.fixture(scope="module")
def protein_call():
    return generate.generate(PROT, 2**31 + 12345)


def test_protein_residues(protein_call):
    """Only the 20 standard letters, at the table's composition within 1%
    absolute over a call."""
    data = np.frombuffer(b"".join(protein_call.x + protein_call.y), np.uint8)
    counts = np.bincount(data, minlength=256)
    assert set(np.flatnonzero(counts)) == set(sw_protein.LETTERS.tolist())
    share = counts[sw_protein.LETTERS] / len(data)
    assert np.abs(share - sw_protein.FREQ).max() < 0.01
    assert set(sw_protein.COMPOSITION) == set("ACDEFGHIKLMNPQRSTVWY")


def test_protein_pairs(protein_call):
    """19,200 pairs, 150 homologs a query at hits 0, 2, 4, ...; lengths
    within the clip; x never longer than y."""
    assert len(protein_call) == 64 * 300 == 19_200
    hom = sw_protein.homologs(300, 0.5)
    assert 64 * hom.sum() == 9_600 and list(np.flatnonzero(hom[:6])) == [0, 2, 4]
    lx = np.array([len(s) for s in protein_call.x])
    ly = np.array([len(s) for s in protein_call.y])
    lo, hi = PROT["len_clip"]
    assert lx.min() >= lo and ly.max() <= hi and (lx <= ly).all()
    assert abs(np.r_[lx, ly].mean() / 358 - 1) < 0.01
    assert 1 <= (lx > 1022).sum() <= 20


def _kmer_share(x, y, k=4):
    kmers = {y[i:i + k] for i in range(len(y) - k + 1)}
    return sum(x[i:i + k] in kmers for i in range(len(x) - k + 1)) / max(
        1, len(x) - k + 1)


def test_protein_homologs_lie_at_the_pattern():
    """Pairs that share many 4-mers are homologs (even hits), the most
    identical of which share them; unrelated hits share almost none."""
    m = dict(PROT, queries=3)
    tr = generate.generate(m, 11)
    share = np.array([_kmer_share(x, y) for x, y in zip(tr.x, tr.y)])
    even = np.arange(len(tr)) % 300 % 2 == 0
    assert (share[~even] < 0.05).all()
    assert (share[even] > 0.1).sum() >= 0.3 * even.sum()


def test_protein_identity():
    """Without indels and at one length (no cut, no flank), a homolog keeps
    identity + (1 - identity) * sum(f^2) of its query's residues and an
    unrelated hit sum(f^2), each within 0.03."""
    m = dict(PROT, queries=2, hits=40, len_sigma=0, len_median=4000,
             indel_rate=0)
    tr = generate.generate(m, 2**31 + 5)
    f2 = float((sw_protein.FREQ ** 2).sum())
    lo, hi = m["identity"]
    ident = lo + (np.arange(20) + 0.5) * (hi - lo) / 20
    for k, (x, y) in enumerate(zip(tr.x, tr.y)):
        assert len(x) == len(y) == 4000
        same = (np.frombuffer(x, np.uint8) == np.frombuffer(y, np.uint8)).mean()
        j = k % 40
        want = ident[j // 2] + (1 - ident[j // 2]) * f2 if j % 2 == 0 else f2
        assert abs(same - want) < 0.03, (k, same, want)


def test_protein_indels_keep_lengths():
    """Indels change the core's length, never a hit's, and every seed
    scores the same (len x, len y) pairs."""
    m = dict(PROT, queries=2, indel_rate=0.2)
    a, b = generate.generate(m, 1), generate.generate(m, 2)
    assert sorted(zip(map(len, a.x), map(len, a.y))) == sorted(
        zip(map(len, b.x), map(len, b.y)))
    assert a.cells() == b.cells() and a.x != b.x


READS = generate.load_mix("sw-512bp-reads")


def test_reads_are_their_source_without_edits():
    """With no substitution and no indel, x lies whole in y at the flank's
    offset, and y's extra length is the flanks'."""
    m = dict(READS, pairs=300, x_len=[3, 200], y_extra=[0, 50], sub_rate=0,
             indel_rate=0)
    tr = generate.generate(m, 2**31 + 8)
    assert all(x in y for x, y in zip(tr.x, tr.y))
    assert {len(y) - len(x) for x, y in zip(tr.x, tr.y)} <= set(range(51))
    m = dict(m, y_extra=[0, 0])
    tr = generate.generate(m, 8)
    assert tr.x == tr.y


def test_reads_substitutions():
    """Without indels a copy keeps 1 - 3/4 sub_rate of the read's bases
    (a substitution draws the same base a quarter of the time), within
    0.01 over a call."""
    m = dict(READS, pairs=200, indel_rate=0, sub_rate=0.2)
    tr = generate.generate(m, 2**31 + 21)
    x = np.frombuffer(b"".join(tr.x), np.uint8)
    y = np.frombuffer(b"".join(tr.y), np.uint8)
    assert len(x) == len(y) == 200 * 512
    assert abs((x == y).mean() - 0.85) < 0.01
    assert set(np.unique(np.r_[x, y]).tobytes()) == set(b"ACGT")


def test_reads_indels_keep_lengths():
    """Indels move bases, never a copy's length: every seed scores the
    same (len x, len y) pairs; the copy still holds most of the read's
    12-mers."""
    m = dict(READS, pairs=300, x_len=[3, 200], y_extra=[0, 50], sub_rate=0,
             indel_rate=0.02)
    a, b = generate.generate(m, 1), generate.generate(m, 2)
    assert sorted(zip(map(len, a.x), map(len, a.y))) == sorted(
        zip(map(len, b.x), map(len, b.y)))
    assert a.cells() == b.cells() and a.x != b.x
    long = [(x, y) for x, y in zip(a.x, a.y) if len(x) >= 150]
    found = [sum(x[i:i + 12] in y for i in range(0, len(x) - 12, 12))
             / len(range(0, len(x) - 12, 12)) for x, y in long]
    assert np.median(found) > 0.4


def test_reads_score_past_int8():
    """The cell's reads score far past 127 against their source, so a
    scoring path narrowed to int8 fails every pair; int16 stays exact at
    this length."""
    tr = generate.generate(READS, 2**31 + 12345)
    xs, ys = tr.x[:12], tr.y[:12]
    sw = {"match": 1, "mismatch": -1, "gap_open": -3, "gap_extend": -1}
    exp = sw_gotoh.scores(xs, ys, sw, "cpu")
    assert exp.min() > 300 and exp.max() <= 512
    narrow = sw_gotoh.scores(xs, ys, sw, "cpu", **sw_gotoh.CONTROLS["int8"])
    assert (narrow != exp).all()
    wide = sw_gotoh.scores(xs, ys, sw, "cpu", **sw_gotoh.CONTROLS["int16"])
    assert (wide == exp).all()
