"""The port's oracle (``genomax_torch.kernels.oracle``, numpy one
anti-diagonal at a time) against the JAX package's per-cell oracle
(``genomax.kernels.oracle``) on seeded cases: SW exact, PairHMM bitwise
equal in fp64 (each cell's expression and the likelihood's sequential sum
keep the JAX order, so no tolerance is needed)."""

import time

import numpy as np
import pytest

from genomax.config import PairHMMConfig as JaxPairHMMConfig
from genomax.config import SWConfig as JaxSWConfig
from genomax.io.formats import PairHMMBatch as JaxBatch
from genomax.io.formats import PairHMMRead as JaxRead
from genomax.io.formats import SWPair as JaxSWPair
from genomax.kernels import oracle as jax_oracle

from genomax_torch.config import PairHMMConfig, SWConfig
from genomax_torch.io.formats import PairHMMBatch, PairHMMRead, SWPair
from genomax_torch.kernels import oracle

ACGT = np.frombuffer(b"ATGC", np.uint8)
ACGTN = np.frombuffer(b"ATGCN", np.uint8)


def _seq(seed, n, abc=ACGT):
    return np.random.default_rng(seed).choice(abc, n).tobytes()


# (sx, sy): 'N', the '\n' quirk, empty and one-base sequences, sx longer
# than sy (the oracle takes them as given), a tandem repeat.
SW_CASES = {
    "empty-both": (b"", b""),
    "empty-x": (b"", b"ACGT"),
    "empty-y": (b"ACGT", b""),
    "one-base-match": (b"A", b"A"),
    "one-base-mismatch": (b"A", b"C"),
    "one-base-vs-long": (b"G", _seq(1, 40)),
    "newline-quirk": (b"AAAA\n", b"TTTT\n"),
    "n-alphabet": (_seq(2, 37, ACGTN) + b"\n", _seq(3, 52, ACGTN) + b"\n"),
    "x-longer-than-y": (_seq(4, 90), _seq(5, 33)),
    "tandem": (_seq(6, 30), _seq(6, 30) + _seq(7, 25) + _seq(6, 30)),
    "ragged": (_seq(8, 121), _seq(9, 140)),
}
SW_CFGS = {
    "default": dict(),
    "gap-open-0": dict(match=2, mismatch=-3, gap_open=0, gap_extend=-1),
    "m3x2o7e2": dict(match=3, mismatch=-2, gap_open=-7, gap_extend=-2),
    "m4x1o5e3": dict(match=4, mismatch=-1, gap_open=-5, gap_extend=-3),
}


@pytest.mark.parametrize("cfg", SW_CFGS.values(), ids=SW_CFGS.keys())
@pytest.mark.parametrize("case", SW_CASES.values(), ids=SW_CASES.keys())
def test_sw_score_equals_jax_oracle(case, cfg):
    sx, sy = case
    want = jax_oracle.sw_score(sx, sy, JaxSWConfig(**cfg))
    assert oracle.sw_score(sx, sy, SWConfig(**cfg)) == want


def _read(seed, n, abc=ACGT, q_lo=10, q_hi=45):
    rng = np.random.default_rng(seed)
    qs = bytes((33 + rng.integers(q_lo, q_hi, size=n)).astype(np.uint8))
    return (rng.choice(abc, n).tobytes(), qs, qs[::-1], qs,
            bytes((33 + rng.integers(5, 40, size=n)).astype(np.uint8)))


# (read fields, haplotype): rl = 1 and hl = 1, N runs, deep-decay mismatch
# pairs (the fp64 range well past fp32's), a read longer than its hap.
PH_CASES = {
    "rl1-hl1": (_read(1, 1), b"A"),
    "rl1": (_read(2, 1), _seq(3, 25)),
    "hl1": (_read(4, 20), b"G"),
    "n-runs": ((b"ACGTNNNNNACGTACGNNA",) + _read(5, 19)[1:],
               b"ACNNNNGTACGTACGTTTACGNNNA"),
    "all-mismatch": ((b"A" * 60,) + _read(6, 60)[1:], b"C" * 80),
    "read-longer": (_read(7, 70, ACGTN), _seq(8, 31, ACGTN)),
    "ragged": (_read(9, 151), _seq(10, 300)),
}


@pytest.mark.parametrize("gatk", [False, True], ids=["plain-qr", "gatk"])
@pytest.mark.parametrize("case", PH_CASES.values(), ids=PH_CASES.keys())
def test_pairhmm_log10_bitwise_equals_jax_oracle(case, gatk):
    fields, hap = case
    want = jax_oracle.pairhmm_log10(*fields, hap,
                                    JaxPairHMMConfig(gatk_emission=gatk))
    got = oracle.pairhmm_log10(*fields, hap, PairHMMConfig(gatk_emission=gatk))
    assert np.float64(got).tobytes() == np.float64(want).tobytes()


def test_pairs_and_batch_entries_equal_jax_oracle():
    """sw_scores_pairs and the read-major pairhmm_batch_log10."""
    pairs = [SWPair(sx=a, sy=b) for a, b in SW_CASES.values()]
    jpairs = [JaxSWPair(sx=a, sy=b) for a, b in SW_CASES.values()]
    got = oracle.sw_scores_pairs(pairs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_oracle.sw_scores_pairs(jpairs))
    reads = [_read(11, 40), _read(12, 7, ACGTN)]
    haps = [_seq(13, 50), _seq(14, 9, ACGTN), b"T"]
    got = oracle.pairhmm_batch_log10(PairHMMBatch(
        reads=[PairHMMRead(*r) for r in reads], haplotypes=haps))
    want = jax_oracle.pairhmm_batch_log10(JaxBatch(
        reads=[JaxRead(*r) for r in reads], haplotypes=haps))
    assert got.dtype == np.float64 and got.shape == (6,)
    assert got.tobytes() == want.tobytes()


def test_sw_score_of_the_soaks_offload_pair_is_vectorised():
    """The soak's 1,200 x 1,400 offload pair: the per-cell JAX oracle
    takes about 10 s on one CPU, the anti-diagonal sweep a small fraction
    of it (about 0.2 s)."""
    sx, sy = _seq(15, 1200), _seq(16, 1400)
    t0 = time.perf_counter()
    score = oracle.sw_score(sx, sy)
    assert time.perf_counter() - t0 < 3.0
    assert score == oracle.sw_score(sy, sx) > 0
