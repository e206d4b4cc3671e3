"""The port's long-read PairHMM (genomax_torch.kernels.pairhmm_long) on the
CPU: its pack against the JAX pack array for array, its plain version
(kernels.wavefront.phmm_long_forward) against the JAX kernel
pairhmm_long._kernel in interpret mode (within 1e-5 in log10: the same
fp32 formulation and order; the largest difference seen is 2e-6) and
against the fp64 oracle (within 2e-4, as the JAX tests hold it), and the
wrapper's refusals. The CUDA kernel is held against the plain version in
tests/test_torch_kernel.py."""

import numpy as np
import pytest
import torch

from genomax.config import PairHMMConfig
from genomax.io.formats import PairHMMRead
from genomax.kernels import oracle
from genomax.kernels import pairhmm_long as jax_long

from genomax_torch import trace
from genomax_torch.kernels import _build
from genomax_torch.kernels import pairhmm_long as torch_long
from _torch_cpu import one_torch_thread  # noqa: F401


def _jobs(seed):
    """Ragged jobs over several strips of 24 rows: random pairs, a
    max-likelihood identical pair, N runs in a read and in a haplotype, and
    a deep all-mismatch pair whose rescales cross strip boundaries
    (tests/test_pallas_interpret.py's long-read case, with the N runs)."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)

    def read(n, q=35, bases=None):
        b = bases if bases is not None else rng.choice(abc, n).tobytes()
        qs = bytes([q] * n)
        return PairHMMRead(bases=b, base_q=qs, ins_q=qs, del_q=qs, gcp_q=qs)

    jobs = [(read(n), rng.choice(abc, h).tobytes())
            for n, h in [(60, 70), (55, 40), (30, 100)]]
    same = rng.choice(abc, 64).tobytes()
    jobs.append((read(64, bases=same), same))
    jobs.append((read(50, bases=same[:20] + b"N" * 8 + same[28:50]),
                 same[:40] + b"NNNN" + same[44:]))
    jobs.append((read(64, q=40, bases=b"A" * 64), b"C" * 72))
    return jobs


@pytest.mark.parametrize("strip_w", [24, 256])
def test_pack_same_arrays_as_jax_pack(strip_w):
    jobs = _jobs(1)
    want, want_st = jax_long.pack_pairhmm_long(jobs, strip_w=strip_w)
    got, got_st = torch_long.pack_pairhmm_long(jobs, strip_w=strip_w)
    assert got_st == want_st
    for name, a in want.items():
        assert got[name].dtype == a.dtype
        np.testing.assert_array_equal(got[name], a)


@pytest.mark.parametrize("strip_w,unroll,gatk", [
    (24, 8, False), (24, 8, True), (32, 16, False)],
    ids=["w24-u8", "w24-u8-gatk", "w32-u16"])
def test_plain_version_matches_jax_interpret(strip_w, unroll, gatk):
    jobs = _jobs(11)
    mm_div = PairHMMConfig(gatk_emission=gatk).mm_div
    got = torch_long.pairhmm_long(jobs, strip_w=strip_w, unroll=unroll,
                                  mm_div=mm_div, device="cpu")
    want = jax_long.pairhmm_long(jobs, strip_w=strip_w, unroll=unroll,
                                 interpret=True, mm_div=mm_div)
    assert got.dtype == np.float32 and got.shape == (len(jobs),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if not gatk:
        ref = [oracle.pairhmm_log10(rd.bases, rd.base_q, rd.ins_q, rd.del_q,
                                    rd.gcp_q, h) for rd, h in jobs]
        np.testing.assert_allclose(got, ref, atol=2e-4)


def test_driver_scores_tiles_of_128_in_order():
    """130 jobs make two tiles; the values come back in job order."""
    rng = np.random.default_rng(4)
    abc = np.frombuffer(b"ACGT", np.uint8)
    jobs = []
    for k in range(130):
        n, h = 3 + k % 17, 5 + k % 23
        q = bytes(rng.integers(43, 74, n).astype(np.uint8))
        jobs.append((PairHMMRead(bases=rng.choice(abc, n).tobytes(),
                                 base_q=q, ins_q=q, del_q=q, gcp_q=q),
                     rng.choice(abc, h).tobytes()))
    got = torch_long.pairhmm_long(jobs, strip_w=8, unroll=8, device="cpu")
    ref = [oracle.pairhmm_log10(rd.bases, rd.base_q, rd.ins_q, rd.del_q,
                                rd.gcp_q, h) for rd, h in jobs]
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_pairhmm_long_needs_the_device():
    """The device has no default: pairhmm_long never picks the CPU by
    itself, as sw_scores_long does not."""
    with pytest.raises(TypeError, match="device"):
        torch_long.pairhmm_long(_jobs(2)[:2])
    with pytest.raises(TypeError):
        torch_long.pairhmm_long(_jobs(2)[:2], 33.0, "cpu")


def _tile(strip_w=24):
    arrays, statics = torch_long.pack_pairhmm_long(_jobs(2)[:2],
                                                   strip_w=strip_w)
    return {k: torch.from_numpy(a) for k, a in arrays.items()}, statics


def test_wrapper_rejects_bad_inputs():
    t, st = _tile()
    with pytest.raises(ValueError, match="unroll"):
        torch_long.pairhmm_long_forward(**t, **st, unroll=12)
    with pytest.raises(ValueError, match="shapes"):
        torch_long.pairhmm_long_forward(**t, **{**st, "k_strips": 9})
    with pytest.raises(ValueError, match="1 to 128"):
        torch_long.pack_pairhmm_long([])


def test_device_tensor_never_takes_plain_version(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: a failed
    build surfaces, nothing drops to the plain version."""

    def fail(*args, **kwargs):
        raise _build.BuildError("nvcc failed (simulated)")

    monkeypatch.setattr(_build, "load", fail)
    t, st = _tile()
    before = trace.counter("launches.pairhmm_long")
    with pytest.raises(_build.BuildError):
        torch_long.pairhmm_long_forward(
            **{k: v.to("meta") for k, v in t.items()}, **st)
    assert trace.counter("launches.pairhmm_long") == before
