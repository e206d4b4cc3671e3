"""genomax_torch.Engine.pairhmm on the CPU: the vendored goldens (within
1e-4 in log10 of the fp64 reference), agreement with the JAX engine on its
Pallas backend in interpret mode (within 1e-5: the same fp32 formulation),
long reads on the long-read kernel and past max_device_diags on the native
model, the fp64 fallback, and the refusals: a CUDA device on a host without
one, a failed kernel build, a bucket that fails twice, and a failure of the
long-read kernel."""

import os

import numpy as np
import pytest
import torch

import genomax
from genomax import native
from genomax.config import EngineConfig as JaxEngineConfig
from genomax.config import PairHMMConfig
from genomax_torch.engine.executor import EngineError
from genomax.io.formats import PairHMMBatch, PairHMMRead
from genomax.io.generator import generate_pairhmm_batch

from genomax_torch.config import EngineConfig
from genomax_torch.engine import executor
from genomax_torch.engine.executor import Engine
from genomax_torch.kernels import _build
from _torch_cpu import one_torch_thread  # noqa: F401


def test_golden_test_in(golden_dir):
    eng = Engine(device="cpu")
    got = eng.pairhmm_file(os.path.join(golden_dir, "test.in"))
    with open(os.path.join(golden_dir, "test.out")) as f:
        want = float(f.read())
    assert got.shape == (1,) and abs(got[0] - want) < 1e-4
    assert eng.last_stats.n_jobs == 1 and eng.last_stats.dp_cells == 41 * 41


def test_golden_10s_in(golden_dir):
    eng = Engine(device="cpu")
    got = eng.pairhmm_file(os.path.join(golden_dir, "10s.in"))
    want = np.loadtxt(os.path.join(golden_dir, "10s.golden.out"))
    assert got.shape == want.shape == (3550,)
    assert np.abs(got - want).max() <= 1e-4
    assert eng.last_stats.fallback_jobs > 0


@pytest.mark.parametrize("gatk", [False, True], ids=["reference", "gatk"])
def test_engine_matches_jax_engine_pallas_interpret(gatk):
    batches = [generate_pairhmm_batch(3, 2, read_len=17, hap_len=25, seed=8),
               generate_pairhmm_batch(2, 3, read_len=30, hap_len=21, seed=9,
                                      from_haps=True)]
    phmm_cfg = PairHMMConfig(gatk_emission=gatk)
    jax_eng = genomax.Engine(JaxEngineConfig(backend="pallas",
                                             rescale_period=8),
                             phmm_cfg=phmm_cfg, interpret=True)
    eng = Engine(EngineConfig(rescale_period=8), phmm_cfg=phmm_cfg,
                 device="cpu")
    got = eng.pairhmm(batches)
    np.testing.assert_allclose(got, jax_eng.pairhmm(batches), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        got, native.pairhmm_native(batches, gatk_emission=gatk), atol=1e-4)
    for key in ("n_jobs", "buckets", "dp_cells", "fallback_jobs"):
        assert getattr(eng.last_stats, key) == getattr(jax_eng.last_stats, key)


def test_long_read_offloads_to_native():
    """A 1,200bp read exceeds max_device_len // 2, and with its 1,300bp
    haplotype max_device_diags too: the native fp64 model scores it."""
    big = generate_pairhmm_batch(1, 1, read_len=1200, hap_len=1300, seed=6)
    small = generate_pairhmm_batch(2, 1, read_len=12, hap_len=15, seed=7)
    eng = Engine(EngineConfig(max_device_diags=2048), device="cpu")
    got = eng.pairhmm([small, big])
    assert eng.last_stats.offloaded_jobs == 1 and eng.last_stats.n_jobs == 3
    np.testing.assert_allclose(got[:2], native.pairhmm_native([small]),
                               atol=1e-4)
    np.testing.assert_allclose(got[2], native.pairhmm_native([big])[0],
                               atol=1e-9)
    # already exact: the fallback leaves the offloaded job alone
    assert eng.last_stats.fallback_jobs == 0


def _long_batch():
    """An 80bp read over max_device_len // 2 = 32 and a 12bp one under it
    (tests/test_pallas_interpret.py's routing case)."""
    rng = np.random.default_rng(13)
    abc = np.frombuffer(b"ACGT", np.uint8)

    def read(n):
        q = bytes([35] * n)
        return PairHMMRead(bases=rng.choice(abc, n).tobytes(), base_q=q,
                           ins_q=q, del_q=q, gcp_q=q)

    small, long_rd = read(12), read(80)
    return PairHMMBatch(reads=[small, long_rd],
                        haplotypes=[rng.choice(abc, 40).tobytes()])


@pytest.mark.parametrize("gatk", [False, True], ids=["reference", "gatk"])
def test_long_read_takes_long_kernel(monkeypatch, gatk):
    """A read over max_device_len // 2 takes the long-read kernel on the
    engine's device, as on the JAX engine's Pallas backend, and agrees
    with that engine in interpret mode."""
    batch = _long_batch()
    phmm_cfg = PairHMMConfig(gatk_emission=gatk)
    seen = []
    real = executor.pairhmm_long

    def spy(jobs, *args, **kwargs):
        seen.append((len(jobs), kwargs["device"]))
        return real(jobs, *args, **kwargs)

    monkeypatch.setattr(executor, "pairhmm_long", spy)
    eng = Engine(EngineConfig(max_device_len=64,
                              phmm_fallback_threshold=None),
                 phmm_cfg=phmm_cfg, device="cpu")
    got = eng.pairhmm([batch])
    assert seen == [(1, torch.device("cpu"))]
    assert eng.last_stats.offloaded_jobs == 1 and got.dtype == np.float32
    jax_eng = genomax.Engine(JaxEngineConfig(backend="pallas",
                                             max_device_len=64,
                                             phmm_fallback_threshold=None),
                             phmm_cfg=phmm_cfg, interpret=True)
    np.testing.assert_allclose(got, jax_eng.pairhmm([batch]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        got, native.pairhmm_native([batch], gatk_emission=gatk), atol=2e-4)


def test_long_kernel_failure_raises_engine_error(monkeypatch):
    """The JAX engine reroutes a failed long-read kernel to the native
    model with a warning; the port raises, naming the stage."""

    def boom(*args, **kwargs):
        raise RuntimeError("device fault (simulated)")

    monkeypatch.setattr(executor, "pairhmm_long", boom)
    eng = Engine(EngineConfig(max_device_len=64), device="cpu")
    with pytest.raises(EngineError) as err:
        eng.pairhmm([_long_batch()])
    assert err.value.stage == "pairhmm_long"
    assert "RuntimeError" in str(err.value)


def test_fallback_exact_for_unrelated_pair():
    """An unrelated read and haplotype score far below the fp32 range; the
    engine hands the pair to the native fp64 model."""
    batch = generate_pairhmm_batch(1, 1, read_len=120, hap_len=130, seed=99)
    eng = Engine(device="cpu")
    got = eng.pairhmm([batch])
    want = native.pairhmm_native([batch])
    assert want[0] < -100
    assert eng.last_stats.fallback_jobs == 1
    np.testing.assert_allclose(got, want, atol=1e-9)
    off = Engine(EngineConfig(phmm_fallback_threshold=None), device="cpu")
    assert np.isfinite(off.pairhmm([batch])).all()
    assert off.last_stats.fallback_jobs == 0


@pytest.mark.parametrize("period", [0, 3, 64])
def test_bad_rescale_period_raises(period):
    with pytest.raises(ValueError, match="rescale_period"):
        EngineConfig(rescale_period=period)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(device="cuda")


def _meta_tensors(b, device, phred_offset):
    """Stand-in for device tensors on a host without a card."""
    cpu = _to_torch(b, torch.device("cpu"), phred_offset)
    return tuple(t.to("meta") for t in cpu)


_to_torch = executor.phmm_bucket_to_torch


def test_kernel_build_failure_raises_not_cpu_scores(monkeypatch):
    """A build failure on the device path surfaces as EngineError: the
    wrapper never drops to the plain version for a tensor off the CPU."""

    def fail(*args, **kwargs):
        raise _build.BuildError("nvcc failed (simulated)")

    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    eng = Engine(device="cuda")
    monkeypatch.setattr(executor, "phmm_bucket_to_torch", _meta_tensors)
    with pytest.raises(EngineError) as err:
        eng.pairhmm([generate_pairhmm_batch(1, 1, 8, 9)])
    assert err.value.stage == "pairhmm"
    assert isinstance(err.value.cause, _build.BuildError)


def test_bucket_failing_twice_raises_engine_error(monkeypatch):
    """The retry path names the PairHMM bucket's shape (a PairHMM bucket
    has no sx) and raises EngineError, not AttributeError."""
    calls = []

    def boom(b):
        calls.append(b)
        raise RuntimeError("device fault (simulated)")

    eng = Engine(device="cpu")
    monkeypatch.setattr(eng, "_phmm_bucket", boom)
    with pytest.raises(EngineError) as err:
        eng.pairhmm([generate_pairhmm_batch(2, 2, 10, 12, seed=1)])
    assert err.value.stage == "pairhmm" and len(calls) == 2
    b = calls[0]
    assert f"shape {b.rchar_u.shape}" in str(err.value)
    assert "RuntimeError" in str(err.value)
