"""genomax_torch.Engine on the CPU: the vendored goldens, agreement with the
JAX engine in the same configuration (resident Pallas kernel in interpret
mode, strips and rotor off), the native offload, and the refusals: knobs
not ported yet, a CUDA device on a host without one, and a failed kernel
build. Scores are int32; tolerance exact."""

import os

import numpy as np
import pytest
import torch

import genomax
from genomax import native
from genomax.config import EngineConfig as JaxEngineConfig
from genomax.config import SWConfig
from genomax.engine.executor import EngineError
from genomax.io.formats import SWPair

from genomax_torch.config import EngineConfig
from genomax_torch.engine import executor
from genomax_torch.engine.executor import Engine
from genomax_torch.kernels import _build
from _torch_cpu import one_torch_thread  # noqa: F401


def _golden_scores(path):
    with open(path) as f:
        return np.array([int(line.split()[1]) for line in f], np.int32)


@pytest.mark.parametrize("name", ["sw_small", "sw_medium", "sw_quirks"])
def test_engine_matches_golden(golden_dir, name):
    eng = Engine(device="cpu")
    got = eng.sw_scores_file(os.path.join(golden_dir, name + ".in"))
    np.testing.assert_array_equal(
        got, _golden_scores(os.path.join(golden_dir, name + ".golden.out")))
    assert eng.last_stats.n_jobs == len(got) and eng.last_stats.buckets >= 1


def _ragged_pairs(seed):
    """Lengths 0-150 with the trailing '\\n', an empty pair and a tandem
    repeat, across several sublane buckets."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = [SWPair(sx=b"", sy=b""), SWPair(sx=b"\n", sy=b"A\n")]
    for lo, hi, n in ((1, 40, 20), (60, 90, 6), (120, 150, 4)):
        for _ in range(n):
            a = rng.choice(abc, int(rng.integers(lo, hi))).tobytes() + b"\n"
            b = rng.choice(abc, int(rng.integers(lo, hi))).tobytes() + b"\n"
            pairs.append(SWPair(sx=min(a, b, key=len), sy=max(a, b, key=len)))
    x = rng.choice(abc, 70).tobytes()
    pairs.append(SWPair(sx=x, sy=x + rng.choice(abc, 80).tobytes() + x))
    return pairs


@pytest.mark.parametrize("cfg", [
    SWConfig(), SWConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)],
    ids=["default", "m2x3o5e2"])
def test_engine_matches_jax_engine_resident_kernel(cfg):
    pairs = _ragged_pairs(11)
    jax_eng = genomax.Engine(
        JaxEngineConfig(backend="pallas", sw_strips=False, sw_rotor=False,
                        unroll=4),
        sw_cfg=cfg, interpret=True)
    eng = Engine(sw_cfg=cfg, device="cpu")
    got = eng.sw_scores(pairs)
    np.testing.assert_array_equal(got, jax_eng.sw_scores(pairs))
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs, cfg))
    assert eng.last_stats.buckets == jax_eng.last_stats.buckets
    assert eng.last_stats.dp_cells == jax_eng.last_stats.dp_cells


def test_engine_offloads_long_x_to_native():
    """len(sx) + 2 > max_device_len (1024) leaves the kernel for the native
    model, as on the JAX engine's non-Pallas backends."""
    rng = np.random.default_rng(2)
    abc = np.frombuffer(b"ACGT", np.uint8)
    long_x = rng.choice(abc, 1023).tobytes()
    pairs = [SWPair(sx=b"ACGT\n", sy=b"TACGTT\n"),
             SWPair(sx=long_x, sy=long_x[::-1] + long_x[:300]),
             SWPair(sx=long_x[:1022], sy=long_x[:1022])]
    eng = Engine(device="cpu")
    got = eng.sw_scores(pairs)
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs))
    assert got[2] == 1022
    assert eng.last_stats.offloaded_jobs == 1
    assert eng.last_stats.n_jobs == 3 and eng.last_stats.buckets == 2


@pytest.mark.parametrize("knob", ["sw_strips", "sw_rotor"])
def test_unported_routers_raise(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(**{knob: True})


def test_max_device_len_past_kernel_rows_raises():
    with pytest.raises(ValueError, match="1024"):
        EngineConfig(max_device_len=2048)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(device="cuda")


def test_kernel_build_failure_raises_not_cpu_scores(monkeypatch):
    """A build failure on the device path surfaces as EngineError: the
    wrapper never drops to the plain version for a tensor off the CPU."""

    def fail(*args, **kwargs):
        raise _build.BuildError("nvcc failed (simulated)")

    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    eng = Engine(device="cuda")
    # Stand-in for device tensors on a host without a card.
    monkeypatch.setattr(
        executor, "sw_bucket_to_torch",
        lambda b, device: tuple(torch.from_numpy(a).to("meta") for a in
                                (b.sx, b.sy, b.ndiag_tile)))
    with pytest.raises(EngineError) as err:
        eng.sw_scores([SWPair(sx=b"ACGT", sy=b"ACGT")])
    assert isinstance(err.value.cause, _build.BuildError)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build("sw_tile")
    assert not os.listdir(tmp_path)
