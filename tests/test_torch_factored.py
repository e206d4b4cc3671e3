"""The port's answer to the JAX config's factored_transfer, on the CPU (the
counterpart of tests/test_factored.py). The port ships every PairHMM bucket
factored and its EngineConfig has no such field
(tests/test_torch_hostlayer.py lists it with its reason): the factored
route gives the kernel the very tensors the JAX engine's unfactored route
gives its Pallas kernel, so a program that set factored_transfer=False gets
the same scores from the port. Held against the JAX package's
Engine(factored_transfer=False) in interpret mode and its make_shipper, on
an ACGTN batch and on a batch with an 'X' byte; every route of the port
packs PairHMM through Engine._phmm_pack. Inputs come from numpy seeds and
the generator."""

import ast
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genomax
from genomax.config import EngineConfig as JaxEngineConfig
from genomax.config import PairHMMConfig
from genomax.io import formats as jax_formats
from genomax.kernels import pairhmm_pallas
from genomax.pack import bucketing as jax_bucketing
from genomax.pack import nibble as jax_nibble

from _torch_cpu import one_torch_thread  # noqa: F401
from genomax_torch.bench import sweep
from genomax_torch.config import EngineConfig
from genomax_torch.dist.engine import ShardedEngine
from genomax_torch.dist.mesh import make_mesh
from genomax_torch.engine.executor import Engine
from genomax_torch.io import formats
from genomax_torch.io.generator import generate_pairhmm_batch
from genomax_torch.pack import bucketing, phmm_bucket_to_torch

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "genomax_torch")
CPU = torch.device("cpu")


def _weird(seed, fmt=formats):
    """tests/test_factored.py's batch with an 'X' byte: the bitmask
    translation declines, the JAX unfactored route ships its codes raw."""
    b = _as(generate_pairhmm_batch(3, 2, read_len=14, hap_len=18, seed=seed),
            fmt)
    b.reads[0].bases = b"AX" + b.reads[0].bases[2:]
    b.haplotypes[0] = b"XA" + b.haplotypes[0][2:]
    return b


def _as(batch, fmt):
    """``batch`` as a PairHMMBatch of the package of ``fmt``."""
    return fmt.PairHMMBatch(
        reads=[fmt.PairHMMRead(**dataclasses.asdict(r)) for r in batch.reads],
        haplotypes=list(batch.haplotypes))


def _batches(which, fmt=formats):
    """ACGTN: two batches of ragged shapes (reads of 23 and 30bp, one drawn
    from its haplotypes); weird: one batch with an 'X' byte."""
    if which == "weird":
        return [_weird(6, fmt)]
    return [_as(generate_pairhmm_batch(5, 3, read_len=23, hap_len=31, seed=5),
                fmt),
            _as(generate_pairhmm_batch(2, 3, read_len=30, hap_len=21, seed=9,
                                       from_haps=True), fmt)]


def test_engine_config_has_no_factored_transfer():
    """The JAX knob is refused, not ignored: a program that sets it learns
    that the port always ships factored."""
    assert "factored_transfer" not in {
        f.name for f in dataclasses.fields(EngineConfig)}
    with pytest.raises(TypeError, match="factored_transfer"):
        EngineConfig(factored_transfer=False)


@pytest.mark.parametrize("gatk", [False, True], ids=["reference", "gatk"])
@pytest.mark.parametrize("which", ["acgtn", "weird"])
def test_engine_matches_jax_unfactored_route(which, gatk):
    """Within 1e-5 of the JAX engine's unfactored route on its Pallas
    backend in interpret mode (the tolerance of
    test_torch_pairhmm_engine.py: the same fp32 formulation), with the same
    fallbacks."""
    jax_eng = genomax.Engine(
        JaxEngineConfig(backend="pallas", factored_transfer=False),
        phmm_cfg=PairHMMConfig(gatk_emission=gatk), interpret=True)
    want = jax_eng.pairhmm(_batches(which, jax_formats))
    eng = Engine(phmm_cfg=PairHMMConfig(gatk_emission=gatk), device="cpu")
    np.testing.assert_allclose(eng.pairhmm(_batches(which)), want, rtol=0,
                               atol=1e-5)
    assert eng.last_stats.fallback_jobs == jax_eng.last_stats.fallback_jobs


def _jax_unfactored_tensors(b, offset=33.0):
    """The ten arrays the JAX engine's _phmm_bucket gives its Pallas kernel
    for an unfactored byte-quals bucket ``b`` (nibble's shipper, four-bit
    where the codes are bitmasks; pairhmm_pallas's expansion)."""
    ship = jax_nibble.make_shipper(jnp.asarray, four_bit=b.bitmask_codes)
    quals = pairhmm_pallas.expand_byte_quals(jnp.asarray(b.qb), offset)
    return [np.asarray(a) for a in (ship(b.rchar), *quals, ship(b.hap),
                                    b.meta, b.ndiag_tile)]


@pytest.mark.parametrize("which", ["acgtn", "weird"])
def test_factored_tensors_equal_jax_unfactored_route(which):
    """phmm_bucket_to_torch on the port's factored pack == the ten tensors
    the JAX unfactored route ships for the same batch, bit for bit, each
    contiguous with the kernel's dtype: the kernel cannot tell the routes
    apart."""
    kw = dict(byte_quals=True, bitmask_codes=True)
    ours, _ = bucketing.pack_pairhmm_batches(_batches(which), factored=True,
                                             **kw)
    theirs, _ = jax_bucketing.pack_pairhmm_batches(
        _batches(which, jax_formats), **kw)
    assert len(ours) == len(theirs)
    for b, jb in zip(ours, theirs):
        assert jb.bitmask_codes == b.bitmask_codes == (which == "acgtn")
        got = phmm_bucket_to_torch(b, CPU)
        want = _jax_unfactored_tensors(jb)
        assert len(got) == len(want) == 10
        for g, w in zip(got, want):
            assert g.is_contiguous() and g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)


def _spy_pack(monkeypatch):
    """Count Engine._phmm_pack's calls; each packs factored."""
    calls = []
    real = Engine._phmm_pack

    def spy(self, batches, job_mask=None):
        out = real(self, batches, job_mask)
        assert all(b.rchar_u is not None for b in out[0])
        calls.append(len(batches))
        return out

    monkeypatch.setattr(Engine, "_phmm_pack", spy)
    return calls


@pytest.mark.parametrize("which", ["acgtn", "weird"])
def test_stream_and_sharded_engine_pack_through_the_engine(which,
                                                           monkeypatch):
    """pairhmm_stream and a one-rank ShardedEngine pack through
    Engine._phmm_pack, one call a chunk, and equal Engine exactly."""
    batches = _batches(which) * 2
    want = Engine(device="cpu").pairhmm(batches)
    calls = _spy_pack(monkeypatch)
    eng = Engine(device="cpu")
    np.testing.assert_array_equal(eng.pairhmm_stream(batches, 1), want)
    assert calls == [1] * len(batches)
    calls.clear()
    dist = ShardedEngine(make_mesh(device="cpu"), EngineConfig())
    np.testing.assert_array_equal(dist.pairhmm(batches), want)
    assert calls == [len(batches)]


def test_sweep_packs_through_the_engine(monkeypatch):
    """The sweep's PairHMM launches pack through Engine._phmm_pack and give
    the engine's scores."""
    batches = _batches("acgtn")
    eng = Engine(device="cpu")
    want = eng.pairhmm(batches)
    calls = _spy_pack(monkeypatch)
    runs, n, _ = sweep.phmm_launches(eng, batches)
    assert calls == [len(batches)]
    buckets, _ = eng._phmm_pack(batches)
    got = bucketing.unpack_scores(
        buckets, [launch().numpy() for launch in runs], n, np.float32)
    np.testing.assert_array_equal(got, want)


def test_one_pack_call_in_the_port():
    """Every route packs PairHMM through Engine._phmm_pack: no module of the
    port but the executor calls pack_pairhmm_batches (the pack's own module
    defines it), read from each module's syntax tree."""
    callers = []
    for root, _, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            rel = os.path.relpath(path, PORT)
            if rel == os.path.join("pack", "bucketing.py"):
                continue
            with open(path) as f:
                tree = ast.parse(f.read())
            if any(isinstance(n, ast.Call) and "pack_pairhmm_batches" in {
                    getattr(n.func, "id", None), getattr(n.func, "attr", None)}
                   for n in ast.walk(tree)):
                callers.append(rel)
    assert callers == [os.path.join("engine", "executor.py")]
