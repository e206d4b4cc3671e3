"""The port's soaks (``genomax_torch.testing.soak``) on the CPU: for one
seed they hand their engines, oracle, long-read kernel and native model
the workloads and configs the JAX soaks hand theirs (both packages' entry
points replaced by recorders in this process, no file edited); a short
soak and a shrunk deep soak pass and reach every SW route; and an SW and
a PairHMM mutant each fail at the first round that shows them, with the
round's parameters logged."""

import dataclasses
import types

import numpy as np
import pytest

import genomax
import genomax.dist.engine
import genomax.engine.executor
import genomax.kernels
import genomax.kernels.pairhmm_long
import genomax.native  # noqa: F401  (a package attribute the soak reads)
from genomax.testing import soak as jax_soak

from genomax_torch.engine.executor import Engine
from genomax_torch.kernels import sw_long
from genomax_torch.testing import soak
from _torch_cpu import one_torch_thread  # noqa: F401

SEED, DEEP_SEED = 20260817, 3_2026
FAKE_LOG10 = -10.0  # what the recorders' long-read kernel and native say


def _cfg(c):
    """A config's fields; the port's SWConfig.matrix, a field the JAX
    package's lacks, left out where it is None (equality scoring, the
    only scoring the JAX soak knows)."""
    if c is None:
        return None
    d = dataclasses.asdict(c)
    if d.get("matrix", 0) is None:
        del d["matrix"]
    return d


def _pairs(pairs):
    return [(p.sx, p.sy) for p in pairs]


def _read(r):
    return (r.bases, r.base_q, r.ins_q, r.del_q, r.gcp_q)


def _batches(batches):
    return [([_read(r) for r in b.reads], list(b.haplotypes))
            for b in batches]


def _recorders(log):
    """Stand-ins for Engine, ShardedEngine, the oracle module, the
    long-read kernel and the native module: each records its inputs and
    returns values that agree with each other, so that every round
    passes."""

    class Eng:
        def __init__(self, *args, sw_cfg=None, phmm_cfg=None, **kw):
            self.sw_cfg, self.phmm_cfg = sw_cfg, phmm_cfg
            self.last_stats = types.SimpleNamespace(fallback_jobs=0, gcups=0.0)

        def sw_scores(self, pairs):
            log.append(("engine sw", _cfg(self.sw_cfg), _pairs(pairs)))
            return np.zeros(len(pairs), np.int32)

        def pairhmm(self, batches):
            log.append(("engine phmm", _cfg(self.phmm_cfg),
                        _batches(batches)))
            return np.zeros(sum(len(b.reads) * len(b.haplotypes)
                                for b in batches))

    def sw_scores_pairs(pairs, cfg=None):
        log.append(("oracle sw", _cfg(cfg), _pairs(pairs)))
        return np.zeros(len(pairs), np.int32)

    def pairhmm_batch_log10(batch, cfg=None):
        log.append(("oracle phmm", _cfg(cfg), _batches([batch])))
        return np.zeros(len(batch.reads) * len(batch.haplotypes))

    def pairhmm_long(jobs, phred_offset, **kw):
        log.append(("long", phred_offset, [(_read(r), h) for r, h in jobs]))
        return np.full(len(jobs), FAKE_LOG10, np.float32)

    def pairhmm_native(batches, phred_offset=33.0, gatk=False):
        log.append(("native", phred_offset, _batches(batches)))
        return np.full(len(batches), FAKE_LOG10)

    oracle = types.SimpleNamespace(sw_scores_pairs=sw_scores_pairs,
                                   pairhmm_batch_log10=pairhmm_batch_log10)
    native = types.SimpleNamespace(pairhmm_native=pairhmm_native)
    return Eng, oracle, pairhmm_long, native


def _jax_log(monkeypatch, run):
    log = []
    eng, oracle, long_fn, native = _recorders(log)
    monkeypatch.setattr(genomax.engine.executor, "Engine", eng)
    monkeypatch.setattr(genomax.dist.engine, "ShardedEngine", eng)
    monkeypatch.setattr(genomax.kernels, "oracle", oracle)
    monkeypatch.setattr(genomax.kernels.pairhmm_long, "pairhmm_long",
                        long_fn)
    monkeypatch.setattr(genomax, "native", native)
    assert run(jax_soak) == 0
    return log


def _port_log(monkeypatch, run):
    log = []
    eng, oracle, long_fn, native = _recorders(log)
    for name, value in (("Engine", eng), ("ShardedEngine", eng),
                        ("oracle", oracle), ("pairhmm_long", long_fn),
                        ("native", native)):
        monkeypatch.setattr(soak, name, value)
    assert run(soak) == 0
    return log


def test_soak_hands_the_jax_soaks_workloads(monkeypatch):
    quiet = dict(log=lambda *_: None)
    want = _jax_log(monkeypatch, lambda m: m.run_soak(
        rounds=24, seed=SEED, backend="lax", **quiet))
    got = _port_log(monkeypatch, lambda m: m.run_soak(
        rounds=24, seed=SEED, device="cpu", **quiet))
    assert len(got) == len(want) == 48
    assert [e[0] for e in got] == [e[0] for e in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"call {i}: {g[0]}"
    # the campaign's shapes: short-regime rounds, the 1,200 x 1,400
    # offload pair, custom scoring on odd rounds, GATK emission
    sw = [e for e in got if e[0] == "engine sw"]
    assert any(len(p[0]) == 1200 for e in sw for p in e[2])
    assert any(e[1] != _cfg(soak.SWConfig()) for e in sw)
    assert {e[1]["gatk_emission"] for e in got if e[0] == "engine phmm"} \
        == {False, True}


def test_deep_soak_hands_the_jax_deep_soaks_workloads(monkeypatch):
    quiet = dict(log=lambda *_: None)
    want = _jax_log(monkeypatch, lambda m: m.run_deep_soak(
        rounds=10, seed=DEEP_SEED, backend="lax", interpret=True, **quiet))
    got = _port_log(monkeypatch, lambda m: m.run_deep_soak(
        rounds=10, seed=DEEP_SEED, device="cpu", **quiet))
    assert len(got) == len(want) == 30
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"call {i}: {g[0]}"
    longs = [e[2][0] for e in got if e[0] == "long"]
    assert len(longs) == 5
    # the five adversary kinds: all-mismatch, N runs, near match, mixed
    # frames, scattered N
    assert longs[0][0][0] == b"A" * len(longs[0][0][0])
    assert b"N" * 100 in longs[1][0][0]


def _routes(monkeypatch):
    """Record each SW bucket's route and each long-pair tile run."""
    seen = []
    prep, tiles = Engine._sw_prep, sw_long.tile_launches

    def spy_prep(self, b):
        r = prep(self, b)
        seen.append(r[0])
        return r

    def spy_tiles(*a, **k):
        seen.append("sw_long")
        return tiles(*a, **k)

    monkeypatch.setattr(Engine, "_sw_prep", spy_prep)
    monkeypatch.setattr(sw_long, "tile_launches", spy_tiles)
    return seen


def test_short_soak_passes_and_reaches_every_sw_route(monkeypatch):
    """Three rounds of the default seed: the lane tile, strips and the
    long-pair kernel in round 0, the rotor in round 1, PairHMM in 2."""
    seen, lines = _routes(monkeypatch), []
    assert soak.run_soak(rounds=3, seed=SEED, device="cpu",
                         log=lines.append) == 0
    assert set(seen) == {"tile", "strips", "rotor", "sw_long"}
    assert lines[-1] == "SOAK PASS"
    assert [ln.split(":")[0] for ln in lines[:-1]] == [
        "round 0", "round 1", "round 2"]
    assert " PHMM " in lines[2]


def test_shrunk_deep_soak_passes():
    lines = []
    assert soak.run_deep_soak(rounds=4, seed=11, device="cpu",
                              long_rows=(300, 380), long_cols=(90, 160),
                              log=lines.append) == 0
    assert lines[-1] == "DEEP SOAK PASS"
    assert "SHARDED-1dev" in lines[1] and "PHMM-LONG" in lines[2]


def test_sw_mutant_fails_at_its_first_round(monkeypatch):
    """A rotor that scores every pair one too high: round 0 has no rotor
    bucket and passes; round 1, the first short-regime round, fails and
    logs its parameters."""
    prep = Engine._sw_prep

    def mutant(self, b):
        route, launch = prep(self, b)
        if route == "rotor":
            return route, lambda: launch() + 1
        return route, launch

    monkeypatch.setattr(Engine, "_sw_prep", mutant)
    lines = []
    assert soak.run_soak(rounds=6, seed=SEED, device="cpu",
                         log=lines.append) == 1
    assert len(lines) == 2 and lines[0].startswith("round 0: OK")
    assert lines[1].startswith("round 1: SW n=10 len[86,101] "
                               "cfg=(2,-4,-3,-2) MISMATCH at ")


def test_pairhmm_mutant_fails_at_its_first_round(monkeypatch):
    """A PairHMM kernel 1e-3 off in log10: round 2's four jobs all fall
    back to fp64 (below -45), which hides it; round 5 keeps one job on the
    kernel and fails, logging its parameters."""
    prep = Engine._phmm_prep

    def mutant(self, b):
        launch = prep(self, b)
        return lambda: launch() + 1e-3

    monkeypatch.setattr(Engine, "_phmm_prep", mutant)
    lines = []
    assert soak.run_soak(rounds=6, seed=SEED, device="cpu",
                         log=lines.append) == 1
    assert [ln.split(":")[0] for ln in lines] == [
        f"round {i}" for i in range(6)]
    assert "PHMM 2x2" in lines[2] and "fb=4" in lines[2]
    assert lines[5].startswith("round 5: PHMM 2x1 rl<=86 hl<=225 gatk=True "
                               "err=1.0e-03")
    assert lines[5].endswith("FAIL")


def test_no_card_is_an_error_not_a_fallback(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.run_soak(rounds=1, seed=SEED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.run_deep_soak(rounds=1)
