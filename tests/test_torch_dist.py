"""The port's multi-device engine (genomax_torch.dist) on the CPU: gloo
process groups of 2 and 4 ranks in subprocesses (a file:// rendezvous under
tmp_path, a timeout on every collective and on every process), held against
the JAX package's local engine and its CPU mesh, modelled on
tests/test_multihost.py; and, in one process, a one-rank ShardedEngine
against the port's Engine, the mesh's refusals, the cross-device path's
failure and the CLI."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genomax.config import EngineConfig as JaxEngineConfig
from genomax.dist import xsharded as jxs
from genomax.dist.mesh import make_mesh as jax_make_mesh
from genomax.engine.executor import Engine as JaxEngine
from genomax.io.formats import SWPair as JaxSWPair
from genomax.kernels import oracle

from _phmm_cases import xshard_cases
from _torch_cpu import one_torch_thread  # noqa: F401
from genomax_torch import native
from genomax_torch.config import EngineConfig
from genomax_torch.dist import sharded, xsharded
from genomax_torch.dist.engine import ShardedEngine
from genomax_torch.dist.mesh import make_mesh
from genomax_torch.engine.executor import Engine, EngineError
from genomax_torch.io.formats import PairHMMRead, SWPair
from genomax_torch.io.generator import generate_pairhmm_batch
from genomax_torch.pack.bucketing import pack_sw_pairs, pad_tiles_to

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "_torch_dist_worker.py")
PROC_TIMEOUT_S = 300


def _multihost_jobs():
    """tests/_multihost_worker.py's jobs(). Importing that module appends
    to XLA_FLAGS and sets JAX_PLATFORMS; this process's JAX backend is up
    first and the environment is restored after."""
    jax.devices()
    saved = {k: os.environ.get(k) for k in ("XLA_FLAGS", "JAX_PLATFORMS")}
    try:
        spec = importlib.util.spec_from_file_location(
            "_multihost_worker", os.path.join(TESTS, "_multihost_worker.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.jobs()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _xshard_routing_pairs():
    """The pairs of tests/test_dist.py's test_sharded_engine_xshard_routing:
    ten short pairs, and two past max_device_len=40 with x of at least 64
    bases."""
    rng = np.random.default_rng(7)
    abc = np.frombuffer(b"ATGC", np.uint8)
    pairs = [SWPair(sx=rng.choice(abc, int(rng.integers(10, 30))).tobytes(),
                    sy=rng.choice(abc, int(rng.integers(30, 60))).tobytes())
             for _ in range(10)]
    pairs.append(SWPair(sx=rng.choice(abc, 90).tobytes(),
                        sy=rng.choice(abc, 120).tobytes()))
    pairs.append(SWPair(sx=rng.choice(abc, 100).tobytes(),
                        sy=rng.choice(abc, 100).tobytes()))
    return pairs


def _jax_pairs(pairs):
    return [JaxSWPair(sx=p.sx, sy=p.sy) for p in pairs]


def _rows(pairs):
    return [(p.sx.hex(), p.sy.hex()) for p in pairs]


def _run_ranks(tmp_path, world, mode, jobs):
    """Run the worker as `world` gloo ranks; each rank's JSON result."""
    jobs_path = tmp_path / "jobs.json"
    jobs_path.write_text(json.dumps(jobs))
    out = str(tmp_path / "out")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update({"GX_WORLD": str(world), "GX_MODE": mode,
                "GX_INIT": "file://" + str(tmp_path / "rendezvous"),
                "GX_JOBS": str(jobs_path), "GX_OUT": out,
                "OMP_NUM_THREADS": "1", "PYTHONUNBUFFERED": "1"})
    procs = []
    for rank in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env={**env, "GX_RANK": str(rank)},
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROC_TIMEOUT_S)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a {world}-rank {mode} worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    results = []
    for rank in range(world):
        with open(f"{out}.{rank}") as f:
            results.append(json.load(f))
    return results


def test_two_rank_sharded_engine(tmp_path):
    pairs, batch = _multihost_jobs()
    xs = _xshard_routing_pairs()
    jobs = {"sw": _rows(pairs), "xs": _rows(xs), "ph": {
        "reads": [[r.bases.hex(), r.base_q.hex(), r.ins_q.hex(),
                   r.del_q.hex(), r.gcp_q.hex()] for r in batch.reads],
        "haplotypes": [h.hex() for h in batch.haplotypes]}}
    r0, r1 = _run_ranks(tmp_path, 2, "engine", jobs)
    assert r0 == r1  # every rank returns the gathered results

    local = JaxEngine(JaxEngineConfig(backend="lax"))
    np.testing.assert_array_equal(np.asarray(r0["sw"], np.int32),
                                  local.sw_scores(pairs))
    assert r0["sw_stats"]["dp_cells"] == local.last_stats.dp_cells > 0
    np.testing.assert_allclose(np.asarray(r0["ph"]), local.pairhmm([batch]),
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(r0["xs"], np.int32),
                                  local.sw_scores(_jax_pairs(xs)))
    np.testing.assert_array_equal(np.asarray(r0["xs"], np.int32),
                                  oracle.sw_scores_pairs(_jax_pairs(xs)))
    assert r0["xs_stats"]["xsharded_jobs"] == 2
    assert r0["xs_stats"]["offloaded_jobs"] == 2


def _multi_tile_pairs():
    """600 pairs of 8-200bp from a numpy seed, y up to 8 bases longer than
    x (so that the short buckets pass the rotor's period and gate):
    buckets of one and two tiles, through the strips kernel's, the rotor's
    and the lane tile's routes."""
    rng = np.random.default_rng(23)
    abc = np.frombuffer(b"ATGC", np.uint8)
    pairs = []
    for _ in range(600):
        n = int(rng.integers(8, 201))
        pairs.append(SWPair(
            sx=rng.choice(abc, n).tobytes(),
            sy=rng.choice(abc, min(200, n + int(rng.integers(0, 9))))
            .tobytes()))
    return pairs


def test_two_rank_sharded_engine_on_multi_tile_buckets(tmp_path):
    """Two gloo ranks of ShardedEngine on multi-tile buckets (the defaults,
    which route them to strips, the rotor and the lane tile; the stacked
    kernel at sw_stack=4; the lane tile alone with strips and the rotor
    off), both ranks held against the JAX engine and the oracle."""
    from genomax_torch.kernels.sw_rotor import maybe_prep_rotor
    from genomax_torch.kernels.sw_strips import maybe_prep_strips

    pairs = _multi_tile_pairs()
    configs = [{}, {"sw_stack": 4}, {"sw_strips": False, "sw_rotor": False}]
    cfg = EngineConfig()
    buckets = pack_sw_pairs(pairs)
    routes = {"strips" if maybe_prep_strips(cfg, b) is not None else
              "rotor" if maybe_prep_rotor(cfg, b) is not None else "tile"
              for b in buckets}
    assert routes == {"strips", "rotor", "tile"}, routes
    assert any(b.ndiag_tile.shape[0] >= 2 for b in buckets)
    r0, r1 = _run_ranks(tmp_path, 2, "sw", {"sw": _rows(pairs),
                                             "configs": configs})
    assert r0 == r1  # every rank returns the gathered results
    want = JaxEngine(JaxEngineConfig(backend="lax")).sw_scores(
        _jax_pairs(pairs))
    np.testing.assert_array_equal(want, oracle.sw_scores_pairs(
        _jax_pairs(pairs)))
    for i in range(len(configs)):
        np.testing.assert_array_equal(np.asarray(r0[f"sw{i}"], np.int32),
                                      want, err_msg=str(configs[i]))
        assert r0[f"sw{i}_stats"]["n_jobs"] == len(pairs)


def test_four_rank_xsharded_forward(tmp_path):
    if len(jax.devices("cpu")) < 4:
        pytest.skip("needs 4 virtual CPU devices (see conftest XLA_FLAGS)")
    cases = xshard_cases()
    results = _run_ranks(tmp_path, 4, "xshard", {
        "cases": [(name, _rows(pairs), unroll)
                  for name, pairs, unroll in cases]})
    mesh = jax_make_mesh(4, devices=jax.devices("cpu")[:4])
    for name, pairs, unroll in cases:
        b = jxs.pack_sw_xsharded(_jax_pairs(pairs), 4, unroll=unroll)
        want = np.asarray(jxs.sw_forward_xsharded(
            jnp.asarray(b.sx), jnp.asarray(b.sy), mesh=mesh,
            strip_w=b.strip_w, n_diags=b.n_diags, unroll=b.unroll,
            anchor=b.anchor, interpret=True))
        for rank, r in enumerate(results):
            np.testing.assert_array_equal(np.asarray(r[name], np.int32), want,
                                          err_msg=f"{name}, rank {rank}")


def _mixed_jobs():
    """The jobs of tests/test_dist.py's
    test_sharded_engine_feature_parity_mixed: short SW pairs and one past
    max_device_len; PairHMM with a deep-negative pair (the fp64 fallback)
    and a 600bp read (the long-read path)."""
    rng = np.random.default_rng(99)
    abc = np.frombuffer(b"ATGC", np.uint8)
    pairs = [SWPair(sx=rng.choice(abc, int(rng.integers(10, 40))).tobytes(),
                    sy=rng.choice(abc, int(rng.integers(40, 80))).tobytes())
             for _ in range(20)]
    pairs.append(SWPair(sx=rng.choice(abc, 1100).tobytes(),
                        sy=rng.choice(abc, 1150).tobytes()))
    batch = generate_pairhmm_batch(2, 2, read_len=15, hap_len=21, seed=4)
    q150 = bytes([40] * 150)
    batch.reads.append(PairHMMRead(bases=b"A" * 150, base_q=q150, ins_q=q150,
                                   del_q=q150, gcp_q=q150))
    qbig = bytes([63] * 600)
    batch.reads.append(PairHMMRead(bases=rng.choice(abc, 600).tobytes(),
                                   base_q=qbig, ins_q=qbig, del_q=qbig,
                                   gcp_q=qbig))
    batch.haplotypes.append(b"C" * 90)
    return pairs, batch


_STAT_KEYS = ("n_jobs", "dp_cells", "padding_efficiency", "buckets",
              "fallback_jobs", "offloaded_jobs", "xsharded_jobs")


def _stats(eng):
    d = eng.last_stats.as_dict()
    return {k: d[k] for k in _STAT_KEYS}


def test_one_rank_sharded_engine_equals_engine():
    pairs, batch = _mixed_jobs()
    local = Engine(device="cpu")
    dist = ShardedEngine(make_mesh(device="cpu"))
    assert dist.device.type == "cpu" and dist.mesh.size == 1
    np.testing.assert_array_equal(dist.sw_scores(pairs),
                                  local.sw_scores(pairs))
    assert _stats(dist) == _stats(local)
    assert local.last_stats.offloaded_jobs == 1
    np.testing.assert_array_equal(dist.pairhmm([batch]),
                                  local.pairhmm([batch]))
    assert _stats(dist) == _stats(local)
    assert local.last_stats.offloaded_jobs == 3
    assert local.last_stats.fallback_jobs >= 1


@pytest.mark.parametrize("size", [1, 2, 4])
def test_tile_slices_regather_to_the_bucket(size):
    rng = np.random.default_rng(2)
    abc = np.frombuffer(b"ATGC", np.uint8)
    pairs = [SWPair(sx=rng.choice(abc, int(rng.integers(5, 40))).tobytes(),
                    sy=rng.choice(abc, int(rng.integers(5, 60))).tobytes())
             for _ in range(300)]
    for b in pack_sw_pairs(pairs):
        b = pad_tiles_to(b, size)
        runs = [sharded.tile_slice(b, r, size) for r in range(size)]
        for name in ("sx", "sy", "ndiag_tile", "nx", "ny", "perm"):
            np.testing.assert_array_equal(
                np.concatenate([getattr(p, name) for p in runs]),
                getattr(b, name), err_msg=name)
        assert sum(p.n_valid for p in runs) == b.n_valid
    nt = b.ndiag_tile.shape[0]
    with pytest.raises(ValueError, match="pad_tiles_to"):
        sharded.tile_slice(b, 0, nt + 1)


def test_one_rank_xshard_routing_equals_oracle():
    pairs = _xshard_routing_pairs()
    eng = ShardedEngine(make_mesh(1, device="cpu"),
                        EngineConfig(max_device_len=40, xshard_min_len=64))
    got = eng.sw_scores(pairs)
    np.testing.assert_array_equal(got, oracle.sw_scores_pairs(
        _jax_pairs(pairs)))
    assert eng.last_stats.xsharded_jobs == 2
    assert eng.last_stats.offloaded_jobs == 2


def test_make_mesh_never_substitutes_devices():
    with pytest.raises(ValueError, match="need 2 devices"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        make_mesh(device="meta")


def test_failing_xshard_path_raises_and_does_not_reroute(monkeypatch):
    from genomax_torch.engine import executor

    def boom(*a, **k):
        raise RuntimeError("strip block failed")

    calls = []
    monkeypatch.setattr(xsharded, "strip_block", boom)
    monkeypatch.setattr(executor, "sw_scores_long",
                        lambda *a, **k: calls.append("sw_long"))
    monkeypatch.setattr(native, "sw_scores_native",
                        lambda *a, **k: calls.append("native"))
    eng = ShardedEngine(make_mesh(device="cpu"),
                        EngineConfig(max_device_len=40, xshard_min_len=64))
    with pytest.raises(EngineError, match="sw_xsharded") as e:
        eng.sw_scores(_xshard_routing_pairs())
    assert e.value.stage == "sw_xsharded"
    assert "strip block failed" in str(e.value.cause)
    assert calls == []


def test_engine_config_cross_device_knobs():
    assert EngineConfig().unroll == JaxEngineConfig().unroll == 32
    assert EngineConfig().xshard_min_len is JaxEngineConfig().xshard_min_len
    for kw in (dict(unroll=0), dict(xshard_min_len=0)):
        with pytest.raises(ValueError):
            EngineConfig(**kw)


@pytest.mark.parametrize("header,n_xshard", [("2", 0), ("4", 1)])
def test_cli_xshard_end_to_end(tmp_path, header, n_xshard):
    """The pairs file of tests/test_dist.py's test_cli_xshard_end_to_end
    through python -m genomax_torch sw --devices 1 --xshard 64. Its header
    of 2 sequences reads only the short pair; with 4 the 80bp x past
    --max-device-len 40 takes the cross-device path."""
    rng = np.random.default_rng(31)
    abc = np.frombuffer(b"ATGC", np.uint8)
    lines = []
    for a, b in [(rng.choice(abc, 8).tobytes(), rng.choice(abc, 12).tobytes()),
                 (rng.choice(abc, 80).tobytes(),
                  rng.choice(abc, 110).tobytes())]:
        lines += [a.decode(), b.decode()]
    inp = tmp_path / "pairs.txt"
    inp.write_text(header + "\n" + "\n".join(lines) + "\n")
    outp = tmp_path / "scores.txt"
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    proc = subprocess.run(
        [sys.executable, "-m", "genomax_torch", "sw", str(inp), "--devices",
         "1", "--xshard", "64", "--max-device-len", "40", "--device", "cpu",
         "--output", str(outp), "--stats"],
        cwd=REPO, env={**env, "OMP_NUM_THREADS": "1"}, capture_output=True,
        text=True, timeout=PROC_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr
    got = [int(line.split()[-1]) for line in outp.read_text().splitlines()]
    from genomax.io.formats import parse_sw_file

    want = oracle.sw_scores_pairs(parse_sw_file(str(inp)))
    assert len(want) == int(header) // 2
    np.testing.assert_array_equal(got, want)
    stats = json.loads(proc.stderr.strip().splitlines()[-1])
    assert stats["xsharded_jobs"] == stats["offloaded_jobs"] == n_xshard


def test_cli_xshard_needs_devices(tmp_path, capsys):
    from genomax_torch.cli.main import main

    inp = tmp_path / "pairs.txt"
    inp.write_text("2\nACGT\nACGT\n")
    assert main(["sw", str(inp), "--xshard", "64", "--device", "cpu"]) == 2
    assert "--devices" in capsys.readouterr().err
