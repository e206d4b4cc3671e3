"""The port's benchmarks on the CPU: the sweep (``bench/sweep.py``) rows,
keys and cells against their formulas, the route a point times against
the engine's own (the shared prep), a timing window that holds no prep,
the PairHMM point's pair count against the JAX sweep's, the --json file;
and the scaling sweep (``bench/scaling.py``) in one process (the "--"
row, efficiency normalised to the first success) and on two gloo ranks
(both rows measured, equal scores)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from genomax.bench.sweep import bench_pairhmm_point as jax_pairhmm_point

from genomax_torch.bench import scaling, sweep
from genomax_torch.engine import executor
from genomax_torch.engine.executor import Engine
from genomax_torch.io.formats import SWPair
from genomax_torch.io.generator import random_dna
from genomax_torch.kernels import sw_long
from _torch_cpu import one_torch_thread  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "_torch_dist_worker.py")


def _fixed_slope(monkeypatch, seconds=0.002):
    """The sweep's timing replaced by a constant, its launch lists kept."""
    seen = []

    def slope(launches, k2, device, trials=3):
        seen.append((len(launches), k2, device.type))
        return seconds

    monkeypatch.setattr(sweep, "slope_s", slope)
    return seen


@pytest.mark.parametrize("length,num", [(16, 20), (64, 7), (200, 3)])
def test_sw_row_keys_and_cells(monkeypatch, length, num):
    seen = _fixed_slope(monkeypatch)
    row = sweep.bench_sw_point(length, num, device="cpu")
    assert set(row) == {"length", "slope_reps", "elapsed_ms", "gcups",
                        "routes", "device"}
    k2 = 2 + max(4, min(32, 4096 // max(length, 64)))
    assert row["length"] == length and row["slope_reps"] == k2
    assert row["elapsed_ms"] == 2.0 and row["device"] == "cpu"
    # cells = num * (length + 1)^2: the '\n' counts, as the C counts it
    assert row["gcups"] == round(num * (length + 1) ** 2 / 0.002 / 1e9, 3)
    assert seen[0][1:] == (k2, "cpu")


def test_pairhmm_row_and_pair_count_equal_the_jax_sweep(monkeypatch):
    want = jax_pairhmm_point(3, 2, 20, 30, "lax", trials=1)
    _fixed_slope(monkeypatch)
    row = sweep.bench_pairhmm_point(3, 2, 20, 30, device="cpu")
    assert set(row) == {"pairs", "read_len", "hap_len", "slope_reps",
                        "elapsed_ms", "gcups", "device"}
    assert row["pairs"] == want["pairs"] == 6
    assert (row["read_len"], row["hap_len"]) == (20, 30)
    # cells = Σ rl·hl = 6 * 20 * 30; k2 from the JAX formula
    assert row["slope_reps"] == want["slope_reps"] == 2 + 16
    assert row["gcups"] == round(6 * 20 * 30 / 0.002 / 1e9, 3)


def _spy_routes(monkeypatch):
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


@pytest.mark.parametrize("length,route", [(64, "rotor"), (512, "strips"),
                                          (1024, "sw_long")])
def test_point_times_the_engines_route(monkeypatch, length, route):
    """64bp takes the rotor, 512bp strips, 1,024bp (past max_device_len
    with its '\\n') the long-pair kernel: through the engine's own prep,
    and the engine scoring the same pairs goes the same way."""
    seen = _spy_routes(monkeypatch)
    _fixed_slope(monkeypatch)
    row = sweep.bench_sw_point(length, 2, device="cpu")
    assert row["routes"] == [route] and seen == [route]
    seen.clear()
    rng = np.random.default_rng(0)
    pairs = [SWPair(sx=random_dna(rng, length) + b"\n",
                    sy=random_dna(rng, length) + b"\n") for _ in range(2)]
    Engine(device="cpu").sw_scores(pairs)
    assert seen == [route]


def test_timing_window_holds_only_launches(monkeypatch):
    """Every prep, pack and copy happens before the window; inside it the
    launches alone run, warm-up once and then trials x (2 + k2) times."""
    counts = {}

    def counting(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    for mod, name in ((Engine, "_sw_prep"), (Engine, "_phmm_prep"),
                      (Engine, "_phmm_pack"), (sweep, "pack_sw_pairs"),
                      (executor, "sw_bucket_to_torch"),
                      (executor, "sw_rotor_to_torch"),
                      (executor, "sw_strips_to_torch"),
                      (executor, "phmm_bucket_to_torch"),
                      (sw_long, "pack_sw_long"), (sw_long, "tile_to_torch")):
        counting(mod, name)
    real_slope, windows = sweep.slope_s, []

    def watched(launches, k2, device, trials=3):
        calls = [0]

        def counted(f):
            def g():
                calls[0] += 1
                return f()
            return g

        before = dict(counts)
        s = real_slope([counted(f) for f in launches], k2, device, trials)
        windows.append((before, dict(counts), calls[0],
                        len(launches) * (1 + trials * (2 + k2))))
        return s

    monkeypatch.setattr(sweep, "slope_s", watched)
    sweep.bench_sw_point(16, 130, device="cpu", trials=1)
    sweep.bench_pairhmm_point(2, 2, 10, 12, device="cpu", trials=1)
    assert len(windows) == 2
    for before, after, calls, want in windows:
        assert before == after and calls == want
    assert counts["_sw_prep"] == counts["_phmm_prep"] == 1


def test_json_is_written(tmp_path, capsys):
    path = tmp_path / "sw.json"
    rows = sweep.run_sweep([8, 24], 4, device="cpu", json_out=str(path))
    assert json.loads(path.read_text()) == rows
    assert [r["length"] for r in rows] == [8, 24]
    out = capsys.readouterr().out
    assert "device=cpu" in out and out.count("\n") == 4
    path = tmp_path / "ph.json"
    rows = sweep.run_pairhmm_sweep([(2, 1, 8, 9)], device="cpu",
                                   json_out=str(path))
    assert json.loads(path.read_text()) == rows and rows[0]["pairs"] == 2


def test_offloaded_pairhmm_point_is_refused():
    with pytest.raises(ValueError, match="long-read kernel"):
        sweep.bench_pairhmm_point(1, 1, 600, 700, device="cpu")


def test_scaling_in_one_process(capsys):
    """One process: a 2-device point is the "--" row and the sweep goes
    on; speedup and efficiency are normalised to the first point that
    succeeded."""
    rows = scaling.run_scaling([2, 1, 1], 12, 24, device="cpu")
    out = capsys.readouterr().out
    assert "platform=cpu, process group of 1 rank(s)" in out
    assert "cannot show scaling" in out
    dash = [ln for ln in out.splitlines() if ln.split()[:2] == ["2", "--"]]
    assert len(dash) == 1 and "need 2 devices" in dash[0]
    assert [r["devices"] for r in rows] == [1, 1]
    assert rows[0]["speedup"] == 1.0 and rows[0]["efficiency"] == 1.0
    assert rows[1]["efficiency"] == round(
        round(rows[1]["pairs_per_s"] / rows[0]["pairs_per_s"], 2), 3)
    assert set(rows[0]) == {"devices", "elapsed_ms", "pairs_per_s",
                            "speedup", "efficiency"}


def test_scaling_on_two_gloo_ranks(tmp_path):
    """Two ranks: the 1-device point runs on a sub-group mesh of rank 0
    while rank 1 waits, the 2-device point on both; both rows measure and
    their scores are equal (run_scaling raises otherwise). A sub-group of
    the last rank maps its rank 0 to global rank 1."""
    jobs = tmp_path / "jobs.json"
    jobs.write_text(json.dumps({"devices": [1, 2, 4], "num": 24,
                                "length": 40}))
    out = str(tmp_path / "out")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update({"GX_WORLD": "2", "GX_MODE": "scaling",
                "GX_INIT": "file://" + str(tmp_path / "rendezvous"),
                "GX_JOBS": str(jobs), "GX_OUT": out,
                "OMP_NUM_THREADS": "1", "PYTHONUNBUFFERED": "1"})
    procs = [subprocess.Popen([sys.executable, WORKER],
                              env={**env, "GX_RANK": str(r)}, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    r0, r1 = (json.load(open(f"{out}.{r}")) for r in range(2))
    assert [r["devices"] for r in r0["rows"]] == [1, 2]
    assert [r["devices"] for r in r1["rows"]] == [2]
    assert all(r["pairs_per_s"] > 0 for r in r0["rows"])
    assert r0["rows"][0]["efficiency"] == 1.0
    assert r1["sub"] == [0, 1, 1]
    assert "process group of 2 rank(s)" in logs[0]
    assert any(ln.split()[:2] == ["4", "--"] for ln in logs[0].splitlines())
    assert "SW scaling" not in logs[1]  # rank 0 prints
