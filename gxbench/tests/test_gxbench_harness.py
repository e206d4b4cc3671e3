"""The harness driven end to end on the CPU (the plain versions of the
port's kernels) at sizes a test run holds: sound runs come out correct,
runs with the timed path broken underneath do not, and a run without a
card, or with only the benchmark's own files, prints no result."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from gxbench import generate, harness
from genomax_torch.engine.executor import Engine

ROOT = harness.ROOT
SW_MIX = {"kind": "sw_pairs", "pairs": 48, "x_len": [30, 140],
          "y_extra": [0, 40], "entry": "sw_scores"}
PHMM_MIX = {"kind": "phmm_regions", "regions": 3, "reads": 5, "haps": 2,
            "read_len": 40, "hap_len": 60, "snp_rate": 0.01,
            "error_rate": 0.005, "base_q": [20, 40], "indel_q": [30, 45],
            "gcp_q": 10, "entry": "pairhmm"}
READS_MIX = {"kind": "sw_reads", "pairs": 24, "x_len": [100, 160],
             "y_extra": [0, 30], "sub_rate": 0.04, "indel_rate": 0.01,
             "entry": "sw_scores"}
CELLS = [("sw-4-8kbp", SW_MIX, "sw_scores"),
         ("phmm-hc-151x300", PHMM_MIX, "pairhmm"),
         ("sw-512bp-reads", READS_MIX, "sw_scores")]


def _run(cell, mix, traced=False):
    return harness.run(cell, 2**31 + 7, 0.3, traced, device="cpu", mix=mix)


@pytest.mark.parametrize("cell,mix,entry", CELLS)
def test_sound_run_is_correct(cell, mix, entry):
    r = _run(cell, mix)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"gcups", "setup_s"}
    assert list(r)[-1] == "checks"
    (check,) = r["checks"].values()
    assert check["value"] <= check["limit"]


def _unchanged(out):
    return np.zeros_like(out)


def _half(out):
    out = out.copy()
    out[len(out) // 2:] = 0
    return out


def _altered(out):
    out = out.copy()
    out[len(out) // 3] += 1 if out.dtype.kind == "i" else 2e-4
    return out


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("cell,mix,entry", CELLS)
def test_broken_path_is_not_correct(monkeypatch, cell, mix, entry, fault):
    """The entry returns outputs that were never computed, half the batch
    left out, or one answer altered where it is produced."""
    real = getattr(Engine, entry)

    def broken(self, inputs, **kw):
        return fault(np.asarray(real(self, inputs, **kw)))

    monkeypatch.setattr(Engine, entry, broken)
    r = _run(cell, mix)
    assert not r["correct"] and r["failed"] == r["attempted"]


@pytest.mark.parametrize("cell,mix,entry", CELLS)
def test_stale_answers_are_not_correct(monkeypatch, cell, mix, entry):
    """The window turns through its input sets and judges each call by the
    answers of its own set: a path that hands back the answer of the first
    inputs it saw fails."""
    real, first = getattr(Engine, entry), []

    def stale(self, inputs, **kw):
        if not first:
            first.append(real(self, inputs, **kw))
        return first[0]

    monkeypatch.setattr(Engine, entry, stale)
    r = _run(cell, mix)
    assert r["attempted"] >= 2 and not r["correct"]
    assert r["failed"] >= r["attempted"] * (harness.SETS - 1) // harness.SETS


# 40 pairs of the protein mix, a kind that a file of gxbench/kinds/ defines.
PROT_MIX = dict(generate.load_mix("prot-search-64x300"), queries=1, hits=40)


@pytest.mark.parametrize("fault", [None, _altered],
                         ids=["sound", "answer_altered"])
def test_file_kind_reaches_engine_and_judgement(monkeypatch, fault):
    """A kind from a file runs through set-up, the window and the
    judgement on ``sw-gotoh-ref``: the engine scores amino-acid bytes
    (its kernels compare bytes) as the reference does, and one answer
    altered where it is produced fails the run."""
    if fault:
        real = Engine.sw_scores
        monkeypatch.setattr(Engine, "sw_scores", lambda self, inputs: fault(
            np.asarray(real(self, inputs))))
    r = _run("sw-512bp-reads", PROT_MIX)
    assert r["attempted"] >= 1
    assert r["correct"] is (fault is None)
    assert (r["checks"]["score_mismatches"]["value"] == 0) is (fault is None)


def test_failing_call_is_not_correct(monkeypatch):
    calls = {"n": 0}
    real = Engine.sw_scores

    def flaky(self, inputs):
        calls["n"] += 1
        if calls["n"] > harness.SETS:
            raise RuntimeError("launch failed")
        return real(self, inputs)

    monkeypatch.setattr(Engine, "sw_scores", flaky)
    r = _run("sw-4-8kbp", SW_MIX)
    assert not r["correct"] and r["failed"] >= 1 and "errors" in r


def test_traced_run_without_device_work_fails():
    """On the CPU the profiler records no device activity: the traced run
    raises instead of printing an empty breakdown."""
    with pytest.raises(harness.HarnessError, match="no device activity"):
        _run("sw-4-8kbp", SW_MIX, traced=True)


def _command(cwd, workload="sw-4-8kbp"):
    return subprocess.run(
        [sys.executable, "-m", "gxbench.run", "--workload", workload,
         "--seed", "2147483649", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return proc.returncode != 0 and not (lines and lines[-1].startswith("{"))


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = _command(ROOT)
    assert _no_result(proc) and "CUDA" in proc.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gxbench"), tmp_path / "gxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _no_result(_command(tmp_path))


def test_forbidden_modules_by_whole_name():
    ok = ["genomax_torch", "genomax_torch.engine.executor", "jaxtyping",
          "flaxen", "numpy"]
    assert harness.forbidden_modules(ok) == []
    bad = ["genomax", "genomax.kernels.sw", "jax.numpy", "jaxlib", "flax.linen"]
    assert harness.forbidden_modules(ok + bad) == ["flax", "genomax", "jax", "jaxlib"]


def test_run_loads_no_forbidden_module():
    """A CPU run in a fresh process leaves no jax and no genomax in
    sys.modules."""
    code = ("import sys; from gxbench import harness; "
            f"harness.run('sw-4-8kbp', 1, 0.2, False, device='cpu', mix={SW_MIX!r}); "
            "print(harness.forbidden_modules(sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_cells_run_on_card():
    """Every cell, a short window on the card, correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        r = harness.run(w["name"], 2**31 + 3, 1.0, False)
        assert r["correct"], (w["name"], r["checks"])
