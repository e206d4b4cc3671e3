"""`python -m genomax_torch sw` and `pairhmm` on the CPU: output format,
--output append (sw) and overwrite (pairhmm) semantics, and error codes,
as tests/test_cli.py checks `genomax sw` and `genomax pairhmm`."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from genomax_torch.cli.main import main
from _torch_cpu import one_torch_thread  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _golden_lines(golden_dir, name):
    with open(os.path.join(golden_dir, name + ".golden.out")) as f:
        return [f"Score: {line.split()[1]}" for line in f]


def test_cli_sw_scores_and_elapsed(capsys, golden_dir):
    rc = main(["sw", os.path.join(golden_dir, "sw_small.in"),
               "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("Score: ")]
    assert lines == _golden_lines(golden_dir, "sw_small")
    assert "elapsed " in out


def test_module_entry_output_appends(tmp_path, golden_dir):
    out = tmp_path / "scores.txt"
    cmd = [sys.executable, "-m", "genomax_torch", "sw", "--device", "cpu",
           os.path.join(golden_dir, "sw_small.in"), "--output", str(out),
           "--stats"]
    for _ in range(2):
        r = subprocess.run(cmd, capture_output=True, text=True, cwd=_REPO,
                           timeout=120)
        assert r.returncode == 0, r.stderr[-400:]
        assert "elapsed " in r.stdout and "Score:" not in r.stdout
        assert '"n_jobs": 32' in r.stderr
    want = _golden_lines(golden_dir, "sw_small")
    assert out.read_text().splitlines() == want + want


def test_cli_missing_file(capsys):
    rc = main(["sw", "/definitely/not/here.in", "--device", "cpu"])
    assert rc == 2
    assert "no such file" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["sw", "pairhmm"])
def test_cli_without_a_card_prints_the_error(capsys, monkeypatch, golden_dir,
                                             tmp_path, cmd):
    """--device cuda (the default) on a host without a card: a one-line
    error and rc 2, no traceback and no CPU scores."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ([cmd, os.path.join(golden_dir, "sw_small.in")] if cmd == "sw"
            else [cmd, os.path.join(golden_dir, "test.in"),
                  str(tmp_path / "out")])
    assert main(args) == 2
    out = capsys.readouterr()
    assert "Score:" not in out.out
    assert out.err.startswith("genomax_torch: error: ")
    assert "no CUDA device" in out.err


def test_cli_engine_failure_prints_the_error(capsys, monkeypatch, golden_dir):
    """An EngineError (here: a bucket that cannot reach the device) ends in
    the same one-line error and rc 2."""
    from genomax_torch.engine import executor

    def fail(b, device):
        raise RuntimeError("device fault (simulated)")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(executor, "sw_bucket_to_torch", fail)
    assert main(["sw", os.path.join(golden_dir, "sw_small.in"),
                 "--device", "cuda"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("genomax_torch: error: sw failed on bucket 0")
    assert "device fault (simulated)" in err


def test_cli_custom_scoring(capsys, golden_dir):
    from genomax import native
    from genomax.config import SWConfig
    from genomax.io.formats import parse_sw_file

    path = os.path.join(golden_dir, "sw_quirks.in")
    rc = main(["sw", path, "--device", "cpu", "--match", "2",
               "--mismatch", "-3", "--gap-open", "-5", "--gap-extend", "-2"])
    assert rc == 0
    got = [int(line.split()[1]) for line in capsys.readouterr().out.splitlines()
           if line.startswith("Score: ")]
    cfg = SWConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    assert got == list(native.sw_scores_native(parse_sw_file(path), cfg))


def test_cli_pairhmm_test_in(tmp_path, golden_dir):
    out = tmp_path / "out.txt"
    out.write_text("stale\n")  # overwritten, as genomax pairhmm does
    cmd = [sys.executable, "-m", "genomax_torch", "pairhmm",
           os.path.join(golden_dir, "test.in"), str(out), "--device", "cpu",
           "--stats"]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=_REPO,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-400:]
    assert out.read_text() == "-4.485565\n"
    assert r.stdout.startswith("elapsed ")
    assert '"n_jobs": 1' in r.stderr


def test_cli_pairhmm_gatk_emission(tmp_path, golden_dir):
    from genomax import native
    from genomax.io.formats import parse_pairhmm_file

    path = os.path.join(golden_dir, "test.in")
    out = tmp_path / "out.txt"
    assert main(["pairhmm", path, str(out), "--device", "cpu",
                 "--gatk-emission"]) == 0
    want = native.pairhmm_native(parse_pairhmm_file(path), gatk_emission=True)
    got = [float(v) for v in out.read_text().split()]
    assert abs(got[0] - want[0]) < 1e-4 and abs(got[0] + 4.485565) > 1e-3


def _write_pairhmm_input(path, batches):
    with open(path, "w") as f:
        for b in batches:
            f.write(f"{len(b.reads)} {len(b.haplotypes)}\n")
            for r in b.reads:
                f.write(" ".join(x.decode() for x in (
                    r.bases, r.base_q, r.ins_q, r.del_q, r.gcp_q)) + "\n")
            for h in b.haplotypes:
                f.write(h.decode() + "\n")


@pytest.fixture()
def phmm_file(tmp_path):
    """tests/test_cli.py's input: four batches of 2 reads x 2 haplotypes."""
    from genomax_torch.io.generator import generate_pairhmm_batch

    batches = [generate_pairhmm_batch(2, 2, read_len=11, hap_len=15, seed=i)
               for i in range(4)]
    p = tmp_path / "in.txt"
    _write_pairhmm_input(p, batches)
    return str(p)


def _pairhmm(phmm_file, out, *flags):
    return main(["pairhmm", phmm_file, str(out), "--device", "cpu", *flags])


def test_cli_pairhmm_resume_matches_full(tmp_path, phmm_file, capsys):
    """tests/test_cli.py::test_cli_pairhmm_resume_matches_full: a resumable
    run equals the one-shot run, and after a crash past batch 2 (a torn
    line beyond the manifest) resuming truncates the tail and completes."""
    full, res = tmp_path / "full.out", tmp_path / "res.out"
    assert _pairhmm(phmm_file, full) == 0
    assert _pairhmm(phmm_file, res, "--resume") == 0
    assert res.read_text() == full.read_text()
    manifest = tmp_path / "res.out.progress.json"
    m = json.loads(manifest.read_text())
    assert m["completed_batches"] == 4 and m["lines"] == 16
    assert m["config"] == {"gatk_emission": False}
    lines = res.read_text().splitlines(True)
    res.write_text("".join(lines[:8]) + "-999.0\n")
    manifest.write_text(json.dumps({"input": os.path.abspath(phmm_file),
                                    "completed_batches": 2, "lines": 8}))
    capsys.readouterr()
    assert _pairhmm(phmm_file, res, "--resume") == 0
    assert "resuming at batch 2/4" in capsys.readouterr().err
    assert res.read_text() == full.read_text()


def test_cli_pairhmm_resume_ignores_other_input_manifest(tmp_path, phmm_file):
    res = tmp_path / "res.out"
    res.write_text("junk\n")
    (tmp_path / "res.out.progress.json").write_text(json.dumps(
        {"input": "/some/other/file", "completed_batches": 2, "lines": 1}))
    assert _pairhmm(phmm_file, res, "--resume") == 0
    assert len(res.read_text().split()) == 16
    assert "junk" not in res.read_text()


def test_cli_pairhmm_resume_truncated_output_restarts(tmp_path, phmm_file,
                                                      capsys):
    res = tmp_path / "res.out"
    assert _pairhmm(phmm_file, res, "--resume") == 0
    full = res.read_text()
    assert json.loads((tmp_path / "res.out.progress.json").read_text())[
        "lines"] > 2
    res.write_text("".join(full.splitlines(True)[:2]))
    capsys.readouterr()
    assert _pairhmm(phmm_file, res, "--resume") == 0
    assert "restarting from scratch" in capsys.readouterr().err
    assert res.read_text() == full


def test_cli_pairhmm_resume_config_mismatch_restarts(tmp_path, phmm_file,
                                                     capsys):
    res = tmp_path / "res.out"
    assert _pairhmm(phmm_file, res, "--resume") == 0
    plain = res.read_text()
    capsys.readouterr()
    assert _pairhmm(phmm_file, res, "--resume", "--gatk-emission") == 0
    assert "different scoring config" in capsys.readouterr().err
    gatk = res.read_text()
    assert len(gatk.splitlines()) == len(plain.splitlines())
    assert gatk != plain
    full_gatk = tmp_path / "full_gatk.out"
    assert _pairhmm(phmm_file, full_gatk, "--gatk-emission") == 0
    assert gatk == full_gatk.read_text()


def test_cli_pairhmm_resume_legacy_manifest_restarts(tmp_path, phmm_file,
                                                     capsys):
    """A manifest without "config" was written under the default emission:
    the same flags resume it (nothing left to do), --gatk-emission
    restarts."""
    res = tmp_path / "res.out"
    manifest = tmp_path / "res.out.progress.json"
    assert _pairhmm(phmm_file, res, "--resume") == 0
    plain = res.read_text()
    m = json.loads(manifest.read_text())
    del m["config"]
    manifest.write_text(json.dumps(m))
    capsys.readouterr()
    assert _pairhmm(phmm_file, res, "--resume") == 0
    assert "resuming at batch 4/4" in capsys.readouterr().err
    assert res.read_text() == plain
    manifest.write_text(json.dumps(m))
    assert _pairhmm(phmm_file, res, "--resume", "--gatk-emission") == 0
    assert "different scoring config" in capsys.readouterr().err
    assert res.read_text() != plain


def test_cli_pairhmm_resume_stale_scaled_manifest_restarts(tmp_path,
                                                           phmm_file, capsys):
    res = tmp_path / "res.out"
    manifest = tmp_path / "res.out.progress.json"
    assert _pairhmm(phmm_file, res, "--resume") == 0
    m = json.loads(manifest.read_text())
    m["config"]["scaled_recurrence"] = True
    manifest.write_text(json.dumps(m))
    capsys.readouterr()
    assert _pairhmm(phmm_file, res, "--resume") == 0
    assert "different scoring config" in capsys.readouterr().err
    assert json.loads(manifest.read_text())["config"] == {
        "gatk_emission": False}


def test_cli_pairhmm_resume_refuses_a_mesh(tmp_path, phmm_file, capsys):
    """Under --devices every rank would resume on its own while rank 0
    alone writes; the port refuses the pair before any process group
    starts or any file is touched."""
    res = tmp_path / "res.out"
    assert _pairhmm(phmm_file, res, "--resume", "--devices", "1") == 2
    assert "--resume" in capsys.readouterr().err
    assert not res.exists()


def test_cli_generate_byte_for_byte(tmp_path, capsys):
    from genomax.cli.main import main as jax_main

    args = ["--num", "10", "--min-len", "30", "--max-len", "40", "--seed", "7"]
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    assert main(["generate", str(ours), *args]) == 0
    out = capsys.readouterr().out
    assert jax_main(["generate", str(theirs), *args]) == 0
    assert out.replace(str(ours), str(theirs)) == capsys.readouterr().out
    assert ours.read_bytes() == theirs.read_bytes()
    # the JAX CLI's defaults: 500 pairs of 450-500bp, seed 0
    assert main(["generate", str(ours)]) == 0
    assert jax_main(["generate", str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()


def test_cli_profile_writes_trace(tmp_path, capsys, golden_dir):
    d = tmp_path / "trace"
    assert main(["sw", os.path.join(golden_dir, "sw_small.in"), "--device",
                 "cpu", "--profile", str(d)]) == 0
    found = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert found and all(os.path.getsize(f) > 0 for f in found)
    trace = json.loads(open(found[0]).read())
    assert trace["traceEvents"]


def test_cli_profile_refuses_what_it_cannot_trace(monkeypatch, capsys,
                                                  golden_dir, tmp_path):
    """--profile on the card with a profiler that cannot trace CUDA fails
    the command rather than write a CPU-only trace."""
    from torch import profiler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiler, "supported_activities",
                        lambda: {profiler.ProfilerActivity.CPU})
    d = tmp_path / "trace"
    assert main(["sw", os.path.join(golden_dir, "sw_small.in"), "--device",
                 "cuda", "--profile", str(d)]) == 2
    assert "cannot trace CUDA" in capsys.readouterr().err
    assert not d.exists()


@pytest.mark.parametrize("chunk", ["1", "5", "100"])
def test_cli_sw_chunk_equals_unchunked(capsys, golden_dir, chunk):
    path = os.path.join(golden_dir, "sw_small.in")
    assert main(["sw", path, "--device", "cpu"]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("Score: ")]
    assert main(["sw", path, "--device", "cpu", "--chunk", chunk,
                 "--stats"]) == 0
    out = capsys.readouterr()
    assert [ln for ln in out.out.splitlines()
            if ln.startswith("Score: ")] == want
    assert json.loads(out.err.strip().splitlines()[-1])["n_jobs"] == 32


@pytest.mark.parametrize("chunk", ["1", "3"])
def test_cli_pairhmm_chunk_equals_unchunked(tmp_path, phmm_file, chunk):
    full, chunked = tmp_path / "full.out", tmp_path / "chunked.out"
    assert _pairhmm(phmm_file, full) == 0
    assert _pairhmm(phmm_file, chunked, "--chunk", chunk) == 0
    assert chunked.read_text() == full.read_text()


@pytest.mark.parametrize("cmd", ["sw", "pairhmm"])
def test_cli_chunk_refuses_devices(capsys, golden_dir, tmp_path, cmd):
    args = ([cmd, os.path.join(golden_dir, "sw_small.in")] if cmd == "sw"
            else [cmd, os.path.join(golden_dir, "test.in"),
                  str(tmp_path / "out")])
    assert main(args + ["--device", "cpu", "--chunk", "4",
                        "--devices", "1"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("genomax_torch: error: --chunk streams through "
                          "the local engine")


def test_cli_chunk_below_one_fails(capsys, golden_dir):
    """A negative chunk is refused (0 is the unchunked run, as in genomax:
    tests/test_torch_device_len.py)."""
    assert main(["sw", os.path.join(golden_dir, "sw_small.in"), "--device",
                 "cpu", "--chunk", "-1"]) == 2
    assert "chunk_pairs must be >= 1" in capsys.readouterr().err


@pytest.mark.parametrize("unroll", ["1", "8", "32"])
def test_cli_unroll_reaches_engine_config(monkeypatch, capsys, golden_dir,
                                          unroll):
    from genomax_torch.engine import executor

    seen = []

    class Recorder(executor.Engine):
        def __init__(self, cfg, **kw):
            seen.append(cfg)
            super().__init__(cfg, **kw)

    monkeypatch.setattr(executor, "Engine", Recorder)
    assert main(["sw", os.path.join(golden_dir, "sw_quirks.in"), "--device",
                 "cpu", "--unroll", unroll]) == 0
    assert [c.unroll for c in seen] == [int(unroll)]


def test_cli_unroll_default_and_choices(capsys, golden_dir):
    from genomax_torch.config import EngineConfig

    assert EngineConfig().unroll == 32
    with pytest.raises(SystemExit) as e:
        main(["sw", os.path.join(golden_dir, "sw_quirks.in"), "--device",
              "cpu", "--unroll", "3"])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_cli_unroll_through_xshard(tmp_path, monkeypatch, capsys):
    """--devices 1 --xshard with --unroll 8 gives the scores of the local
    engine: the 80bp x past --max-device-len 40 takes the cross-device
    wavefront in blocks of 8 diagonals."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    rng = np.random.default_rng(31)
    abc = np.frombuffer(b"ATGC", np.uint8)
    seqs = [rng.choice(abc, n).tobytes().decode() for n in (8, 12, 80, 110)]
    inp = tmp_path / "pairs.txt"
    inp.write_text("4\n" + "\n".join(seqs) + "\n")
    base = ["sw", str(inp), "--device", "cpu", "--max-device-len", "40"]
    assert main(base) == 0
    want = capsys.readouterr().out.splitlines()[:2]
    assert main(base + ["--devices", "1", "--xshard", "64", "--unroll", "8",
                        "--stats"]) == 0
    out = capsys.readouterr()
    assert out.out.splitlines()[:2] == want
    assert json.loads(out.err.strip().splitlines()[-1])["xsharded_jobs"] == 1


@pytest.mark.parametrize("argv", [["sw", "x.in", "--backend", "lax"],
                                  ["sw", "x.in", "--interpret"],
                                  ["probe"],
                                  ["bench", "--unrolls", "8"],
                                  ["bench", "--backend", "lax"],
                                  ["bench-dist", "--backend", "lax"],
                                  ["parity", "--backend", "lax"],
                                  ["soak", "--backend", "lax"],
                                  ["soak", "--interpret"]])
def test_cli_tpu_only_surface_is_refused(capsys, argv):
    """--backend, --interpret, bench's --unrolls (the TPU wavefront's
    unroll) and probe belong to the TPU package."""
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2


# The harness subcommands on the CPU, as tests/test_cli.py runs them for
# the JAX package.
HARNESS_ARGV = {
    "parity": ["parity"],
    "soak": ["soak", "--rounds", "3", "--seed", "7"],
    "bench": ["bench", "--lengths", "16,40", "--num", "16", "--json", None],
    "bench-dist": ["bench-dist", "--devices", "1", "--num", "16", "--length",
                   "32"],
}


@pytest.mark.parametrize("cmd", HARNESS_ARGV)
def test_cli_harness_subcommand_on_the_cpu(capsys, tmp_path, cmd):
    js = tmp_path / "rows.json"
    argv = [str(js) if a is None else a for a in HARNESS_ARGV[cmd]]
    assert main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    want = {"parity": "PARITY: PASS", "soak": "SOAK PASS",
            "bench": "SW sweep: 16 alignments per point, device=cpu",
            "bench-dist": "platform=cpu, process group of 1 rank(s)"}[cmd]
    assert want in out
    if cmd == "bench":
        rows = json.loads(js.read_text())
        assert [r["length"] for r in rows] == [16, 40]


def test_cli_bench_pairhmm_points(capsys, tmp_path):
    js = tmp_path / "ph.json"
    assert main(["bench", "--kernel", "pairhmm", "--pairhmm-points",
                 "2,1,8,9;1,2,5,6", "--json", str(js), "--device",
                 "cpu"]) == 0
    rows = json.loads(js.read_text())
    assert [(r["pairs"], r["read_len"], r["hap_len"]) for r in rows] == [
        (2, 8, 9), (2, 5, 6)]
    assert main(["bench", "--kernel", "pairhmm", "--pairhmm-points", "2,1,8",
                 "--device", "cpu"]) == 2


def test_cli_soak_deep_on_the_cpu(capsys, monkeypatch):
    """soak --deep: the sharded rounds on a one-rank mesh, no process
    group started for one device."""
    from genomax_torch.testing import soak

    real = soak.run_deep_soak
    monkeypatch.setattr(soak, "run_deep_soak", lambda **kw: real(
        **kw, long_rows=(200, 260), long_cols=(60, 90)))
    assert main(["soak", "--deep", "--rounds", "2", "--seed", "11",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "SHARDED-1dev" in out and "DEEP SOAK PASS" in out


def test_cli_soak_mismatch_returns_one(capsys, monkeypatch):
    from genomax_torch.engine.executor import Engine

    real = Engine.sw_scores
    monkeypatch.setattr(Engine, "sw_scores",
                        lambda self, pairs: real(self, pairs) + 1)
    assert main(["soak", "--rounds", "1", "--seed", "7", "--device",
                 "cpu"]) == 1
    assert "MISMATCH" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["parity"], ["soak", "--rounds", "1"],
                                  ["soak", "--deep", "--rounds", "1"],
                                  ["bench", "--lengths", "8", "--num", "2"],
                                  ["bench-dist", "--devices", "1", "--num",
                                   "2"]])
def test_cli_harness_without_a_card_prints_the_error(capsys, monkeypatch,
                                                     argv):
    """--device cuda (the default) without a card: rc 2 and the error,
    never a run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err
    assert "PASS" not in out.out
