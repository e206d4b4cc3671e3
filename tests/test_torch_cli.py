"""`python -m genomax_torch sw` and `pairhmm` on the CPU: output format,
--output append (sw) and overwrite (pairhmm) semantics, and error codes,
as tests/test_cli.py checks `genomax sw` and `genomax pairhmm`."""

import os
import subprocess
import sys

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
