"""`python -m genomax_torch sw` on the CPU: output format, --output append
semantics and error codes, as tests/test_cli.py checks `genomax sw`."""

import os
import subprocess
import sys

from genomax_torch.cli.main import main

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
