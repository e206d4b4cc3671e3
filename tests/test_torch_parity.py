"""The port's parity harness (``genomax_torch.testing.parity``) on the
CPU: the degradation paths of tests/test_parity.py (a partial reference
checkout fails the gate; sources that do not compile fall back to the
vendored goldens and still PASS), a mutant engine caught, and the same
per-case lines and pair counts as the JAX harness."""

import pytest

from genomax.testing.parity import run_parity as jax_run_parity

from genomax_torch.engine import executor
from genomax_torch.testing.parity import _have_reference, run_parity
from _torch_cpu import one_torch_thread  # noqa: F401


def _case_lines(text):
    """Each case's line up to its error figure: name, verdict, pairs."""
    out = []
    for line in text.splitlines():
        if line.startswith(("SW ", "PairHMM ")):
            head, _, tail = line.partition("(")
            out.append((head.strip(), tail.split(",")[-1].strip(" )")))
    return out


@pytest.fixture(scope="module")
def jax_lines():
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jax_run_parity(reference_dir="/nonexistent", backend="lax")
    assert rc == 0
    return _case_lines(buf.getvalue())


def test_have_reference_requires_both_sources(tmp_path):
    ref = tmp_path / "ref"
    (ref / "pairHMM").mkdir(parents=True)
    (ref / "pairHMM" / "pairHMMmatrix.c").write_text("int main(){}")
    # the pairHMM source alone is a partial checkout: no gate
    assert not _have_reference(str(ref))
    (ref / "smithWaterman").mkdir()
    (ref / "smithWaterman" / "antidiagonalSmithWaterman.c").write_text(
        "int main(){}")
    assert _have_reference(str(ref))


def test_parity_falls_back_on_compile_failure(tmp_path, capsys, jax_lines):
    """Sources that do not compile degrade to the vendored goldens, which
    the port's engine on the CPU passes, case for case as the JAX
    harness."""
    ref = tmp_path / "ref"
    (ref / "pairHMM").mkdir(parents=True)
    (ref / "smithWaterman").mkdir()
    (ref / "pairHMM" / "pairHMMmatrix.c").write_text("this is not C\n")
    (ref / "smithWaterman" / "antidiagonalSmithWaterman.c").write_text(
        "neither is this\n")
    rc = run_parity(reference_dir=str(ref), device="cpu")
    out = capsys.readouterr().out
    assert "using vendored goldens" in out
    assert "PARITY: PASS" in out
    assert rc == 0
    assert _case_lines(out) == jax_lines


def test_case_lines_equal_the_jax_harness(capsys, jax_lines):
    rc = run_parity(reference_dir="/nonexistent", device="cpu")
    out = capsys.readouterr().out
    assert rc == 0
    assert jax_lines == [("SW sw_quirks.in: OK", "4 pairs"),
                         ("SW sw_small.in: OK", "32 pairs"),
                         ("SW sw_medium.in: OK", "16 pairs"),
                         ("PairHMM test.in: OK", "1 pairs"),
                         ("PairHMM 10s.in: OK", "3550 pairs")]
    assert _case_lines(out) == jax_lines


def test_mutant_engine_fails_parity(monkeypatch, capsys):
    """An engine that scores one SW pair one too high: rc 1, the case's
    MISMATCH line, PARITY: FAIL."""
    real = executor.Engine.sw_scores

    def plus_one(self, pairs):
        out = real(self, pairs)
        if len(out) == 32:
            out[7] += 1
        return out

    monkeypatch.setattr(executor.Engine, "sw_scores", plus_one)
    rc = run_parity(reference_dir="/nonexistent", device="cpu")
    out = capsys.readouterr().out
    assert rc == 1
    assert "SW sw_small.in: MISMATCH (32 pairs)" in out
    assert "SW sw_medium.in: OK (16 pairs)" in out
    assert "PARITY: FAIL (1)" in out


def test_no_card_is_an_error_not_a_fallback(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_parity(reference_dir="/nonexistent")
