"""The plain references against the reference project's golden outputs,
and their controls failing the limits at a size a test run holds."""

import os

import numpy as np
import pytest
import torch

from gxbench import generate
from gxbench.reference import pairhmm_forward, sw_gotoh

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SCORING = {"match": 1, "mismatch": -1, "gap_open": -3, "gap_extend": -1}


def _sw_file(path):
    """Pairs of an SW input file as the reference's C reads them: every
    line keeps its newline (a base that matches itself), the shorter line
    is x, the header counts the lines read."""
    data = open(path, "rb").read().split(b"\n")
    lines = [ln + b"\n" for ln in data[1:-1]] + ([data[-1]] if data[-1] else [])
    xs, ys = [], []
    for i in range(0, int(data[0]) - 1, 2):
        a, b = lines[i], lines[i + 1]
        a, b = (b, a) if len(a) > len(b) else (a, b)
        xs.append(a)
        ys.append(b)
    return xs, ys


@pytest.mark.parametrize("name", ["sw_small", "sw_medium", "sw_quirks"])
def test_sw_golden(name):
    xs, ys = _sw_file(os.path.join(GOLDEN, name + ".in"))
    want = [int(ln.split()[1]) for ln in open(os.path.join(GOLDEN, name + ".golden.out"))]
    got = sw_gotoh.scores(xs, ys, SCORING, "cpu")
    assert got.tolist() == want


def test_sw_blocks_agree():
    """Scores do not depend on how the pairs are cut into blocks."""
    tr = generate.generate({"kind": "sw_pairs", "pairs": 40, "x_len": [5, 90],
                            "y_extra": [0, 40]}, 3)
    a = sw_gotoh.scores(tr.x, tr.y, SCORING, "cpu")
    b = sw_gotoh.scores(tr.x, tr.y, SCORING, "cpu", max_elems=200)
    assert (a == b).all()


def test_pairhmm_test_in():
    regions = generate.parse_pairhmm(os.path.join(GOLDEN, "test.in"))
    out = pairhmm_forward.forward(generate.PHMMRegions(regions), {}, "cpu")
    assert out[0] == pytest.approx(-4.485565, abs=1e-6)


def test_pairhmm_10s_golden():
    """The first three regions of 10s.in (the golden's first lines)."""
    regions = generate.parse_pairhmm(os.path.join(ROOT, "gxbench", "data", "10s.in"))[:3]
    tr = generate.PHMMRegions(regions)
    want = np.loadtxt(os.path.join(GOLDEN, "10s.golden.out"))[:len(tr)]
    out = pairhmm_forward.forward(tr, {"phred_offset": 33.0}, "cpu")
    assert np.abs(out - want).max() < 1e-6  # the golden prints 6 decimals


def test_sw_band_control_fails():
    """The band of 100 diagonals misses the best local alignment of random
    pairs longer than it; the narrower integers cannot change a score that
    stays far below 127."""
    tr = generate.generate({"kind": "sw_pairs", "pairs": 24, "x_len": [300, 300],
                            "y_extra": [0, 0]}, 8)
    exp = sw_gotoh.expected(tr, {"sw": SCORING}, "cpu")
    wrong, _ = sw_gotoh.judge([sw_gotoh.control(tr, {"sw": SCORING}, "cpu", "band100")],
                              [exp], 0)
    assert wrong > 0
    for narrow in ("int16", "int8"):
        same, _ = sw_gotoh.judge([sw_gotoh.control(tr, {"sw": SCORING}, "cpu", narrow)],
                                 [exp], 0)
        assert same == 0 and exp.max() < 127


def test_sw_int8_control_fails_on_related_pairs():
    """Pairs of a sequence against a mutated copy of it score past 127, so
    the int8 control saturates and fails; int16 still holds every score."""
    mix = dict(generate.load_mix("sw-4-8kbp"), pairs=6, x_len=[300, 400],
               y_extra=[0, 60])
    tr = generate.generate(mix, 2**31 + 5)
    exp = sw_gotoh.expected(tr, {"sw": SCORING}, "cpu")
    assert exp.min() > 127
    wrong, _ = sw_gotoh.judge([sw_gotoh.control(tr, {"sw": SCORING}, "cpu", "int8")],
                              [exp], 0)
    assert wrong == len(exp)
    same, _ = sw_gotoh.judge([sw_gotoh.control(tr, {"sw": SCORING}, "cpu", "int16")],
                             [exp], 0)
    assert same == 0


def test_pairhmm_bf16_control_fails():
    m = dict(generate.load_mix("phmm-hc-151x300"), regions=1, reads=8, haps=2)
    tr = generate.generate(m, 2)
    cfg = {"pairhmm": {"phred_offset": 33.0}}
    exp = pairhmm_forward.expected(tr, cfg, "cpu")
    gap, _ = pairhmm_forward.judge(
        [pairhmm_forward.control(tr, cfg, "cpu", "bf16")], [exp], 1e-4)
    assert gap > 1e-3
    gap32, _ = pairhmm_forward.judge(
        [pairhmm_forward.control(tr, cfg, "cpu", "fp32")], [exp], 1e-4)
    assert gap32 < 1e-4 < gap


def test_reference_imports_nothing_of_the_program():
    for mod in (sw_gotoh, pairhmm_forward):
        src = open(mod.__file__).read()
        for name in ("genomax", "jax"):
            assert f"import {name}" not in src and f"from {name}" not in src
    assert torch.float64 not in pairhmm_forward.CONTROLS.values()
