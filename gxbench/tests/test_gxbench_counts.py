"""The roofline's yardstick: cells from the inputs alone, the frozen
operation counts and peaks."""

import numpy as np
import pytest

from gxbench import counts, generate


def test_sw_cells_by_hand():
    assert counts.sw_cells([3, 5], [4, 7]) == 3 * 4 + 5 * 7
    assert counts.sw_bytes([3, 5], [4, 7]) == 19 + 8


def test_phmm_cells_by_hand():
    # Region 1: reads 2 and 3 against haplotypes 5 and 7; region 2: one
    # read of 4 against one haplotype of 6.
    assert counts.phmm_cells([([2, 3], [5, 7]), ([4], [6])]) == 5 * 12 + 24


@pytest.mark.parametrize("width", [16, 520, 4096])
def test_bucket_count_ignores_padding(width):
    """A bucket padded to any width counts the cells of its real lengths."""
    rng = np.random.default_rng(0)
    lx = rng.integers(1, 16, 100)
    ly = rng.integers(1, 16, 100)
    pad = np.zeros((100, width), np.uint8)
    for i, n in enumerate(lx):
        pad[i, :n] = 65
    xs = [row[:n].tobytes() for row, n in zip(pad, lx)]
    ys = [b"A" * int(n) for n in ly]
    tr = generate.SWPairs(x=xs, y=ys)
    assert tr.cells() == int((lx * ly).sum())


def test_peaks_and_bounds():
    assert counts.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)
    # The 25,000 x 512bp call: 6.554 G cells x 7.5 over the int32 rate.
    b = counts.sw_bound_s([512] * 25000, [512] * 25000)
    assert b == pytest.approx(2.9385e-3, rel=1e-3)
    # 65,536 jobs of 151 x 300: 2.969 G cells x 11 flops over 67 TFLOP/s.
    b = counts.phmm_bound_s([([151] * 64, [300] * 8)] * 128)
    assert b == pytest.approx(0.48742e-3, rel=1e-3)
    assert counts.SW_OPS_PER_CELL < counts.SW_OPS_PER_CELL_PLAIN
