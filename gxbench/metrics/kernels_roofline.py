"""Percent of their roofline that the port's kernels (every ``__global__``
function of genomax_torch/csrc) reached together over the traced window:
the least time for the real cells of the window's calls (counts.py) over
the summed device time of all of them, so it reads whichever kernels, and
however many, a call takes."""

from gxbench.metrics import kernels_roofline_pct


def read(ctx):
    return kernels_roofline_pct(ctx)
