"""Percent of its roofline that sw_strips_kernel
(genomax_torch/csrc/sw_strips.cu) reached over the traced window: the
least time for the real cells of the window's calls (counts.py) over the
kernel's device time."""

from gxbench.metrics import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "sw_strips_kernel")
