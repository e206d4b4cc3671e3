"""Giga DP cells a second: the real cells (counts.py, from the inputs) of
every call the window completed, over the window's wall time on the host
clock. Everything a call does is inside: the offload mask, the pack, the
copies, the kernels, the unpack, the long-pair kernels and the fp64
fallback."""

from gxbench.metrics import done


def read(ctx):
    return len(done(ctx)) * ctx["cells_per_call"] / ctx["window_s"] / 1e9
