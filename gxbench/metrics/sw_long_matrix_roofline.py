"""Percent of its roofline that sw_long_kernel (genomax_torch/csrc/
sw_long.cu) reached over the traced window, on the cells it computed
whatever other kernels ran beside it: the least time for the cells that
the program counted under ``cells.sw_long`` (counts.py's operations a
cell at the card's integer peak) over the kernel's device time. Read only
where the traced calls' ``cells.*`` counters sum to the cells the harness
counts from the inputs, so that the program's counter cannot move its own
yardstick."""

from gxbench import counts
from gxbench.program_trace import per_call


def route_roofline_pct(ctx, route: str, kernel: str):
    """The share of its roofline that ``kernel`` reached on the cells of
    the program's route ``route``; None where the trace or the counters
    hold nothing to read, or the counters miss the harness's count."""
    got, tr = per_call(ctx), ctx.get("trace")
    if got is None or not tr:
        return None
    calls, _, counted = got
    cells = {k: v for k, v in counted.items() if k.startswith("cells.")}
    if sum(cells.values()) != calls * ctx["cells_per_call"]:
        return None
    n, t = cells.get("cells." + route, 0), tr["kernel_s"].get(kernel, 0.0)
    if not n or not t:
        return None
    return 100.0 * n * counts.SW_OPS_PER_CELL / counts.INT32_OPS_PER_S / t


def read(ctx):
    return route_roofline_pct(ctx, "sw_long", "sw_long_kernel")
