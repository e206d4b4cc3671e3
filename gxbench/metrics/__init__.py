"""Readers of the benchmark's metrics, one file each, ``<name>.py`` with
``read(ctx)``: the metric's value, or None where the run holds nothing for
it to read (the harness then leaves the metric out of the line).

``ctx`` holds ``calls`` (the window's engine calls, ``harness.Call``),
``window_s``, ``setup_s``, ``cells_per_call`` and ``bound_s_per_call``
(``counts.py``, from the inputs) and, in a traced run, ``trace``
(``trace.summarize``)."""

from __future__ import annotations


def done(ctx) -> list:
    """The calls of the window that returned."""
    return [c for c in ctx["calls"] if c.error is None]


def mean_ms(ctx, field: str):
    calls = done(ctx)
    if not calls:
        return None
    return 1e3 * sum(getattr(c, field) for c in calls) / len(calls)


def kernels_roofline_pct(ctx):
    """The share of their roofline that the port's kernels ran at over the
    traced window, whichever kernels the calls took: the least time the
    card could take for the real cells of the window's calls (counts.py)
    over the summed device time of every port kernel in the trace."""
    tr = ctx.get("trace")
    total = sum(tr["kernel_s"].values()) if tr else 0.0
    if not total:
        return None
    return 100.0 * tr["calls"] * ctx["bound_s_per_call"] / total


def roofline_pct(ctx, kernel: str):
    """The share of its roofline that ``kernel`` ran at over the traced
    window: the least time the card could take for the real cells of the
    window's calls (counts.py) over the kernel's time in the trace. Read
    only where that kernel was the only one of the port's to run, so that
    every cell counted is one it computed."""
    tr = ctx.get("trace")
    if not tr or set(tr["kernel_s"]) != {kernel} or not tr["kernel_s"][kernel]:
        return None
    return 100.0 * tr["calls"] * ctx["bound_s_per_call"] / tr["kernel_s"][kernel]
