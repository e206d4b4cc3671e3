"""The program's own spans and counters over a traced run, per engine
call: the record that ``genomax_torch.trace`` keeps in memory while the
run's profiler records, summed by span name and by counter name over the
engine calls it holds, and divided by their number. The readers of
``metrics/`` whose source is ``program_span`` or ``program_counter`` read
it here.

The harness reads the metrics after the window, once the profiler has
stopped, so the record holds the traced calls: each a ``call`` span with
the spans of its stages below it, every one carrying the call's id. The
first reader takes the record from the program (``trace.take``, which
leaves it empty) and sums it; the sums stay in ``ctx`` for the others.
Where the program keeps no record (a checkout without
``genomax_torch.trace``), where the record holds no call, or where it
holds another number of calls than the trace (``ctx["trace"]["calls"]``),
there is nothing to read and the readers return None."""

from __future__ import annotations

import importlib


KEY = "program_trace"  # where the sums stay in ctx


def per_call(ctx):
    """(calls, seconds by span name, counts by counter name) over the
    spans of the traced engine calls, or None where there is nothing to
    read."""
    if KEY not in ctx:
        ctx[KEY] = _sums(ctx)
    return ctx[KEY]


def _sums(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    try:
        trace = importlib.import_module("genomax_torch.trace")
    except ImportError:
        return None
    take = getattr(trace, "take", None)
    if take is None:
        return None
    spans = [s for s in take() if s.call is not None and s.t1]
    calls = sum(1 for s in spans if s.name == "call")
    if not calls or calls != tr["calls"]:
        return None
    seconds, counts = {}, {}
    for s in spans:
        seconds[s.name] = seconds.get(s.name, 0.0) + (s.t1 - s.t0) * 1e-9
        for k, v in (s.counts or {}).items():
            counts[k] = counts.get(k, 0) + v
    return calls, seconds, counts


def span_ms(ctx, name: str):
    """Mean milliseconds a traced call spends in spans named ``name``
    (0.0 where a call opened none)."""
    got = per_call(ctx)
    if got is None:
        return None
    calls, seconds, _ = got
    return 1e3 * seconds.get(name, 0.0) / calls


def count_per_call(ctx, prefix: str):
    """Mean count a traced call makes of the counters whose names start
    with ``prefix``."""
    got = per_call(ctx)
    if got is None:
        return None
    calls, _, counts = got
    return sum(v for k, v in counts.items() if k.startswith(prefix)) / calls
