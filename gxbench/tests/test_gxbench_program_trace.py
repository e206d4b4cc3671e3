"""The readers of the program's own spans and counters
(``program_trace.py``): None where the program keeps no record, or one
that does not hold the traced calls; the per-call mean on a record built
by hand."""

import sys

import pytest

from gxbench import harness
from genomax_torch import trace

READERS = ["plan_ms", "h2d_ms", "h2d_mb", "launch_ms", "launches", "sync_ms",
           "offload_ms", "fallback_ms", "gc_ms"]


def _span(name, t0_ms, t1_ms, parent=None, call=None, counts=None):
    s = trace.Span(name, call)
    s.t0, s.t1 = int(t0_ms * 1e6), int(t1_ms * 1e6)
    s.parent, s.counts = parent, counts
    if parent is not None and call is None:
        s.call = parent.call
    return s


def _record():
    """Two calls: 30 and 50 ms. The first plans 2 + 1 ms, copies 4 ms
    (3 MB), launches twice in 1 ms, syncs 6 ms, offloads 10 ms and
    collects 2 ms; the second plans 4 ms, copies 1 MB in 2 ms, launches
    once in 1 ms, syncs 10 ms, falls back 8 ms and collects 0 ms."""
    a = _span("call", 0, 30, call=1)
    b = _span("call", 100, 150, call=2)
    off = _span("offload", 10, 20, a)
    return [
        a, _span("plan", 0, 2, a), _span("plan", 2, 3, a),
        _span("h2d", 3, 7, a, counts={"h2d_bytes": 3_000_000}),
        _span("launch", 7, 8, a, counts={"launches.tile": 1,
                                         "launches.strips": 1}),
        _span("sync", 8, 9, a), off, _span("sync", 15, 20, off),
        _span("gc", 16, 18, off),
        b, _span("plan", 100, 104, b),
        _span("h2d", 104, 106, b, counts={"h2d_bytes": 1_000_000}),
        _span("launch", 106, 107, b, counts={"launches.pairhmm_tile": 1}),
        _span("sync", 107, 117, b), _span("fallback", 120, 128, b),
        # outside any call, and a span still open: neither is read
        _span("plan", 200, 290), _span("sync", 300, 0, b),
    ]


WANT = {"plan_ms": 3.5, "h2d_ms": 3.0, "h2d_mb": 2.0, "launch_ms": 1.0,
        "launches": 1.5, "sync_ms": 8.0, "offload_ms": 5.0,
        "fallback_ms": 4.0, "gc_ms": 1.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_per_call_mean(monkeypatch, name):
    monkeypatch.setattr(trace, "take", _record)
    got = harness.load_metric(name)({"trace": {"calls": 2}})
    assert got == pytest.approx(WANT[name])


def test_readers_take_the_record_once(monkeypatch):
    taken = []
    monkeypatch.setattr(trace, "take", lambda: taken.append(1) or _record())
    ctx = {"trace": {"calls": 2}}
    got = {name: harness.load_metric(name)(ctx) for name in READERS}
    assert got == pytest.approx(WANT) and taken == [1]


@pytest.mark.parametrize("name", READERS)
def test_reader_none_without_record(monkeypatch, name):
    read = harness.load_metric(name)
    monkeypatch.setattr(trace, "take", _record)
    # an untraced run, and a record of other calls than the trace's
    assert read({"trace": None}) is None
    assert read({"trace": {"calls": 3}}) is None
    monkeypatch.setattr(trace, "take", lambda: [])
    assert read({"trace": {"calls": 2}}) is None
    # a checkout whose program has no trace module
    monkeypatch.setitem(sys.modules, "genomax_torch.trace", None)
    assert read({"trace": {"calls": 2}}) is None
