"""genomax_torch.trace on the CPU: spans cost nothing but a flag read while
off; under ``trace.recording()`` and under a CPU ``torch.profiler`` an
engine call gives its span tree (one call id, the stages nested where the
work happens), the ``pack`` and ``execute`` spans are ``RunStats.pack_s``
and ``exec_s``, ``h2d_bytes`` counts what ``to_device`` is handed, and a
collection inside a call shows up as a ``gc`` span."""

import gc
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from genomax_torch import trace
from genomax_torch.config import EngineConfig
from genomax_torch.engine.executor import Engine
from genomax_torch.io.formats import SWPair, parse_pairhmm_file
from genomax_torch.io.generator import random_dna
from _torch_cpu import one_torch_thread  # noqa: F401

PACK_STAGES = {"pack.flatten", "pack.concat", "pack.bucket", "pack.fill",
               "pack.translate"}


def _sw_pairs(n=40, seed=3, lens=(20, 70)):
    rng = np.random.default_rng(seed)
    return [SWPair(sx=random_dna(rng, int(rng.integers(*lens))),
                   sy=random_dna(rng, int(rng.integers(*lens))))
            for _ in range(n)]


def _batches(golden_dir, n=2):
    return parse_pairhmm_file(f"{golden_dir}/10s.in")[:n]


def _children(spans, parent, skip=("gc",)):
    """Names of parent's children; collections, which the allocator may
    start anywhere, left out unless asked for."""
    return [s.name for s in spans if s.parent is parent
            and s.name not in skip]


def _root(spans):
    (call,) = [s for s in spans if s.name == "call"]
    return call


def _check_tree(spans):
    """One call, every span of it carrying its id and reaching it through
    its parents; returns the call span."""
    call = _root(spans)
    assert call.parent is None and call.call is not None
    for s in spans:
        assert s.call == call.call and s.t1 >= s.t0 > 0, s.name
        p = s
        while p.parent is not None:
            assert p.parent.t0 <= s.t0 and s.t1 <= p.parent.t1
            p = p.parent
        assert p is call
    for s in spans:
        if s.parent is not None and s.parent.name == "pack":
            assert s.name in PACK_STAGES | {"gc"}
    return call


# (entry, engine config, the call's children in order)
CASES = {
    "sw": ("sw_scores", EngineConfig(),
           ["plan", "pack", "execute", "unpack", "offload"]),
    "sw_offload": ("sw_scores", EngineConfig(max_device_len=48),
                   ["plan", "pack", "execute", "unpack", "offload"]),
    "pairhmm": ("pairhmm", EngineConfig(),
                ["plan", "plan", "pack", "execute", "unpack", "offload",
                 "fallback"]),
    "pairhmm_offload": ("pairhmm", EngineConfig(max_device_len=64),
                        ["plan", "plan", "pack", "execute", "unpack",
                         "offload", "fallback"]),
}


def _work(case, golden_dir):
    return _sw_pairs() if CASES[case][0] == "sw_scores" else _batches(
        golden_dir)


def _call(case, golden_dir):
    entry, cfg, _ = CASES[case]
    eng = Engine(cfg, device="cpu")
    work = _work(case, golden_dir)
    return eng, lambda: getattr(eng, entry)(work)


def test_off_records_nothing_and_never_calls_record_function(
        monkeypatch, golden_dir):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert trace.span("a") is trace.span("b") is trace.span("call")
    trace.take()
    for case in ("sw", "pairhmm"):
        _, run = _call(case, golden_dir)
        run()
    with trace.span("x"), trace.timed("y") as t:
        pass
    assert t.seconds >= 0
    assert trace.take() == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_tree_under_recording(case, golden_dir):
    eng, run = _call(case, golden_dir)
    with trace.recording() as rec:
        run()
    spans = rec
    call = _check_tree(spans)
    assert _children(spans, call) == CASES[case][2]
    (pack,) = [s for s in spans if s.name == "pack"]
    (execute,) = [s for s in spans if s.name == "execute"]
    assert pack.seconds == eng.last_stats.pack_s
    assert execute.seconds == eng.last_stats.exec_s
    assert {"pack.flatten", "pack.concat", "pack.bucket",
            "pack.fill"} <= set(_children(spans, pack))
    # the CPU runs the plain versions: copies, expansion and the copies
    # back, no kernel launch
    assert {"dispatch", "sync"} <= set(_children(spans, execute))
    for d in (s for s in spans if s.name == "dispatch"):
        assert "h2d" in _children(spans, d)
        if CASES[case][0] == "pairhmm":
            assert "expand" in _children(spans, d)
    (off,) = [s for s in spans if s.name == "offload"]
    if case.endswith("_offload"):
        assert eng.last_stats.offloaded_jobs
        assert {"pack.fill", "h2d", "sync"} <= set(_children(spans, off))
    else:
        assert not eng.last_stats.offloaded_jobs
        assert _children(spans, off) == []


@pytest.mark.parametrize("case", ["sw", "pairhmm"])
def test_span_tree_under_profiler(case, golden_dir, tmp_path):
    eng, run = _call(case, golden_dir)
    trace.take()
    with trace.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("caller"):
                run()
    spans = trace.take()
    assert spans == rec and trace.take() == []
    call = _check_tree(spans)
    assert _children(spans, call) == CASES[case][2]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (caller,) = [e for e in events if e["name"] == "caller"]
    (root,) = [e for e in events if e["name"] == "call"]
    lo, hi = caller["ts"], caller["ts"] + caller["dur"]
    inside = [e for e in events
              if lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
    assert root in inside
    assert sorted(e["name"] for e in inside if e is not caller) == sorted(
        s.name for s in spans)
    for e in inside:
        if e is not caller and e is not root:
            assert root["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                             <= root["ts"] + root["dur"])


def test_h2d_bytes_count_what_to_device_is_handed(monkeypatch, golden_dir):
    handed = []
    real = torch.from_numpy

    def spy(a):
        handed.append(a.nbytes)
        return real(a)

    monkeypatch.setattr(trace.torch, "from_numpy", spy)
    for case in ("sw", "sw_offload", "pairhmm", "pairhmm_offload"):
        handed.clear()
        _, run = _call(case, golden_dir)
        total = trace.counter("h2d_bytes")
        with trace.recording() as rec:
            run()
        in_spans = sum((s.counts or {}).get("h2d_bytes", 0)
                       for s in rec)
        assert handed and in_spans == sum(handed), case
        assert trace.counter("h2d_bytes") - total == sum(handed)
        assert all(s.name == "h2d" for s in rec
                   if s.counts and "h2d_bytes" in s.counts)


def test_a_bucket_copies_in_one_h2d_span(golden_dir):
    """A bucket's or a tile's arrays travel in one ``h2d`` span; of a
    PairHMM bucket, only the phred table the expansion copies has one of
    its own, inside ``expand``."""
    for case in ("sw", "sw_offload", "pairhmm", "pairhmm_offload"):
        _, run = _call(case, golden_dir)
        with trace.recording() as rec:
            run()
        for d in (s for s in rec if s.name == "dispatch"):
            assert _children(rec, d).count("h2d") == 1, case
        for s in rec:
            if s.name == "h2d":
                assert s.parent.name in ("dispatch", "expand", "offload")
                assert _children(rec, s) == []


def test_counts_go_to_totals_always_and_to_the_open_span_when_on():
    before = trace.counter("test.thing")
    trace.count("test.thing", 3)
    assert trace.counter("test.thing") == before + 3
    with trace.recording() as rec:
        with trace.span("outer"):
            trace.count("test.thing")
            with trace.span("inner"):
                trace.count("test.thing", 2)
    outer, inner = rec
    assert outer.counts == {"test.thing": 1} and inner.counts == {
        "test.thing": 2}
    assert inner.parent is outer
    assert trace.counts()["test.thing"] == before + 6


def test_collection_in_a_call_is_a_gc_span():
    with trace.recording() as rec:
        with trace.span("call"):
            with trace.span("outer"):
                gc.collect()
        assert trace._on_gc not in gc.callbacks
        gc.collect()  # outside a call: no hook, no span
    spans = rec
    call = _check_tree(spans)
    (outer,) = [s for s in spans if s.name == "outer"]
    assert _children(spans, call) == ["outer"]
    assert "gc" in _children(spans, outer, skip=())


def test_take_hands_over_the_kept_spans_once(monkeypatch):
    """Spans kept while a profiler records go to take(), which empties
    the record; past KEEP, no more are kept."""
    trace.take()
    monkeypatch.setattr(trace, "KEEP", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for name in "abcde":
            with trace.span(name):
                pass
    assert [s.name for s in trace.take()] == ["a", "b", "c"]
    assert trace.take() == []


def test_recordings_collect_their_own_spans():
    """A recording() block holds the spans of its own block; another,
    nested, holds its own; nothing is kept for take()."""
    trace.take()
    with trace.recording() as outer:
        with trace.span("a"):
            pass
        with trace.recording() as inner:
            with trace.span("b"):
                pass
        with trace.span("c"):
            pass
    assert [s.name for s in outer] == ["a", "b", "c"]
    assert [s.name for s in inner] == ["b"]
    assert trace.take() == [] and trace._sinks == []


def test_launched_counts_since_a_snapshot():
    base = trace.counts()
    total = trace.launched("test_route")
    trace.count("launches.test_route", 2)
    assert trace.launched("test_route", base) == 2
    assert trace.launched("test_route") == total + 2


def test_calls_get_their_own_ids():
    with trace.recording() as rec:
        for _ in range(3):
            with trace.span("call"):
                with trace.span("inner"):
                    pass
    calls = [s for s in rec if s.name == "call"]
    inner = [s for s in rec if s.name == "inner"]
    assert len({c.call for c in calls}) == 3
    assert [s.call for s in inner] == [c.call for c in calls]


@pytest.mark.parametrize("entry", ["sw_scores_stream", "pairhmm_stream"])
def test_stream_entry_is_one_call(entry, golden_dir):
    eng = Engine(device="cpu")
    work = _sw_pairs() if entry == "sw_scores_stream" else _batches(
        golden_dir, 3)
    with trace.recording() as rec:
        getattr(eng, entry)(work, 1 if entry == "pairhmm_stream" else 16)
    mine = [s for s in rec if s.call is not None]
    call = _root(mine)
    kids = _children(mine, call)
    chunks = kids.count("stream.wait")
    assert chunks == 3 and kids.count("execute") == chunks
    waits = sum(s.seconds for s in mine if s.name == "stream.wait")
    assert waits == pytest.approx(eng.last_stats.pack_s, abs=1e-9)
