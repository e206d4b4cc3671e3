"""The reduction of a profiler trace, on a synthetic chrome trace."""

import pytest

from gxbench import harness, trace
from gxbench.metrics import kernels_roofline_pct, roofline_pct


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _ev(trace.CALL, "user_annotation", 0, 100),
    _ev("pack_sw_pairs", "user_annotation", 5, 40),
    _ev("Engine._sw_run", "user_annotation", 50, 45),
    _ev(trace.CALL, "user_annotation", 110, 90),
    _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 55, 5),
    _ev("void (anonymous namespace)::sw_strips_kernel<3, 4>(signed char const*, int)", "kernel", 60, 20),
    _ev("void at::native::elementwise_kernel<128>(int)", "kernel", 70, 15),
    _ev("void sw_strips_kernel<3, 4>(signed char const*, int)", "kernel", 150, 30),
    _ev("before the window", "kernel", -50, 10),
]


def test_summary():
    s = trace.summarize(EVENTS, ["sw_strips_kernel", "sw_long_kernel"])
    assert s["window_s"] == pytest.approx(200e-6)
    # Busy: 55-85 and 150-180.
    assert s["busy_s"] == pytest.approx(60e-6)
    assert s["kernel_s"] == {"sw_strips_kernel": pytest.approx(50e-6)}
    assert s["calls"] == 2
    idle = dict(s["idle_gaps"])
    assert idle["pack_sw_pairs"] == pytest.approx(40e-6)
    assert idle["Engine._sw_run"] == pytest.approx(5e-6 + 10e-6)
    assert idle[trace.CALL] == pytest.approx(5e-6 + 5e-6 + 5e-6 + 40e-6 + 20e-6)
    assert idle[trace.LOOP] == pytest.approx(10e-6)
    assert sum(idle.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    assert dict(s["device_ops"])["sw_strips_kernel<3, 4>"] == pytest.approx(50e-6)


def test_empty_device_trace_fails():
    with pytest.raises(trace.TraceError, match="no device activity"):
        trace.summarize([e for e in EVENTS if e["cat"] == "user_annotation"], [])


def test_roofline_reads_one_kernel_only():
    s = trace.summarize(EVENTS, ["sw_strips_kernel"])
    ctx = {"trace": s, "bound_s_per_call": 10e-6}
    assert roofline_pct(ctx, "sw_strips_kernel") == pytest.approx(40.0)
    assert roofline_pct(ctx, "sw_long_kernel") is None
    s["kernel_s"]["sw_long_kernel"] = 1.0
    assert roofline_pct(ctx, "sw_strips_kernel") is None


def test_kernels_roofline_sums_every_port_kernel():
    """The kernel layer reads with any number of port kernels in the
    trace: two kernels' time adds, and a trace with none reads nothing."""
    s = trace.summarize(EVENTS, ["sw_strips_kernel"])
    ctx = {"trace": s, "bound_s_per_call": 10e-6}
    assert kernels_roofline_pct(ctx) == pytest.approx(40.0)
    s["kernel_s"]["sw_long_kernel"] = 50e-6
    assert kernels_roofline_pct(ctx) == pytest.approx(20.0)
    s["kernel_s"] = {}
    assert kernels_roofline_pct(ctx) is None
    assert kernels_roofline_pct({"trace": None}) is None


def test_port_kernels_named():
    names = trace.port_kernels(harness.ROOT + "/genomax_torch/csrc")
    for k in ("sw_strips_kernel", "sw_long_kernel", "pairhmm_tile_kernel",
              "sw_tile_kernel", "pairhmm_long_kernel"):
        assert k in names


def test_spans_wrap_and_restore():
    from genomax_torch.engine import executor

    before = executor.pack_sw_pairs
    with trace.spans(harness.HERE):
        assert executor.pack_sw_pairs is not before
        assert executor.Engine._sw_run.__name__ == "_sw_run"
    assert executor.pack_sw_pairs is before
