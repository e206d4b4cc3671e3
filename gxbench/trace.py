"""The traced run: torch.profiler over the first ``SECONDS`` of the timed
window, reduced to what the per-layer metrics and the breakdown read.

The window of a trace runs from the start of its first engine call to the
end of its last traced one (the harness's ``gxbench.call`` spans): the
calls that start in the first ``SECONDS`` of the timed window, so that a
trace of short calls stays some tens of MB. In it, the device
is busy where a kernel, a copy or a memset runs; the rest are idle gaps,
each labelled with the innermost host span open over it: a span the
harness put around a function of the port (``spans/*.json``), the engine
call itself, or ``gxbench.loop`` between calls. Kernel time is summed by
kernel, and the port's kernels are told apart by the names of the
``__global__`` functions in ``genomax_torch/csrc``.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import importlib
import json
import os
import re
import tempfile

SECONDS = 10.0
CALL = "gxbench.call"
LOOP = "gxbench.loop"
_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
    r"(\w+)\s*\(")


class TraceError(RuntimeError):
    """The profiler recorded nothing that the metrics can read."""


def port_kernels(csrc: str) -> list:
    """Names of the ``__global__`` functions in the port's CUDA sources."""
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu")):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return sorted(names)


@contextlib.contextmanager
def spans(root: str):
    """Wrap each function that ``spans/*.json`` names ([module, attribute
    path] pairs) in a ``torch.profiler.record_function`` of its attribute
    path while the block runs, and restore it after. A name the program no
    longer has is passed over."""
    import torch

    undo = []
    try:
        for path in sorted(glob.glob(os.path.join(root, "spans", "*.json"))):
            with open(path) as f:
                targets = json.load(f)
            for module, attr in targets:
                try:
                    owner = importlib.import_module(module)
                    *parents, last = attr.split(".")
                    for p in parents:
                        owner = getattr(owner, p)
                    fn = getattr(owner, last)
                except (ImportError, AttributeError):
                    continue

                def wrapped(*a, _fn=fn, _label=attr, **k):
                    with torch.profiler.record_function(_label):
                        return _fn(*a, **k)

                setattr(owner, last, functools.wraps(fn)(wrapped))
                undo.append((owner, last, fn))
        yield
    finally:
        for owner, last, fn in reversed(undo):
            setattr(owner, last, fn)


def start():
    """A started torch.profiler with CPU and CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False, profile_memory=False)
    prof.start()
    return prof


def export_events(prof) -> list:
    """The profiler's complete events, through a chrome trace written to a
    temporary file and deleted once read."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f).get("traceEvents", [])
                    if e.get("ph") == "X" and "dur" in e]
    finally:
        os.remove(path)


def short_name(name: str) -> str:
    """A kernel's name without its namespace, arguments and return type."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if name.startswith("void "):
        name = name[5:]
    return name[:120]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list, kernels: list) -> dict:
    """Busy and idle time of the device over the window of the engine
    calls, seconds by device operation, by port kernel and by idle label.
    Raises :class:`TraceError` when the window holds no call or the
    device did nothing in it."""
    calls = [e for e in events
             if e.get("cat") == "user_annotation" and e["name"] == CALL]
    if not calls:
        raise TraceError("the trace holds no engine call")
    t0 = min(e["ts"] for e in calls)
    t1 = max(e["ts"] + e["dur"] for e in calls)
    device = []
    for e in events:
        if str(e.get("cat", "")).lower() not in _DEVICE:
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b > a:
            device.append((a, b, e))
    if not device:
        raise TraceError("the profiler recorded no device activity in the "
                         "window of the engine calls")
    busy = _union([(a, b) for a, b, _ in device])
    ops, kernel_s = {}, {}
    pattern = {k: re.compile(r"(?<!\w)" + re.escape(k) + r"(?!\w)")
               for k in kernels}
    for a, b, e in device:
        is_kernel = str(e.get("cat")).lower() == "kernel"
        name = short_name(e["name"]) if is_kernel else e["name"]
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
        if is_kernel:
            for k, pat in pattern.items():
                if pat.search(e["name"]):
                    kernel_s[k] = kernel_s.get(k, 0.0) + (b - a) * 1e-6
                    break
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    idle = _label_gaps(gaps, [e for e in events
                              if e.get("cat") == "user_annotation"])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": busy_s,
        "calls": len(calls),
        "kernel_s": kernel_s,
        "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
    }


def _label_gaps(gaps, host):
    """Idle seconds by the innermost host span open over them (host spans
    of one thread nest), ``gxbench.loop`` where none is."""
    marks = []
    for e in host:
        marks.append((e["ts"], 1, e["name"]))
        marks.append((e["ts"] + e["dur"], 0, e["name"]))
    for a, b in gaps:
        marks.append((a, 2, None))
        marks.append((b, -1, None))
    # At one instant: gap ends, span ends, span starts, gap starts.
    marks.sort(key=lambda m: (m[0], m[1]))
    stack, open_gap, last, out = [], False, None, {}
    for t, kind, name in marks:
        if open_gap and last is not None and t > last:
            label = stack[-1] if stack else LOOP
            out[label] = out.get(label, 0.0) + (t - last) * 1e-6
        last = t
        if kind == 1:
            stack.append(name)
        elif kind == 0:
            if name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
        elif kind == 2:
            open_gap = True
        else:
            open_gap = False
    return out
