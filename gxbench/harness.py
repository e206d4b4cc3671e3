"""One run of one cell: set-up, the timed window, the judgement of what
the window produced, and the metrics of the result line.

Set-up builds ``SETS`` input sets of the cell from the seed, each a call's
worth of the same sizes, an ``Engine`` on the configuration's settings,
and calls the cell's entry once on each set (the first call builds the
kernels its route loads, into the port's build directory inside the
checkout). It then freezes the garbage collector's view of what set-up
left alive, so that a full collection in the window scans only what the
program made since. The window is a closed loop with one caller: the
entry is called back to back, turning through the sets, until ``seconds``
have passed, every output kept. After it the engine is freed, the plain
reference computes the answers of each set once, and every call's output
is judged against those of its own set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

from gxbench import generate, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Input sets a run turns through: no call is handed the inputs of the call
# before it, and a program that kept answers by its inputs would have to
# hold this many batches. The reference computes each set once.
SETS = 4
# Top-level modules no run may hold: jax and the JAX package beside the
# port. Compared whole, so the port, genomax_torch, is not one of them.
FORBIDDEN = ("jax", "jaxlib", "flax", "genomax")


class HarnessError(RuntimeError):
    """The run cannot produce a result: no card, a missing piece, a module
    it may not load, a trace with nothing in it."""


@dataclasses.dataclass
class Call:
    """One engine call of the window: its wall on the host clock and the
    engine's own split of it (``RunStats``), None where the call raised."""

    wall_s: float
    pack_s: float | None = None
    exec_s: float | None = None
    fallback_jobs: int | None = None
    error: str | None = None


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def forbidden_modules(names) -> list:
    """The top-level names among module names that no run may load."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str) -> dict:
    """The workload's entry of BENCHMARK.json with its configuration,
    traffic mix and metric entries."""
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise HarnessError(f"no BENCHMARK.json at {ROOT}")
    bench = load_json(path)
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise HarnessError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return {
        "name": workload,
        "chips": int(w["chips"]),
        "config": load_json(os.path.join(ROOT, conf["file"])),
        "mix": generate.load_mix(w["traffic"]),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, workload)],
    }


def require_card(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise HarnessError("torch finds no CUDA device: the benchmark runs "
                           "on the card only")
    if torch.cuda.device_count() < chips:
        raise HarnessError(f"the cell asks for {chips} cards, torch finds "
                           f"{torch.cuda.device_count()}")


def port_inputs(traffic):
    """The program's own input types, built from the plain traffic."""
    try:
        from genomax_torch.io.formats import PairHMMBatch, PairHMMRead, SWPair
    except ImportError as e:
        raise HarnessError(f"cannot import the program: {e}") from e

    if isinstance(traffic, generate.SWPairs):
        return [SWPair(sx=x, sy=y) for x, y in zip(traffic.x, traffic.y)]
    return [PairHMMBatch(reads=[PairHMMRead(*rd) for rd in r.reads],
                         haplotypes=list(r.haps))
            for r in traffic.regions]


def make_engine(cfg: dict, device: str):
    try:
        from genomax_torch.config import EngineConfig, PairHMMConfig, SWConfig
        from genomax_torch.engine.executor import Engine
    except ImportError as e:
        raise HarnessError(f"cannot import the program: {e}") from e
    return Engine(EngineConfig(**cfg.get("engine", {})),
                  SWConfig(**cfg.get("sw", {})),
                  PairHMMConfig(**cfg.get("pairhmm", {})), device=device)


def load_metric(name: str):
    """The reader of metric ``name``: ``read(ctx)`` of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        raise HarnessError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "gxbench.metrics._" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window(engine, entry, sets, args, seconds, prof=None):
    """Call the entry back to back for ``seconds``, call i on input set
    i mod len(sets); (calls, outputs, window seconds). The window closes
    at the end of the first call that ends past the deadline. With a
    started profiler, the calls that start in the first ``trace.SECONDS``
    are traced, each in a ``gxbench.call`` span, and the profiler is
    stopped after them."""
    import torch

    fn = getattr(engine, entry)
    calls, outputs = [], []
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        a = time.perf_counter()
        try:
            with (torch.profiler.record_function(trace.CALL) if prof
                  else contextlib.nullcontext()):
                out = fn(sets[len(calls) % len(sets)], **args)
            b = time.perf_counter()
            st = engine.last_stats
            calls.append(Call(wall_s=b - a, pack_s=st.pack_s,
                              exec_s=st.exec_s,
                              fallback_jobs=st.fallback_jobs))
        except Exception as e:  # a failed call counts as failed, not fatal
            b = time.perf_counter()
            out = None
            calls.append(Call(wall_s=b - a, error=repr(e)))
        outputs.append(out)
        if prof and (b - start >= trace.SECONDS or b >= deadline):
            prof.stop()
            prof = None
        if b >= deadline:
            return calls, outputs, b - start


def nvidia_smi() -> dict:
    """The card's power limit and SM clocks as nvidia-smi reads them, to
    stand beside every number; empty where it cannot be read."""
    q = "power.limit,clocks.max.sm,clocks.sm"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
        vals = [float(v) for v in out.splitlines()[0].split(",")]
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}
    return dict(zip(("power_limit_w", "sm_clock_max_mhz", "sm_clock_mhz"),
                    vals))


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        t0: float | None = None, device: str = "cuda",
        mix: dict | None = None) -> dict:
    """One run of the cell; the result object. ``device`` and ``mix`` stand
    in for the card and the cell's traffic in the CPU tests only."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = cell(workload)
    spec["mix"] = mix or spec["mix"]
    cfg, mix = spec["config"], spec["mix"]
    try:
        import torch
    except ImportError as e:
        raise HarnessError(f"cannot import torch: {e}") from e
    if device == "cuda":
        require_card(spec["chips"])
    traffic = generate.sets(mix, seed, SETS)
    cells = {t.cells() for t in traffic}
    if len(cells) != 1:
        raise HarnessError(f"the input sets differ in cells: {sorted(cells)}")
    inputs = [port_inputs(t) for t in traffic]
    engine = make_engine(cfg, device)
    args = mix.get("entry_args", {})
    for one in inputs:
        getattr(engine, mix["entry"])(one, **args)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    try:
        with trace.spans(HERE) if traced else contextlib.nullcontext():
            prof = trace.start() if traced else None
            calls, outputs, window_s = window(engine, mix["entry"], inputs,
                                              args, seconds, prof)
    finally:
        gc.unfreeze()
    summary = None
    if traced:
        t = time.perf_counter()
        events = trace.export_events(prof)
        try:
            summary = trace.summarize(
                events,
                trace.port_kernels(os.path.join(ROOT, "genomax_torch", "csrc")))
        except trace.TraceError as e:
            raise HarnessError(f"traced run: {e}") from e
        print(f"gxbench: trace of {len(events)} events read in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
        del events
    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": 0}
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": spec["chips"],
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
        dev.update(nvidia_smi())
    if summary:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]

    del engine, inputs, prof
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = importlib.import_module("gxbench.reference." + cfg["reference"])
    exps = [ref.expected(t, cfg, device) for t in traffic[:len(calls)]]
    value, ok = ref.judge(outputs, [exps[i % SETS] for i in range(len(calls))],
                          cfg["limit"])
    failed = sum(1 for c, good in zip(calls, ok) if c.error or not good)

    ctx = {"calls": calls, "window_s": window_s, "setup_s": setup_s,
           "cells_per_call": traffic[0].cells(),
           "bound_s_per_call": traffic[0].bound_s(), "trace": summary}
    metrics = {}
    for m in spec["per_layer" if traced else "end_to_end"]:
        v = load_metric(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    bad = forbidden_modules(sys.modules)
    if bad:
        raise HarnessError(f"the run loaded {', '.join(bad)}: no run may "
                           "load jax or the JAX package")
    result = {
        "correct": bool(calls) and failed == 0 and value <= cfg["limit"],
        "attempted": len(calls),
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if summary:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    errors = sorted({c.error for c in calls if c.error})
    if errors:
        result["errors"] = errors[:3]
    # The numbers compared come last, each beside its limit.
    result["checks"] = {ref.CHECK: {"value": value, "limit": cfg["limit"]}}
    return result
