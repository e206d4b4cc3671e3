"""Mesh scaling benchmark of the port (the counterpart of
``genomax.bench.scaling``): pairs/s and parallel efficiency of
``ShardedEngine`` at 1..N devices (BASELINE.json: "pairs/s scaling
efficiency at 1 chip, 1 host, and N>=2 hosts").

A point of K devices runs on a mesh of the first K ranks of the process
group (a ``torch.distributed.new_group`` of ranks 0..K-1), one process a
device; ranks past K wait at a barrier. A K above the group's size prints
the ``--`` row with ``make_mesh``'s error and the sweep goes on. Rank 0
prints. Every point's scores must equal the first point's. On the CPU the
ranks are gloo processes sharing the host's cores: that checks the sharded
path and measures its overhead, not card scaling.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
import torch.distributed as dist

from genomax_torch.config import EngineConfig
from genomax_torch.dist.engine import ShardedEngine
from genomax_torch.dist.mesh import make_mesh
from genomax_torch.io.formats import SWPair
from genomax_torch.io.generator import random_dna


def bench_scaling_point(mesh, pairs, trials: int = 3):
    """(row, scores): the best of ``trials`` host-clock walls of
    ``ShardedEngine(mesh).sw_scores(pairs)`` after a warm call, the ranks
    lined up at a barrier before each run."""
    eng = ShardedEngine(mesh, EngineConfig())
    scores = eng.sw_scores(pairs)  # build + warm
    best = float("inf")
    for _ in range(trials):
        if mesh.group is not None:
            dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        eng.sw_scores(pairs)
        best = min(best, time.perf_counter() - t0)
    return {
        "devices": mesh.size,
        "elapsed_ms": round(best * 1e3, 4),
        "pairs_per_s": round(len(pairs) / best, 1),
    }, scores


def run_scaling(device_counts, num_alignments: int, length: int,
                device="cuda", json_out=None):
    rng = np.random.default_rng(0)
    pairs = [
        SWPair(sx=random_dna(rng, length) + b"\n",
               sy=random_dna(rng, length) + b"\n")
        for _ in range(num_alignments)
    ]
    grouped = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if grouped else (0, 1)
    out = print if rank == 0 else (lambda *_: None)
    kind = torch.device(device).type
    out(f"SW scaling: {num_alignments} x {length}bp, platform={kind}, "
        f"process group of {world} rank(s)")
    if world == 1:
        out("NOTE: one rank, so only the 1-device point can measure: this "
            "run cannot show scaling")
    if kind == "cpu":
        out("NOTE: gloo ranks on the CPU share the host's cores: this checks "
            "the sharded path and measures its overhead, not card scaling")
    out(f"{'devices':>8} {'ms':>10} {'pairs/s':>12} {'speedup':>8} "
        f"{'efficiency':>10}")
    rows, base, want = [], None, None
    for n in device_counts:
        try:
            group = (dist.new_group(list(range(n)))
                     if grouped and n <= world else None)
            if rank >= n:
                continue  # past this point's mesh: wait at the barrier
            try:
                r, scores = bench_scaling_point(
                    make_mesh(n, device=device, group=group), pairs)
            except ValueError as e:
                out(f"{n:>8}   -- {e}")
                continue
            if want is None:
                want = scores
            elif not np.array_equal(scores, want):
                raise RuntimeError(f"{n} devices scored differently from "
                                   f"{rows[0]['devices']}")
            if base is None:
                base, base_n = r["pairs_per_s"], n
            r["speedup"] = round(r["pairs_per_s"] / base, 2)
            # normalised to the first point that succeeded, so that a
            # skipped first count cannot make speedup and efficiency
            # disagree
            r["efficiency"] = round(r["speedup"] / (n / base_n), 3)
            rows.append(r)
            out(f"{n:>8} {r['elapsed_ms']:>10.1f} {r['pairs_per_s']:>12.1f} "
                f"{r['speedup']:>8.2f} {r['efficiency']:>10.3f}")
        finally:
            if grouped:
                dist.barrier()
    if json_out and rank == 0:
        with open(json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows
