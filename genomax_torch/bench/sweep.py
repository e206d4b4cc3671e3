"""Benchmark sweep of the port (the counterpart of ``genomax.bench.sweep``):
kernel-only GCUPS by length, the analogue of the reference's hiprun.sh
sweep (smithWaterman/hiprun.sh:18-39: lengths {64..1024}, 25,000
alignments per point; tabulated in BASELINE.md).

A point packs its seeded workload and routes it through the engine's own
prep (``Engine._sw_prep``, ``Engine._phmm_prep``, and for the pairs the
engine offloads ``kernels.sw_long.tile_launches``), so it times the kernel
the engine runs on that workload. The preps and the copies to the device
happen once, before the timing window, which holds only the kernel
launches: the slope (t(k2) - t(2)) / (k2 - 2) over back-to-back runs of
every launch of the workload, each t the best of ``trials``, by CUDA events
on the card (by the host clock on the CPU, where the launches are the plain
versions and synchronous). The port's kernels take their geometry from
their pickers: there is no unroll knob.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from genomax_torch.config import MAX_PHMM_ROWS
from genomax_torch.engine.executor import Engine, _jobs
from genomax_torch.io.formats import SWPair
from genomax_torch.io.generator import generate_pairhmm_batch, random_dna
from genomax_torch.kernels import sw_long
from genomax_torch.pack import pack_sw_pairs


def sw_launches(eng: Engine, pairs) -> list[tuple[str, object]]:
    """(route, launch) of every kernel launch ``eng.sw_scores(pairs)`` makes:
    a bucket's ("strips", "rotor", "stacked" or "tile") through the engine's
    prep, a tile of the pairs it offloads as "sw_long". Raises ValueError
    where the engine would score pairs on the host (native model)."""
    off = eng._sw_offload_mask(pairs)
    buckets = pack_sw_pairs(pairs, job_mask=None if off is None else ~off,
                            stream_band=eng._stream_band())
    runs = [eng._sw_prep(b) for b in buckets]
    if off is not None:
        idx = np.nonzero(off)[0]
        on_device = eng._sw_long_ok(pairs, idx)
        if not on_device.all():
            raise ValueError(
                f"{int((~on_device).sum())} pairs past max_device_diags: the "
                "engine scores them with the native model on the host, "
                "which the sweep does not time")
        runs += [("sw_long", launch) for _, _, launch in sw_long.tile_launches(
            [pairs[i] for i in idx], eng.sw_cfg, device=eng.device)]
    return runs


def phmm_launches(eng: Engine, batches):
    """(launches, jobs, cells): the engine's pack of ``batches`` and each
    bucket's launch through its prep (copies and expansion done), the job
    count and Σ rl·hl. Raises ValueError where the engine would offload
    jobs (reads past max_device_len // 2 take the long-read kernel)."""
    off = eng._phmm_offload_mask(_jobs(batches))
    if off is not None:
        raise ValueError(
            f"{int(off.sum())} jobs past the lane-tile kernel's "
            f"{min(eng.cfg.max_device_len // 2, MAX_PHMM_ROWS) - 2}bp reads: "
            "the engine sends "
            "them to the long-read kernel, which the PairHMM sweep does not "
            "time")
    buckets, n = eng._phmm_pack(batches)
    cells = sum(int((b.rl.astype(np.int64) * b.hl).sum()) for b in buckets)
    return [eng._phmm_prep(b) for b in buckets], n, cells


def slope_s(launches, k2: int, device: torch.device, trials: int = 3):
    """Seconds of one more back-to-back run of every launch:
    (t(k2) - t(2)) / (k2 - 2), each t(k) the best of ``trials`` timings of
    k runs, the launches warmed (built) first."""
    cuda = device.type == "cuda"
    for f in launches:
        f()
    if cuda:
        torch.cuda.synchronize(device)

    def fenced(k):
        best = float("inf")
        for _ in range(trials):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(k):
                    for f in launches:
                        f()
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(k):
                    for f in launches:
                        f()
                t = time.perf_counter() - t0
            best = min(best, t)
        return best

    t2, tk = fenced(2), fenced(k2)
    return max((tk - t2) / (k2 - 2), 1e-12)


def bench_sw_point(length: int, num_alignments: int, device="cuda",
                   trials: int = 3, seed: int = 0) -> dict:
    """One sweep point: ``num_alignments`` seeded pairs of ``length`` random
    bases + '\\n' each side, the kernel-only slope of the engine's
    launches for them. Cells count the '\\n' as a base, as the C does."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(num_alignments):
        a = random_dna(rng, length) + b"\n"
        b = random_dna(rng, length) + b"\n"
        pairs.append(SWPair(sx=a, sy=b))
    eng = Engine(device=device)
    runs = sw_launches(eng, pairs)
    routes = sorted({r for r, _ in runs})
    if "sw_long" in routes:
        print(f"  note: LEN={length}: len(x) + 2 > max_device_len="
              f"{eng.cfg.max_device_len}, so the engine offloads these pairs "
              "to the long-pair kernel; this point times that route (sw_long, "
              "tiles of 128)")
    # enough extra runs that the slope dwarfs timer noise even when one
    # run is ~0.1 ms, without making the long points take minutes
    k2 = 2 + max(4, min(32, 4096 // max(length, 64)))
    per = slope_s([f for _, f in runs], k2, eng.device, trials)
    cells = num_alignments * (length + 1) ** 2
    return {
        "length": length,
        "slope_reps": k2,
        "elapsed_ms": round(per * 1e3, 6),
        "gcups": round(cells / per / 1e9, 3),
        "routes": routes,
        "device": eng.device.type,
    }


def run_sweep(lengths, num_alignments, device="cuda", json_out=None):
    rows = []
    print(f"SW sweep: {num_alignments} alignments per point, device={device}")
    print(f"{'LEN':>6} {'ms':>12} {'GCUPS':>10}  route")
    for L in lengths:
        r = bench_sw_point(L, num_alignments, device)
        rows.append(r)
        print(f"{L:>6} {r['elapsed_ms']:>12.4f} {r['gcups']:>10.2f}  "
              f"{'+'.join(r['routes'])}")
    if json_out:
        with open(json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


def bench_pairhmm_point(n_reads: int, n_haps: int, read_len: int,
                        hap_len: int, device="cuda", trials: int = 3,
                        seed: int = 0) -> dict:
    """One PairHMM sweep point: ``generate_pairhmm_batch``'s seeded batch,
    the kernel-only slope of the engine's bucket launches. Cells =
    Σ rl·hl."""
    batch = generate_pairhmm_batch(n_reads, n_haps, read_len=read_len,
                                   hap_len=hap_len, seed=seed)
    eng = Engine(device=device)
    launches, n, cells = phmm_launches(eng, [batch])
    k2 = 2 + max(4, min(16, (1 << 31) // max(cells, 1)))
    per = slope_s(launches, k2, eng.device, trials)
    return {
        "pairs": n,
        "read_len": read_len,
        "hap_len": hap_len,
        "slope_reps": k2,
        "elapsed_ms": round(per * 1e3, 6),
        "gcups": round(cells / per / 1e9, 3),
        "device": eng.device.type,
    }


def run_pairhmm_sweep(points, device="cuda", json_out=None):
    """points: list of (n_reads, n_haps, read_len, hap_len)."""
    rows = []
    print(f"PairHMM sweep, device={device}")
    print(f"{'pairs':>8} {'read':>6} {'hap':>6} {'ms':>12} {'GCUPS':>8}")
    for nr, nh, rl, hl in points:
        r = bench_pairhmm_point(nr, nh, rl, hl, device)
        rows.append(r)
        print(f"{r['pairs']:>8} {rl:>6} {hl:>6} {r['elapsed_ms']:>12.4f} "
              f"{r['gcups']:>8.2f}")
    if json_out:
        with open(json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows
