"""Command line of the port: ``python -m genomax_torch sw <input>``,
``python -m genomax_torch pairhmm <input> <output>``,
``python -m genomax_torch generate <output>``, and the harnesses ``parity``,
``soak``, ``bench`` and ``bench-dist``.

The same flags and output as ``genomax sw``, ``genomax pairhmm`` and
``genomax generate``: sw prints one "Score: %d" line per pair (appended to
--output when given); pairhmm writes one "%f" log10 likelihood per line to
<output>, overwriting it; both then print "elapsed %f". --stats prints the
run's RunStats as JSON on stderr. --device picks the torch device, and there
is no fallback from one to the other: without a card, --device cuda (the
default) prints the error and returns 2. The TPU's --backend, --interpret
(soak's too), bench's --unrolls and ``probe`` have no counterpart.

--chunk N streams the workload through ``engine/stream.py`` in chunks of N
pairs (sw) or N batches (pairhmm), the next chunk packed while this one
runs; N = 0 is the unchunked run, as in ``genomax``, and a negative N is
refused. --profile DIR records the scoring call with
``torch.profiler`` (the CPU, and the card when the engine runs there) and
writes the trace into DIR, the engine's own spans in it (``trace.py``: the
call, plan, pack and its stages, execute, copies, launches, syncs,
unpack, offload, fallback, collections); a profiler that cannot trace what
was asked fails the command. pairhmm --resume appends batch by batch and
keeps a ``<output>.progress.json`` manifest, so that a killed run
restarts at the next batch.

--devices N scores over a mesh of N ranks (ShardedEngine), one process a
device: N is the process group's size, 1 in a lone process, the world size
under ``torchrun`` (or of --num-processes processes started with
--coordinator and each its --process-id). Rank 0 alone writes the output.
--xshard MINLEN (with --devices) sends SW pairs past --max-device-len
whose x has at least MINLEN bases through the cross-device wavefront, in
blocks of --unroll diagonals. --chunk and --resume take no --devices.

``parity`` diffs the engine against the reference binaries, or the
vendored goldens (testing/parity.py); ``soak`` runs the seeded campaign
against the oracles, ``--deep`` the sharded engine and the long-read
kernel (testing/soak.py); ``bench`` times the kernels the engine runs, by
length (bench/sweep.py); ``bench-dist`` times ShardedEngine on meshes of
the first K ranks of the process group (bench/scaling.py). ``bench-dist``
and ``soak --deep --devices N`` start the process group as ``sw
--devices`` does. Each takes --device, default cuda.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def _build_engine(args, **kw):
    """Engine, or ShardedEngine over a mesh of --devices ranks, with the
    process group started first (genomax.cli.main._build_engine)."""
    from genomax_torch.config import EngineConfig
    from genomax_torch.engine.executor import Engine

    if args.xshard is not None and not args.devices:
        raise ValueError("--xshard routes through the cross-device "
                         "wavefront; it requires --devices N")
    if args.chunk and args.devices:
        raise ValueError("--chunk streams through the local engine; "
                         "it cannot be combined with --devices")
    cfg_kw = {} if args.max_device_len is None else dict(
        max_device_len=args.max_device_len)
    cfg = EngineConfig(xshard_min_len=args.xshard, unroll=args.unroll,
                       **cfg_kw)
    if not args.devices:
        return Engine(cfg, device=args.device, **kw)
    from genomax_torch.dist.engine import ShardedEngine
    from genomax_torch.dist.mesh import (BACKENDS, initialize_distributed,
                                         make_mesh)

    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id, backend=BACKENDS[args.device])
    return ShardedEngine(make_mesh(args.devices, device=args.device), cfg,
                         **kw)


def _is_writer(eng) -> bool:
    """Every rank computes the same results; rank 0 writes them."""
    return getattr(eng, "mesh", None) is None or eng.mesh.rank == 0


@contextlib.contextmanager
def _profiled(args, eng):
    """torch.profiler around the scoring call for --profile DIR: CPU
    activity, and CUDA activity when the engine runs on the card. The trace
    goes into DIR (``<host>_<pid>.<n>.pt.trace.json``). It raises where the
    profiler cannot trace the card, or traced no device work on a run that
    had some, rather than leave a trace without the card in it."""
    if args.profile is None:
        yield
        return
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile,
                                supported_activities, tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("--profile: this torch's profiler cannot "
                               "trace CUDA")
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(args.profile)) as p:
        yield
    stats = eng.last_stats
    if (eng.device.type == "cuda" and stats is not None and stats.buckets
            and not any(e.device_type == DeviceType.CUDA
                        for e in p.events())):
        raise RuntimeError("--profile: the profiler recorded no CUDA "
                           "activity on a run that used the card")


def cmd_sw(args) -> int:
    from genomax_torch.config import SWConfig
    from genomax_torch.io.formats import parse_sw_file

    eng = _build_engine(args, sw_cfg=SWConfig(
        match=args.match, mismatch=args.mismatch, gap_open=args.gap_open,
        gap_extend=args.gap_extend))
    pairs = parse_sw_file(args.input)
    t0 = time.time()
    with _profiled(args, eng):
        scores = (eng.sw_scores_stream(pairs, args.chunk) if args.chunk
                  else eng.sw_scores(pairs))
    elapsed = time.time() - t0
    if not _is_writer(eng):
        return 0
    lines = "".join("Score: %d\n" % s for s in scores)
    if args.output:
        with open(args.output, "a") as f:
            f.write(lines)
    else:
        sys.stdout.write(lines)
    print("elapsed %f" % elapsed)
    if args.stats:
        print(json.dumps(eng.last_stats.as_dict()), file=sys.stderr)
    return 0


def cmd_pairhmm(args) -> int:
    from genomax_torch.config import PairHMMConfig
    from genomax_torch.io.formats import parse_pairhmm_file, write_pairhmm_output

    if args.resume and args.devices:
        raise ValueError("--resume checkpoints the output of one process; "
                         "it cannot be combined with --devices")
    eng = _build_engine(args, phmm_cfg=PairHMMConfig(
        gatk_emission=args.gatk_emission))
    batches = parse_pairhmm_file(args.input)
    if args.resume:
        with _profiled(args, eng):
            return _pairhmm_resumable(args, eng, batches)
    t0 = time.time()
    with _profiled(args, eng):
        values = (eng.pairhmm_stream(batches, args.chunk) if args.chunk
                  else eng.pairhmm(batches))
    elapsed = time.time() - t0
    if not _is_writer(eng):
        return 0
    write_pairhmm_output(args.output, values)
    print("elapsed %f" % elapsed)
    if args.stats:
        print(json.dumps(eng.last_stats.as_dict()), file=sys.stderr)
    return 0


def _pairhmm_resumable(args, eng, batches) -> int:
    """Batch by batch, each batch's values appended to the output and the
    manifest ``<output>.progress.json`` rewritten after it, so that a killed
    run restarts at the next batch (genomax.cli.main._pairhmm_resumable).
    The manifest records the input, the scoring config (the emission model),
    the batches done and the output's lines; a manifest of another input or
    config, or an output shorter than it records, restarts from scratch."""
    from genomax_torch.io.formats import format_pairhmm_values

    manifest_path = args.output + ".progress.json"
    # Values written under another emission model must not be mixed with
    # this run's (SW's scoring flags do not reach pairhmm).
    fp = {"gatk_emission": bool(args.gatk_emission)}
    done, lines = 0, 0
    if os.path.exists(manifest_path) and os.path.exists(args.output):
        with open(manifest_path) as f:
            m = json.load(f)
        # A manifest without some key was written when that key's behaviour
        # was its default, False: compare with that, never with this run's
        # flags. A manifest of the scaled-recurrence step, whose values
        # differ from the classic step's within fp32, restarts.
        mcfg = m.get("config", {})
        stale_scaled = bool(mcfg.get("scaled_recurrence", False))
        mcfg = {k: bool(mcfg.get(k, False)) for k in fp}
        if m.get("input") != os.path.abspath(args.input):
            pass  # another workload: restart
        elif mcfg != fp or stale_scaled:
            print("resume manifest was written with different scoring "
                  "config; restarting from scratch", file=sys.stderr)
        else:
            done, lines = int(m["completed_batches"]), int(m["lines"])
    if done:
        # keep the checkpointed lines, drop a partial tail past them
        with open(args.output) as f:
            kept = [ln for _, ln in zip(range(lines), f)]
        if len(kept) < lines:
            print(f"output has {len(kept)} lines but manifest records "
                  f"{lines}; restarting from scratch", file=sys.stderr)
            done, lines, kept = 0, 0, []
        with open(args.output, "w") as f:
            f.writelines(kept)
        if done:
            print(f"resuming at batch {done}/{len(batches)}",
                  file=sys.stderr)
    else:
        open(args.output, "w").close()
    t0 = time.time()
    for i in range(done, len(batches)):
        vals = eng.pairhmm([batches[i]])
        with open(args.output, "a") as f:
            f.write(format_pairhmm_values(vals))
        lines += len(vals)
        with open(manifest_path, "w") as f:
            json.dump({"input": os.path.abspath(args.input), "config": fp,
                       "completed_batches": i + 1, "lines": lines}, f)
    print("elapsed %f" % (time.time() - t0))
    if args.stats and eng.last_stats is not None:
        print(json.dumps(eng.last_stats.as_dict()), file=sys.stderr)
    return 0


def cmd_generate(args) -> int:
    from genomax_torch.io.generator import write_sw_file

    write_sw_file(args.output, num_alignments=args.num, min_len=args.min_len,
                  max_len=args.max_len, seed=args.seed)
    print(f"wrote {2 * args.num} sequences ({args.num} alignments) to "
          f"{args.output}")
    return 0


def _add_engine_args(p):
    p.add_argument("--chunk", type=int, metavar="N",
                   help="stream the workload in chunks of N pairs (sw) / N "
                        "batches (pairhmm), the next chunk packed while this "
                        "one runs (engine/stream.py; local engine only); 0 "
                        "runs unchunked")
    p.add_argument("--profile", metavar="DIR",
                   help="record the run with torch.profiler (CPU, and CUDA "
                        "on the card) and write the trace into DIR")
    p.add_argument("--unroll", type=int, default=32,
                   choices=[1, 2, 4, 8, 16, 32], metavar="{1,2,4,8,16,32}",
                   help="the cross-device block length U of --xshard: the "
                        "diagonals one launch sweeps and the halo rows a "
                        "rank hands on a block (EngineConfig.unroll; the "
                        "other kernels do not read it)")
    p.add_argument("--max-device-len", type=int, metavar="L",
                   help="pairs whose padded x extent exceeds L leave the "
                        "lane-tile kernels for the long-pair paths "
                        "(EngineConfig.max_device_len; default 1024, any "
                        "L >= 8)")
    p.add_argument("--devices", type=int, metavar="N",
                   help="score over a mesh of N ranks, one process a device "
                        "(ShardedEngine); N must be the process group's size")
    p.add_argument("--xshard", type=int, metavar="MINLEN",
                   help="with --devices: SW pairs past --max-device-len with "
                        "len(x) >= MINLEN score through the cross-device "
                        "wavefront (one DP matrix in per-rank strips)")
    _add_group_args(p)


def _add_group_args(p):
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="the process group's TCP rendezvous")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)


def _start_group(args):
    """Start the process group of --coordinator, --num-processes and
    --process-id (or torchrun's environment): NCCL on cuda, gloo on the
    CPU; a no-op for one process."""
    from genomax_torch.dist.mesh import BACKENDS, initialize_distributed

    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id, backend=BACKENDS[args.device])


def cmd_parity(args) -> int:
    from genomax_torch.testing.parity import run_parity

    return run_parity(reference_dir=args.reference_dir, device=args.device)


def cmd_soak(args) -> int:
    from genomax_torch.testing import soak

    if args.deep:
        _start_group(args)
    return soak.main(args)


def cmd_bench(args) -> int:
    from genomax_torch.bench.sweep import run_pairhmm_sweep, run_sweep

    if args.kernel == "pairhmm":
        pts = [tuple(int(x) for x in spec.split(","))
               for spec in args.pairhmm_points.split(";")]
        if any(len(p) != 4 for p in pts):
            raise ValueError(f"--pairhmm-points {args.pairhmm_points!r}: "
                             "want n_reads,n_haps,read_len,hap_len;...")
        run_pairhmm_sweep(pts, device=args.device, json_out=args.json)
        return 0
    run_sweep([int(x) for x in args.lengths.split(",")], args.num,
              device=args.device, json_out=args.json)
    return 0


def cmd_bench_dist(args) -> int:
    from genomax_torch.bench.scaling import run_scaling

    _start_group(args)
    run_scaling([int(x) for x in args.devices.split(",")], args.num,
                args.length, device=args.device, json_out=args.json)
    return 0


def main(argv=None) -> int:
    import genomax_torch

    ap = argparse.ArgumentParser(
        prog="genomax_torch",
        description="pairwise alignment scoring on PyTorch and CUDA")
    ap.add_argument("--version", action="version",
                    version=f"genomax_torch {genomax_torch.__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("sw", help="Smith-Waterman affine-gap scores for a "
                                  "pairs file")
    p.add_argument("input")
    p.add_argument("--output", help="append 'Score: N' lines to this file")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--match", type=int, default=1)
    p.add_argument("--mismatch", type=int, default=-1)
    p.add_argument("--gap-open", type=int, default=-3)
    p.add_argument("--gap-extend", type=int, default=-1)
    p.add_argument("--stats", action="store_true",
                   help="print JSON run stats to stderr")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_sw)
    p = sub.add_parser("pairhmm", help="PairHMM forward log10 likelihoods "
                                       "for a reads x haplotypes file")
    p.add_argument("input")
    p.add_argument("output", help="one '%%f' value per line (overwritten)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--gatk-emission", action="store_true",
                   help="GATK mismatch emission Qr/3 instead of the "
                        "reference's plain Qr")
    p.add_argument("--stats", action="store_true",
                   help="print JSON run stats to stderr")
    p.add_argument("--resume", action="store_true",
                   help="batch by batch, with a <output>.progress.json "
                        "manifest to restart a killed run at the next batch "
                        "(--chunk does not apply)")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_pairhmm)
    p = sub.add_parser("generate", help="random ATGC SW input file")
    p.add_argument("output")
    p.add_argument("--num", type=int, default=500)
    p.add_argument("--min-len", type=int, default=450)
    p.add_argument("--max-len", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_generate)
    p = sub.add_parser("bench", help="length sweep of kernel-only GCUPS "
                                     "(bench/sweep.py)")
    p.add_argument("--kernel", default="sw", choices=["sw", "pairhmm"])
    p.add_argument("--pairhmm-points",
                   default="1024,8,151,300;4096,8,151,300;1024,8,250,400",
                   help="semicolon-separated n_reads,n_haps,read_len,hap_len")
    p.add_argument("--lengths", default="64,128,256,512,1024")
    p.add_argument("--num", type=int, default=25000,
                   help="alignments per point")
    p.add_argument("--json", help="write the rows as JSON to this path")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.set_defaults(fn=cmd_bench)
    p = sub.add_parser("bench-dist", help="pairs/s scaling of ShardedEngine "
                                          "over meshes of 1..N ranks "
                                          "(bench/scaling.py)")
    p.add_argument("--devices", default="1,2,4,8",
                   help="mesh sizes to sweep, each the first K ranks of the "
                        "process group")
    p.add_argument("--num", type=int, default=2048, help="alignments")
    p.add_argument("--length", type=int, default=256)
    p.add_argument("--json", help="write the rows as JSON to this path")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    _add_group_args(p)
    p.set_defaults(fn=cmd_bench_dist)
    p = sub.add_parser("parity", help="diff against the reference C "
                                      "binaries, or the vendored goldens")
    p.add_argument("--reference-dir", default="/root/reference")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.set_defaults(fn=cmd_parity)
    p = sub.add_parser("soak", help="seeded randomised differential soak "
                                    "against the fp64 oracles")
    p.add_argument("--rounds", type=int, default=24)
    p.add_argument("--seed", type=int, default=20260817)
    p.add_argument("--deep", action="store_true",
                   help="the deep paths: ShardedEngine on a mesh and the "
                        "long-read kernel on adversarial rescale patterns")
    p.add_argument("--devices", type=int, default=1,
                   help="the mesh size of --deep's sharded rounds (the "
                        "process group's size)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    _add_group_args(p)
    p.set_defaults(fn=cmd_soak)
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"genomax_torch: error: no such file: {e.filename}",
              file=sys.stderr)
        return 2
    except (ValueError, RuntimeError) as e:
        # RuntimeError: no CUDA device for --device cuda, or EngineError
        # from a kernel that failed to build or launch; nothing falls back
        # to the CPU.
        print(f"genomax_torch: error: {e}", file=sys.stderr)
        return 2
    finally:
        _leave_group()


def _leave_group():
    """Destroy the process group that --devices started, if any."""
    if "torch.distributed" not in sys.modules:
        return
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
