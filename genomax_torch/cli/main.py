"""Command line of the port: ``python -m genomax_torch sw <input>`` and
``python -m genomax_torch pairhmm <input> <output>``.

The same flags and output as ``genomax sw`` and ``genomax pairhmm``: sw
prints one "Score: %d" line per pair (appended to --output when given);
pairhmm writes one "%f" log10 likelihood per line to <output>,
overwriting it; both then print "elapsed %f". --stats prints the run's
RunStats as JSON on stderr. --device picks the torch device, and there is
no fallback from one to the other: without a card, --device cuda (the
default) prints the error and returns 2.

--devices N scores over a mesh of N ranks (ShardedEngine), one process a
device: N is the process group's size, 1 in a lone process, the world size
under ``torchrun`` (or of --num-processes processes started with
--coordinator and each its --process-id). Rank 0 alone writes the output.
--xshard MINLEN (with --devices) sends SW pairs past --max-device-len
whose x has at least MINLEN bases through the cross-device wavefront.
"""

from __future__ import annotations

import argparse
import json
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
    cfg_kw = {} if args.max_device_len is None else dict(
        max_device_len=args.max_device_len)
    cfg = EngineConfig(xshard_min_len=args.xshard, **cfg_kw)
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


def cmd_sw(args) -> int:
    from genomax_torch.config import SWConfig
    from genomax_torch.io.formats import parse_sw_file

    eng = _build_engine(args, sw_cfg=SWConfig(
        match=args.match, mismatch=args.mismatch, gap_open=args.gap_open,
        gap_extend=args.gap_extend))
    pairs = parse_sw_file(args.input)
    t0 = time.time()
    scores = eng.sw_scores(pairs)
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

    eng = _build_engine(args, phmm_cfg=PairHMMConfig(
        gatk_emission=args.gatk_emission))
    batches = parse_pairhmm_file(args.input)
    t0 = time.time()
    values = eng.pairhmm(batches)
    elapsed = time.time() - t0
    if not _is_writer(eng):
        return 0
    write_pairhmm_output(args.output, values)
    print("elapsed %f" % elapsed)
    if args.stats:
        print(json.dumps(eng.last_stats.as_dict()), file=sys.stderr)
    return 0


def _add_mesh_args(p):
    p.add_argument("--max-device-len", type=int, metavar="L",
                   help="pairs whose padded x extent exceeds L leave the "
                        "lane-tile kernels for the long-pair paths "
                        "(EngineConfig.max_device_len; default 1024)")
    p.add_argument("--devices", type=int, metavar="N",
                   help="score over a mesh of N ranks, one process a device "
                        "(ShardedEngine); N must be the process group's size")
    p.add_argument("--xshard", type=int, metavar="MINLEN",
                   help="with --devices: SW pairs past --max-device-len with "
                        "len(x) >= MINLEN score through the cross-device "
                        "wavefront (one DP matrix in per-rank strips)")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="the process group's TCP rendezvous")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)


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
    _add_mesh_args(p)
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
    _add_mesh_args(p)
    p.set_defaults(fn=cmd_pairhmm)
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
