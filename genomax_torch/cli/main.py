"""Command line of the port: ``python -m genomax_torch sw <input>`` and
``python -m genomax_torch pairhmm <input> <output>``.

The same flags and output as ``genomax sw`` and ``genomax pairhmm``: sw
prints one "Score: %d" line per pair (appended to --output when given);
pairhmm writes one "%f" log10 likelihood per line to <output>,
overwriting it; both then print "elapsed %f". --stats prints the run's
RunStats as JSON on stderr. --device picks the torch device, and there is
no fallback from one to the other: without a card, --device cuda (the
default) prints the error and returns 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_sw(args) -> int:
    from genomax_torch.config import SWConfig
    from genomax_torch.io.formats import parse_sw_file

    from genomax_torch.engine.executor import Engine

    eng = Engine(sw_cfg=SWConfig(match=args.match, mismatch=args.mismatch,
                                 gap_open=args.gap_open,
                                 gap_extend=args.gap_extend),
                 device=args.device)
    pairs = parse_sw_file(args.input)
    t0 = time.time()
    scores = eng.sw_scores(pairs)
    elapsed = time.time() - t0
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

    from genomax_torch.engine.executor import Engine

    eng = Engine(phmm_cfg=PairHMMConfig(gatk_emission=args.gatk_emission),
                 device=args.device)
    batches = parse_pairhmm_file(args.input)
    t0 = time.time()
    values = eng.pairhmm(batches)
    elapsed = time.time() - t0
    write_pairhmm_output(args.output, values)
    print("elapsed %f" % elapsed)
    if args.stats:
        print(json.dumps(eng.last_stats.as_dict()), file=sys.stderr)
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


if __name__ == "__main__":
    sys.exit(main())
