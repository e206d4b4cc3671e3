"""Run one cell of the benchmark once and print its result line.

    python3 -m gxbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (engine calls of the window), ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, each
number compared beside its limit; the same numbers close standard error.
Without a CUDA card, or with fewer than the cell asks for, without the
program, or having loaded jax or the JAX package, the run prints no result
and exits with 1.
"""

import time

_T0 = time.perf_counter()  # set-up starts here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gxbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if a.seconds <= 0:
        p.error("--seconds must be positive")
    from gxbench.harness import HarnessError, run

    try:
        result = run(a.workload, a.seed, a.seconds, bool(a.trace), t0=_T0)
    except HarnessError as e:
        print(f"gxbench: {e}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
