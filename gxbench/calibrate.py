"""Readings that the limit of a cell's check is set from, on the card, in
one process:

    python3 -m gxbench.calibrate --workload <cell> --seeds 11,12,... \
        --seconds 3 --controls 3

For every seed, one run of the cell on the card with a short window at
the cell's own load (``harness.run``): the program's reading of the
number compared, the lower reading. For the first ``--controls`` seeds,
every control of the configuration's reference (``CONTROLS``: the
reference in a lower precision, or with a guarantee broken) put in the
program's place on the seed's first input set, on the card, and judged
the same way: the upper readings. One JSON line a reading. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from gxbench import generate, harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gxbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one run each")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=3,
                   help="seeds, from the first, on which to run the controls")
    a = p.parse_args(argv)
    spec = harness.cell(a.workload)
    cfg = spec["config"]
    ref = importlib.import_module("gxbench.reference." + cfg["reference"])
    for k, seed in enumerate(int(s) for s in a.seeds.split(",")):
        r = harness.run(a.workload, seed, a.seconds, False)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "side": "program", "correct": r["correct"],
                          "calls": r["attempted"], "checks": r["checks"],
                          "metrics": r["metrics"]}), flush=True)
        if k >= a.controls:
            continue
        traffic = generate.generate(spec["mix"], seed)
        t = time.perf_counter()
        exp = ref.expected(traffic, cfg, "cuda")
        ref_s = time.perf_counter() - t
        for name in ref.CONTROLS:
            value, _ = ref.judge([ref.control(traffic, cfg, "cuda", name)],
                                 [exp], cfg["limit"])
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "side": "control", "control": name,
                              ref.CHECK: value, "limit": cfg["limit"],
                              "reference_s": ref_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
