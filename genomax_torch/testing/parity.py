"""Parity harness of the port: compile the reference C sources (read-only)
and diff the port's engine against their outputs, the judged contract (the
counterpart of ``genomax.testing.parity``).

Falls back to the vendored golden files in tests/golden/ when the
reference tree or a C compiler is unavailable, or its sources do not
compile. The engine runs on ``device`` ("cuda" unless the caller asks for
the CPU); there is no fallback from one device to the other.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(_REPO, "tests", "golden")


def _have_reference(ref: str) -> bool:
    # Both sources must exist (a partial checkout would otherwise pass
    # the gate and crash the compile step instead of falling back).
    return (
        os.path.isfile(os.path.join(ref, "pairHMM", "pairHMMmatrix.c"))
        and os.path.isfile(
            os.path.join(ref, "smithWaterman", "antidiagonalSmithWaterman.c"))
        and shutil.which("gcc") is not None
    )


def compile_reference(ref: str, outdir: str) -> dict:
    """Build the reference CPU binaries from their (read-only) sources."""
    sw_src = os.path.join(ref, "smithWaterman", "antidiagonalSmithWaterman.c")
    ph_src = os.path.join(ref, "pairHMM", "pairHMMmatrix.c")
    bins = {"sw": os.path.join(outdir, "ref_sw"),
            "pairhmm": os.path.join(outdir, "ref_pairhmm")}
    subprocess.run(["gcc", "-O2", "-fgnu89-inline", "-o", bins["sw"], sw_src],
                   check=True)
    subprocess.run(["gcc", "-O2", "-o", bins["pairhmm"], ph_src, "-lm"],
                   check=True)
    return bins


def run_parity(reference_dir: str = "/root/reference",
               device: str = "cuda") -> int:
    """Diff the port's Engine(device=device) against the reference (or the
    goldens): SW exact, PairHMM within 1e-3 in log10. Prints one line a
    case and ``PARITY: PASS`` or ``FAIL``; returns 0 on PASS, else 1."""
    from genomax_torch.engine.executor import Engine
    from genomax_torch.io.formats import parse_pairhmm_file, parse_sw_file
    from genomax_torch.io.generator import write_sw_file

    eng = Engine(device=device)
    failures = 0

    with tempfile.TemporaryDirectory() as td:
        use_ref = _have_reference(reference_dir)
        if use_ref:
            try:
                bins = compile_reference(reference_dir, td)
                print(f"reference binaries built from {reference_dir}")
            except (subprocess.CalledProcessError, OSError) as e:
                print(f"reference compile failed ({e}); "
                      "using vendored goldens")
                use_ref = False
        else:
            print("reference sources/gcc unavailable; using vendored goldens")

        # --- SW: fresh generator workload (if reference available) ---
        sw_cases = []
        if use_ref:
            gen = os.path.join(td, "gen.in")
            write_sw_file(gen, num_alignments=64, min_len=100, max_len=260,
                          seed=123)
            sw_cases.append(gen)
        for name in ("sw_quirks.in", "sw_small.in", "sw_medium.in"):
            sw_cases.append(os.path.join(GOLDEN_DIR, name))

        for case in sw_cases:
            got = eng.sw_scores(parse_sw_file(case))
            if use_ref:
                out = subprocess.run([bins["sw"], case], capture_output=True,
                                     text=True, check=True).stdout
                want = np.array([int(line.split()[1])
                                 for line in out.splitlines()
                                 if line.startswith("Score:")])
            else:
                gold = case.replace(".in", ".golden.out")
                if not os.path.exists(gold):
                    continue
                with open(gold) as f:
                    want = np.array([int(line.split()[1]) for line in f])
            ok = np.array_equal(got, want)
            failures += 0 if ok else 1
            print(f"SW {os.path.basename(case)}: "
                  f"{'OK' if ok else 'MISMATCH'} ({len(want)} pairs)")

        # --- PairHMM: repo test set ---
        for name in ("test.in", "10s.in"):
            case = os.path.join(GOLDEN_DIR, name)
            got = eng.pairhmm(parse_pairhmm_file(case))
            if use_ref:
                outp = os.path.join(td, "ph.out")
                subprocess.run([bins["pairhmm"], case, outp], check=True,
                               stdout=subprocess.DEVNULL)
                want = np.loadtxt(outp)
            else:
                want = np.loadtxt(os.path.join(
                    GOLDEN_DIR,
                    "test.out" if name == "test.in" else "10s.golden.out"))
            want = np.atleast_1d(want)
            err = float(np.abs(got - want).max())
            ok = err < 1e-3
            failures += 0 if ok else 1
            print(f"PairHMM {name}: {'OK' if ok else 'MISMATCH'} "
                  f"(max |err| {err:.2e}, {len(want)} pairs)")

    print("PARITY:", "PASS" if failures == 0 else f"FAIL ({failures})")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    sys.exit(run_parity())
