"""On-card smoke run of genomax_torch, the port of genomax to PyTorch and
CUDA.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. build      nvcc-builds the SW kernel (csrc/sw_tile.cu) from the checkout
  2. kernel     kernel vs its plain PyTorch version on ragged buckets under
                three scoring configs, exact
  3. goldens    Engine(device="cuda") on the vendored SW goldens, exact
  4. main path  the engine on 25,000 pairs of 512bp random DNA + '\\n'
                (seeded), sampled pairs held against the native golden
                model; the kernel's launch count is read around this run
  5. timing     kernel vs plain ms per 25k-pair bucket by CUDA events,
                slope (t(9) - t(1)) / 8, in turns plain, kernel, kernel,
                plain
  6. card       the card's name and power limit from nvidia-smi

Then one JSON line describing each kernel, the card line, and, last,
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. It imports no jax.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_PAIRS, LEN, SEED = 25000, 512, 0
CFGS = [dict(match=1, mismatch=-1, gap_open=-3, gap_extend=-1),
        dict(match=2, mismatch=-3, gap_open=-5, gap_extend=-2),
        dict(match=3, mismatch=-1, gap_open=0, gap_extend=-2)]


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def ragged_pairs(seed):
    """Lengths 1-700 with the trailing '\\n', an empty pair, a lone '\\n'
    and tandem repeats (y holds x again about NXs rows later)."""
    import numpy as np

    from genomax.io.formats import SWPair

    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = [SWPair(sx=b"", sy=b""), SWPair(sx=b"\n", sy=b"ACGT\n")]
    for _ in range(600):
        a = rng.choice(abc, int(rng.integers(1, 701))).tobytes() + b"\n"
        b = rng.choice(abc, int(rng.integers(1, 701))).tobytes() + b"\n"
        pairs.append(SWPair(sx=min(a, b, key=len), sy=max(a, b, key=len)))
    for xlen, gap in [(100, 104), (250, 256), (250, 1000), (600, 610)]:
        x = rng.choice(abc, xlen).tobytes()
        junk = rng.choice(abc, gap).tobytes()
        pairs.append(SWPair(sx=x, sy=x + junk + x))
        pairs.append(SWPair(sx=x, sy=x + junk + x + junk + x))
    return pairs


def slope_ms(fn, torch):
    """Marginal ms of one more back-to-back call: (t(9) - t(1)) / 8, each
    t(k) from CUDA events around k calls."""
    def t(k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    fn()
    torch.cuda.synchronize()
    return (t(9) - t(1)) / 8


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda finds no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from genomax import native
    from genomax.config import SWConfig
    from genomax.io.formats import SWPair
    from genomax.io.generator import random_dna
    from genomax.kernels import oracle
    from genomax.pack.bucketing import pack_sw_pairs, unpack_scores

    from genomax_torch.engine.executor import Engine
    from genomax_torch.kernels import _build, sw
    from genomax_torch.kernels.wavefront import sw_forward_tiles
    from genomax_torch.pack import sw_bucket_to_torch

    dev = torch.device("cuda")
    max_err = 0

    # 1. build
    t0 = time.perf_counter()
    path, log = _build.build("sw_tile")
    print(f"phase 1 build: {os.path.relpath(path, REPO)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "bytes stack" in line:
            print(f"  ptxas: {line.strip()}")

    # 2. kernel vs plain version on the card
    pairs = ragged_pairs(1)
    buckets = pack_sw_pairs(pairs)
    for c in CFGS:
        cfg = SWConfig(**c)
        results = []
        for b in buckets:
            sx, sy, nd = sw_bucket_to_torch(b, dev)
            got = sw.sw_forward(sx, sy, nd, cfg)
            want = sw_forward_tiles(sx, sy, nd, cfg)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"kernel != plain on bucket {tuple(sx.shape)} "
                            f"under {cfg}: max |diff| {err}")
            results.append(got.cpu().numpy())
        scores = unpack_scores(buckets, results, len(pairs))
        check(np.array_equal(scores, native.sw_scores_native(pairs, cfg)),
              f"kernel != native model under {cfg}")
        print(f"phase 2 kernel == plain: {len(pairs)} ragged pairs, "
              f"{len(buckets)} buckets, {cfg}, max_abs_err 0")

    # 3. engine on the vendored goldens
    eng = Engine(device="cuda")
    sw.launches = 0
    for name in ("sw_small", "sw_medium", "sw_quirks"):
        got = eng.sw_scores_file(os.path.join(REPO, "tests", "golden",
                                              name + ".in"))
        with open(os.path.join(REPO, "tests", "golden",
                               name + ".golden.out")) as f:
            want = np.array([int(line.split()[1]) for line in f], np.int32)
        check(np.array_equal(got, want), f"engine != golden on {name}")
        print(f"phase 3 golden {name}: {len(got)} scores exact")
    print(f"phase 3 kernel launches: {sw.launches}")

    # 4. the main path at full width
    rng = np.random.default_rng(SEED)
    pairs = [SWPair(sx=random_dna(rng, LEN) + b"\n",
                    sy=random_dna(rng, LEN) + b"\n") for _ in range(N_PAIRS)]
    sw.launches = 0
    t0 = time.perf_counter()
    scores = eng.sw_scores(pairs)
    wall = time.perf_counter() - t0
    launches = sw.launches
    stats = eng.last_stats
    check(scores.shape == (N_PAIRS,) and scores.dtype == np.int32,
          f"scores of shape {scores.shape} {scores.dtype}")
    check(launches >= stats.buckets >= 1,
          f"{launches} kernel launches for {stats.buckets} buckets")
    sample = np.random.default_rng(SEED + 1).choice(
        N_PAIRS, 512 if native.available() else 64, replace=False)
    sub = [pairs[i] for i in sample]
    ref_name = "native" if native.available() else "oracle"
    ref = (native.sw_scores_native(sub) if native.available()
           else oracle.sw_scores_pairs(sub))
    check(np.array_equal(scores[sample], ref),
          f"engine != {ref_name} on the sampled pairs")
    print(f"phase 4 main path: {N_PAIRS} x {LEN}bp+'\\n', engine wall "
          f"{wall:.3f} s, {launches} launches for {stats.buckets} buckets, "
          f"{len(sample)} sampled pairs == {ref_name} model, "
          f"stats {json.dumps(stats.as_dict())}")

    # 5. timing on the full-width bucket
    (b,) = pack_sw_pairs(pairs)
    sx, sy, nd = sw_bucket_to_torch(b, dev)
    cfg = SWConfig()
    got = sw.sw_forward(sx, sy, nd, cfg)
    want = sw_forward_tiles(sx, sy, nd, cfg)
    err = int((got.long() - want.long()).abs().max())
    max_err = max(max_err, err)
    check(err == 0, f"kernel != plain on the 25k bucket: {err}")
    kernel = lambda: sw.sw_forward(sx, sy, nd, cfg)  # noqa: E731
    plain = lambda: sw_forward_tiles(sx, sy, nd, cfg)  # noqa: E731
    p1, k1, k2, p2 = (slope_ms(plain, torch), slope_ms(kernel, torch),
                      slope_ms(kernel, torch), slope_ms(plain, torch))
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    cells = int(((b.nx - 1).astype(np.int64) * (b.ny - 1)).sum())
    print(f"phase 5 timing, bucket {tuple(sx.shape)} stream "
          f"{tuple(sy.shape)}: kernel {k1:.3f} / {k2:.3f} ms, plain "
          f"{p1:.3f} / {p2:.3f} ms per call; GCUPS kernel "
          f"{cells / kernel_ms / 1e6:.2f}, plain {cells / plain_ms / 1e6:.2f} "
          f"(cells = sum (nx-1)(ny-1) = len(sx) * len(sy) with the '\\n', "
          f"{cells})")

    # 6. the card
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    check("jax" not in sys.modules, "jax was imported")

    print(json.dumps({"kernels": [{
        "name": "sw_tile", "route": "cuda",
        "source": "genomax_torch/csrc/sw_tile.cu",
        "replaces": "genomax/kernels/sw_pallas.py:42",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(f"phase 6 card: {smi.stdout.strip()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
