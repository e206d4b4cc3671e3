"""What the JAX engine's ``EngineConfig(factored_transfer=False)`` route would
cost genomax_torch, measured beside the route the port runs.

The port packs every PairHMM bucket factored: each unique read and
haplotype is copied once with per-slot gather indices and the job tiles
are rebuilt on the device (``kernels/expand.expand_factored``). Its
``EngineConfig`` has no ``factored_transfer`` (ROADMAP §3). This script
builds the JAX package's other route from the port's own parts: the job
tiles packed with byte qualities (``pack_pairhmm_batches(byte_quals=True)``),
the read codes and haplotype stream packed four-bit on the host where they
are match bitmasks (``pack.nibble.nibble_pack_4bit``, raw otherwise) and
expanded on the device (``expand_nibbles``), and the raw quality bytes
expanded on the device (``expand_byte_quals``). For each input it

- requires the ten kernel inputs of the two routes to be equal bit for bit,
  and ``pairhmm_forward`` to give equal scores on both;
- prints the bytes each route copies to the device;
- times both routes in turns, ``--turns`` each, stage by stage on the host
  clock (each stage synchronized): pack, four-bit pack, copy + expansion,
  launch.

Inputs: chip_smoke.py phase 9's jobs (8,192 reads of 151bp x 8 haplotypes
of 300bp, seed 0; ``--reads`` cuts the reads) and tests/golden/10s.in.

    python3 unfactored_cost.py                      # one CUDA device
    python3 unfactored_cost.py --device cpu --reads 16   # plain versions

Exits non-zero if a check fails or, with ``--device cuda``, when there is
no CUDA device.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

from genomax_torch.io.formats import parse_pairhmm_file
from genomax_torch.io.generator import generate_pairhmm_batch
from genomax_torch.kernels.expand import expand_byte_quals
from genomax_torch.kernels.pairhmm import pairhmm_forward
from genomax_torch.pack import (pack_pairhmm_batches, phmm_bucket_to_torch,
                                unpack_scores)
from genomax_torch.pack.nibble import expand_nibbles, nibble_pack_4bit

REPO = os.path.dirname(os.path.abspath(__file__))


def factored(batches, dev, sync, t):
    """The port's route: (buckets, the ten tensors of each, bytes)."""
    buckets, n = t("pack", lambda: pack_pairhmm_batches(
        batches, byte_quals=True, factored=True, bitmask_codes=True))
    tensors = t("copy+expand", lambda: sync([
        phmm_bucket_to_torch(b, dev) for b in buckets]))
    nbytes = sum(a.nbytes for b in buckets for a in (
        b.rchar_u, b.qb_u, b.hap_u, b.ridx, b.hidx, b.meta, b.ndiag_tile))
    return buckets, n, tensors, nbytes


def unfactored(batches, dev, sync, t):
    """The JAX engine's factored_transfer=False route, from the port's
    parts: (buckets, the ten tensors of each, bytes)."""
    def put(a):
        return torch.from_numpy(a).to(dev)

    buckets, n = t("pack", lambda: pack_pairhmm_batches(
        batches, byte_quals=True, bitmask_codes=True))
    codes = t("four-bit pack", lambda: [
        (nibble_pack_4bit(b.rchar), nibble_pack_4bit(b.hap))
        if b.bitmask_codes else (b.rchar, b.hap) for b in buckets])

    def ship(b, rc, hap):
        if b.bitmask_codes:
            rc = expand_nibbles(put(rc), b.rchar.shape[1])
            hap = expand_nibbles(put(hap), b.hap.shape[1])
        else:
            rc, hap = put(rc), put(hap)
        return ((rc,) + expand_byte_quals(put(b.qb)) + (hap, put(b.meta),
                                                        put(b.ndiag_tile)))

    tensors = t("copy+expand", lambda: sync([
        ship(b, *c) for b, c in zip(buckets, codes)]))
    nbytes = sum(a.nbytes for b, c in zip(buckets, codes)
                 for a in (*c, b.qb, b.meta, b.ndiag_tile))
    return buckets, n, tensors, nbytes


def run(route, batches, dev, sync):
    """One run of ``route`` to its scores: (scores, stage seconds, wall,
    the ten tensors of each bucket, bytes)."""
    stages = {}

    def t(name, fn):
        t0 = time.perf_counter()
        out = fn()
        stages[name] = time.perf_counter() - t0
        return out

    t0 = time.perf_counter()
    buckets, n, tensors, nbytes = route(batches, dev, sync, t)
    outs = t("launch", lambda: sync([
        pairhmm_forward(*x, bitmask=b.bitmask_codes)
        for b, x in zip(buckets, tensors)]))
    scores = unpack_scores(buckets, [o.cpu().numpy() for o in outs], n,
                           np.float32)
    return scores, stages, time.perf_counter() - t0, tensors, nbytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reads", type=int, default=8192)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("unfactored_cost: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())

    def sync(x):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return x

    inputs = {
        "phase 9": [generate_pairhmm_batch(args.reads, 8, read_len=151,
                                           hap_len=300, seed=0,
                                           from_haps=True)],
        "10s.in": parse_pairhmm_file(os.path.join(REPO, "tests", "golden",
                                                  "10s.in"))}
    routes = {"factored": factored, "unfactored": unfactored}
    ok = True
    for label, batches in inputs.items():
        run(factored, batches, dev, sync)  # the kernel's build and warm-up
        first, walls, tensors = {}, {k: [] for k in routes}, {}
        for name in (["factored", "unfactored", "unfactored", "factored"]
                     * args.turns)[: 2 * args.turns]:
            scores, stages, wall, x, nbytes = run(routes[name], batches, dev,
                                                  sync)
            tensors.setdefault(name, x)
            first.setdefault(name, scores)
            walls[name].append(wall)
            print(f"{label} {name}: wall {wall:.4f} s = " + " + ".join(
                f"{k} {v:.4f}" for k, v in stages.items())
                + f"; {nbytes} bytes copied; {len(x)} buckets")
        same = all(len(a) == len(b) and all(torch.equal(p, q) and
                                            p.dtype == q.dtype
                                            for p, q in zip(a, b))
                   for a, b in zip(tensors["factored"], tensors["unfactored"]))
        same &= len(tensors["factored"]) == len(tensors["unfactored"])
        equal = np.array_equal(first["factored"], first["unfactored"])
        med = {k: float(np.median(v)) for k, v in walls.items()}
        print(f"{label}: {len(first['factored'])} jobs; the ten tensors "
              f"{'equal' if same else 'DIFFER'}, the scores "
              f"{'equal' if equal else 'DIFFER'}; median walls factored "
              f"{med['factored']:.4f} s, unfactored {med['unfactored']:.4f} "
              f"s, unfactored / factored {med['unfactored'] / med['factored']:.3f}")
        ok &= same and equal
    print("unfactored_cost: " + ("ok" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
