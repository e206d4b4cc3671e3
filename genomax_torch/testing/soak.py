"""Randomized differential soaks of the port (the counterpart of
``genomax.testing.soak``): seeded campaigns of the port's engine against
the fp64 oracles.

- ``run_soak``      — ``Engine`` (every routing path: strips, rotor and
  lane-tile buckets, offloads to the long-pair kernel, the fp64 fallback,
  both emission modes, 'N' alphabets, tandem and '\\n'-quirk adversaries)
  vs the port's ``kernels.oracle``.
- ``run_deep_soak`` — the two deep paths a plain engine run never
  exercises at depth: (a) ``ShardedEngine`` on a mesh of ``devices`` ranks
  and (b) the long-read kernel (``kernels.pairhmm_long``) on adversarial
  rescale patterns (all-mismatch runs crossing every strip seam, 'N' runs
  over seams, mixed exponent frames) vs the native fp64 model.

Every round draws from ``np.random.default_rng(seed)`` in the order of the
JAX soak, so a seed hands the port's engines the workloads it hands the
JAX package's. The engines run on ``device`` ("cuda" unless the caller
asks for the CPU), with no fallback from one to the other.

CLI: ``python -m genomax_torch soak [--deep] [--rounds N] [--seed S]
[--device cuda|cpu]``. The first mismatch aborts with the failing round's
parameters.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from genomax_torch import native
from genomax_torch.config import EngineConfig, PairHMMConfig, SWConfig
from genomax_torch.dist.engine import ShardedEngine
from genomax_torch.dist.mesh import make_mesh
from genomax_torch.engine.executor import Engine
from genomax_torch.io.formats import PairHMMBatch, PairHMMRead, SWPair
from genomax_torch.kernels import oracle
from genomax_torch.kernels.pairhmm_long import pairhmm_long

_ABC4 = np.frombuffer(b"ATGC", np.uint8)
_ABCN = np.frombuffer(b"ATGCN", np.uint8)


def _seq(rng, n, alphabet=_ABC4) -> bytes:
    return rng.choice(alphabet, max(int(n), 0)).tobytes()


def run_soak(rounds: int = 60, seed: int = 20260817, device: str = "cuda",
             max_len: int = 700, log=print) -> int:
    """Engine-vs-oracle randomized soak. Returns 0 on PASS, 1 on the
    first mismatch (after logging the failing parameters)."""
    rng = np.random.default_rng(seed)
    t_start = time.time()
    for rd_i in range(rounds):
        if rd_i % 3 in (0, 1):  # SW round
            cfg = SWConfig() if rd_i % 2 == 0 else SWConfig(
                match=int(rng.integers(1, 5)),
                mismatch=-int(rng.integers(1, 5)),
                gap_open=-int(rng.integers(0, 6)),
                gap_extend=-int(rng.integers(1, 4)))
            lo, hi = sorted(rng.integers(1, max_len, size=2) + [0, 2])
            if rd_i % 6 == 1:
                # a steady share of rounds in the short regime, so that
                # the rotor (short buckets) soaks every campaign: a
                # uniform [1, max_len) draw lands there ~3% of the time
                lo, hi = sorted(rng.integers(1, 110, size=2) + [0, 2])
            alphabet = _ABCN if rd_i % 4 == 0 else _ABC4
            pairs = []
            for _ in range(int(rng.integers(8, 40))):
                a = _seq(rng, rng.integers(lo, hi + 1), alphabet)
                b = _seq(rng, rng.integers(lo, hi + 1), alphabet)
                if rng.random() < 0.5:  # the '\n'-in-sequence quirk
                    a += b"\n"
                    b += b"\n"
                if len(a) > len(b):
                    a, b = b, a
                pairs.append(SWPair(sx=a, sy=b))
            if rng.random() < 0.3:  # tandem-repeat adversary
                x = _seq(rng, min(hi, 400))
                pairs.append(SWPair(sx=x, sy=x + _seq(rng, rng.integers(1, 300)) + x))
            if rng.random() < 0.2:  # oversized -> the long-pair kernel
                pairs.append(SWPair(sx=_seq(rng, 1200), sy=_seq(rng, 1400)))
            e = Engine(EngineConfig(), sw_cfg=cfg, device=device)
            got = e.sw_scores(pairs)
            want = oracle.sw_scores_pairs(pairs, cfg)
            bad = np.nonzero(got != want)[0]
            stat = (f"SW n={len(pairs)} len[{lo},{hi}] cfg=({cfg.match},"
                    f"{cfg.mismatch},{cfg.gap_open},{cfg.gap_extend})")
            if len(bad):
                log(f"round {rd_i}: {stat} MISMATCH at {bad[:5]}: "
                    f"got {got[bad[:5]]} want {want[bad[:5]]}")
                return 1
        else:  # PairHMM round
            gatk = rng.random() < 0.5
            pcfg = PairHMMConfig(gatk_emission=gatk)
            nr, nh = int(rng.integers(1, 5)), int(rng.integers(1, 4))
            rl_hi = int(rng.integers(10, min(260, max_len)))
            hl_hi = int(rng.integers(10, min(400, max_len)))
            reads, haps = [], []
            for _ in range(nr):
                L = int(rng.integers(1, rl_hi + 1))
                qs = bytes((33 + rng.integers(10, 45, size=L)).astype(np.uint8))
                alphabet = _ABCN if rng.random() < 0.3 else _ABC4
                reads.append(PairHMMRead(bases=_seq(rng, L, alphabet),
                                         base_q=qs, ins_q=qs[::-1],
                                         del_q=qs, gcp_q=qs))
            for _ in range(nh):
                alphabet = _ABCN if rng.random() < 0.3 else _ABC4
                haps.append(_seq(rng, rng.integers(1, hl_hi + 1), alphabet))
            batch = PairHMMBatch(reads=reads, haplotypes=haps)
            e = Engine(EngineConfig(), phmm_cfg=pcfg, device=device)
            got = np.asarray(e.pairhmm([batch]), np.float64)
            want = oracle.pairhmm_batch_log10(batch, pcfg)
            finite = np.isfinite(want)
            worst = np.abs(got - want)[finite].max() if finite.any() else 0.0
            nan_ok = (bool(np.all(~np.isfinite(got[~finite])))
                      if (~finite).any() else True)
            stat = (f"PHMM {nr}x{nh} rl<={rl_hi} hl<={hl_hi} gatk={gatk} "
                    f"err={worst:.1e} fb={e.last_stats.fallback_jobs}")
            if worst > 2e-4 or not nan_ok:
                log(f"round {rd_i}: {stat} FAIL")
                return 1
        log(f"round {rd_i}: OK  {stat}  [{time.time() - t_start:.0f}s]")
    log("SOAK PASS")
    return 0


def run_deep_soak(rounds: int = 16, seed: int = 3_2026, device: str = "cuda",
                  devices: int = 1, long_rows: tuple[int, int] = (2048, 4096),
                  long_cols: tuple[int, int] = (600, 2200),
                  log=print) -> int:
    """Deep-path soak: (a) ShardedEngine on a mesh of ``devices`` ranks
    (the process group's size), (b) the long-read kernel on adversarial
    cross-seam rescale patterns. Returns 0 on PASS, 1 on the first
    mismatch. Every rank draws the same rounds; rank 0 logs."""
    rng = np.random.default_rng(seed)
    mesh = make_mesh(devices, device=device)
    if mesh.rank:
        log = lambda *_: None  # noqa: E731
    log(f"mesh: {mesh.size} rank(s), this one {mesh.rank} on {mesh.device}")
    t_start = time.time()
    for rd_i in range(rounds):
        if rd_i % 2 == 0:  # (a) sharded engine on the mesh
            lo, hi = sorted(rng.integers(1, 500, size=2) + [0, 2])
            pairs = []
            for _ in range(int(rng.integers(8, 30))):
                a = _seq(rng, rng.integers(lo, hi + 1))
                b = _seq(rng, rng.integers(lo, hi + 1))
                if len(a) > len(b):
                    a, b = b, a
                pairs.append(SWPair(sx=a, sy=b))
            eng = ShardedEngine(mesh, EngineConfig())
            got = eng.sw_scores(pairs)
            want = oracle.sw_scores_pairs(pairs)
            if not np.array_equal(got, want):
                log(f"round {rd_i}: SHARDED SW MISMATCH {got} vs {want}")
                return 1
            nr, nh = int(rng.integers(1, 4)), int(rng.integers(1, 4))
            reads = []
            for _ in range(nr):
                L = int(rng.integers(5, 200))
                qs = bytes((33 + rng.integers(10, 45, size=L)).astype(np.uint8))
                reads.append(PairHMMRead(bases=_seq(rng, L, _ABCN), base_q=qs,
                                         ins_q=qs[::-1], del_q=qs, gcp_q=qs))
            haps = [_seq(rng, rng.integers(5, 300), _ABCN) for _ in range(nh)]
            batch = PairHMMBatch(reads=reads, haplotypes=haps)
            gp = np.asarray(eng.pairhmm([batch]), np.float64)
            wp = oracle.pairhmm_batch_log10(batch)
            finite = np.isfinite(wp)
            worst = np.abs(gp - wp)[finite].max() if finite.any() else 0.0
            if worst > 2e-4:
                log(f"round {rd_i}: SHARDED PHMM err={worst:.1e} FAIL")
                return 1
            stat = (f"SHARDED-{devices}dev sw n={len(pairs)} phmm {nr}x{nh} "
                    f"err={worst:.1e} gcups={eng.last_stats.gcups:.1f}")
        else:  # (b) long-read kernel, adversarial rescale patterns
            L = int(rng.integers(long_rows[0], long_rows[1] + 1))
            H = int(rng.integers(long_cols[0], long_cols[1] + 1))
            # odd rounds only: the adversary kind from the odd-round index,
            # so that every kind comes up
            kind = ((rd_i - 1) // 2) % 5
            qs = bytes((33 + rng.integers(10, 45, size=L)).astype(np.uint8))
            if kind == 0:  # all-mismatch across every strip seam
                bases, hap = b"A" * L, b"C" * H
            elif kind == 1:  # N-runs crossing seams
                b_arr = rng.choice(_ABC4, L)
                b_arr[L // 3: L // 3 + min(600, L // 2)] = ord("N")
                h_arr = rng.choice(_ABC4, H)
                h_arr[H // 2: H // 2 + min(200, H // 3)] = ord("N")
                bases, hap = b_arr.tobytes(), h_arr.tobytes()
            elif kind == 2:
                # Near-match read crossing seams: every other kind is
                # mismatch-dominated and lands in the want < -45 branch
                # below, so this is the one kind whose value stays in the
                # fp32 design range and arms the err <= 2e-4 gate. Read =
                # hap prefix with one cheap (phred-20) mismatch at every
                # other strip seam row (strips of 256 rows).
                h_arr = rng.choice(_ABC4, H)
                # gap-free fit (a read longer than the hap forces
                # insertions that would push the value below -45)
                L = max(min(L, H) - 8, 16)
                b_arr = h_arr[:L].copy()
                q_arr = np.full(L, 33 + 40, np.uint8)
                for r in range(256, L, 512):
                    b_arr[r] = ord("A") if b_arr[r] != ord("A") else ord("C")
                    q_arr[r] = 33 + 20  # ~-2 log10 each: stays above -45
                bases, hap = b_arr.tobytes(), h_arr.tobytes()
                qs = q_arr.tobytes()
            elif kind == 3:  # mismatch block then strong match (mixed frames)
                half = rng.choice(_ABC4, L)
                # a copy: half[:H] would be a view, and the deep-decay
                # mutation below would rewrite the hap too
                hap_a = (half[:H].copy() if H <= L
                         else np.concatenate([half, rng.choice(_ABC4, H - L)]))
                half[: L // 2] = ord("A")  # deep decay in early strips
                bases, hap = half.tobytes(), hap_a.tobytes()
            else:  # scattered-'N' random long pairs
                bases, hap = _seq(rng, L, _ABCN), _seq(rng, H, _ABCN)
            read = PairHMMRead(bases=bases, base_q=qs, ins_q=qs[::-1],
                               del_q=qs, gcp_q=qs)
            got = float(pairhmm_long([(read, hap)], 33.0,
                                     device=mesh.device)[0])
            want = float(native.pairhmm_native(
                [PairHMMBatch(reads=[read], haplotypes=[hap])], 33.0)[0])
            if not np.isfinite(want):
                if np.isfinite(got):
                    log(f"round {rd_i}: PHMM-LONG {L}x{H} kind={kind} "
                        f"finite {got} vs non-finite oracle FAIL")
                    return 1
                stat = f"PHMM-LONG {L}x{H} kind={kind} both non-finite OK"
            elif want < -45:
                if kind == 2:
                    # kind 2 is built to stay above -45: landing here means
                    # the accuracy gate never runs in this campaign
                    log(f"round {rd_i}: PHMM-LONG kind=2 adversary "
                        f"unexpectedly deep ({want:.1f} < -45): the "
                        f"accuracy gate never runs — FAIL")
                    return 1
                # past the fp32 design range: the engine sends such a job
                # to the fp64 fallback; recorded, not failed
                stat = (f"PHMM-LONG {L}x{H} kind={kind} deep({want:.0f}) "
                        f"got={got:.2f} (engine->fp64)")
            else:
                err = abs(got - want)
                if err > 2e-4:
                    log(f"round {rd_i}: PHMM-LONG {L}x{H} kind={kind} "
                        f"err={err:.1e} ({got} vs {want}) FAIL")
                    return 1
                stat = f"PHMM-LONG {L}x{H} kind={kind} err={err:.1e}"
        log(f"round {rd_i}: OK  {stat}  [{time.time() - t_start:.0f}s]")
    log("DEEP SOAK PASS")
    return 0


def main(args) -> int:
    """The ``soak`` subcommand: args.deep, args.rounds, args.seed,
    args.device, args.devices (the deep soak's mesh)."""
    if args.deep:
        return run_deep_soak(rounds=args.rounds, seed=args.seed,
                             device=args.device, devices=args.devices or 1)
    return run_soak(rounds=args.rounds, seed=args.seed, device=args.device)


if __name__ == "__main__":  # pragma: no cover - thin hand-run entry
    from genomax_torch.cli.main import main as cli

    sys.exit(cli(["soak", *sys.argv[1:]]))
