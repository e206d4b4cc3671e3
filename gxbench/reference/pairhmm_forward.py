"""Plain fp64 PairHMM forward log10 likelihood.

The recurrence of GATK HaplotypeCaller's PairHMM as the reference project
computes it (pairHMM/pairHMMmatrix.c:32-55), rows i along the read and
columns j along the haplotype, each quality q decoded as
10 ** (-(q - 33) / 10):

    p       = 1 - e_r if the bases match (or either is N), else e_r
    M[i][j] = p * (t_mm * M[i-1][j-1] + t_gm * (X[i-1][j-1] + Y[i-1][j-1]))
    X[i][j] = M[i-1][j] * e_i + X[i-1][j] * e_g
    Y[i][j] = M[i][j-1] * e_d + Y[i][j-1] * e_g

with t_mm = 1 - (e_i + e_d), t_gm = 1 - e_g, of row i. Row 0 holds
Y = init = (DBL_MAX / 16) / len(haplotype) and M = X = 0; column 0 is 0.
The result is log10(sum over j of M[rl][j] + X[rl][j]) - log10(DBL_MAX / 16).
The mismatch emission is the reference's plain e_r (``gatk_emission``
false); true divides it by 3, as GATK does. A block of jobs advances one
anti-diagonal d = i + j at a time in plain torch operations.
"""

from __future__ import annotations

import numpy as np
import torch

CHECK = "max_abs_err_log10"
# The controls: the reference computed in float32 and in bfloat16, with
# FLT_MAX / 16 as the scale, which both types hold.
CONTROLS = {"fp32": torch.float32, "bf16": torch.bfloat16}
_BIG = {torch.float64: np.finfo(np.float64).max,
        torch.float32: float(np.finfo(np.float32).max),
        torch.bfloat16: float(np.finfo(np.float32).max)}
_N = ord("N")


def _jobs(traffic):
    """(read, haplotype) of every job, read-major within a region."""
    return [(rd, hp) for r in traffic.regions for rd in r.reads
            for hp in r.haps]


def _block_forward(jobs, offset, mm_div, device, dtype):
    rl = np.array([len(rd[0]) for rd, _ in jobs], np.int64)
    hl = np.array([len(hp) for _, hp in jobs], np.int64)
    B, RL, HL = len(jobs), int(rl.max()), int(hl.max())
    K = RL + HL
    W = K + HL + 2
    hap = np.zeros((B, HL + 1), np.uint8)
    # Row parameters reversed: entry K - t holds read position t, so that
    # the rows a diagonal crosses read left to right.
    base = np.zeros((B, W), np.uint8)
    quals = np.full((4, B, W), 255, np.uint8)  # 255: a pad, decoded to 0
    for b, (rd, hp) in enumerate(jobs):
        hap[b, 1:hl[b] + 1] = np.frombuffer(hp, np.uint8)
        s = slice(K - rl[b] + 1, K + 1)
        base[b, s] = np.frombuffer(rd[0], np.uint8)[::-1]
        for k in range(4):
            quals[k, b, s] = np.frombuffer(rd[1 + k], np.uint8)[::-1]
    q = torch.from_numpy(quals).to(device).to(torch.float64)
    err = torch.where(q == 255, 0.0, torch.pow(10.0, -(q - offset) / 10.0))
    e_r, e_i, e_d, e_g = (err[k].to(dtype) for k in range(4))
    t_mm = (1.0 - (err[1] + err[2])).to(dtype)
    t_gm = (1.0 - err[3]).to(dtype)
    hap = torch.from_numpy(hap).to(device)
    base = torch.from_numpy(base).to(device)
    trl = torch.from_numpy(rl).to(device)[:, None]
    thl = torch.from_numpy(hl).to(device)[:, None]
    big = _BIG[dtype]
    init = (torch.tensor(big / 16.0, dtype=torch.float64, device=device)
            / torch.from_numpy(hl).to(device).to(torch.float64)).to(dtype)

    def zeros():
        return torch.zeros((B, HL + 1), dtype=dtype, device=device)

    def yinit():
        y = init[:, None].expand(B, HL + 1).clone()
        y[:, 0] = 0
        return y

    M = [zeros(), zeros(), zeros()]  # diagonals d, d-1, d-2
    X = [zeros(), zeros(), zeros()]
    Y = [yinit(), yinit(), yinit()]
    Y[2][:, 0] = init  # (0, 0), read by M[1][1] alone
    acc = torch.zeros(B, dtype=dtype, device=device)
    cols = torch.arange(HL + 1, device=device)
    for d in range(2, RL + HL + 1):
        lo, hi = max(1, d - RL), min(HL, d - 1)
        sl, sm = slice(lo, hi + 1), slice(lo - 1, hi)
        rs = slice(K - d + 1 + lo, K - d + 2 + hi)
        rb, hb = base[:, rs], hap[:, sl]
        eq = (rb == hb) | (rb == _N) | (hb == _N)
        er = e_r[:, rs]
        p = torch.where(eq, 1.0 - er, er / mm_div)
        m = p * (t_mm[:, rs] * M[2][:, sm]
                 + t_gm[:, rs] * (X[2][:, sm] + Y[2][:, sm]))
        x = M[1][:, sl] * e_i[:, rs] + X[1][:, sl] * e_g[:, rs]
        y = M[1][:, sm] * e_d[:, rs] + Y[1][:, sm] * e_g[:, rs]
        j = cols[sl]
        last = ((d - j)[None, :] == trl) & (j[None, :] <= thl)
        acc = acc + torch.where(last, m + x, 0).sum(1)
        M[0][:, sl], X[0][:, sl], Y[0][:, sl] = m, x, y
        if d == 2:
            Y[2][:, 0] = 0  # that buffer serves diagonal 3 next
        M = [M[2], M[0], M[1]]
        X = [X[2], X[0], X[1]]
        Y = [Y[2], Y[0], Y[1]]
    lh = acc.to(torch.float64).cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log10(lh) - np.log10(big / 16.0)


def forward(traffic, phmm_cfg, device, dtype=torch.float64,
            max_elems=1 << 23) -> np.ndarray:
    """log10 likelihood of every job of the traffic, in job order."""
    jobs = _jobs(traffic)
    offset = float(phmm_cfg.get("phred_offset", 33.0))
    mm_div = 3.0 if phmm_cfg.get("gatk_emission", False) else 1.0
    rl = np.array([len(rd[0]) for rd, _ in jobs], np.int64)
    hl = np.array([len(hp) for _, hp in jobs], np.int64)
    order = np.lexsort((rl, hl))
    out = np.zeros(len(jobs), np.float64)
    start = 0
    while start < len(order):
        width = int(rl[order[start:]].max() + 2 * hl[order[start:]].max() + 2)
        stop = min(len(order), start + max(1, max_elems // width))
        sel = order[start:stop]
        out[sel] = _block_forward([jobs[i] for i in sel], offset, mm_div,
                                  device, dtype)
        start = stop
    return out


def expected(traffic, cfg, device) -> np.ndarray:
    return forward(traffic, cfg["pairhmm"], device)


def control(traffic, cfg, device, which: str) -> np.ndarray:
    return forward(traffic, cfg["pairhmm"], device, dtype=CONTROLS[which])


def judge(outputs, exps, limit):
    """(the widest gap, over every call and job, between an output and the
    reference's log10 likelihood of that call's inputs (``exps``, one a
    call), a value that is not finite where the reference's is counting as
    an infinite gap; whether each call's gaps all keep within the limit)."""
    worst, ok = 0.0, []
    for out, exp in zip(outputs, exps, strict=True):
        out = np.asarray(out, np.float64)
        if out.shape != exp.shape:
            gap = float("inf")
        else:
            diff = np.abs(out - exp)
            diff[~np.isfinite(out)] = np.inf
            gap = float(diff.max()) if len(diff) else 0.0
        worst = max(worst, gap)
        ok.append(gap <= limit)
    return worst, ok
