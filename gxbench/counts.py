"""The yardstick of the roofline: DP cells counted from the inputs, the
operations and bytes a cell needs, and the peaks of one NVIDIA H100 SXM.

Counts come from the inputs alone (sum of len(x) * len(y), sum of
len(read) * len(haplotype)), never from a kernel's padded shapes or its
instruction count, so the same work reads the same whatever implements it.
The constants are frozen here, apart from the program, so that a change to
the program cannot move its own yardstick.
"""

from __future__ import annotations

# --- Operations a DP cell needs ---------------------------------------------
# Smith-Waterman (Gotoh, score only), integer instructions a cell. The plain
# recurrence takes 13: P = max(D + o + e, P + e) (2 adds, 1 max), Q the same
# (3), D = max(P, Q, D_diag + s, 0) (the substitution's compare and select,
# 1 add, 3 maxes: 6), and 1 max into the running best. Hopper's DPX
# instructions fuse an add into a max (__viaddmax_s32) and take three
# operands (__vimax3_s32), and with the gap opening folded into the stored D
# a cell needs 7 of them (the DPX form of the cell, a compare, a select, an
# add) and half of the running max: 7.5, the fewest a cell can take on this
# card, and so the bound's count.
SW_OPS_PER_CELL = 7.5
SW_OPS_PER_CELL_PLAIN = 13
# PairHMM forward, fp32 flops a cell (an FMA counted as 2):
# M = p * (t_mm * M' + t_gm * (X' + Y')): 1 add, 1 mul, 1 FMA, 1 mul = 5;
# X = M'' * e_i + X'' * e_g: 1 mul, 1 FMA = 3; Y the same = 3. The emission
# p is a select, not a flop. 11 in all.
PHMM_FLOPS_PER_CELL = 11

# --- Peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet) ---------------
SMS = 132
# 32-bit integer lanes an SM issues per clock (4 sub-partitions x 16 INT32
# units), counted for DPX as for plain integer instructions.
INT32_LANES_PER_SM = 64
# The SM's boost clock as nvidia-smi reads it under clocks.max.sm (1980 MHz
# on the H100 80GB HBM3 at 700 W); the peak assumes that clock.
SM_CLOCK_MAX_HZ = 1.98e9
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * SM_CLOCK_MAX_HZ  # 16.73e12
# fp32 outside the tensor cores, dense.
FP32_FLOPS_PER_S = 67e12
# HBM3.
HBM_BYTES_PER_S = 3.35e12


def sw_cells(x_lens, y_lens) -> int:
    """Real DP cells of SW pairs: sum of len(x) * len(y)."""
    return sum(int(a) * int(b) for a, b in zip(x_lens, y_lens))


def sw_bytes(x_lens, y_lens) -> int:
    """Bytes an SW call must move at least: each base read once, each int32
    score written once."""
    return sum(int(a) + int(b) for a, b in zip(x_lens, y_lens)) + 4 * len(x_lens)


def phmm_cells(regions) -> int:
    """Real DP cells of PairHMM jobs, regions given as (read lengths,
    haplotype lengths): every read against every haplotype of its region,
    sum of len(read) * len(haplotype)."""
    return sum(sum(int(r) for r in rl) * sum(int(h) for h in hl)
               for rl, hl in regions)


def phmm_bytes(regions) -> int:
    """Bytes a PairHMM call must move at least: each read's base and four
    quality bytes and each haplotype base read once, one fp64 result a job
    written once."""
    return sum(5 * sum(int(r) for r in rl) + sum(int(h) for h in hl)
               + 8 * len(rl) * len(hl) for rl, hl in regions)


def bound_s(ops: float, ops_per_s: float, nbytes: float) -> float:
    """The least time the card can take: the larger of the operations over
    their peak and the bytes over the HBM's."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)


def sw_bound_s(x_lens, y_lens) -> float:
    return bound_s(SW_OPS_PER_CELL * sw_cells(x_lens, y_lens),
                   INT32_OPS_PER_S, sw_bytes(x_lens, y_lens))


def phmm_bound_s(regions) -> float:
    return bound_s(PHMM_FLOPS_PER_CELL * phmm_cells(regions),
                   FP32_FLOPS_PER_S, phmm_bytes(regions))
