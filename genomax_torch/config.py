"""Configuration dataclasses of the port.

``SWConfig`` and ``PairHMMConfig`` are copies of the ones in
``genomax.config``: the same fields, defaults, ``validate()`` and
``mm_div``. ``EngineConfig`` is the port's own: the JAX package's resolves
its backend through jax, so the port holds only the knobs its paths read,
and the engine takes an explicit ``torch.device`` instead of a resolver.
"""

from __future__ import annotations

import dataclasses

# The lane-tile SW kernel's tallest bucket, a routing constant, not a cap
# on max_device_len: 32 warps x 32 threads x 8 rows hold 8,193 rows (a
# CUDA block's 1,024 threads; csrc/sw_tile.cu's block form,
# kernels/sw.tile_geometry), and the pack's rows are a multiple of 8. The
# JAX engine takes any max_device_len, and so does the port: a pair with
# len(x) + 2 past this height stays in the bucket path only where the
# strips kernel takes its bucket (csrc/sw_strips.cu walks sub-strips of 32R
# rows at any height), else it takes the long-pair kernel
# (Engine._sw_offload_mask).
MAX_KERNEL_ROWS = 8192
# The PairHMM lane-tile kernel's tallest bucket, a routing constant too:
# one warp a pair up to 32 x R rows, past that a block of up to 32 warps
# (csrc/pairhmm_tile.cu, kernels/pairhmm.tile_geometry), 8,192 rows at
# R = 8. The engine sends it reads under max_device_len // 2, as the JAX
# engine does, and reads past 8,190 bases to the long-read kernel
# (Engine._phmm_offload_mask).
MAX_PHMM_ROWS = 8192
# The stacked kernel's rows a stack and the conveyor's window rows: the TPU
# kernels' limit of 1,024, at which both are held on the card
# (kernels/sw_stacked.py, kernels/sw_conveyor.py).
MAX_STACK_ROWS = 1024
MAX_CONVEYOR_ROWS = 1024
# The rotor kernel's segments hold up to 32 * 5 columns of the period
# (csrc/sw_rotor.cu: one queue a warp, five columns a lane): periods up
# to 160.
MAX_ROTOR_PERIOD = 160
# Rescale periods the packs reserve stream slack for (layout.MAX_UNROLL =
# 32 rows past every pair's last diagonal).
RESCALE_PERIODS = (1, 2, 4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class SWConfig:
    """Smith-Waterman affine-gap (Gotoh) scoring parameters.

    The defaults are the reference's (antidiagonalSmithWaterman.c:40-43).
    The gap model is g(k) = open + k*extend, so opening a gap costs
    open + extend = -4.

    ``matrix``, the port's one field past the JAX package's, names a
    substitution matrix of ``genomax_torch.scoring`` ("BLOSUM62"): a cell
    then scores the table's entry of its two residues, and ``match`` and
    ``mismatch`` are not read. None (the default) scores equal bytes
    ``match`` and others ``mismatch``. BLAST's "gap existence 11,
    extension 1" is gap_open=-11, gap_extend=-1 here: a gap of one residue
    costs 12.
    """

    match: int = 1
    mismatch: int = -1
    gap_open: int = -3
    gap_extend: int = -1
    matrix: str | None = None

    def validate(self) -> "SWConfig":
        """The kernels let pad cells decay instead of masking them, which
        (like local alignment itself) needs penalties to be penalties:
        mismatch and gap_extend strictly negative, gap_open non-positive,
        match positive. Under a matrix, match and mismatch stay at their
        defaults (they are not read, so a value there would be ignored
        silently) and the matrix is one ``scoring.MATRICES`` holds."""
        if self.matrix is not None:
            from genomax_torch.scoring import MATRICES

            if self.matrix not in MATRICES:
                raise ValueError(f"unsupported SW matrix {self.matrix!r}: "
                                 f"want one of {sorted(MATRICES)}")
            if (self.match, self.mismatch) != (1, -1):
                raise ValueError(
                    f"unsupported SW scoring {self}: under a matrix, match "
                    "and mismatch are not read; leave them at 1 and -1")
            if not (self.gap_open <= 0 and self.gap_extend < 0):
                raise ValueError(
                    f"unsupported SW scoring {self}: need gap_open <= 0, "
                    "gap_extend < 0")
            return self
        if not (self.match > 0 and self.mismatch < 0
                and self.gap_open <= 0 and self.gap_extend < 0):
            # The JAX package's message, whose config has no matrix field.
            shown = (f"SWConfig(match={self.match}, mismatch={self.mismatch}"
                     f", gap_open={self.gap_open}, gap_extend="
                     f"{self.gap_extend})")
            raise ValueError(
                f"unsupported SW scoring {shown}: need match > 0, "
                f"mismatch < 0, gap_open <= 0, gap_extend < 0"
            )
        return self


@dataclasses.dataclass(frozen=True)
class PairHMMConfig:
    """PairHMM forward parameters (pairHMMmatrix.c:9,32-55).

    ``log10_init`` is the log10 of the initial Y-row constant. The reference
    uses DBL_MAX/16 (fp64); the fp32 kernels use 2**120 internally and
    fold the difference into the final log-space result, so results agree
    to fp32 tolerance regardless of this constant.
    """

    phred_offset: float = 33.0
    # log10(DBL_MAX/16): the reference's scaling constant in log space.
    log10_init: float = 307.05063220302535
    # The reference's mismatch emission is plain Qr where GATK uses Qr/3
    # (pairHMMmatrix.c:32-34 against GKL). False is exact reference parity;
    # True is the HaplotypeCaller emission, applied alike by the kernels
    # and the fp64 fallback and offload paths.
    gatk_emission: bool = False

    @property
    def mm_div(self) -> float:
        """Mismatch-emission divisor for the kernels."""
        return 3.0 if self.gatk_emission else 1.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # Pairs with len(sx) + 2 > max_device_len, or len(sx) + len(sy) + 1 >
    # max_device_diags, leave the lane-tile kernel (the predicate of
    # genomax.engine.executor._sw_offload_mask): the long-pair kernels take
    # them on the same device up to max_device_diags, the native model past
    # it. PairHMM applies half of both bounds. Any max_device_len of 8 or
    # more, as in the JAX engine; past the lane tiles' tallest buckets
    # (MAX_KERNEL_ROWS, MAX_PHMM_ROWS) the port routes as their comments
    # say, with the same scores.
    max_device_len: int = 1024
    max_device_diags: int = 1 << 20
    # Route SW buckets of at least strips_min_nxs rows through the
    # strip-mined kernel (kernels/sw_strips.py, csrc/sw_strips.cu), which
    # sweeps only each strip's live diagonals; the rest, and the buckets it
    # declines, go to the rotor (below) or the lane-tile kernel
    # (csrc/sw_tile.cu). Measured on one NVIDIA H100 80GB HBM3 at 700.00 W
    # (chip_smoke.py phases 5, 20 and 23): on the 25,000 x 512bp bucket (224
    # tiles x 520 rows) the strips kernel takes 6.58-6.60 ms against the
    # lane-tile kernel's 10.50, and it wins from 256bp (264 rows) to
    # 1,000bp; the rotor (below) takes the short buckets from it, 0.088-
    # 0.093 ms against 0.32 at 72 rows and 0.088-0.098 against 0.103-0.111
    # at 136 rows (4,096 x 128bp), in two runs, so strips start at 144
    # rows, the first bucket past 136 (the JAX engine's floor of 128 is a
    # TPU number).
    sw_strips: bool = True
    strips_min_nxs: int = 144
    # Sublane-stacked SW for short pairs (kernels/sw_stacked.py,
    # csrc/sw_stacked.cu): with sw_stack >= 2, a bucket of at most
    # stack_max_nxs rows that strips declines stacks sw_stack tiles deep,
    # and the rotor is bypassed (the JAX engine's order: an explicit
    # opt-in). The kernel packs a stack's regions side by side in warps'
    # rows; a stack holds sw_stack * stack_max_nxs <= 1,024 rows, the TPU
    # kernel's limit. 0 or 1 disables, the default, as in genomax.config.
    # Measured on one NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py
    # phases 20 and 26, two runs): on the 25,000 x 64bp bucket (224 tiles x
    # 72 rows) the stacked kernel takes 0.122-0.127 ms at S = 4
    # (0.133-0.141 at 2, 0.130-0.134 at 8) against the rotor's 0.088-0.093
    # and the lane tile's 0.226-0.237; on 4,096 pairs of 64bp it took
    # 0.031-0.034 ms in one run and 0.061-0.065 in the other, against the
    # rotor's 0.041-0.043. It beats the lane tile everywhere and never the
    # rotor on the 25,000-pair bucket, so sw_stack stays 0.
    sw_stack: int = 0
    stack_max_nxs: int = 96
    # Column-stationary rotor for short pairs (kernels/sw_rotor.py,
    # csrc/sw_rotor.cu): a bucket that strips declines, whose every pair
    # fits one period T = round_up(max(nx, ny) + 1, 8) <= rotor_max_period
    # and that passes the rotor's geometry gate, queues its tiles per lane,
    # rotor_max_slots pairs a queue at most; the rest take the lane-tile
    # kernel. The knobs, the period of 136 and the order of the routers are
    # genomax.config's. Measured on one NVIDIA H100 80GB HBM3 at 700.00 W
    # (chip_smoke.py phases 20 and 23, two runs): on the 25,000 x 64bp
    # bucket the rotor takes 0.105-0.108 ms at 2 slots, 0.088-0.093 at 4,
    # 0.117-0.120 at 8 and 0.165-0.169 at 16, against strips' 0.32 and the
    # lane tile's 0.23; on 4,096 pairs of 128bp 2 slots beat 4 in both runs
    # (0.072-0.074 against 0.088-0.098 ms), at 64bp in one run of two.
    # Four slots stay: the fastest on the 25,000-pair bucket.
    sw_rotor: bool = True
    rotor_max_period: int = 136
    rotor_max_slots: int = 4
    # PairHMM knobs of genomax.config.EngineConfig, with its defaults: the
    # fp32 exponent-rescale period in diagonals, and the log10 threshold
    # below which (or when non-finite) a result is recomputed by the native
    # fp64 model, None disabling it.
    rescale_period: int = 32
    phmm_fallback_threshold: float | None = -45.0
    # Cross-device SW wavefront (ShardedEngine only; genomax.config's
    # fields and defaults): offloaded SW pairs whose x has at least
    # xshard_min_len bases score through one DP matrix split into per-rank
    # strips of x (dist/xsharded.py, csrc/sw_xstrip.cu) instead of the
    # long-pair kernel; None disables. unroll is its block length U: the
    # diagonals one kernel launch sweeps and the halo rows a rank hands its
    # right neighbour per block (any U >= 1; the port's other kernels do
    # not read it).
    unroll: int = 32
    xshard_min_len: int | None = None

    def __post_init__(self):
        if self.unroll < 1:
            raise ValueError(f"unroll={self.unroll}: want a block of at "
                             "least one diagonal")
        if self.xshard_min_len is not None and self.xshard_min_len < 1:
            raise ValueError(f"xshard_min_len={self.xshard_min_len}: want a "
                             "positive x length, or None")
        if (self.sw_stack >= 2
                and self.sw_stack * self.stack_max_nxs > MAX_STACK_ROWS):
            raise ValueError(
                f"sw_stack={self.sw_stack} x stack_max_nxs="
                f"{self.stack_max_nxs} rows: the stacked kernel takes at "
                f"most {MAX_STACK_ROWS} rows a stack")
        if self.strips_min_nxs < 1:
            raise ValueError(f"strips_min_nxs={self.strips_min_nxs}: want a "
                             "positive row count")
        if (not 8 <= self.rotor_max_period <= MAX_ROTOR_PERIOD
                or self.rotor_max_period % 8):
            raise ValueError(
                f"rotor_max_period={self.rotor_max_period}: want a multiple "
                f"of 8 in [8, {MAX_ROTOR_PERIOD}] (the rotor kernel's warp "
                "holds at most that many columns)")
        if self.rotor_max_slots < 1:
            raise ValueError(f"rotor_max_slots={self.rotor_max_slots}: want "
                             "at least one pair a queue")
        if self.max_device_len < 8:
            raise ValueError(f"max_device_len={self.max_device_len}: want "
                             "at least 8 rows")
        if self.rescale_period not in RESCALE_PERIODS:
            raise ValueError(
                f"rescale_period={self.rescale_period}: want one of "
                f"{RESCALE_PERIODS} (the packs reserve 32 rows of stream "
                "slack past each pair)")
