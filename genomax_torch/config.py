"""Engine configuration of the port.

``genomax.config.EngineConfig`` resolves its backend through jax, so the
port keeps its own config holding only the knobs its path reads. There is
no backend resolver: the engine takes an explicit ``torch.device``.
"""

from __future__ import annotations

import dataclasses

# The SW kernel runs one thread per x row of a pair, and a CUDA block holds
# at most 1024 threads (csrc/sw_tile.cu).
MAX_KERNEL_ROWS = 1024
# The PairHMM kernel runs one thread per read row; the engine sends it reads
# under max_device_len // 2 (csrc/pairhmm_tile.cu).
MAX_PHMM_ROWS = MAX_KERNEL_ROWS // 2
# Rescale periods the packs reserve stream slack for (genomax.layout
# MAX_UNROLL = 32 rows past every pair's last diagonal).
RESCALE_PERIODS = (1, 2, 4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # Pairs with len(sx) + 2 > max_device_len, or len(sx) + len(sy) + 1 >
    # max_device_diags, leave the device kernel for the native model
    # (the same predicate as genomax.engine.executor._sw_offload_mask).
    max_device_len: int = 1024
    max_device_diags: int = 1 << 20
    # Routers of the JAX engine whose kernels are not ported yet. The port
    # runs the JAX engine's sw_strips=False, sw_rotor=False configuration,
    # in which every SW bucket takes the resident lane-tile kernel.
    sw_strips: bool = False
    sw_rotor: bool = False
    # PairHMM knobs of genomax.config.EngineConfig, with its defaults: the
    # fp32 exponent-rescale period in diagonals, and the log10 threshold
    # below which (or when non-finite) a result is recomputed by the native
    # fp64 model, None disabling it.
    rescale_period: int = 32
    phmm_fallback_threshold: float | None = -45.0

    def __post_init__(self):
        if self.sw_strips:
            raise NotImplementedError(
                "sw_strips: the strip-mined SW kernel is not ported yet "
                "(ROADMAP queue 2 item 1)")
        if self.sw_rotor:
            raise NotImplementedError(
                "sw_rotor: the short-pair rotor SW kernel is not ported yet "
                "(ROADMAP queue 2 item 3)")
        if not 8 <= self.max_device_len <= MAX_KERNEL_ROWS:
            raise ValueError(
                f"max_device_len={self.max_device_len}: the SW kernel takes "
                f"8 to {MAX_KERNEL_ROWS} x rows per pair")
        if self.rescale_period not in RESCALE_PERIODS:
            raise ValueError(
                f"rescale_period={self.rescale_period}: want one of "
                f"{RESCALE_PERIODS} (the packs reserve 32 rows of stream "
                "slack past each pair)")
