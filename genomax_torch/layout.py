"""Shared tile-layout constants: the contract between the packers
(``pack/bucketing.py``, ``kernels/sw_long.py``, ``kernels/pairhmm_long.py``)
and every kernel. A copy of ``genomax/layout.py`` with the same values, so
the port's packs equal the JAX package's array for array.

- x tiles are (NXs, LANES): sequence position on axis 0, LANES independent
  pairs side by side.
- stream buffers are (NDs, LANES) with the sequence reversed around the
  anchor A = NDs - NXs: sy[k] sits at row A - 1 - k, pads (PAD_STREAM)
  below row A - len. A kernel's cell (x = p, y = j) reads row A - j. The
  packers guarantee A >= n_diags + MAX_UNROLL and quantize A to
  STREAM_CHUNK.
"""

LANES = 128  # pairs per tile
SUB_Q = 8  # padding quantum of the position axis
MAX_UNROLL = 32  # rows of anchor slack the packs reserve past n_diags
STREAM_CHUNK = 256  # quantum of the stream anchor

# Pad codes. x pads mismatch everything, PAD_STREAM included, so cells
# outside a pair's matrix decay; the packers reject bytes 0 and 1 inside
# real sequences.
PAD_X = 1
PAD_STREAM = 0
