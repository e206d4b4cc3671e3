"""The SW transfer ladder: the host-to-device rung of the SW code tiles (the
counterpart of ``genomax.pack.nibble``).

The engine ships every SW stream packed as a :class:`StreamBand` (its live
rows only) through ``ship_stream``, which rebuilds the full buffer on the
device bit for bit: the kernels see the same tensors as from a full pack.

The nibble rung (``build_code_lut``, ``nibble_pack``,
``nibble_pack_4bit``, ``expand_nibbles``, ``make_shipper``) is kept equal
to the JAX module's but runs on no engine path: on the H100 its host table
and pack cost more than the copy they save (PERF.md). It rests on
an invariant of the SW kernels: they read sequence codes only through
equality tests plus the pad contract (x pads are code 1, stream pads code
0, and the packers reject bytes 0 and 1 inside sequences). Scores are
therefore the same under any one-to-one remap of the alphabet that keeps
the two pad codes, so when a bucket's alphabet has at most 14 symbols
(always for DNA: ACGTN and the trailing '\\n' make 6) the bytes are
remapped to the codes 2..15 and two rows travel in one byte. The tensors a
nibble shipper gives are that remap of the host pack, not the host pack: a
kernel that read a code's value (as the PairHMM kernels read their N code)
would score differently under it.

Contract: ``build_code_lut`` over every array a route copies (one shared
alphabet: the x codes must equal the same stream bytes after the remap),
``nibble_pack`` each on the host, ``expand_nibbles`` each on the device;
``make_shipper`` ties the three together. The expansion and the rebuild
are plain torch on the tensor's device: one or two passes over the copied
bytes each.
"""

from __future__ import annotations

import numpy as np
import torch

from genomax_torch.layout import PAD_STREAM, PAD_X
from genomax_torch.pack.bucketing import StreamBand

MAX_SYMBOLS = 14  # nibble values 2..15 (0 and 1 are the pad codes)

_IDENTITY_LUT = np.arange(256, dtype=np.uint8)


def build_code_lut(*arrays: np.ndarray) -> np.ndarray | None:
    """uint8[256] remap table over the distinct non-pad bytes of
    ``arrays``, or None when the alphabet needs more than 14 codes (inputs
    of arbitrary bytes: the caller copies them raw). One bincount pass a
    array; the identity on the pad codes 0 and 1."""
    counts = np.zeros(256, dtype=np.int64)
    for a in arrays:
        counts += np.bincount(a.reshape(-1).view(np.uint8), minlength=256)
    present = np.flatnonzero(counts[2:]) + 2
    if len(present) > MAX_SYMBOLS:
        return None
    lut = np.zeros(256, dtype=np.uint8)
    lut[PAD_X] = PAD_X
    lut[PAD_STREAM] = PAD_STREAM
    lut[present] = np.arange(2, 2 + len(present), dtype=np.uint8)
    return lut


def nibble_pack(arr: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """(NT, R, 128) int8 codes -> (NT, ceil(R/2), 128) uint8: remap
    through ``lut``, then row 2k in the low nibble and row 2k+1 in the
    high one. An odd R gets one pad row, which the expansion drops."""
    m = lut[arr.view(np.uint8) if arr.dtype == np.int8 else arr.astype(np.uint8)]
    nt, r, lanes = m.shape
    if r % 2:
        m = np.concatenate(
            [m, np.zeros((nt, 1, lanes), dtype=np.uint8)], axis=1)
    return m[:, 0::2] | (m[:, 1::2] << 4)


def nibble_pack_4bit(arr: np.ndarray) -> np.ndarray:
    """``nibble_pack`` of an array whose values are already 4-bit (the
    PairHMM match-bitmask codes 0, 1, 2, 4, 8, 15): no remap, two rows a
    byte. A value past 15 would spill into its neighbour's high nibble, so
    it raises ValueError."""
    if arr.size and int(arr.view(np.uint8).max()) > 0xF:
        raise ValueError("nibble_pack_4bit: array has values > 15")
    return nibble_pack(arr, _IDENTITY_LUT)


def expand_nibbles(packed: torch.Tensor, rows: int) -> torch.Tensor:
    """The inverse of ``nibble_pack`` on the tensor's device: (NT,
    ceil(rows/2), 128) uint8 -> (NT, rows, 128) int8, contiguous, the low
    and high nibbles of each byte back in consecutive rows."""
    nt, _, lanes = packed.shape
    full = torch.stack((packed & 0xF, packed >> 4), dim=2)
    return full.view(nt, -1, lanes)[:, :rows].view(torch.int8).contiguous()


def stream_bytes(sy):
    """The host bytes behind a stream: the band of a :class:`StreamBand`,
    the full buffer otherwise (for ``build_code_lut``)."""
    return sy.band if isinstance(sy, StreamBand) else sy


def ship_stream(ship, sy) -> torch.Tensor:
    """A reversed stream buffer on the device through ``ship`` (a
    ``make_shipper`` function or a plain placement). A :class:`StreamBand`
    ships its band only, and the full (NT, NDs, 128) int8 buffer is rebuilt
    on the band's device: zeros, the band inserted at row ``lo``. That is
    the host buffer bit for bit, since every row outside the band is
    PAD_STREAM = 0 by the pack's construction."""
    if not isinstance(sy, StreamBand):
        return ship(sy)
    band = ship(sy.band)
    nt, rows, lanes = band.shape
    full = torch.zeros((nt, sy.nds, lanes), dtype=band.dtype,
                       device=band.device)
    full[:, sy.lo: sy.lo + rows] = band
    return full


def make_shipper(put, *, lut=None):
    """The nibble shipper of SW code tiles. ``put`` places a numpy array on
    the device (``lambda a: torch.from_numpy(a).to(device)``). With ``lut``
    (the remap table of ``build_code_lut``) it returns a function of a (NT,
    R, 128) array that nibble-packs it on the host, places the half-size
    buffer and expands it on the device, giving the remapped codes; with
    None it returns ``put``: the tiles travel raw."""
    if lut is not None:
        return lambda a: expand_nibbles(put(nibble_pack(a, lut)), a.shape[1])
    return put
