"""Packed buckets (``pack.bucketing.SWPacked`` and ``PairHMMPacked``) as
tensors on a device. An SW stream packed as a
:class:`~genomax_torch.pack.bucketing.StreamBand` travels as its band and
is rebuilt on the device (``pack.nibble.ship_stream``)."""

from __future__ import annotations

import torch

from genomax_torch.kernels.expand import expand_factored
from genomax_torch.pack.bucketing import PairHMMPacked, SWPacked
from genomax_torch.pack.nibble import ship_stream, stream_bytes
from genomax_torch.trace import to_device


def sw_bucket_to_torch(b: SWPacked, device: torch.device):
    """(sx (NT,NXs,128) int8, sy (NT,NDs,128) int8, ndiag_tile (NT,) int32)
    on ``device``."""
    # a band is copied with the rest, then rebuilt into the full buffer
    sx, sy, nd = to_device(device, b.sx, stream_bytes(b.sy), b.ndiag_tile)
    return sx, ship_stream(lambda _: sy, b.sy), nd


def sw_strips_to_torch(prep, b: SWPacked, device: torch.device):
    """(sx (NT,K*W,128) int8, sy (NT,NDs,128) int8, nx, ny (NT*128,) int32)
    on ``device``: the re-padded codes and stream of a strips prep of
    bucket ``b`` (``kernels.sw_strips.prep_bucket_strips``) and the
    bucket's per-slot lengths."""
    (sx, sy, _, _), _ = prep
    tx, ty, nx, ny = to_device(device, sx, stream_bytes(sy), b.nx, b.ny)
    return tx, ship_stream(lambda _: ty, sy), nx, ny


def sw_rotor_to_torch(prep, device: torch.device):
    """(xrev (NT_r,NB,128) int8, ybuf (NT_r,NY,128) int8) on ``device``: the
    arrays of a rotor prep (``kernels.sw_rotor.prep_bucket_rotor``)."""
    (xrev, ybuf), _ = prep
    return to_device(device, xrev, ybuf)


def sw_stacked_to_torch(prep, device: torch.device):
    """(sx (NT',S*h,128) int8, sy (NT',a0+S*h,128) int8, ndt (NT',) int32)
    on ``device``: the arrays of a stacked prep
    (``kernels.sw_stacked.prep_bucket_stacked``)."""
    return to_device(device, *prep[0])


def phmm_bucket_to_torch(b: PairHMMPacked, device: torch.device,
                         phred_offset: float = 33.0):
    """The ten inputs of ``kernels.pairhmm.pairhmm_forward`` on ``device``:
    (rchar int8, qr, mmv, gapm, qi, qd, qg fp32, hap int8, meta int32,
    ndiag_tile int32), the tiles (NT, NXs|NDs, 128), all contiguous.

    ``b`` is a factored pack (``pack_pairhmm_batches(factored=True)``, as
    the engine packs): its unique rows and gather indices are copied and
    expanded on ``device``."""
    if b.rchar_u is None:
        raise ValueError("phmm_bucket_to_torch takes a factored pack "
                         "(pack_pairhmm_batches(..., factored=True))")
    *factors, meta, nd = to_device(device, b.rchar_u, b.qb_u, b.hap_u,
                                   b.ridx, b.hidx, b.meta, b.ndiag_tile)
    return expand_factored(*factors, phred_offset) + (meta, nd)
