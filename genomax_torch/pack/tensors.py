"""Packed buckets (``pack.bucketing.SWPacked`` and ``PairHMMPacked``) as
tensors on a device. An SW stream packed as a
:class:`~genomax_torch.pack.bucketing.StreamBand` travels as its band and
is rebuilt on the device (``pack.nibble.ship_stream``)."""

from __future__ import annotations

import torch

from genomax_torch.kernels.expand import expand_factored
from genomax_torch.pack.bucketing import PairHMMPacked, SWPacked
from genomax_torch.pack.nibble import ship_stream


def _put(device):
    return lambda a: torch.from_numpy(a).to(device)


def sw_bucket_to_torch(b: SWPacked, device: torch.device):
    """(sx (NT,NXs,128) int8, sy (NT,NDs,128) int8, ndiag_tile (NT,) int32)
    on ``device``."""
    put = _put(device)
    return put(b.sx), ship_stream(put, b.sy), put(b.ndiag_tile)


def sw_strips_to_torch(prep, b: SWPacked, device: torch.device):
    """(sx (NT,K*W,128) int8, sy (NT,NDs,128) int8, nx, ny (NT*128,) int32)
    on ``device``: the re-padded codes and stream of a strips prep of
    bucket ``b`` (``kernels.sw_strips.prep_bucket_strips``) and the
    bucket's per-slot lengths."""
    (sx, sy, _, _), _ = prep
    put = _put(device)
    return put(sx), ship_stream(put, sy), put(b.nx), put(b.ny)


def sw_rotor_to_torch(prep, device: torch.device):
    """(xrev (NT_r,NB,128) int8, ybuf (NT_r,NY,128) int8) on ``device``: the
    arrays of a rotor prep (``kernels.sw_rotor.prep_bucket_rotor``)."""
    (xrev, ybuf), _ = prep
    return tuple(torch.from_numpy(a).to(device) for a in (xrev, ybuf))


def sw_stacked_to_torch(prep, device: torch.device):
    """(sx (NT',S*h,128) int8, sy (NT',a0+S*h,128) int8, ndt (NT',) int32)
    on ``device``: the arrays of a stacked prep
    (``kernels.sw_stacked.prep_bucket_stacked``)."""
    return tuple(torch.from_numpy(a).to(device) for a in prep[0])


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

    def dev(a):
        return torch.from_numpy(a).to(device)

    tiles = expand_factored(dev(b.rchar_u), dev(b.qb_u), dev(b.hap_u),
                            dev(b.ridx), dev(b.hidx), phred_offset)
    return tiles + (dev(b.meta), dev(b.ndiag_tile))
