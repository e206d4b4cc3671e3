"""Packed SW buckets (``genomax.pack.bucketing.SWPacked``) as tensors on a
device. The packing itself is the JAX package's, imported unchanged."""

from __future__ import annotations

import torch

from genomax.pack.bucketing import StreamBand, SWPacked


def sw_bucket_to_torch(b: SWPacked, device: torch.device):
    """(sx (NT,NXs,128) int8, sy (NT,NDs,128) int8, ndiag_tile (NT,) int32)
    on ``device``. A stream packed as a :class:`StreamBand` is
    materialized on the host first."""
    sy = b.sy.materialize() if isinstance(b.sy, StreamBand) else b.sy
    return (torch.from_numpy(b.sx).to(device),
            torch.from_numpy(sy).to(device),
            torch.from_numpy(b.ndiag_tile).to(device))
