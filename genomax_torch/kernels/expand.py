"""Device-side expansion of packed PairHMM qualities: the torch counterparts
of ``genomax.kernels.pairhmm_pallas.expand_byte_quals`` and
``expand_factored``.

On the JAX side these are XLA operations, not Pallas kernels, so plain
torch on the device is their port: a 256-entry fp32 table gather, an
``index_select`` of the unique read and haplotype rows, and a ``permute``
back to the (NT, rows, 128) tiles. The results are bit-identical to the
JAX ones (the same fp64 table cast to fp32, the same fp32 order of
``1 - (qi + qd)``), and every output is contiguous, as the kernel wants.
"""

from __future__ import annotations

import numpy as np
import torch


def _phred_lut(phred_offset: float, device) -> torch.Tensor:
    """10**(-(b - offset)/10) for every byte b, computed in fp64 and cast to
    fp32; exact 0.0 below the offset, so the pads' byte 0 decodes to 0."""
    # With offset < 1 nothing would be zeroed, and a live qual byte 0 would
    # collide with the byte-0 pad sentinel.
    if phred_offset < 1.0:
        raise ValueError(
            f"phred_offset={phred_offset} < 1 breaks the byte-0 pad "
            "sentinel (lut[0] must be exactly 0)")
    lut = np.power(10.0, -(np.arange(256) - phred_offset) / 10.0)
    lut[: max(0, int(np.ceil(phred_offset)))] = 0.0
    return torch.from_numpy(lut.astype(np.float32)).to(device)


def expand_byte_quals(qb: torch.Tensor, phred_offset: float = 33.0):
    """Raw phred bytes (NT, 4, NXs, 128) int8, planes base/ins/del/gcp, pads
    byte 0 -> (qr, mmv, gapm, qi, qd, qg), each (NT, NXs, 128) fp32 and
    exactly 0 at every pad cell (mmv and gapm are gated on qb[:, 0] != 0,
    since 1 - 0 would be 1 there)."""
    lut = _phred_lut(phred_offset, qb.device)
    # Contiguous first, so every gather and select below is too.
    idx = qb.contiguous().view(torch.uint8).long()
    qr, qi, qd, qg = (lut[idx[:, k]] for k in range(4))
    live = idx[:, 0] != 0
    mmv = torch.where(live, 1.0 - (qi + qd), 0.0)
    gapm = torch.where(live, 1.0 - qg, 0.0)
    return qr, mmv, gapm, qi, qd, qg


def expand_factored(rchar_u, qb_u, hap_u, ridx, hidx,
                    phred_offset: float = 33.0):
    """Job tiles from a factored pack: unique rows rchar_u (NRu+1, NXs),
    qb_u (NRu+1, 4, NXs), hap_u (NHu+1, NDs) and per-slot gather indices
    ridx/hidx (NT, 128) -> (rchar, qr, mmv, gapm, qi, qd, qg, hap), as the
    unfactored byte-quals pack would give them."""
    nt, lanes = ridx.shape
    r = ridx.reshape(-1).long()
    h = hidx.reshape(-1).long()
    rchar = (rchar_u.index_select(0, r).view(nt, lanes, -1)
             .permute(0, 2, 1).contiguous())
    qb = qb_u.index_select(0, r).view(nt, lanes, 4, -1).permute(0, 2, 3, 1)
    hap = (hap_u.index_select(0, h).view(nt, lanes, -1)
           .permute(0, 2, 1).contiguous())
    return (rchar,) + expand_byte_quals(qb, phred_offset) + (hap,)
