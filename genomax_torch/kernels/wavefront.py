"""Plain PyTorch Smith-Waterman wavefront: the torch twin of the SW half of
``genomax/kernels/wavefront.py``.

It is the plain reference of the CUDA kernel in ``csrc/sw_tile.cu``: the
CPU path of ``kernels.sw.sw_forward`` runs it, the tests hold it against
the JAX package, and ``chip_smoke.py`` holds the kernel against it on the
card. It keeps the JAX formulation as it is, so the two can be read side
by side:

  * the ``(NXs, L)`` layout: x position on axis 0, one pair per column;
  * the reversed diagonal stream, anchored at A = NDs - NXs: the window of
    diagonal d is rows [A-d, A-d+NXs), and its row s holds sy[d-1-s];
  * the mask-free recurrence: pads (x 1, stream 0) mismatch everything,
    so cells outside a pair's matrix decay and never feed a real cell;
  * the -KILL pins on the boundary rows, which make the circular
    ``torch.roll`` of the carried diagonals act as the first-column
    boundary (D = 0, Q = 0 at row 0).
"""

from __future__ import annotations

import torch

from genomax.config import SWConfig

# Boundary-row kill constant, as in genomax/kernels/wavefront.py: it
# dominates any real score chain and keeps every int32 add from wrapping.
KILL = 1 << 28


def sw_make_consts(sxb: torch.Tensor, cfg: SWConfig):
    """Loop-invariant (NXs, L) vectors (genomax wavefront.sw_make_consts):
    match/mismatch and gap-open+extend carry -KILL at the bottom row,
    gap-extend for Q's carry at row 0."""
    rows = torch.arange(sxb.shape[0], device=sxb.device).unsqueeze(1)
    row0, rowl = rows == 0, rows == sxb.shape[0] - 1

    def vec(mask, value):
        v = torch.full_like(sxb, value)
        return v.masked_fill_(mask.expand_as(v), -KILL)

    return (vec(rowl, cfg.match), vec(rowl, cfg.mismatch),
            vec(row0, cfg.gap_extend), vec(rowl, cfg.gap_open + cfg.gap_extend))


def sw_forward_dense(sx: torch.Tensor, sy_rev: torch.Tensor, n_diags: int,
                     cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """SW scores of the pairs packed in the columns of ``sx``.

    sx: (NXs, L) sublane-fixed codes (row p holds x[p-1], pads 1);
    sy_rev: (NDs, L) reversed diagonal stream; n_diags: diagonals swept
    (any count from the pairs' largest nx+ny-1 up to NDs-NXs).
    Returns (L,) int32 scores.
    """
    # Widen first: the state and the -KILL constants take the input dtype,
    # and int8 would wrap KILL to 0 and scores at 127.
    sx = sx.to(torch.int32)
    sy_rev = sy_rev.to(torch.int32)
    nxs = sx.shape[0]
    anchor = sy_rev.shape[0] - nxs
    if not 0 <= n_diags <= anchor:
        raise ValueError(f"n_diags={n_diags} outside the stream window "
                         f"(anchor {anchor})")
    subm, subx, gev, ogev = sw_make_consts(sx, cfg)
    z = torch.zeros_like(sx)
    p1, d1, d1s, q1s, d2s, mx = z, z, z, z, z, z
    for d in range(n_diags):
        syw = sy_rev[anchor - d: anchor - d + nxs]
        pn = torch.maximum(d1, p1 + cfg.gap_extend)
        qn = torch.maximum(d1s, q1s + gev)
        sub = torch.where(syw == sx, subm, subx)
        dn = torch.maximum(torch.maximum(pn, qn) + ogev,
                           torch.clamp_min(d2s + sub, 0))
        mx = torch.maximum(mx, dn)
        p1, d1, d1s, q1s, d2s = (pn, dn, torch.roll(dn, 1, 0),
                                 torch.roll(qn, 1, 0), d1s)
    return mx.amax(dim=0)


def sw_forward_tiles(sx: torch.Tensor, sy: torch.Tensor,
                     ndiag_tile: torch.Tensor,
                     cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """The same on a packed bucket: sx (NT, NXs, 128), sy (NT, NDs, 128),
    ndiag_tile (NT,) -> (NT, 128) int32, the contract of
    ``genomax.kernels.sw_pallas.sw_forward_pallas``. All tiles sweep the
    bucket's largest diagonal count, which the pad decay makes harmless."""
    nt, nxs, lanes = sx.shape
    if nt == 0:
        return torch.zeros((0, lanes), dtype=torch.int32, device=sx.device)
    flat_x = sx.permute(1, 0, 2).reshape(nxs, nt * lanes)
    flat_y = sy.permute(1, 0, 2).reshape(sy.shape[1], nt * lanes)
    scores = sw_forward_dense(flat_x, flat_y, int(ndiag_tile.max()), cfg)
    return scores.reshape(nt, lanes)
