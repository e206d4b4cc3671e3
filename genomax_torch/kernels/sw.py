"""Smith-Waterman bucket scoring: the wrapper of the hand-written CUDA
kernel ``csrc/sw_tile.cu``, with the contract of
``genomax.kernels.sw_pallas.sw_forward_pallas``.

CUDA tensors launch the kernel on the current stream; CPU tensors take the
plain version (``kernels.wavefront.sw_forward_tiles``). There is no other
route: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from genomax_torch.config import MAX_KERNEL_ROWS, SWConfig
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import sw_forward_tiles
from genomax_torch.layout import LANES

# Kernel launches made by sw_forward (CUDA tensors only).
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def sw_forward(sx: torch.Tensor, sy: torch.Tensor, ndiag_tile: torch.Tensor,
               cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """Scores of a packed SW bucket.

    sx: (NT, NXs, 128) int8 sublane-fixed codes; sy: (NT, NDs, 128) int8
    reversed diagonal stream with anchor NDs - NXs >= every tile's
    diagonal count (the pack guarantees it); ndiag_tile: (NT,) int32.
    Returns (NT, 128) int32, slot-major, on the inputs' device.
    """
    if sx.device.type == "cpu":
        return sw_forward_tiles(sx, sy, ndiag_tile, cfg)
    return _launch(sx, sy, ndiag_tile, cfg)


def _launch(sx, sy, ndiag_tile, cfg: SWConfig) -> torch.Tensor:
    global launches
    launch = _build.load("sw_tile", "sw_tile_launch", _ARGTYPES)
    nt, nxs, lanes = sx.shape
    if not (sx.is_cuda and sy.device == sx.device
            and ndiag_tile.device == sx.device):
        raise ValueError("sw_forward: sx, sy and ndiag_tile must lie on one "
                         f"CUDA device (got {sx.device}, {sy.device}, "
                         f"{ndiag_tile.device})")
    if (sx.dtype, sy.dtype, ndiag_tile.dtype) != (torch.int8, torch.int8,
                                                  torch.int32):
        raise TypeError("sw_forward: want int8 sx/sy and int32 ndiag_tile, "
                        f"got {sx.dtype}, {sy.dtype}, {ndiag_tile.dtype}")
    if (lanes != LANES or sy.dim() != 3 or sy.shape[0] != nt
            or sy.shape[2] != LANES or tuple(ndiag_tile.shape) != (nt,)):
        raise ValueError(f"sw_forward: shapes {tuple(sx.shape)}, "
                         f"{tuple(sy.shape)}, {tuple(ndiag_tile.shape)} are "
                         f"not (NT,NXs,{LANES}), (NT,NDs,{LANES}), (NT,)")
    if not 2 <= nxs <= MAX_KERNEL_ROWS or sy.shape[1] <= nxs:
        raise ValueError(f"sw_forward: NXs={nxs} must lie in [2, "
                         f"{MAX_KERNEL_ROWS}] and below NDs={sy.shape[1]}")
    sx, sy, ndiag_tile = (sx.contiguous(), sy.contiguous(),
                          ndiag_tile.contiguous())
    out = torch.empty((nt, LANES), dtype=torch.int32, device=sx.device)
    if nt == 0:
        return out
    with torch.cuda.device(sx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            sx.data_ptr(), sy.data_ptr(), ndiag_tile.data_ptr(),
            out.data_ptr(), nt, nxs, sy.shape[1], cfg.match, cfg.mismatch,
            cfg.gap_open, cfg.gap_extend, stream)
    if err != 0:
        raise RuntimeError(f"sw_tile launch failed: cudaError {err}")
    launches += 1
    return out
