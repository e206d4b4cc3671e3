"""Smith-Waterman bucket scoring: the wrapper of the hand-written CUDA
kernel ``csrc/sw_tile.cu``, with the contract of
``genomax.kernels.sw_pallas.sw_forward_pallas``.

The kernel keeps R rows a thread in registers and sweeps a pair's rows in
groups of 32 * R, one warp a group (``tile_geometry``): a pair of at most
32 * R rows is one warp, several pairs a block; a taller one a block of
up to 32 warps (8,193 rows at R = 8). CUDA tensors launch the kernel on the current stream; CPU tensors
take the plain version (``kernels.wavefront.sw_forward_tiles``). There is
no other route: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from genomax_torch import trace
from genomax_torch.config import SWConfig
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import sw_forward_tiles
from genomax_torch.layout import LANES

# Rows a thread of the kernel keeps in registers (its template argument,
# the values the build makes).
ROWS_PER_THREAD = (2, 3, 4, 5, 6, 8)
WARP = 32
# Pairs a block when a pair is one warp; the most warps a pair's block has
# (a CUDA block's 1,024 threads; blocks past 16 warps are the kernel's
# third instance family, with a launch bound of 1,024 threads).
PAIRS_PER_BLOCK = 8
MAX_WARPS = 32
# A step's fixed part (the hand-over's shuffles, the stream shuffle, the
# loop) in cells, and a block's barrier and seam in cells a warp: the
# weights of tile_geometry's cost.
STEP_CELLS, BARRIER_CELLS = 2, 1

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """How the kernel sweeps a bucket of ``nxs`` rows: R rows a thread,
    ``warps`` warps a pair (rows 1 .. nxs - 1 in groups of 32 * R), and
    ``pairs`` pairs a block (1 where a pair is a block of warps)."""

    rows_per_thread: int
    warps: int
    pairs: int


def max_rows() -> int:
    """The tallest bucket the kernel holds: MAX_WARPS warps of 32 threads
    at the largest R, plus row 0 (8,193 rows)."""
    return MAX_WARPS * WARP * max(ROWS_PER_THREAD) + 1


def tile_geometry(nxs: int, r: int | None = None) -> TileGeometry:
    """The kernel's geometry on a bucket of nxs rows. r None picks, of the
    R the build makes, the one whose step costs least: W warps of R cells
    and a fixed part each, W = ceil((nxs - 1) / (32 R)), plus a barrier a
    warp where W > 1; the smallest R on a tie. So a pair that one warp
    holds at some R is one warp (R = ceil((nxs - 1) / 32) rounded up to a
    built R), and a taller one takes the R that wastes fewest rows."""
    if not 2 <= nxs <= max_rows():
        raise ValueError(f"nxs={nxs}: want 2 to {max_rows()} rows")
    if r is not None and r not in ROWS_PER_THREAD:
        raise ValueError(f"rows_per_thread={r}: the build makes "
                         f"{ROWS_PER_THREAD}")

    def warps(r):
        return -(-(nxs - 1) // (WARP * r))

    def cost(r):
        w = warps(r)
        return w * (r + STEP_CELLS + (BARRIER_CELLS if w > 1 else 0))

    if r is None:
        r = min((r for r in ROWS_PER_THREAD if warps(r) <= MAX_WARPS),
                key=lambda r: (cost(r), r))
    w = warps(r)
    if w > MAX_WARPS:
        raise ValueError(f"nxs={nxs} at R={r}: {w} warps a pair, past "
                         f"{MAX_WARPS}")
    return TileGeometry(rows_per_thread=r, warps=w,
                        pairs=PAIRS_PER_BLOCK if w == 1 else 1)


def sw_forward(sx: torch.Tensor, sy: torch.Tensor, ndiag_tile: torch.Tensor,
               cfg: SWConfig = SWConfig(), *,
               _rows_per_thread: int | None = None) -> torch.Tensor:
    """Scores of a packed SW bucket.

    sx: (NT, NXs, 128) int8 sublane-fixed codes; sy: (NT, NDs, 128) int8
    reversed diagonal stream with anchor NDs - NXs >= every tile's
    diagonal count (the pack guarantees it); ndiag_tile: (NT,) int32.
    Returns (NT, 128) int32, slot-major, on the inputs' device.
    ``_rows_per_thread`` picks the kernel's R among those the build makes
    (``tile_geometry``'s choice when None), for its tests and timing.
    """
    if _rows_per_thread not in (None, *ROWS_PER_THREAD):
        raise ValueError(f"rows_per_thread={_rows_per_thread}: the build "
                         f"makes {ROWS_PER_THREAD}")
    if sx.device.type == "cpu":
        return sw_forward_tiles(sx, sy, ndiag_tile, cfg)
    return _launch(sx, sy, ndiag_tile, cfg, _rows_per_thread)


@trace.traced("launch")
def _launch(sx, sy, ndiag_tile, cfg: SWConfig, r) -> torch.Tensor:
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
    if not 2 <= nxs <= max_rows() or sy.shape[1] <= nxs:
        raise ValueError(f"sw_forward: NXs={nxs} must lie in [2, "
                         f"{max_rows()}] and below NDs={sy.shape[1]}")
    geo = tile_geometry(nxs, r)
    sx, sy, ndiag_tile = (sx.contiguous(), sy.contiguous(),
                          ndiag_tile.contiguous())
    out = torch.empty((nt, LANES), dtype=torch.int32, device=sx.device)
    if nt == 0:
        return out
    with torch.cuda.device(sx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            sx.data_ptr(), sy.data_ptr(), ndiag_tile.data_ptr(),
            out.data_ptr(), nt, nxs, sy.shape[1], geo.rows_per_thread,
            geo.warps, geo.pairs, cfg.match, cfg.mismatch, cfg.gap_open,
            cfg.gap_extend, stream)
    if err != 0:
        raise RuntimeError(f"sw_tile launch failed: cudaError {err}")
    trace.count("launches.tile")
    return out
