"""PairHMM bucket scoring: the wrapper of the hand-written CUDA kernel
``csrc/pairhmm_tile.cu``, with the contract of
``genomax.kernels.pairhmm_pallas.pairhmm_forward_pallas``.

The kernel keeps R read rows a thread in registers and sweeps a pair with a
group of G <= 32 threads of one warp, or past 32R rows with a block of up to
32 warps (``tile_geometry``; 8,192 rows at R = 8). CUDA tensors
launch the kernel on the current stream; CPU tensors take the plain version
(``kernels.wavefront.phmm_forward_tiles``). There is no other route: a
build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from genomax_torch.config import MAX_PHMM_ROWS, RESCALE_PERIODS
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import phmm_forward_tiles
from genomax_torch.layout import LANES

# Rows a thread of the kernel keeps in registers (its template argument,
# the values the build makes), the warp width and the warps of a block.
TILE_R = (1, 2, 4, 5, 6, 8, 10, 16)
WARP = 32
TILE_WARPS = 8
# R of the block form, a pair of more than 32R rows as a block of up to
# BLOCK_MAX_WARPS warps (register pressure past 8 rows a thread; a CUDA
# block's 1,024 threads, so 8,192 rows at R = 8 and 4,096 at R = 4), and
# the weights of its cost in cells: a step's fixed part (the hand-over's
# shuffles, the stream shuffle, the loop) and a warp's barrier and seam.
# The weights are not fitted: they pick R = 8 at 1,008 and 2,048 rows, the
# fastest of every R that chip_smoke.py phase 38 times there on one H100.
BLOCK_R = (4, 5, 6, 8)
BLOCK_MAX_WARPS = 32
STEP_CELLS, BARRIER_CELLS = 1, 1

# Kernel launches made by pairhmm_forward (CUDA tensors only).
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """How the kernel sweeps a bucket of NXs rows: ``rows_per_thread`` (R)
    rows a thread, a ``group`` of G threads a pair (G * R >= NXs),
    ``pairs_per_warp`` = 32 // G pairs a warp, ``warps`` a block, so
    ``lanes_per_block`` neighbouring lanes of one tile a block and
    ``blocks_per_tile`` blocks a tile of 128 lanes. The warp form has G <=
    32 and 8 warps a block; the block form (``block``) G = 32 * warps, one
    pair a block (pairs_per_warp 0: a pair spans the warps)."""

    rows_per_thread: int
    group: int
    pairs_per_warp: int
    warps: int
    lanes_per_block: int
    blocks_per_tile: int

    @property
    def block(self) -> bool:
        return self.group > WARP


def _block_warps(nxs: int, r: int) -> int:
    return -(-nxs // (WARP * r))


def block_bounds(r: int) -> tuple[int, ...]:
    """The launch bounds, in warps, of the block form's instances at R = r
    (csrc/pairhmm_tile.cu): the warps of a 2,048-row block, 16 and 32; a
    launch takes the smallest that holds its block."""
    return tuple(sorted({_block_warps(2048, r), BLOCK_MAX_WARPS // 2,
                         BLOCK_MAX_WARPS}))


def default_rows_per_thread(nxs: int) -> int:
    """R the wrappers take when the caller names none: the fewest rows a
    thread with which one warp holds a pair of NXs rows; past 512 rows, of
    the R of BLOCK_R with which BLOCK_MAX_WARPS warps hold the pair, the one
    whose step costs least (W warps of R cells, a fixed part and a barrier
    each, W = ceil(NXs / 32R)), the smallest on a tie."""
    for r in TILE_R:
        if -(-nxs // r) <= WARP:
            return r
    return min((r for r in BLOCK_R
                if _block_warps(nxs, r) <= BLOCK_MAX_WARPS),
               key=lambda r: (
                   _block_warps(nxs, r) * (r + STEP_CELLS + BARRIER_CELLS),
                   r))


def tile_geometry(nxs: int, r: int | None = None) -> TileGeometry:
    """The kernel's geometry on a bucket of NXs rows at R rows a thread
    (the default's when r is None): the warp form where one warp holds the
    pair at R, else the block form. Raises ValueError for an R the build
    does not make, or one with which a pair needs more than a warp and the
    block form is not built, or needs more than BLOCK_MAX_WARPS warps."""
    if not 2 <= nxs <= MAX_PHMM_ROWS:
        raise ValueError(f"NXs={nxs} must lie in [2, {MAX_PHMM_ROWS}]")
    if r is None:
        r = default_rows_per_thread(nxs)
    if r not in TILE_R:
        raise ValueError(f"rows_per_thread={r}: the build makes {TILE_R}")
    g = -(-nxs // r)
    if g > WARP:
        if r not in BLOCK_R:
            raise ValueError(
                f"rows_per_thread={r}: NXs={nxs} needs {g} threads a pair, "
                f"more than a warp of {WARP}, and the block form takes R in "
                f"{BLOCK_R}")
        w = _block_warps(nxs, r)
        if w > BLOCK_MAX_WARPS:
            raise ValueError(
                f"rows_per_thread={r}: NXs={nxs} needs {w} warps a pair, "
                f"past the block form's {BLOCK_MAX_WARPS}")
        return TileGeometry(rows_per_thread=r, group=w * WARP,
                            pairs_per_warp=0, warps=w, lanes_per_block=1,
                            blocks_per_tile=LANES)
    p = WARP // g
    lanes = TILE_WARPS * p
    return TileGeometry(rows_per_thread=r, group=g, pairs_per_warp=p,
                        warps=TILE_WARPS, lanes_per_block=lanes,
                        blocks_per_tile=-(-LANES // lanes))


def pairhmm_forward(rchar, qr, mmv, gapm, qi, qd, qg, hap, meta, ndiag_tile,
                    rescale_period: int = 32, mm_div: float = 1.0,
                    bitmask: bool = False, *,
                    _rows_per_thread: int | None = None) -> torch.Tensor:
    """log10 likelihoods of a packed PairHMM bucket.

    rchar: (NT, NXs, 128) int8 read codes, row i holding base i-1; qr, mmv,
    gapm, qi, qd, qg: (NT, NXs, 128) fp32; hap: (NT, NDs, 128) int8
    reversed haplotype stream with anchor NDs - NXs past every pair's last
    diagonal plus 32 (the pack guarantees it); meta: (NT, 8, 128) int32,
    row 0 read_len, row 1 hap_len; ndiag_tile: (NT,) int32. mm_div 3 is
    the GATK mismatch emission; bitmask: the codes are the pack's one-hot
    match bitmasks. Returns (NT, 128) fp32, slot-major, relative to the
    reference's constant, on the inputs' device. ``_rows_per_thread``
    picks the kernel's R (a test and timing hook; ``tile_geometry``); an
    R the build does not make raises on every device.
    """
    if _rows_per_thread is not None and rchar.dim() == 3:
        tile_geometry(rchar.shape[1], _rows_per_thread)
    if rchar.device.type == "cpu":
        return phmm_forward_tiles(rchar, qr, mmv, gapm, qi, qd, qg, hap, meta,
                                  ndiag_tile, rescale_period, mm_div, bitmask)
    return _launch(rchar, (qr, mmv, gapm, qi, qd, qg), hap, meta, ndiag_tile,
                   rescale_period, mm_div, bitmask, _rows_per_thread)


def _launch(rchar, quals, hap, meta, ndiag_tile, rescale_period, mm_div,
            bitmask, rows_per_thread) -> torch.Tensor:
    global launches
    launch = _build.load("pairhmm_tile", "pairhmm_tile_launch", _ARGTYPES)
    tensors = (rchar, *quals, hap, meta, ndiag_tile)
    if not rchar.is_cuda or any(t.device != rchar.device for t in tensors):
        raise ValueError("pairhmm_forward: every input must lie on one CUDA "
                         f"device (got {[str(t.device) for t in tensors]})")
    want = ((torch.int8,) + (torch.float32,) * 6
            + (torch.int8, torch.int32, torch.int32))
    got = tuple(t.dtype for t in tensors)
    if got != want:
        raise TypeError(f"pairhmm_forward: dtypes {got}, want {want}")
    nt, nxs, lanes = rchar.shape
    nds = hap.shape[1] if hap.dim() == 3 else -1
    if (lanes != LANES or any(tuple(q.shape) != (nt, nxs, LANES)
                              for q in quals)
            or tuple(hap.shape) != (nt, nds, LANES)
            or tuple(meta.shape) != (nt, 8, LANES)
            or tuple(ndiag_tile.shape) != (nt,)):
        raise ValueError(
            "pairhmm_forward: shapes "
            f"{[tuple(t.shape) for t in tensors]} are not (NT,NXs,{LANES}) "
            f"x7, (NT,NDs,{LANES}), (NT,8,{LANES}), (NT,)")
    if not 2 <= nxs <= MAX_PHMM_ROWS or nds <= nxs:
        raise ValueError(f"pairhmm_forward: NXs={nxs} must lie in [2, "
                         f"{MAX_PHMM_ROWS}] and below NDs={nds}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pairhmm_forward: every input must be contiguous")
    if rescale_period not in RESCALE_PERIODS:
        raise ValueError(f"pairhmm_forward: rescale_period={rescale_period} "
                         f"not in {RESCALE_PERIODS}")
    geo = tile_geometry(nxs, rows_per_thread)
    out = torch.empty((nt, LANES), dtype=torch.float32, device=rchar.device)
    if nt == 0:
        return out
    with torch.cuda.device(rchar.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(*(t.data_ptr() for t in tensors), out.data_ptr(), nt, nxs,
                     nds, rescale_period, float(mm_div), int(bool(bitmask)),
                     geo.rows_per_thread, geo.group, geo.warps, stream)
    if err != 0:
        raise RuntimeError(f"pairhmm_tile launch failed: cudaError {err}")
    launches += 1
    return out
