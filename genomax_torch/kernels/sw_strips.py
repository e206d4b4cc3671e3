"""Strip-mined Smith-Waterman over a packed bucket: the routing predicate,
the host prep and the wrapper of the hand-written CUDA kernel
``csrc/sw_strips.cu``, with the contracts of ``genomax.kernels.sw_strips``
(``pick_strip_w``, ``prep_bucket_strips``, ``maybe_prep_strips`` and
``sw_forward_pallas_strips``).

The prep cuts the x axis of a bucket into K strips of W rows, as the JAX
prep does; the kernel walks those K*W rows in sub-strips of its own height
H = 32 * R, one warp a pair (``geometry``), each sub-strip over its own
live diagonals only; the lane-tile kernel (``csrc/sw_tile.cu``) sweeps
every row over the tile's whole diagonal count. The engine sends a bucket
here when ``EngineConfig.sw_strips`` is on, it has at least
``strips_min_nxs`` rows and the kernel can take it. CUDA tensors launch
the kernel on the current stream; CPU tensors take the plain version
(``kernels.wavefront.sw_strips_forward_tiles``, strips of W). There is no
other route: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from genomax_torch import scoring, trace
from genomax_torch.config import SWConfig
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import sw_strips_forward_tiles
from genomax_torch.layout import LANES, PAD_X
from genomax_torch.pack.bucketing import _round_up

WARP = 32
# Rows a thread of the kernel keeps in registers (its template argument,
# the values the build makes); a sub-strip is 32 * R rows.
ROWS_PER_THREAD = (2, 3, 4, 5, 6, 8)
# Pairs (warps) a block at most.
PAIRS_PER_BLOCK = 8
# Shared memory a block may use on the H100 (cudaDevAttrMaxSharedMemory-
# PerBlockOptin, 227 KB; the kernel has no static shared memory), and an
# SM's (228 KB, of which each resident block reserves 1 KB), with its
# limits of resident blocks and warps.
MAX_SMEM_BYTES = 232448
SM_SMEM_BYTES, BLOCK_RESERVED_BYTES = 233472, 1024
SM_BLOCKS, SM_WARPS = 32, 64
# The weights of geometry's cost, in cells: a step's fixed part (three
# shuffles, the ring and code loads, lane 31's ring store, the loop) and
# the extra of a masked cell (chip_smoke.py phase 5's times by R on one
# H100 fit them).
STEP_CELLS, MASKED_CELL = 1.0, 0.6

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
             + [ctypes.c_void_p] * 2)
# Shared memory of a block's code table under a matrix (sw_cell.cuh's
# kSubEntries int32), before its pairs' regions.
TABLE_BYTES = 4 * scoring.CODES * scoring.STRIDE


def smem_bytes(ny_max: int) -> int:
    """Shared memory of one pair of csrc/sw_strips.cu (strips_pair_bytes
    there): the seam ring of ny_max (D, Q) int32 entries and ny_max y
    codes, rounded to 16 bytes. A block of P pairs takes P times this,
    and under a matrix TABLE_BYTES more (``block_bytes``)."""
    return 8 * ny_max + _round_up(ny_max, 16)


def block_bytes(pairs: int, ny_max: int, matrix: bool = False) -> int:
    """Shared memory of a block of ``pairs`` pairs: theirs, and the code
    table's under a matrix."""
    return pairs * smem_bytes(ny_max) + (TABLE_BYTES if matrix else 0)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How the kernel sweeps a bucket: R rows a thread (sub-strips of
    32 * R rows), ``pairs`` warps a block and ``smem`` bytes of shared
    memory a block."""

    rows_per_thread: int
    pairs: int
    smem: int


def _steps(n_rows: int, ny_max: int, r: int) -> tuple[int, int]:
    """(steps, masked steps) of a pair with len x = n_rows - 1 and len y =
    ny_max - 1 in sub-strips of H = 32 r rows: sub-strip row0 sweeps
    [row0 + 1, min(row0 + H - 1, len x) + len y], unmasked on
    [row0 + H, row0 + len y] where its last row is live."""
    h, lx, ly = WARP * r, n_rows - 1, ny_max - 1
    steps = masked = 0
    for row0 in range(1, lx + 1, h):
        n = min(row0 + h - 1, lx) + ly - row0
        fast = max(0, ly - h + 1) if row0 + h - 1 <= lx else 0
        steps += n
        masked += n - fast
    return steps, masked


def _cost(n_rows: int, ny_max: int, r: int) -> float:
    """Geometry's cost of R = r, in cells: every step R cells and a fixed
    part, every masked step R cells' extra."""
    steps, masked = _steps(n_rows, ny_max, r)
    return steps * (r + STEP_CELLS) + masked * r * MASKED_CELL


def geometry(n_rows: int, ny_max: int, r: int | None = None,
             matrix: bool = False) -> Geometry:
    """The kernel's geometry on a bucket of n_rows (K*W) rows whose longest
    y needs ny_max ring entries. r None picks, of the R the build makes,
    the one whose longest pair costs least (``_cost``); the smallest R on
    a tie. Pairs a block: of 1 to
    PAIRS_PER_BLOCK, the count with which an SM's shared memory holds the
    most warps; the largest on a tie. Raises where one pair passes
    MAX_SMEM_BYTES. ``matrix``: the blocks hold the code table too."""
    if r is not None and r not in ROWS_PER_THREAD:
        raise ValueError(f"rows_per_thread={r}: the build makes "
                         f"{ROWS_PER_THREAD}")
    if n_rows < 1 or ny_max < 1:
        raise ValueError(f"n_rows={n_rows}, ny_max={ny_max}: want both "
                         "positive")
    if block_bytes(1, ny_max, matrix) > MAX_SMEM_BYTES:
        raise ValueError(f"ny_max={ny_max} needs "
                         f"{block_bytes(1, ny_max, matrix)} bytes of shared "
                         f"memory a pair, past {MAX_SMEM_BYTES}")
    if r is None:
        r = min(ROWS_PER_THREAD, key=lambda r: (_cost(n_rows, ny_max, r), r))

    def resident_warps(p):
        blocks = SM_SMEM_BYTES // (block_bytes(p, ny_max, matrix)
                                   + BLOCK_RESERVED_BYTES)
        return min(SM_WARPS, p * min(SM_BLOCKS, blocks))

    pairs = max((p for p in range(1, PAIRS_PER_BLOCK + 1)
                 if block_bytes(p, ny_max, matrix) <= MAX_SMEM_BYTES),
                key=lambda p: (resident_warps(p), p))
    return Geometry(rows_per_thread=r, pairs=pairs,
                    smem=block_bytes(pairs, ny_max, matrix))


def pick_strip_w(nxs: int, nyt: int) -> int | None:
    """Strip width of the prep for a bucket of nxs rows (nyt, the columns
    of its longest y, is the JAX signature's and weighs nothing here): nxs,
    one strip, so the prep re-pads nothing; None for nxs <= 33.

    The port's own rule, not the JAX one (whose 64-row floor and 8-row
    quantum were the TPU's). The kernel walks the pack's K*W rows in
    sub-strips of its own height (``geometry``), so W shapes only the
    prep's re-pad, and one strip needs none. The floor is the earlier
    rule's (W = 32 paid, in the one-thread-a-row kernel, at every
    nxs > 33), so the router takes the buckets it took."""
    return nxs if nxs > WARP + 1 else None


def prep_bucket_strips(bucket, strip_w: int | None = None,
                       matrix: bool = False):
    """Host prep of one SWPacked bucket for the strips kernel:
    ((sx, sy, ndiag_tile, nyt), dict(k_strips, strip_w, anchor)), the
    arrays and statics of ``genomax.kernels.sw_strips.prep_bucket_strips``
    at the same strip_w: sx re-padded with PAD_X to K*W rows, the stream
    untouched (a StreamBand too, which ``pack.tensors.sw_strips_to_torch``
    rebuilds on the device), nyt the largest ny of each tile,
    anchor = NDs - NXs.

    strip_w None picks it (``pick_strip_w``). Returns None where the
    kernel cannot take the bucket: a bucket of at most 33 rows, or one
    pair's shared memory past MAX_SMEM_BYTES (a longest y of about 25,800
    bases; with the code table's under ``matrix``). Raises for strip_w
    outside [1, NXs]: an oversized strip's first row reads past the stream
    in the plain strip sweep (the JAX prep raises the same way)."""
    nxs = bucket.sx.shape[1]
    nds = bucket.sy.shape[1]
    anchor = nds - nxs
    nyt = bucket.ny.reshape(-1, LANES).max(axis=1).astype(np.int32)
    if strip_w is None:
        strip_w = pick_strip_w(nxs, int(nyt.max()))
        if strip_w is None:
            return None
    elif not 1 <= strip_w <= nxs:
        raise ValueError(
            f"strip_w must be in [1, NXs={nxs}] (got {strip_w}): a strip's "
            "first row reads stream rows up to anchor + strip_w - 1, and "
            "the stream holds anchor + NXs rows, so an oversized strip "
            "reads past it")
    if block_bytes(1, int(nyt.max()), matrix) > MAX_SMEM_BYTES:
        return None
    k = -(-nxs // strip_w)
    sx = bucket.sx
    if k * strip_w != nxs:
        pad = np.full((sx.shape[0], k * strip_w - nxs, LANES), PAD_X,
                      sx.dtype)
        sx = np.concatenate([sx, pad], axis=1)
    arrays = (sx, bucket.sy, bucket.ndiag_tile, nyt)
    return arrays, dict(k_strips=k, strip_w=strip_w, anchor=anchor)


def takes(cfg, nxs: int, ny_max: int, matrix: bool = False) -> bool:
    """Whether the strips route takes a bucket of nxs rows whose longest y
    needs ny_max ring entries: cfg.sw_strips, at least cfg.strips_min_nxs
    rows, a strip width (``pick_strip_w``) and one pair's shared memory
    (with the code table's under ``matrix``) within MAX_SMEM_BYTES.
    ``maybe_prep_strips`` routes by it, and the engine's offload mask asks
    it of the buckets past the lane tile's tallest."""
    return bool(cfg.sw_strips and nxs >= cfg.strips_min_nxs
                and pick_strip_w(nxs, ny_max) is not None
                and block_bytes(1, ny_max, matrix) <= MAX_SMEM_BYTES)


def maybe_prep_strips(cfg, bucket, matrix: bool = False):
    """The routing predicate of the strips kernel (``takes``). Returns the
    prep, or None. The JAX predicate's two other gates (a stream past
    stream_vmem_rows, a VMEM footprint past STRIPS_VMEM_BUDGET) are the
    TPU's capacity; the shared-memory limit of the prep takes their
    place."""
    if not takes(cfg, bucket.sx.shape[1], int(bucket.ny.max()), matrix):
        return None
    return prep_bucket_strips(bucket, matrix=matrix)


def sw_forward_strips(sx: torch.Tensor, sy: torch.Tensor, nx: torch.Tensor,
                      ny: torch.Tensor, *, k_strips: int, strip_w: int,
                      anchor: int, ny_max: int, cfg: SWConfig = SWConfig(),
                      table: torch.Tensor | None = None,
                      _rows_per_thread: int | None = None) -> torch.Tensor:
    """(NT, 128) int32 scores of a bucket prepared by
    ``prep_bucket_strips``, slot-major, on the inputs' device.

    sx: (NT, K*W, 128) int8; sy: (NT, NDs, 128) int8 with y[j-1] at row
    anchor - j; nx, ny: (NT*128,) int32 matrix dimensions of each slot
    (``SWPacked.nx/ny``); ny_max: at least every ny (the largest of the
    prep's nyt), the size of the kernel's seam ring. Under ``cfg.matrix``
    the codes are ``scoring``'s and ``table`` the code table on the device
    (``scoring.device_table``; copied per call where None).
    ``_rows_per_thread`` picks the kernel's R among those the build makes
    (``geometry``'s choice when None), for its tests and timing.
    """
    if strip_w < 1 or k_strips < 1:
        raise ValueError(f"sw_forward_strips: strip_w={strip_w} and "
                         f"k_strips={k_strips} must be positive")
    tensors = (sx, sy, nx, ny)
    nt = sx.shape[0] if sx.dim() == 3 else -1
    nds = sy.shape[1] if sy.dim() == 3 else -1
    want = ((nt, k_strips * strip_w, LANES), (nt, nds, LANES),
            (nt * LANES,), (nt * LANES,))
    got = tuple(tuple(t.shape) for t in tensors)
    if got != want or nt < 0:
        raise ValueError(f"sw_forward_strips: shapes {got}, want {want} "
                         f"(sx of k_strips={k_strips} x strip_w={strip_w} "
                         "rows)")
    want = (torch.int8, torch.int8, torch.int32, torch.int32)
    got = tuple(t.dtype for t in tensors)
    if got != want:
        raise TypeError(f"sw_forward_strips: dtypes {got}, want {want}")
    if any(t.device != sx.device for t in tensors):
        raise ValueError("sw_forward_strips: every input must lie on one "
                         f"device (got {[str(t.device) for t in tensors]})")
    if not (1 <= ny_max <= anchor and anchor + strip_w <= nds):
        raise ValueError(f"sw_forward_strips: want 1 <= ny_max={ny_max} <= "
                         f"anchor={anchor} and anchor + strip_w={strip_w} "
                         f"<= NDs={nds}")
    geo = geometry(k_strips * strip_w, ny_max, _rows_per_thread,
                   scoring.matrix_of(cfg) is not None)
    if sx.device.type == "cpu":
        if nt and int(ny.max()) > ny_max:
            raise ValueError(f"sw_forward_strips: ny up to {int(ny.max())} "
                             f"past ny_max={ny_max}")
        return sw_strips_forward_tiles(sx, sy, nx, ny, k_strips=k_strips,
                                       strip_w=strip_w, anchor=anchor,
                                       cfg=cfg)
    return _launch(sx, sy, nx, ny, k_strips * strip_w, anchor, ny_max, geo,
                   cfg, scoring.device_table(cfg, sx.device, table))


@trace.traced("launch")
def _launch(sx, sy, nx, ny, n_rows, anchor, ny_max, geo: Geometry,
            cfg: SWConfig, table) -> torch.Tensor:
    launch = _build.load("sw_strips", "sw_strips_launch", _ARGTYPES)
    if not sx.is_cuda:
        raise ValueError(f"sw_forward_strips: device {sx.device} is neither "
                         "cpu nor cuda")
    sx, sy, nx, ny = (t.contiguous() for t in (sx, sy, nx, ny))
    nt = sx.shape[0]
    out = torch.empty((nt, LANES), dtype=torch.int32, device=sx.device)
    if nt == 0:
        return out
    with torch.cuda.device(sx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(sx.data_ptr(), sy.data_ptr(), nx.data_ptr(),
                     ny.data_ptr(), out.data_ptr(), nt, n_rows,
                     geo.rows_per_thread, geo.pairs, sy.shape[1], anchor,
                     ny_max, cfg.match, cfg.mismatch, cfg.gap_open,
                     cfg.gap_extend, scoring.table_ptr(table), stream)
    if err != 0:
        raise RuntimeError(f"sw_strips launch failed: cudaError {err}")
    trace.count("launches.strips")
    return out
