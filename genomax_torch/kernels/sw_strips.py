"""Strip-mined Smith-Waterman over a packed bucket: the routing predicate,
the host prep and the wrapper of the hand-written CUDA kernel
``csrc/sw_strips.cu``, with the contracts of ``genomax.kernels.sw_strips``
(``pick_strip_w``, ``prep_bucket_strips``, ``maybe_prep_strips`` and
``sw_forward_pallas_strips``).

The x axis of a bucket is cut into K strips of W rows, swept one after
another, each over its own live diagonals only; the lane-tile kernel
(``csrc/sw_tile.cu``) sweeps every row over the tile's whole diagonal
count. The engine sends a bucket here when ``EngineConfig.sw_strips`` is
on, it has at least ``strips_min_nxs`` rows and the kernel can take it.
CUDA tensors launch the kernel on the current stream; CPU tensors take the
plain version (``kernels.wavefront.sw_strips_forward_tiles``). There is no
other route: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from genomax_torch.config import SWConfig
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import sw_strips_forward_tiles
from genomax_torch.layout import LANES, PAD_X
from genomax_torch.pack.bucketing import _round_up

WARP = 32
# Rows per strip: one CUDA thread per row, so at most 1024.
MAX_STRIP_W = 1024
# Shared memory a block may use on the H100 (cudaDevAttrMaxSharedMemory-
# PerBlockOptin, 227 KB), less room for the kernel's static word.
MAX_SMEM_BYTES = 232448 - 256

# Kernel launches made by sw_forward_strips (CUDA tensors only).
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
             + [ctypes.c_void_p])


def smem_bytes(strip_w: int, ny_max: int) -> int:
    """Dynamic shared memory of one block of csrc/sw_strips.cu
    (strips_smem_bytes there): ping-pong D, Q and y-code rows (6W int32),
    the seam ring of ny_max (D, Q) entries and ny_max y codes, rounded to
    16 bytes."""
    return 24 * strip_w + 8 * ny_max + _round_up(ny_max, 16)


def pick_strip_w(nxs: int, nyt: int) -> int | None:
    """Strip width of a bucket of nxs rows whose longest y needs nyt
    columns (ny = len + 1): of the multiples of 32 in [32, min(1024,
    nxs - 1)] that pay, the one that minimises K*(W + nyt)*(W + 32),
    K = ceil(nxs / W); the smallest on a tie. A width pays where its
    sweep takes fewer thread-steps, K*W*(W + nyt), than the lane-tile
    kernel's round_up(nxs, 32) threads over nxs + nyt - 1 diagonals; W =
    32 pays at every nxs > 33, so None means nxs <= 33.

    The port's own rule, not the JAX one (whose 64-row floor and 8-row
    quantum were the TPU's). A block runs W threads, one per row, so W is
    whole warps. Strip k sweeps W + len(y) diagonals, and a diagonal costs
    its W thread-steps plus a fixed part about one warp's worth (the
    barrier, the seam hand-over of thread 0 and thread W-1), which favours
    wider strips on long pairs: on one H100 (chip_smoke.py phase 20) the
    rule picks the fastest of W = 32..256 at 64bp and 128bp (32), 512bp
    (96) and 1,000bp (128)."""
    tile_steps = _round_up(nxs, WARP) * (nxs + nyt - 1)
    best, bw = None, None
    for w in range(WARP, min(MAX_STRIP_W, nxs - 1) + 1, WARP):
        k = -(-nxs // w)
        cost = k * (w + nyt) * (w + WARP)
        if k * w * (w + nyt) < tile_steps and (best is None or cost < best):
            best, bw = cost, w
    return bw


def prep_bucket_strips(bucket, strip_w: int | None = None):
    """Host prep of one SWPacked bucket for the strips kernel:
    ((sx, sy, ndiag_tile, nyt), dict(k_strips, strip_w, anchor)), the
    arrays and statics of ``genomax.kernels.sw_strips.prep_bucket_strips``
    at the same strip_w: sx re-padded with PAD_X to K*W rows, the stream
    untouched, nyt the largest ny of each tile, anchor = NDs - NXs.

    strip_w None picks it (``pick_strip_w``). Returns None where the
    kernel cannot take the bucket: no strip width pays, a strip wider than
    a block, or shared memory past MAX_SMEM_BYTES (a stream of about
    23,000 rows). Raises for strip_w outside [1, NXs]: an oversized strip
    reads past the stream (the JAX prep raises the same way)."""
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
    if (strip_w > MAX_STRIP_W
            or smem_bytes(strip_w, int(nyt.max())) > MAX_SMEM_BYTES):
        return None
    k = -(-nxs // strip_w)
    sx = bucket.sx
    if k * strip_w != nxs:
        pad = np.full((sx.shape[0], k * strip_w - nxs, LANES), PAD_X,
                      sx.dtype)
        sx = np.concatenate([sx, pad], axis=1)
    arrays = (sx, bucket.sy, bucket.ndiag_tile, nyt)
    return arrays, dict(k_strips=k, strip_w=strip_w, anchor=anchor)


def maybe_prep_strips(cfg, bucket):
    """The routing predicate of the strips kernel: cfg.sw_strips, at least
    cfg.strips_min_nxs rows, and a bucket the kernel takes
    (``prep_bucket_strips``). Returns the prep, or None. The JAX
    predicate's two other gates (a stream past stream_vmem_rows, a VMEM
    footprint past STRIPS_VMEM_BUDGET) are the TPU's capacity; the
    shared-memory limit of the prep takes their place."""
    if not cfg.sw_strips or bucket.sx.shape[1] < cfg.strips_min_nxs:
        return None
    return prep_bucket_strips(bucket)


def sw_forward_strips(sx: torch.Tensor, sy: torch.Tensor, nx: torch.Tensor,
                      ny: torch.Tensor, *, k_strips: int, strip_w: int,
                      anchor: int, ny_max: int,
                      cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """(NT, 128) int32 scores of a bucket prepared by
    ``prep_bucket_strips``, slot-major, on the inputs' device.

    sx: (NT, K*W, 128) int8; sy: (NT, NDs, 128) int8 with y[j-1] at row
    anchor - j; nx, ny: (NT*128,) int32 matrix dimensions of each slot
    (``SWPacked.nx/ny``); ny_max: at least every ny (the largest of the
    prep's nyt), the size of the kernel's seam ring.
    """
    if not 1 <= strip_w <= MAX_STRIP_W or k_strips < 1:
        raise ValueError(f"sw_forward_strips: strip_w={strip_w} must lie in "
                         f"[1, {MAX_STRIP_W}] (one CUDA thread per row) and "
                         f"k_strips={k_strips} be positive")
    tensors = (sx, sy, nx, ny)
    nt = sx.shape[0] if sx.dim() == 3 else -1
    nds = sy.shape[1] if sy.dim() == 3 else -1
    want = ((nt, k_strips * strip_w, LANES), (nt, nds, LANES),
            (nt * LANES,), (nt * LANES,))
    got = tuple(tuple(t.shape) for t in tensors)
    if got != want or nt < 0:
        raise ValueError(f"sw_forward_strips: shapes {got}, want {want}")
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
    if smem_bytes(strip_w, ny_max) > MAX_SMEM_BYTES:
        raise ValueError(f"sw_forward_strips: strip_w={strip_w}, "
                         f"ny_max={ny_max} need {smem_bytes(strip_w, ny_max)}"
                         f" bytes of shared memory, past {MAX_SMEM_BYTES}")
    if sx.device.type == "cpu":
        if nt and int(ny.max()) > ny_max:
            raise ValueError(f"sw_forward_strips: ny up to {int(ny.max())} "
                             f"past ny_max={ny_max}")
        return sw_strips_forward_tiles(sx, sy, nx, ny, k_strips=k_strips,
                                       strip_w=strip_w, anchor=anchor,
                                       cfg=cfg)
    return _launch(sx, sy, nx, ny, k_strips, strip_w, anchor, ny_max, cfg)


def _launch(sx, sy, nx, ny, k_strips, strip_w, anchor, ny_max,
            cfg: SWConfig) -> torch.Tensor:
    global launches
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
                     ny.data_ptr(), out.data_ptr(), nt, k_strips, strip_w,
                     sy.shape[1], anchor, ny_max, cfg.match, cfg.mismatch,
                     cfg.gap_open, cfg.gap_extend, stream)
    if err != 0:
        raise RuntimeError(f"sw_strips launch failed: cudaError {err}")
    launches += 1
    return out
