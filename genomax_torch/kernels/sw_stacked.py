"""Sublane-stacked Smith-Waterman for short pairs: the host re-stack, the
routing predicate and the wrapper of the hand-written CUDA kernel
``csrc/sw_stacked.cu``, with the contracts of
``genomax.kernels.sw_stacked`` (``prep_bucket_stacked``,
``maybe_prep_stacked``, ``run_bucket_stacked``,
``sw_forward_pallas_stacked``).

A packed bucket of h rows re-stacks S tiles deep: bucket tile t*S + q
becomes region q (rows [q*h, (q+1)*h)) of stacked tile t, its stream
copied to the staggered anchor a0 + q*h, so one window of S*h rows hands
every region its own stream at every diagonal. The kernel packs the
regions into warps' rows, R rows a thread (``geometry``). The flat output
row
t*S + q is bucket tile t*S + q, so ``unpack_scores`` needs no change; the
pad tiles that round the tile count up to S sit at the end of that order,
past ``n_valid``. The engine sends a bucket here when
``EngineConfig.sw_stack`` >= 2 and the strips kernel declined it (the
rotor is then bypassed). CUDA tensors launch the kernel on the current
stream; CPU tensors take the plain version
(``kernels.wavefront.sw_stacked_forward_tiles``). There is no other
route: a build or launch failure raises. The TPU kernel's ``unroll`` (its
loop length) has no counterpart.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from genomax_torch import trace
from genomax_torch.config import MAX_STACK_ROWS, SWConfig
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import sw_stacked_forward_tiles
from genomax_torch.layout import LANES, PAD_STREAM
from genomax_torch.pack.bucketing import StreamBand, pad_tiles_to

# Rows a thread of the kernel keeps in registers (its template argument,
# the values the build makes): 16 lets a warp hold a region of h <= 512
# rows, the tallest that stack >= 2 and stack * h <= 1,024 allow.
ROWS_PER_THREAD = (2, 3, 4, 5, 6, 8, 9, 10, 12, 16)
WARP = 32
# A warp step's fixed part (the hand-over's shuffles, the stream shuffle,
# the loop) in cells: the weight of geometry's cost.
STEP_CELLS = 2

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class StackedGeometry:
    """How the kernel sweeps a stack of ``stack`` regions of h rows: R
    rows a thread, a region's rows 1 .. h-1 on ``lanes_per_region``
    consecutive lanes of one warp, ``regions_per_warp`` regions side by
    side in a warp and ``warps_per_stack`` warps a stack."""

    rows_per_thread: int
    lanes_per_region: int
    regions_per_warp: int
    warps_per_stack: int


def geometry(stack: int, h: int, r: int | None = None) -> StackedGeometry:
    """The kernel's geometry for a stack of ``stack`` regions of h rows.
    r None picks, of the R the build makes, the one whose stack costs
    least: W warps of R cells and a fixed part a step, W = ceil(stack /
    floor(32 / ceil((h-1) / R))); the smallest R on a tie. At h = 72 and
    stack 4 that is one warp at R = 9 (4 regions of 8 lanes). Raises
    ValueError for an R the build does not make or at which a region's
    rows pass a warp."""
    if stack < 2 or h < 1 or stack * h > MAX_STACK_ROWS:
        raise ValueError(f"stack={stack} regions of h={h} rows; want "
                         f"stack >= 2, h >= 1 and stack*h <= "
                         f"{MAX_STACK_ROWS}")
    if r is not None and r not in ROWS_PER_THREAD:
        raise ValueError(f"rows_per_thread={r}: the build makes "
                         f"{ROWS_PER_THREAD}")

    def lanes(r):
        return max(1, -(-(h - 1) // r))

    def shape(r):
        per_warp = min(stack, WARP // lanes(r))
        return per_warp, -(-stack // per_warp)

    if r is None:
        r = min((r for r in ROWS_PER_THREAD if lanes(r) <= WARP),
                key=lambda r: (shape(r)[1] * (r + STEP_CELLS), r))
    if lanes(r) > WARP:
        raise ValueError(f"h={h} at R={r}: a region takes {lanes(r)} lanes, "
                         f"past a warp's {WARP}")
    return StackedGeometry(r, lanes(r), *shape(r))


def prep_bucket_stacked(bucket, stack: int):
    """Re-stack a packed SWPacked bucket ``stack`` tiles deep (numpy slice
    copies): ((sx', sy', ndt'), dict(stack, h)), or None when the bucket
    cannot stack (stack < 2, fewer than two tiles, or a y longer than h,
    whose codes would reach the region before).

    The bucket's window for diagonal d is rows [a0 - d, a0 - d + h), a0 =
    NDs - h, with y[k] at row a0 - 1 - k. Region q's window in the stack is
    rows [a0 - d + q*h, a0 - d + (q+1)*h), so copying the top h rows of
    its stream, [a0 - h, a0), to [a0 + (q-1)*h, a0 + q*h) makes that window
    the single-pair window for every q at once. Raises ValueError when
    h > a0 (a hand-built bucket; the q = 0 copy would start below row 0).
    A stream packed as a StreamBand is materialized first, as the JAX prep
    does.
    """
    nt = bucket.sx.shape[0]
    h = bucket.sx.shape[1]
    nds = bucket.sy.shape[1]
    a0 = nds - h
    if stack < 2 or nt < 2:
        return None
    if h > a0:
        raise ValueError(
            f"bucket sublane window h={h} exceeds the stream anchor "
            f"a0={a0}; not a pack_sw_pairs-shaped bucket")
    if int(bucket.ny.max()) - 1 > h:  # stream codes must fit one region
        return None
    if isinstance(bucket.sy, StreamBand):
        # the re-stack slices the host stream: materialize a band first
        # (the engine packs no band where it stacks)
        bucket = dataclasses.replace(bucket, sy=bucket.sy.materialize())
    b = pad_tiles_to(bucket, stack)
    nt2 = b.sx.shape[0] // stack
    sx = np.empty((nt2, stack * h, LANES), b.sx.dtype)
    sy = np.full((nt2, a0 + stack * h, LANES), PAD_STREAM, b.sy.dtype)
    ndt = np.empty((nt2, stack), np.int32)
    for q in range(stack):
        sx[:, q * h: (q + 1) * h, :] = b.sx[q::stack]
        sy[:, a0 + (q - 1) * h: a0 + q * h, :] = b.sy[q::stack][:, a0 - h: a0]
        ndt[:, q] = b.ndiag_tile[q::stack]
    return (sx, sy, ndt.max(axis=1)), dict(stack=stack, h=h)


def maybe_prep_stacked(cfg, bucket):
    """The routing predicate of the stacked kernel: cfg.sw_stack >= 2 and
    a bucket of at most cfg.stack_max_nxs rows. Returns
    ``prep_bucket_stacked``'s result, or None."""
    if cfg.sw_stack < 2:
        return None
    if bucket.sx.shape[1] > cfg.stack_max_nxs:
        return None
    return prep_bucket_stacked(bucket, cfg.sw_stack)


def run_bucket_stacked(bucket, stack: int, cfg: SWConfig = SWConfig(), *,
                       device) -> torch.Tensor:
    """One SWPacked bucket through the stacked kernel on ``device`` (the
    plain version where it is the CPU): the (NT'*stack, 128) scores, not
    synchronized."""
    prep = prep_bucket_stacked(bucket, stack)
    if prep is None:
        raise ValueError(f"bucket of {bucket.sx.shape[0]} tiles and y up to "
                         f"{int(bucket.ny.max()) - 1} bases cannot stack "
                         f"{stack} deep")
    (sx, sy, ndt), statics = prep
    return sw_forward_stacked(*trace.to_device(device, sx, sy, ndt), cfg=cfg,
                              **statics)


def sw_forward_stacked(sx: torch.Tensor, sy: torch.Tensor, ndt: torch.Tensor,
                       *, stack: int, h: int, cfg: SWConfig = SWConfig(),
                       _rows_per_thread: int | None = None) -> torch.Tensor:
    """(NT*stack, 128) int32 scores on the inputs' device, row t*stack + q
    region q of stacked tile t (``sw_forward_pallas_stacked``'s output).

    sx (NT, stack*h, 128) int8, sy (NT, a0 + stack*h, 128) int8 with
    a0 >= h, ndt (NT,) int32 <= a0, as ``prep_bucket_stacked`` lays them
    out. Raises before any sweep or launch on a call outside that
    contract, or past the TPU kernel's limit of 1,024 rows a stack
    (stack*h), which the kernel keeps. ``_rows_per_thread`` picks the
    kernel's R among those the build makes (``geometry``'s choice when
    None), for its tests and timing; one the build does not make, or at
    which a region passes a warp, raises on every device."""
    if stack < 2 or h < 1 or stack * h > MAX_STACK_ROWS:
        raise ValueError(f"sw_forward_stacked: stack={stack} regions of "
                         f"h={h} rows; want stack >= 2, h >= 1 and stack*h "
                         f"<= {MAX_STACK_ROWS} (the rows of a stack)")
    if _rows_per_thread is not None:
        geometry(stack, h, _rows_per_thread)
    if (sx.dtype, sy.dtype, ndt.dtype) != (torch.int8, torch.int8,
                                           torch.int32):
        raise TypeError(f"sw_forward_stacked: dtypes {sx.dtype}, {sy.dtype}, "
                        f"{ndt.dtype}, want int8, int8, int32")
    if not sy.device == ndt.device == sx.device:
        raise ValueError(f"sw_forward_stacked: sx on {sx.device}, sy on "
                         f"{sy.device}, ndt on {ndt.device}; want one device")
    nt = sx.shape[0] if sx.dim() == 3 else -1
    if (nt < 0 or sx.shape[1:] != (stack * h, LANES) or sy.dim() != 3
            or sy.shape[0] != nt or sy.shape[2] != LANES
            or tuple(ndt.shape) != (nt,)):
        raise ValueError(f"sw_forward_stacked: shapes {tuple(sx.shape)}, "
                         f"{tuple(sy.shape)}, {tuple(ndt.shape)}, want "
                         f"(NT, {stack * h}, {LANES}), (NT, NDs, {LANES}), "
                         "(NT,)")
    if sy.shape[1] - stack * h < h:
        raise ValueError(f"sw_forward_stacked: stream of {sy.shape[1]} rows "
                         f"leaves an anchor below h={h}")
    if sx.device.type == "cpu":
        return sw_stacked_forward_tiles(sx, sy, ndt, stack=stack, h=h,
                                        cfg=cfg)
    return _launch(sx, sy, ndt, stack, h, cfg, _rows_per_thread)


@trace.traced("launch")
def _launch(sx, sy, ndt, stack, h, cfg: SWConfig, r=None) -> torch.Tensor:
    """Launch csrc/sw_stacked.cu on checked inputs, at ``geometry``'s R or
    at ``r``."""
    launch = _build.load("sw_stacked", "sw_stacked_launch", _ARGTYPES)
    if not sx.is_cuda:
        raise ValueError(f"sw_forward_stacked: device {sx.device} is neither "
                         "cpu nor cuda")
    sx, sy, ndt = sx.contiguous(), sy.contiguous(), ndt.contiguous()
    nt = sx.shape[0]
    geo = geometry(stack, h, r)
    out = torch.empty((nt * stack, LANES), dtype=torch.int32,
                      device=sx.device)
    if nt == 0:
        return out
    with torch.cuda.device(sx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(sx.data_ptr(), sy.data_ptr(), ndt.data_ptr(),
                     out.data_ptr(), nt, stack, h, sy.shape[1],
                     geo.rows_per_thread, geo.regions_per_warp, cfg.match,
                     cfg.mismatch, cfg.gap_open, cfg.gap_extend, stream)
    if err != 0:
        raise RuntimeError(f"sw_stacked launch failed: cudaError {err}")
    trace.count("launches.stacked")
    return out
