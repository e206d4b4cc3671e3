"""Conveyor-packed Smith-Waterman for short pairs: the pack, the unpack,
the library entry and the wrapper of the hand-written CUDA kernel
``csrc/sw_conveyor.cu``, with the contracts of
``genomax.kernels.sw_conveyor`` (``pack_sw_conveyor``, ``unpack_conveyor``,
``sw_scores_conveyor``, ``sw_forward_pallas_conveyor``).

Each lane of a tile chains a queue of P pairs through one window of nxs
rows with period T = round_up(max(nxs, ny_max + 1), UNROLL): pair q's cell
(row r, column j) falls on step d = qT + r + j, so exactly one row
switches pairs a step, r* = (d-1) mod T. ``sched`` row d holds the x code
row r* adopts at step d; the stream position a0 - m holds the y code of
coordinate m, so the window of step d is sy[a0 - d: a0 - d + nxs] for
every pair of the queue. No engine route reaches the conveyor (the JAX
engine has none either); ``sw_scores_conveyor`` is its entry. CUDA tensors
launch the kernel on the current stream; CPU tensors take the plain
version (``kernels.wavefront.sw_conveyor_forward_tiles``). There is no
other route: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from genomax_torch import trace
from genomax_torch.config import MAX_CONVEYOR_ROWS, SWConfig
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import sw_conveyor_forward_tiles
from genomax_torch.layout import LANES, PAD_STREAM, PAD_X
from genomax_torch.pack.bucketing import _reject_pad_codes, _round_up

UNROLL = 8  # block length; T is rounded to it so period boundaries are
# block-aligned (the JAX kernel harvests at block starts only)

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 16
             + [ctypes.c_void_p])

WARP = 32
# The kernel's geometries (its template arguments, the ones the build
# makes), (G, R, W): the warp form, W = 1, G queues a warp, each a segment
# of 32 / G lanes, and R window rows a lane, 1 .. MAX_ROWS[G] (windows up
# to 512 rows at G = 1); the block form, G = 1, a queue a block of W
# warps of BLOCK_ROWS rows a lane, as many as a window past 512 rows
# takes: 3 or 4 (windows up to 1,024 rows).
QUEUES_PER_WARP = (1, 2, 4)
MAX_ROWS = {1: 16, 2: 10, 4: 10}
BLOCK_ROWS, MAX_WARPS = 8, 4
MIN_BLOCK_WARPS = -(-(WARP * MAX_ROWS[1] + 1) // (WARP * BLOCK_ROWS))
GEOMETRIES = (tuple((g, r, 1) for g in QUEUES_PER_WARP
                    for r in range(1, MAX_ROWS[g] + 1))
              + tuple((1, BLOCK_ROWS, w)
                      for w in range(MIN_BLOCK_WARPS, MAX_WARPS + 1)))
# Streaming multiprocessors and warp schedulers of an H100 SXM. The
# weights of geometry's cost, in cycles: a warp step takes WARP_ROW a row
# and WARP_STEP of its scheduler's instruction slots (the cells, then the
# stream and hand-over shuffles, lane 0's boundary and the switch's
# moves), and a lone warp's step LONE_ROW a row and LONE_STEP. Fitted on
# one H100 to the times of G = 1, 2, 4 at their fewest rows on the 25,000
# x 64bp pack (nxs 72) at 4, 16 and 64 slots (6,272, 1,664 and 512
# queues), which chip_smoke.py phase 29 takes on every run. No other
# window height was timed: there the choice is the model's alone.
SMS, SCHEDULERS = 132, 132 * 4
WARP_ROW, WARP_STEP, LONE_ROW, LONE_STEP = 17, 14, 22, 30


@dataclasses.dataclass
class SWConveyorPacked:
    """Conveyor-packed SW jobs: tiles of 128 lanes x P queue slots.

    sched: (NT, SR, 128) int8 - row d holds the x code that the
           switching row r* = (d-1) mod T adopts at step d
    sy   : (NT, NB, 128) int8 - stream buffer, position A0 - m holds
           the code for coordinate m
    perm : original pair index of (tile, slot, lane), slot-major
    """

    sched: np.ndarray
    sy: np.ndarray
    nxs: int
    n_slots: int  # P
    period: int  # T
    a0: int
    perm: np.ndarray
    n_valid: int


def pack_sw_conveyor(pairs, idx=None, max_slots: int = 64) -> SWConveyorPacked:
    """Pack the given pairs (optionally a subset via idx) for the
    conveyor kernel: nxs = round_up(max len(sx) + 2, 8), T as above, tiles
    of 128 * P pairs, sorted (stably) by len(sy) so co-tiled queues have
    similar periods."""
    if idx is None:
        idx = np.arange(len(pairs))
    idx = np.asarray(idx)
    n = len(idx)
    nx_max = max(len(pairs[i].sx) for i in idx)
    ny_max = max(len(pairs[i].sy) for i in idx)
    nxs = _round_up(nx_max + 2, 8)
    T = _round_up(max(nxs, ny_max + 1), UNROLL)
    nt = max(1, -(-n // (LANES * max_slots)))
    P = -(-n // (LANES * nt))
    dmax = (P + 1) * T + UNROLL
    SR = dmax + 2 * UNROLL + 8
    A0 = _round_up(dmax + UNROLL, 8)
    NB = A0 + nxs

    order = np.argsort([len(pairs[i].sy) for i in idx], kind="stable")
    idx = idx[order]

    sched = np.full((nt, SR, LANES), PAD_X, np.int8)
    sy = np.full((nt, NB, LANES), PAD_STREAM, np.int8)
    for r, gi in enumerate(idx):
        p = pairs[gi]
        t, rem = divmod(r, P * LANES)
        q, lane = divmod(rem, LANES)
        ys = np.frombuffer(p.sy, np.uint8)
        _reject_pad_codes(ys, "sy")
        # buf[A0 - (q*T + j)] = sy[j-1], j = 1..ny
        base = A0 - q * T
        sy[t, base - len(ys): base, lane] = ys[::-1]
        xs = np.frombuffer(p.sx, np.uint8)
        _reject_pad_codes(xs, "sx")
        # sched[d = q*T + r' + 1] = sx[r'-1] for r' in [1, len(sx)]
        d0 = q * T + 2
        sched[t, d0: d0 + len(xs), lane] = xs
    return SWConveyorPacked(
        sched=sched, sy=sy, nxs=nxs, n_slots=P, period=T, a0=A0,
        perm=idx, n_valid=n,
    )


def unpack_conveyor(b: SWConveyorPacked, res, n_total: int) -> np.ndarray:
    """Scatter kernel output ((NT * P8, 128)) back to original pair
    order; pairs left out of the pack score 0."""
    res = np.asarray(res)
    p8 = _round_up(b.n_slots, 8)
    out = np.zeros(n_total, np.int32)
    r = np.arange(len(b.perm))
    t, rem = np.divmod(r, b.n_slots * LANES)
    q, lane = np.divmod(rem, LANES)
    out[b.perm] = res[t * p8 + q, lane]
    return out


def geometries_holding(nxs: int) -> list[tuple[int, int, int]]:
    """The (G, R, W) of ``GEOMETRIES`` whose lanes hold a window of nxs
    rows: those ``geometry`` takes for it."""
    return [g for g in GEOMETRIES if (WARP // g[0]) * g[1] * g[2] >= nxs]


@dataclasses.dataclass(frozen=True)
class ConveyorGeometry:
    """How the kernel sweeps the queues: ``queues_per_warp`` (G) queues a
    warp of 32 / G lanes each, ``rows`` (R) window rows a lane,
    ``warps_per_queue`` (W; above 1 a queue is a block of W warps) and
    ``warps_per_block`` (the block form's W, else independent warps)."""

    queues_per_warp: int
    rows: int
    warps_per_queue: int
    warps_per_block: int


def geometry(nxs: int, n_queues: int, queues_per_warp: int | None = None,
             rows: int | None = None,
             warps_per_queue: int | None = None) -> ConveyorGeometry:
    """The kernel's geometry for ``n_queues`` queues (128 a tile) through a
    window of ``nxs`` rows. With G, R and W None it takes, of the warp
    forms the build makes, the one whose step costs least: each G at the
    fewest rows a lane that hold the window (R = ceil(nxs / (32 / G))), a
    warp step of R cells and a fixed part times the warps each scheduler
    runs (ceil(n_queues / G) warps over 528 schedulers), or where that is
    less a lone warp's step, which grows with R faster; the smallest G on
    a tie. So many queues pack into warps of many rows a lane, and a few
    deep ones spread over the schedulers at few rows a lane. A window
    past one warp's 32 * 16 rows takes the block form: R = 8 and the
    fewest warps that hold it. Given G, R and W, it checks them. A
    warp-form block takes as few warps (at most four) as put one block on
    each SM where the warps allow it, so that no SM runs two blocks while
    another runs none. Raises ValueError for a geometry the build does not
    make or one whose lanes cannot hold the window."""
    if not 1 <= nxs <= MAX_CONVEYOR_ROWS or n_queues < 1:
        raise ValueError(f"nxs={nxs}, n_queues={n_queues}: want a window "
                         f"in [1, {MAX_CONVEYOR_ROWS}] rows and a queue")
    given = (queues_per_warp, rows, warps_per_queue)
    if None in given and given != (None, None, None):
        raise ValueError("give queues_per_warp, rows and warps_per_queue, "
                         "or none of them")

    def cost(g, r):
        warps = -(-n_queues // g)
        return max(-(-warps // SCHEDULERS) * (WARP_ROW * r + WARP_STEP),
                   LONE_ROW * r + LONE_STEP)

    if queues_per_warp is None:
        fits = [(g, -(-nxs // (WARP // g))) for g in QUEUES_PER_WARP]
        fits = [f for f in fits if f[1] <= MAX_ROWS[f[0]]]
        if fits:
            queues_per_warp, rows = min(fits,
                                        key=lambda f: (cost(*f), f[0]))
            warps_per_queue = 1
        else:  # past one warp: the block form
            queues_per_warp, rows = 1, BLOCK_ROWS
            warps_per_queue = -(-nxs // (WARP * BLOCK_ROWS))
    geo = (queues_per_warp, rows, warps_per_queue)
    if geo not in GEOMETRIES:
        raise ValueError(f"geometry (queues_per_warp, rows, "
                         f"warps_per_queue) = {geo}: the build makes "
                         f"{GEOMETRIES}")
    if geo not in geometries_holding(nxs):
        raise ValueError(f"geometry {geo}: {WARP // queues_per_warp} lanes "
                         f"x {rows} rows x {warps_per_queue} warps cannot "
                         f"hold a window of nxs={nxs} rows")
    if warps_per_queue > 1:
        wpb = warps_per_queue
    else:  # as few warps a block as put a block on each SM, at most 4
        warps = -(-n_queues // queues_per_warp)
        wpb = max(1, min(MAX_WARPS, -(-warps // SMS)))
    return ConveyorGeometry(queues_per_warp, rows, warps_per_queue, wpb)


def sw_scores_conveyor(pairs, cfg: SWConfig = SWConfig(), idx=None,
                       max_slots: int = 64, *, device) -> np.ndarray:
    """Scores for short SWPair jobs through the conveyor kernel on
    ``device`` (the plain version where it is the CPU)."""
    b = pack_sw_conveyor(pairs, idx, max_slots)
    res = sw_forward_conveyor(
        *trace.to_device(device, b.sched, b.sy),
        nxs=b.nxs, n_slots=b.n_slots, period=b.period, a0=b.a0, cfg=cfg)
    return unpack_conveyor(b, trace.to_host(res), len(pairs))


def _check(name, sched, sy, nxs, n_slots, period, a0):
    """The launch contract, for the kernel and the plain version alike."""
    if (sched.dtype, sy.dtype) != (torch.int8, torch.int8):
        raise TypeError(f"{name}: dtypes {sched.dtype}, {sy.dtype}, want "
                        "int8")
    if sy.device != sched.device:
        raise ValueError(f"{name}: sched on {sched.device}, sy on "
                         f"{sy.device}; want one device")
    nt = sched.shape[0] if sched.dim() == 3 else -1
    if (nt < 0 or sy.dim() != 3 or sy.shape[0] != nt
            or sched.shape[2] != LANES or sy.shape[2] != LANES):
        raise ValueError(f"{name}: shapes {tuple(sched.shape)}, "
                         f"{tuple(sy.shape)}, want (NT, SR, {LANES}) and "
                         f"(NT, NB, {LANES})")
    if not 8 <= nxs <= MAX_CONVEYOR_ROWS or nxs % 8:
        raise ValueError(f"{name}: nxs={nxs} must be a multiple of 8 in "
                         f"[8, {MAX_CONVEYOR_ROWS}] (the kernel's tallest "
                         "window: a block of 4 warps x 32 lanes x 8 rows)")
    if n_slots < 1 or period % UNROLL or period < nxs:
        raise ValueError(f"{name}: want n_slots={n_slots} >= 1 and "
                         f"period={period} a multiple of {UNROLL} and >= "
                         f"nxs={nxs}: the harvest falls at period "
                         "boundaries and row T-1 must be pinned or absent")
    steps = (n_slots + 1) * period + UNROLL
    if not (a0 >= steps - 1 and a0 + nxs <= sy.shape[1]
            and steps <= sched.shape[1]):
        raise ValueError(f"{name}: the sweep of {steps} steps wants a0="
                         f"{a0} >= {steps - 1}, a0 + nxs <= NB="
                         f"{sy.shape[1]} and SR={sched.shape[1]} >= {steps}")


def sw_forward_conveyor(sched: torch.Tensor, sy: torch.Tensor, *, nxs: int,
                        n_slots: int, period: int, a0: int,
                        cfg: SWConfig = SWConfig(),
                        _geometry: tuple[int, int, int] | None = None
                        ) -> torch.Tensor:
    """(NT * P8, 128) int32 scores, P8 = round_up(P, 8), on the inputs'
    device: row q of a tile's block is queue slot q's score, rows P..P8-1
    are 0 (``sw_forward_pallas_conveyor``'s shape; the JAX kernel leaves
    those rows unwritten).

    sched (NT, SR, 128) and sy (NT, NB, 128) int8 as ``pack_sw_conveyor``
    lays them out. Raises before any sweep or launch on a call outside
    that contract, or past the kernel's 1,024 window rows (nxs).
    ``_geometry`` picks the kernel's (G, R, W) among those the build makes
    (``geometry``'s choice when None), for its tests and timing; one the
    build does not make, or that cannot hold the window, raises on every
    device."""
    _check("sw_forward_conveyor", sched, sy, nxs, n_slots, period, a0)
    if _geometry is not None:
        geometry(nxs, 1, *_geometry)
    if sched.device.type == "cpu":
        return sw_conveyor_forward_tiles(sched, sy, nxs=nxs, n_slots=n_slots,
                                         period=period, a0=a0, unroll=UNROLL,
                                         cfg=cfg)
    return _launch(sched, sy, nxs, n_slots, period, a0, cfg, _geometry)


@trace.traced("launch")
def _launch(sched, sy, nxs, n_slots, period, a0, cfg: SWConfig, geo=None):
    """Launch csrc/sw_conveyor.cu at ``geometry``'s choice, or at (G, R, W)
    = ``geo``: (NT * P8, 128), slot q in row q of a tile's block, the
    kernel writing rows P..P8-1 as 0."""
    launch = _build.load("sw_conveyor", "sw_conveyor_launch", _ARGTYPES)
    if not sched.is_cuda:
        raise ValueError(f"sw_forward_conveyor: device {sched.device} is "
                         "neither cpu nor cuda")
    sched, sy = sched.contiguous(), sy.contiguous()
    nt, p8 = sched.shape[0], _round_up(n_slots, 8)
    g = geometry(nxs, max(1, nt * LANES), *(geo or ()))
    out = torch.empty((nt * p8, LANES), dtype=torch.int32,
                      device=sched.device)
    if nt == 0:
        return out
    with torch.cuda.device(sched.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(sched.data_ptr(), sy.data_ptr(), out.data_ptr(), nt,
                     sched.shape[1], sy.shape[1], nxs, n_slots, period, a0,
                     p8, g.queues_per_warp, g.rows, g.warps_per_queue,
                     g.warps_per_block, cfg.match, cfg.mismatch,
                     cfg.gap_open, cfg.gap_extend, stream)
    if err != 0:
        raise RuntimeError(f"sw_conveyor launch failed: cudaError {err}")
    trace.count("launches.conveyor")
    return out
