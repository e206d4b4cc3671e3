"""Column-stationary ("rotor") Smith-Waterman for short pairs: the pack,
the routing predicate, the host prep and the wrappers of the hand-written
CUDA kernel ``csrc/sw_rotor.cu``, with the contracts of
``genomax.kernels.sw_rotor`` (``pack_sw_rotor``, ``maybe_prep_rotor``,
``_pick_unroll``, ``prep_bucket_rotor``, ``unpack_rotor``,
``sw_forward_pallas_rotor(_bucket)``).

A bucket's tiles queue up per lane: tile t becomes slot q = t % P of rotor
tile t // P, so each of the 128 lanes of a rotor tile scores P pairs one
after another with period T = round_up(max(nx, ny) + 1, 8); matrix column
c of pair q is swept at steps qT + r + c, T^2 slots a pair where the
lane-tile kernel sweeps NXs * (nx + ny - 1). The engine sends a bucket
here when ``EngineConfig.sw_rotor`` is on, ``sw_stack`` is below 2 and
the strips kernel declined it. CUDA tensors launch the kernel on the
current stream; CPU tensors take the plain version
(``kernels.wavefront.sw_rotor_forward_tiles``). There is no other route:
a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from genomax_torch import scoring, trace
from genomax_torch.config import MAX_ROTOR_PERIOD, SWConfig
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import sw_rotor_forward_tiles
from genomax_torch.layout import LANES, PAD_STREAM, PAD_X
from genomax_torch.pack.bucketing import (StreamBand, _reject_pad_codes,
                                          _round_up)

UNROLLS = (8, 16, 24, 32)
WARP = 32
# The kernel's geometries (its template arguments, the ones the build
# makes): G queues a warp, each a segment of 32 / G lanes, and C columns
# a lane, 1 .. MAX_COLS[G] (periods up to 32 * 5 = 160 at G = 1).
QUEUES_PER_WARP = (1, 2, 4)
MAX_COLS = {1: 5, 2: 10, 4: 10}
GEOMETRIES = tuple((g, c) for g in QUEUES_PER_WARP
                   for c in range(1, MAX_COLS[g] + 1))
# Streaming multiprocessors and warp schedulers of an H100 SXM, the most
# warps a block; a warp step's fixed part (the stream and hand-over
# shuffles, the boundary, the wrap's moves) and the latency of one step
# of a lone warp less its columns, in columns: the weights of geometry's
# cost, fitted on one H100 to the 25,000 x 64bp bucket (T = 72) and to
# 4,096 and 25,000 pairs of 128bp (T = 136), each at 2, 4, 8 and 16 queue
# slots (chip_smoke.py phases 20 and 23 time it).
SMS, SCHEDULERS = 132, 132 * 4
MAX_WARPS_PER_BLOCK = 4
STEP_CELLS, LATENCY_CELLS = 3, 10

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 14
             + [ctypes.c_void_p] * 2)


@dataclasses.dataclass(frozen=True)
class RotorGeometry:
    """How the kernel sweeps a rotor bucket: ``queues_per_warp`` (G)
    queues a warp of 32 / G lanes each, ``cols`` (C) columns a lane, and
    ``warps_per_block`` independent warps a block."""

    queues_per_warp: int
    cols: int
    warps_per_block: int


def geometry(period: int, n_queues: int, queues_per_warp: int | None = None,
             cols: int | None = None) -> RotorGeometry:
    """The kernel's geometry for ``n_queues`` queues (128 a rotor tile) of
    period T. With G and C None it takes, of the G the build makes, the
    one whose step costs least: each G at the fewest columns a lane that
    hold T - 1 (C = ceil((T-1) / (32 / G))), a warp step of C cells and a
    fixed part times the warps each scheduler runs (ceil(n_queues / G)
    warps over 528 schedulers), or where that is less the latency of a
    step, which grows with C; the smallest G on a tie. So a bucket that
    fills the card packs queues into warps, and one that does not runs
    fewer queues a warp. Given G and C, it checks them. Blocks take up to
    four warps, fewer where that leaves an SM idle. Raises ValueError for
    a geometry the build does not make or one whose segment cannot hold
    the period."""
    if not 2 <= period <= MAX_ROTOR_PERIOD or n_queues < 1:
        raise ValueError(f"period={period}, n_queues={n_queues}: want a "
                         f"period in [2, {MAX_ROTOR_PERIOD}] and a queue")
    if (queues_per_warp is None) != (cols is None):
        raise ValueError("give both queues_per_warp and cols, or neither")

    def fewest(g):
        return -(-(period - 1) // (WARP // g))

    def cost(g, c):
        warps = -(-n_queues // g)
        return max(-(-warps // SCHEDULERS) * (c + STEP_CELLS),
                   LATENCY_CELLS + c)

    if queues_per_warp is None:
        queues_per_warp = min(
            (g for g in QUEUES_PER_WARP if fewest(g) <= MAX_COLS[g]),
            key=lambda g: (cost(g, fewest(g)), g))
        cols = fewest(queues_per_warp)
    if (queues_per_warp, cols) not in GEOMETRIES:
        raise ValueError(f"geometry (queues_per_warp={queues_per_warp}, "
                         f"cols={cols}): the build makes {GEOMETRIES}")
    if (WARP // queues_per_warp) * cols < period - 1:
        raise ValueError(f"geometry ({queues_per_warp}, {cols}): "
                         f"{WARP // queues_per_warp} lanes x {cols} columns "
                         f"cannot hold period {period}")
    warps = -(-n_queues // queues_per_warp)
    return RotorGeometry(queues_per_warp, cols,
                         max(1, min(MAX_WARPS_PER_BLOCK, warps // SMS)))


@dataclasses.dataclass
class SWRotorPacked:
    """Rotor-packed SW jobs: tiles of 128 lanes x P queue slots.

    xrev: (NT, NB, 128) int8 - reversed x stream, xrev[A - u] holds the
          code for schedule coordinate u (= sx_q[r-1] at u = qT + r for
          r in [1, nx_q]; PAD_X at r = 0 and pad rows)
    ybuf: (NT, NY, 128) int8 - ybuf[qT + p] = sy_q[p] (PAD_STREAM
          beyond ny_q); row d-1 feeds the wrap row's refresh at step d
    perm: original pair index of (tile, slot, lane), slot-major
    """

    xrev: np.ndarray
    ybuf: np.ndarray
    period: int  # T
    n_slots: int  # P
    anchor: int  # A
    unroll: int
    perm: np.ndarray
    n_valid: int


def pack_sw_rotor(pairs, idx=None, max_slots: int = 64,
                  unroll: int = 8) -> SWRotorPacked:
    """Pack pairs (optionally a subset via idx) for the rotor kernel.
    Requires max(nx, ny) + 1 <= T for every pair; the period is the
    bucket max rounded to lcm(8, unroll) so harvest blocks align."""
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be 8/16/24/32, got {unroll}")
    if idx is None:
        idx = np.arange(len(pairs))
    idx = np.asarray(idx)
    n = len(idx)
    maxlen = max(max(len(pairs[i].sx), len(pairs[i].sy)) for i in idx)
    tq = np.lcm(8, unroll)
    T = _round_up(maxlen + 1, tq)
    nt = max(1, -(-n // (LANES * max_slots)))
    P = -(-n // (LANES * nt))
    max_d = (P + 1) * T + unroll  # last block runs through this step
    A = _round_up(max_d, 8)
    NB = A + T + 8
    NY = _round_up(max_d, 8)

    # sort by length so co-tiled queues have similar periods; stable to
    # keep perm deterministic
    order = np.argsort(
        [max(len(pairs[i].sx), len(pairs[i].sy)) for i in idx],
        kind="stable")
    idx = idx[order]

    xrev = np.full((nt, NB, LANES), PAD_X, np.int8)
    ybuf = np.full((nt, NY, LANES), PAD_STREAM, np.int8)
    for s, gi in enumerate(idx):
        p = pairs[gi]
        t, rem = divmod(s, P * LANES)
        q, lane = divmod(rem, LANES)
        xs = np.frombuffer(p.sx, np.uint8)
        _reject_pad_codes(xs, "sx")
        # xrev[A - (qT + r)] = sx[r-1], r = 1..nx  -> contiguous reversed
        hi = A - q * T
        xrev[t, hi - len(xs): hi, lane] = xs[::-1]
        ys = np.frombuffer(p.sy, np.uint8)
        _reject_pad_codes(ys, "sy")
        v0 = q * T
        ybuf[t, v0: v0 + len(ys), lane] = ys
    return SWRotorPacked(
        xrev=xrev, ybuf=ybuf, period=int(T), n_slots=P, anchor=A,
        unroll=unroll, perm=idx, n_valid=n,
    )


def maybe_prep_rotor(cfg, bucket, n_shards: int = 1):
    """The routing predicate of the rotor kernel: cfg.sw_rotor, a bucket
    with a live tile whose every pair fits one period T = round_up(max(nx,
    ny) + 1, 8) <= cfg.rotor_max_period (both sequences bound T: a
    short-x/long-y bucket declines), and the geometry gate. Returns
    ``prep_bucket_rotor``'s ((xrev, ybuf), statics), or None. ``n_shards``:
    a sharded engine needs the rotor tile count divisible by its devices.

    The gate declines where 3 T^2 > 2 NXs max_diags, so equality routes:
    the JAX code's behaviour, not its comment's (which says <). As in the
    JAX predicate, cfg.sw_stack >= 2 declines every bucket: stacking is an
    explicit opt-in that bypasses the rotor (``kernels.sw_stacked``)."""
    if not cfg.sw_rotor or cfg.sw_stack >= 2:
        return None
    maxlen = max(int(bucket.nx.max()), int(bucket.ny.max())) - 1
    T = _round_up(maxlen + 1, 8)
    if T > cfg.rotor_max_period:
        return None
    if 3 * T * T > 2 * bucket.sx.shape[1] * int(bucket.max_diags):
        return None
    return prep_bucket_rotor(bucket, T, cfg.rotor_max_slots,
                             n_shards=n_shards)


def _pick_unroll(T: int) -> int:
    """Largest supported block length dividing the period (harvest
    blocks must start at period boundaries)."""
    for u in (32, 24, 16, 8):
        if T % u == 0:
            return u
    return 8


def prep_bucket_rotor(bucket, T: int, max_slots: int = 32,
                      unroll: int | None = None, n_shards: int = 1):
    """Re-pack an SWPacked bucket (sublane-fixed x codes + reversed y
    stream) into the rotor layout: ((xrev, ybuf), dict(period, n_slots,
    anchor, unroll)), the arrays and statics of the JAX prep, from a full
    stream or a :class:`~genomax_torch.pack.bucketing.StreamBand` (whose
    band holds the stream's top rows). Bucket tile t becomes
    queue slot q = t % P of rotor tile t // P, so rotor output row
    t_r * P + q is bucket tile t and ``unpack_scores`` needs no change.

    Only live tiles join queues (a pad tile would sweep a full period);
    the queue depth P = ceil(nt / nt_r) is the least that covers them.
    Returns None for a bucket with no live tile, where the JAX prep
    divides by zero."""
    if unroll is None:
        unroll = _pick_unroll(T)
    sx = bucket.sx
    nt, nxs, _ = sx.shape
    nt = min(nt, -(-bucket.n_valid // LANES))
    if nt <= 0:
        return None
    nt_r = -(-(-(-nt // max_slots)) // n_shards) * n_shards
    P = -(-nt // nt_r)
    max_d = (P + 1) * T + unroll
    A = _round_up(max_d, 8)
    NB = A + T + 8
    NY = _round_up(max_d, 8)
    xrev = np.full((nt_r, NB, LANES), PAD_X, np.int8)
    ybuf = np.full((nt_r, NY, LANES), PAD_STREAM, np.int8)
    sy = bucket.sy
    if isinstance(sy, StreamBand):
        stream = sy.band
        sa = stream.shape[1]  # the band's own anchor, A - lo
    else:
        stream = sy
        sa = sy.shape[1] - nxs  # the stream's anchor, NDs - NXs
    W = min(nxs, T) - 1  # x code rows 1..W of the bucket tile
    H = min(T, sa)
    for t in range(nt):
        t_r, q = divmod(t, P)
        # xrev[A - u] = x code at u = qT + r, r in [1, W]
        xrev[t_r, A - q * T - W: A - q * T, :] = sx[t, 1: W + 1, :][::-1]
        # ybuf[qT + p] = sy[p]: the bucket stream holds sy[k] at row
        # sa - 1 - k, so the flipped top-H slice is exactly sy[0..H)
        ybuf[t_r, q * T: q * T + H, :] = stream[t, sa - H: sa, :][::-1]
    statics = dict(period=T, n_slots=P, anchor=A, unroll=unroll)
    return (xrev, ybuf), statics


def unpack_rotor(b: SWRotorPacked, res, n_total: int) -> np.ndarray:
    """Scatter kernel output ((NT * P8, 128)) back to original pair
    order."""
    res = np.asarray(res)
    p8 = _round_up(b.n_slots, 8)
    out = np.zeros(n_total, np.int32)
    s = np.arange(len(b.perm))
    t, rem = np.divmod(s, b.n_slots * LANES)
    q, lane = np.divmod(rem, LANES)
    out[b.perm] = res[t * p8 + q, lane]
    return out


def sw_scores_rotor(pairs, cfg: SWConfig = SWConfig(), idx=None,
                    max_slots: int = 64, unroll: int = 8, *,
                    device) -> np.ndarray:
    """Scores for short SWPair jobs through the rotor kernel on
    ``device`` (the plain version where it is the CPU)."""
    b = pack_sw_rotor(pairs, idx, max_slots, unroll)
    res = sw_forward_rotor(
        *trace.to_device(device, b.xrev, b.ybuf),
        period=b.period, n_slots=b.n_slots, anchor=b.anchor,
        unroll=b.unroll, cfg=cfg)
    return unpack_rotor(b, trace.to_host(res), len(pairs))


def _check(name, xrev, ybuf, period, n_slots, anchor, unroll):
    """The launch contract, for the kernel and the plain version alike."""
    if unroll not in UNROLLS or period % unroll:
        raise ValueError(
            f"{name}: period={period} must be a multiple of unroll="
            f"{unroll} in {UNROLLS}: the harvest falls at block starts "
            "only then (the JAX kernel scores 0 silently otherwise)")
    if not 8 <= period <= MAX_ROTOR_PERIOD or period % 8 or n_slots < 1:
        raise ValueError(f"{name}: want period={period} a multiple of 8 in "
                         f"[8, {MAX_ROTOR_PERIOD}] and n_slots={n_slots} "
                         ">= 1")
    if (xrev.dtype, ybuf.dtype) != (torch.int8, torch.int8):
        raise TypeError(f"{name}: dtypes {xrev.dtype}, {ybuf.dtype}, want "
                        "int8")
    if ybuf.device != xrev.device:
        raise ValueError(f"{name}: xrev on {xrev.device}, ybuf on "
                         f"{ybuf.device}; want one device")
    nt = xrev.shape[0] if xrev.dim() == 3 else -1
    if (nt < 0 or ybuf.dim() != 3 or ybuf.shape[0] != nt
            or xrev.shape[2] != LANES or ybuf.shape[2] != LANES):
        raise ValueError(f"{name}: shapes {tuple(xrev.shape)}, "
                         f"{tuple(ybuf.shape)}, want (NT, NB, {LANES}) and "
                         f"(NT, NY, {LANES})")
    max_d = (n_slots + 1) * period + unroll
    if not (max_d <= anchor and anchor + period <= xrev.shape[1]
            and max_d <= ybuf.shape[1]):
        raise ValueError(f"{name}: want (P+1)T + unroll = {max_d} <= "
                         f"anchor={anchor}, anchor + T <= NB="
                         f"{xrev.shape[1]} and {max_d} <= NY="
                         f"{ybuf.shape[1]}")


def sw_forward_rotor(xrev: torch.Tensor, ybuf: torch.Tensor, *, period: int,
                     n_slots: int, anchor: int, unroll: int = 8,
                     cfg: SWConfig = SWConfig(),
                     table: torch.Tensor | None = None,
                     _geometry: tuple[int, int] | None = None
                     ) -> torch.Tensor:
    """(NT * P8, 128) int32 scores, P8 = round_up(P, 8), on the inputs'
    device: row q of a tile's block is queue slot q's score, rows P..P8-1
    are 0 (``sw_forward_pallas_rotor``'s shape).

    xrev (NT, NB, 128) and ybuf (NT, NY, 128) int8 as ``pack_sw_rotor``
    and ``prep_bucket_rotor`` lay them out. ``unroll`` sets only the
    buffers' slack (NB, NY) and must divide ``period``. Under
    ``cfg.matrix`` the codes are ``scoring``'s and ``table`` the code
    table on the device (``scoring.device_table``; copied per call where
    None). ``_geometry``
    picks the kernel's (G, C) among those the build makes (``geometry``'s
    choice when None), for its tests and timing; one the build does not
    make, or that cannot hold the period, raises on every device."""
    _check("sw_forward_rotor", xrev, ybuf, period, n_slots, anchor, unroll)
    _check_geometry(period, _geometry)
    if xrev.device.type == "cpu":
        return sw_rotor_forward_tiles(xrev, ybuf, period=period,
                                      n_slots=n_slots, anchor=anchor,
                                      unroll=unroll, cfg=cfg)
    p8 = _round_up(n_slots, 8)
    return _launch(xrev, ybuf, period, n_slots, anchor, p8, cfg,
                   "sw_forward_rotor", _geometry,
                   scoring.device_table(cfg, xrev.device, table)
                   ).reshape(-1, LANES)


def sw_forward_rotor_bucket(xrev: torch.Tensor, ybuf: torch.Tensor, *,
                            period: int, n_slots: int, anchor: int,
                            unroll: int = 8,
                            cfg: SWConfig = SWConfig(),
                            table: torch.Tensor | None = None,
                            _geometry: tuple[int, int] | None = None
                            ) -> torch.Tensor:
    """The engine's wrapper: (NT * P, 128) int32 scores in bucket tile
    order (``prep_bucket_rotor``): the P8 -> P row compaction of
    ``sw_forward_pallas_rotor_bucket``. Rows past the bucket's live tiles
    are pad queues that ``unpack_scores`` never reads. On the card the
    kernel writes this order directly. ``table`` and ``_geometry`` as in
    ``sw_forward_rotor``."""
    _check("sw_forward_rotor_bucket", xrev, ybuf, period, n_slots, anchor,
           unroll)
    _check_geometry(period, _geometry)
    if xrev.device.type == "cpu":
        out = sw_rotor_forward_tiles(xrev, ybuf, period=period,
                                     n_slots=n_slots, anchor=anchor,
                                     unroll=unroll, cfg=cfg)
        p8 = _round_up(n_slots, 8)
        return out.view(-1, p8, LANES)[:, :n_slots].reshape(-1, LANES)
    return _launch(xrev, ybuf, period, n_slots, anchor, n_slots, cfg,
                   "sw_forward_rotor_bucket", _geometry,
                   scoring.device_table(cfg, xrev.device, table)
                   ).reshape(-1, LANES)


def _check_geometry(period, geo):
    """A (G, C) hook the build makes and whose segment holds the period;
    raises ValueError otherwise."""
    if geo is not None:
        geometry(period, 1, *geo)


@trace.traced("launch")
def _launch(xrev, ybuf, period, n_slots, anchor, out_rows, cfg: SWConfig,
            name, geo=None, table=None) -> torch.Tensor:
    """Launch csrc/sw_rotor.cu at ``geometry``'s choice, or at (G, C) =
    ``geo``: out_rows rows a tile, slot q in row q and rows n_slots..
    zero."""
    launch = _build.load("sw_rotor", "sw_rotor_launch", _ARGTYPES)
    if not xrev.is_cuda:
        raise ValueError(f"{name}: device {xrev.device} is neither cpu nor "
                         "cuda")
    xrev, ybuf = xrev.contiguous(), ybuf.contiguous()
    nt = xrev.shape[0]
    g = geometry(period, max(1, nt * LANES), *(geo or ()))
    alloc = torch.zeros if out_rows > n_slots else torch.empty
    out = alloc((nt, out_rows, LANES), dtype=torch.int32, device=xrev.device)
    if nt == 0:
        return out
    with torch.cuda.device(xrev.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(xrev.data_ptr(), ybuf.data_ptr(), out.data_ptr(), nt,
                     xrev.shape[1], ybuf.shape[1], period, n_slots, anchor,
                     out_rows, g.queues_per_warp, g.cols, g.warps_per_block,
                     cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_extend,
                     scoring.table_ptr(table), stream)
    if err != 0:
        raise RuntimeError(f"sw_rotor launch failed: cudaError {err}")
    trace.count("launches.rotor")
    return out
