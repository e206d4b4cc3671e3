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

from genomax_torch.config import MAX_KERNEL_ROWS, SWConfig
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import sw_conveyor_forward_tiles
from genomax_torch.layout import LANES, PAD_STREAM, PAD_X
from genomax_torch.pack.bucketing import _reject_pad_codes, _round_up

UNROLL = 8  # block length; T is rounded to it so period boundaries are
# block-aligned (the JAX kernel harvests at block starts only)

# Kernel launches made by sw_forward_conveyor (CUDA tensors only).
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
             + [ctypes.c_void_p])


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


def sw_scores_conveyor(pairs, cfg: SWConfig = SWConfig(), idx=None,
                       max_slots: int = 64, *, device) -> np.ndarray:
    """Scores for short SWPair jobs through the conveyor kernel on
    ``device`` (the plain version where it is the CPU)."""
    b = pack_sw_conveyor(pairs, idx, max_slots)
    res = sw_forward_conveyor(
        torch.from_numpy(b.sched).to(device),
        torch.from_numpy(b.sy).to(device),
        nxs=b.nxs, n_slots=b.n_slots, period=b.period, a0=b.a0, cfg=cfg)
    return unpack_conveyor(b, res.cpu().numpy(), len(pairs))


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
    if not 8 <= nxs <= MAX_KERNEL_ROWS or nxs % 8:
        raise ValueError(f"{name}: nxs={nxs} must be a multiple of 8 in "
                         f"[8, {MAX_KERNEL_ROWS}] (one thread a window row, "
                         "1,024 threads a block)")
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
                        cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """(NT * P8, 128) int32 scores, P8 = round_up(P, 8), on the inputs'
    device: row q of a tile's block is queue slot q's score, rows P..P8-1
    are 0 (``sw_forward_pallas_conveyor``'s shape; the JAX kernel leaves
    those rows unwritten).

    sched (NT, SR, 128) and sy (NT, NB, 128) int8 as ``pack_sw_conveyor``
    lays them out. Raises before any sweep or launch on a call outside
    that contract, or past the kernel's 1,024 threads a block (nxs)."""
    _check("sw_forward_conveyor", sched, sy, nxs, n_slots, period, a0)
    if sched.device.type == "cpu":
        return sw_conveyor_forward_tiles(sched, sy, nxs=nxs, n_slots=n_slots,
                                         period=period, a0=a0, unroll=UNROLL,
                                         cfg=cfg)
    return _launch(sched, sy, nxs, n_slots, period, a0, cfg)


def _launch(sched, sy, nxs, n_slots, period, a0, cfg: SWConfig):
    """Launch csrc/sw_conveyor.cu: (NT * P8, 128), slot q in row q of a
    tile's block, the kernel writing rows P..P8-1 as 0."""
    global launches
    launch = _build.load("sw_conveyor", "sw_conveyor_launch", _ARGTYPES)
    if not sched.is_cuda:
        raise ValueError(f"sw_forward_conveyor: device {sched.device} is "
                         "neither cpu nor cuda")
    sched, sy = sched.contiguous(), sy.contiguous()
    nt, p8 = sched.shape[0], _round_up(n_slots, 8)
    out = torch.empty((nt * p8, LANES), dtype=torch.int32,
                      device=sched.device)
    if nt == 0:
        return out
    with torch.cuda.device(sched.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(sched.data_ptr(), sy.data_ptr(), out.data_ptr(), nt,
                     sched.shape[1], sy.shape[1], nxs, n_slots, period, a0,
                     p8, cfg.match, cfg.mismatch, cfg.gap_open,
                     cfg.gap_extend, stream)
    if err != 0:
        raise RuntimeError(f"sw_conveyor launch failed: cudaError {err}")
    launches += 1
    return out
