"""Cross-device SW wavefront: one DP matrix split over the mesh, x into K
strips of w rows, strip k on rank k, up to 128 huge pairs on the lanes (the
counterpart of ``genomax.dist.xsharded``).

Execution is skewed: rank k runs U = ``unroll`` diagonals behind rank k-1.
Block b on rank k covers diagonals [(b-k)U, (b-k+1)U) and is one launch of
``csrc/sw_xstrip.cu`` (``strip_block``); the only traffic between ranks is
its halo, the strip's last-row D and Q of each of the block's U steps,
which rank k sends to rank k+1 before the next block (rank 0, and every
rank's block 0, take zeros, the first-column boundary). There are
ceil(n_diags / U) + K - 1 blocks: the pipeline's fill and drain. The blocks
before a strip's fill and after its drain read pad rows of the stream, which
the pack reserves on both sides of the codes and whose decay makes them
inert, as in the JAX package. At the end the ranks take the maximum of their
strips' best scores.

Given the tile's longest y (``ly_max``), a block sweeps only its live rows
(``live_rows``): the rows above the block's last diagonal hold zeros and
keep them, the rows more than ``ly_max`` below its first are done, and a
block whose window is empty launches nothing and hands on a zero halo.
``csrc/sw_xstrip.cu`` argues why the scores are the full sweep's.

Each rank holds only its strip of x (``sx[k*w:(k+1)*w]``, the host-sharded
feed) and the whole stream. ``sw_forward_xsharded_ring`` plays the K ranks'
hand-off in one process, on one device: it is how K > 1 runs on one card.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from genomax_torch import scoring, trace
from genomax_torch.config import SWConfig
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import sw_xstrip_block
from genomax_torch.layout import LANES, PAD_STREAM, PAD_X, SUB_Q
from genomax_torch.pack.bucketing import _reject_pad_codes, _round_up

# Rows a thread of the kernel keeps in registers (its template argument,
# the values the build makes) and the default; rows a CUDA block sweeps at
# once (threads x R).
ROWS_PER_THREAD = (4, 8, 16)
XSTRIP_R = 4
MAX_ROWS = 4096
WARP = 32
# Shared memory a block may take on the card, and the largest block length
# it holds (5 ints a step, beside 6 ints a warp).
SMEM_BYTES = 227 * 1024
MAX_UNROLL = 8192

_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


@dataclasses.dataclass
class SWXPacked:
    """One tile of up to 128 huge pairs, x split into K strips.

    sx : (K*w, 128) int8 codes, row p of lane l holding that pair's
         sx[p-1] (pads 1)
    sy : (NDt, 128) int8 reversed stream; rank k's window for diagonal d
         is rows [A + k*w - d, ... + w), A = ``anchor``, sized past the
         whole skewed sweep so that every window lies in the buffer and the
         windows before a strip's fill and after its drain hold pads only
    """

    sx: np.ndarray
    sy: np.ndarray
    n_devices: int
    strip_w: int
    n_diags: int
    unroll: int
    anchor: int
    nx: np.ndarray
    ny: np.ndarray
    n_valid: int


def pack_sw_xsharded(pairs, n_devices: int, unroll: int = 16) -> SWXPacked:
    """Pack up to 128 pairs for the cross-device wavefront: the arrays of
    genomax.dist.xsharded.pack_sw_xsharded."""
    if not 0 < len(pairs) <= LANES:
        raise ValueError(f"{len(pairs)} pairs: a tile takes 1 to {LANES}")
    if n_devices < 1 or unroll < 1:
        raise ValueError(f"n_devices={n_devices}, unroll={unroll}: want "
                         "both positive")
    nxs = _round_up(max(len(p.sx) for p in pairs) + 2, SUB_Q)
    w = _round_up(-(-nxs // n_devices), SUB_Q)
    nd = max(len(p.sx) + len(p.sy) + 1 for p in pairs)
    # The anchor covers every diagonal a rank visits, the K-1 drain blocks
    # past ceil(nd/U)*U included.
    anchor = _round_up(nd + (n_devices + 2) * unroll, SUB_Q)
    ndt = _round_up(anchor + (n_devices - 1) * (w + unroll) + w, SUB_Q)

    sx = np.full((n_devices * w, LANES), PAD_X, np.int8)
    sy = np.full((ndt, LANES), PAD_STREAM, np.int8)
    nx = np.ones(LANES, np.int32)
    ny = np.ones(LANES, np.int32)
    for lane, p in enumerate(pairs):
        _reject_pad_codes(np.frombuffer(p.sx, np.uint8), "sx")
        _reject_pad_codes(np.frombuffer(p.sy, np.uint8), "sy")
        sx[1: len(p.sx) + 1, lane] = np.frombuffer(p.sx, np.uint8)
        sy[anchor - len(p.sy): anchor, lane] = (
            np.frombuffer(p.sy, np.uint8)[::-1])
        nx[lane] = len(p.sx) + 1
        ny[lane] = len(p.sy) + 1
    return SWXPacked(
        sx=sx, sy=sy, n_devices=n_devices, strip_w=w, n_diags=nd,
        unroll=unroll, anchor=anchor, nx=nx, ny=ny, n_valid=len(pairs),
    )


def n_blocks(n_diags: int, unroll: int, n_strips: int) -> int:
    """Blocks of the skewed sweep: ceil(n_diags / U) + K - 1."""
    return -(-n_diags // unroll) + n_strips - 1


def slab_start(anchor: int, k: int, b: int, *, strip_w: int, unroll: int,
               ndt: int) -> int:
    """First stream row of rank k's slab for block b: anchor + k*w - (b-k)U
    - U, whose w+U rows must lie in the stream's ndt. The JAX kernel's
    dynamic slice clamps a start out of range; this raises instead, so a
    stream too short for the sweep cannot shift a window silently."""
    s = anchor + k * strip_w - (b - k) * unroll - unroll
    if not 0 <= s <= ndt - strip_w - unroll:
        raise ValueError(
            f"rank {k}, block {b}: slab rows [{s}, {s + strip_w + unroll}) "
            f"outside the stream's {ndt} rows (anchor {anchor}, w {strip_w},"
            f" U {unroll})")
    return s


def live_rows(k: int, b: int, *, strip_w: int, unroll: int,
              ly_max: int) -> tuple[int, int]:
    """The live-row window [g_lo, g_hi) of block b on rank k (diagonals
    [(b-k)U, (b-k+1)U)), in the strip's rows: g_lo = max(0, (b-k)U - ly_max
    - k*w), below which every row is done (its cells lie past every y),
    and g_hi = min(w, (b-k+1)U - k*w), above which every row is zero and
    stays zero; both lie in [0, w]. Empty (g_lo >= g_hi) before the
    strip's fill and after its drain."""
    w, U = strip_w, unroll
    return (min(w, max(0, (b - k) * U - ly_max - k * w)),
            max(0, min(w, (b - k + 1) * U - k * w)))


def _threads(rows: int, r: int) -> int:
    """Threads a block at R = r rows a thread: the window's rows (from g_lo
    rounded down to 4, where the kernel starts its sub-strips) in as few
    sub-strips of at most MAX_ROWS as will do, split evenly, rounded up to
    whole warps."""
    per_sub = -(-rows // -(-rows // MAX_ROWS))
    return _round_up(-(-per_sub // r), WARP)


def _moves(ptrs, srow: int, slane: int, threads: int, r: int,
           U: int) -> tuple[bool, bool]:
    """(vector, prefetch) of a launch: the kernel moves a thread's R rows
    of state as int4 where the state is lane-major with a lane stride of
    whole int4 and every array 16-byte aligned (``ptrs``, their data
    pointers), and also copies the next sub-strip's state into shared
    memory while one steps where that copy (6 x threads x R ints) fits
    beside the 5U + 6 a warp. Otherwise the same kernel moves one int at a
    time."""
    vector = (srow == 1 and slane % 4 == 0
              and all(p % 16 == 0 for p in ptrs))
    smem = 4 * (6 * threads * r + 5 * U + 6 * (threads // WARP))
    return vector, vector and smem <= SMEM_BYTES


def strip_block(sxb: torch.Tensor, slab: torch.Tensor, hD: torch.Tensor,
                hQ: torch.Tensor, state, *, w: int, U: int,
                cfg: SWConfig = SWConfig(), out=None, rows=None,
                _rows_per_thread: int = XSTRIP_R):
    """One skewed block of U diagonals of one strip of w rows: (state', bD,
    bQ), the contract of ``kernels.wavefront.sw_xstrip_block``. CUDA tensors
    launch ``csrc/sw_xstrip.cu`` on the current stream; CPU tensors take
    the plain version. There is no other route: a build or launch failure
    raises. ``_rows_per_thread`` picks the kernel's R among those the build
    makes, for its tests and timing.

    sxb: (w, 128) int8; slab: (w+U, 128) int8; hD, hQ: (U, 128) int32;
    state: six (w, 128) int32 (P1, D1, D1s, Q1s, D2s, mx) at one common
    stride pair (contiguous, or lane-major: the transpose of a contiguous
    (128, w)). ``out``: six tensors like state to write the new state into,
    which may be ``state`` itself (the update is then in place); by default
    new ones are allocated with state's strides.

    ``rows=(g_lo, g_hi)`` sweeps only those rows (default: all w): the rows
    outside keep their state, row g_lo takes zeros as its row above when
    g_lo > 0 (hD, hQ when g_lo = 0), and bD, bQ are zeros when g_hi < w
    (this strip's last row when g_hi = w). An empty window launches
    nothing. ``live_rows`` gives the window that leaves the scores exact.
    """
    if w < 1 or not 1 <= U <= MAX_UNROLL:
        raise ValueError(f"strip_block: w={w}, U={U}: want w >= 1 and "
                         f"1 <= U <= {MAX_UNROLL}")
    g_lo, g_hi = (0, w) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= g_lo <= w or not 0 <= g_hi <= w:
        raise ValueError(f"strip_block: rows=({g_lo}, {g_hi}) outside the "
                         f"strip's {w} rows")
    if _rows_per_thread not in ROWS_PER_THREAD:
        raise ValueError(f"strip_block: rows_per_thread={_rows_per_thread}:"
                         f" the build makes {ROWS_PER_THREAD}")
    state = tuple(state)
    if len(state) != 6 or (out is not None and len(tuple(out)) != 6):
        raise ValueError("strip_block: state and out hold six tensors")
    outs = () if out is None else tuple(out)
    tensors = (sxb, slab, hD, hQ) + state + outs
    want = ((w, LANES), (w + U, LANES), (U, LANES), (U, LANES)) + (
        (w, LANES),) * (len(state) + len(outs))
    got = tuple(tuple(t.shape) for t in tensors)
    if got != want:
        raise ValueError(f"strip_block: shapes {got}, want {want}")
    want = (torch.int8, torch.int8) + (torch.int32,) * (len(tensors) - 2)
    got = tuple(t.dtype for t in tensors)
    if got != want:
        raise TypeError(f"strip_block: dtypes {got}, want {want}")
    if any(t.device != sxb.device for t in tensors):
        raise ValueError("strip_block: every input must lie on one device "
                         f"(got {sorted({str(t.device) for t in tensors})})")
    if g_lo >= g_hi:  # nothing live: the state as it is, a zero halo
        bD = torch.zeros((U, LANES), dtype=torch.int32, device=sxb.device)
        if out is None:
            return tuple(t.clone() for t in state), bD, bD.clone()
        for o, i in zip(outs, state):
            if o is not i:
                o.copy_(i)
        return outs, bD, bD.clone()
    if sxb.device.type == "cpu":
        return _plain_window(sxb, slab, hD, hQ, state, outs, w, U, g_lo,
                             g_hi, cfg)
    return _launch(sxb, slab, hD, hQ, state, outs, w, U, g_lo, g_hi,
                   _rows_per_thread, cfg)


def _plain_window(sxb, slab, hD, hQ, state, outs, w, U, g_lo, g_hi,
                  cfg: SWConfig):
    """The plain block on the rows [g_lo, g_hi) of the strip, the rows
    outside left as they are (strip_block's CPU route)."""
    if g_lo > 0:
        hD = hQ = torch.zeros_like(hD)
    new, bD, bQ = sw_xstrip_block(
        sxb[g_lo:g_hi], slab[g_lo: g_hi + U], hD, hQ,
        tuple(t[g_lo:g_hi] for t in state), w=g_hi - g_lo, U=U, cfg=cfg)
    if g_hi < w:
        bD, bQ = torch.zeros_like(bD), torch.zeros_like(bQ)
    if not outs:
        if (g_lo, g_hi) == (0, w):
            return new, bD, bQ
        outs = tuple(t.clone() for t in state)
    else:
        for o, i in zip(outs, state):
            if o is not i:
                o.copy_(i)
    # The new state may hold an input tensor itself (D2s at U = 1), which
    # the first copies into out = state would overwrite.
    for o, n in zip(outs, [n.clone() for n in new]):
        o[g_lo:g_hi] = n
    return outs, bD, bQ


@trace.traced("launch")
def _launch(sxb, slab, hD, hQ, state, outs, w, U, g_lo, g_hi, r,
            cfg: SWConfig):
    if not sxb.is_cuda:
        raise ValueError(f"strip_block: device {sxb.device} is neither cpu "
                         "nor cuda")
    if not all(t.is_contiguous() for t in (sxb, slab, hD, hQ)):
        raise ValueError("strip_block: sxb, slab, hD and hQ must be "
                         "contiguous")
    if not outs:
        outs = tuple(torch.empty_like(t) for t in state)
        if (g_lo, g_hi) != (0, w):  # the rows outside keep their state
            for o, i in zip(outs, state):
                o.copy_(i)
    strides = {t.stride() for t in state + outs}
    if len(strides) != 1:
        raise ValueError(f"strip_block: the state arrays' strides differ: "
                         f"{sorted(strides)}")
    (srow, slane), = strides
    if (srow, slane) not in ((LANES, 1), (1, w)):
        raise ValueError(f"strip_block: state strides ({srow}, {slane}): "
                         f"want (128, 1) or (1, {w})")
    ins = {t.data_ptr() for t in state}
    for o, i in zip(outs, state):
        if o.data_ptr() != i.data_ptr() and o.data_ptr() in ins:
            raise ValueError("strip_block: an output aliases another "
                             "state input")
    launch = _build.load("sw_xstrip", "sw_xstrip_launch", _ARGTYPES)
    bD = torch.empty((U, LANES), dtype=torch.int32, device=sxb.device)
    bQ = torch.empty_like(bD)
    threads = _threads(g_hi - (g_lo & ~3), r)
    vector, prefetch = _moves([t.data_ptr() for t in state + outs], srow,
                              slane, threads, r, U)
    with torch.cuda.device(sxb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(*(t.data_ptr() for t in (sxb, slab, hD, hQ) + state
                       + outs + (bD, bQ)),
                     w, U, g_lo, g_hi, r, threads, int(vector),
                     int(prefetch), srow, slane, cfg.match, cfg.mismatch,
                     cfg.gap_open, cfg.gap_extend, stream)
    if err != 0:
        raise RuntimeError(f"sw_xstrip launch failed: cudaError {err}")
    trace.count("launches.xstrip")
    return outs, bD, bQ


def tile_ly_max(pk: SWXPacked) -> int:
    """The longest y of a packed tile, the ``ly_max`` of ``live_rows``."""
    return int(pk.ny.max()) - 1


def new_state(w: int, device) -> tuple:
    """Six zeroed (w, 128) int32 state arrays, lane-major (the transposes
    of contiguous (128, w) arrays), so that the kernel's loads of one lane's
    rows are contiguous."""
    return tuple(torch.zeros((LANES, w), dtype=torch.int32,
                             device=device).t() for _ in range(6))


def sw_forward_xsharded(sx_strip: torch.Tensor, sy: torch.Tensor, *, mesh,
                        strip_w: int, n_diags: int, ly_max: int,
                        unroll: int = 16, anchor: int | None = None,
                        cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """(128,) int32 scores of one tile of huge pairs, the same on every
    rank, on the mesh's device.

    sx_strip: (w, 128) int8, this rank's strip sx[k*w:(k+1)*w] of the pack;
    sy: (NDt, 128) int8, the whole stream. ``anchor`` must be the pack's
    (SWXPacked.anchor): a reconstruction from the buffer's shape is wrong
    whenever the pack's last round-up moved. Before each block, rank k
    posts the send of its previous block's halo to rank k+1 and the receive
    of rank k-1's in one batch, and waits for both before the launch that
    reads the receive. ``ly_max``, the tile's longest y
    (``tile_ly_max``), windows each block to its ``live_rows``.
    """
    if anchor is None:
        raise ValueError("pass anchor=SWXPacked.anchor")
    k, K, w, U = mesh.rank, mesh.size, strip_w, unroll
    dev = sx_strip.device
    ndt = sy.shape[0]
    state = new_state(w, dev)
    zh = torch.zeros((2, U, LANES), dtype=torch.int32, device=dev)
    mine, theirs = zh, zh  # this rank's last halo, the left neighbour's
    for b in range(n_blocks(n_diags, U, K)):
        if K > 1 and b > 0:
            ops = []
            if k + 1 < K:
                ops.append(dist.P2POp(dist.isend, mine,
                                      mesh.global_rank(k + 1),
                                      group=mesh.group))
            if k > 0:
                theirs = torch.empty_like(zh)
                ops.append(dist.P2POp(dist.irecv, theirs,
                                      mesh.global_rank(k - 1),
                                      group=mesh.group))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        s = slab_start(anchor, k, b, strip_w=w, unroll=U, ndt=ndt)
        state, bD, bQ = strip_block(sx_strip, sy[s: s + w + U], theirs[0],
                                    theirs[1], state, w=w, U=U, cfg=cfg,
                                    out=state,
                                    rows=live_rows(k, b, strip_w=w,
                                                   unroll=U, ly_max=ly_max))
        if K > 1:
            mine = torch.stack((bD, bQ))
    return mesh.all_reduce_max(state[5].amax(dim=0))


def sw_forward_xsharded_ring(sx: torch.Tensor, sy: torch.Tensor, *,
                             n_strips: int, strip_w: int, n_diags: int,
                             unroll: int = 16, anchor: int | None = None,
                             ly_max: int | None = None,
                             cfg: SWConfig = SWConfig(),
                             block=strip_block) -> torch.Tensor:
    """``sw_forward_xsharded`` with its K ranks played in one process on
    ``sx``'s device: sx (K*w, 128) the whole pack. Block b of strip k takes
    strip k-1's halo of block b-1 (zeros for strip 0 and block 0), as the
    send and receive hand it over between ranks. ``block`` is the per-block
    function: ``strip_block`` (the kernel on a CUDA tensor) or
    ``kernels.wavefront.sw_xstrip_block`` (the plain version, which sweeps
    whole strips). With ``ly_max`` each block is windowed to its
    ``live_rows`` (``block`` must then take ``rows=``), as in the forward;
    without it, as the plain version needs, every block sweeps its whole
    strip."""
    if anchor is None:
        raise ValueError("pass anchor=SWXPacked.anchor")
    K, w, U = n_strips, strip_w, unroll
    if sx.shape[0] != K * w:
        raise ValueError(f"sx of {sx.shape[0]} rows: want {K} strips of {w}")
    dev = sx.device
    zero = torch.zeros((U, LANES), dtype=torch.int32, device=dev)
    states = [new_state(w, dev) for _ in range(K)]
    halos = [(zero, zero)] * K  # strip k's halo of the previous block
    for b in range(n_blocks(n_diags, U, K)):
        new = []
        for k in range(K):
            s = slab_start(anchor, k, b, strip_w=w, unroll=U, ndt=sy.shape[0])
            hD, hQ = halos[k - 1] if k else (zero, zero)
            kw = {} if ly_max is None else {"rows": live_rows(
                k, b, strip_w=w, unroll=U, ly_max=ly_max)}
            states[k], bD, bQ = block(sx[k * w: (k + 1) * w],
                                      sy[s: s + w + U], hD, hQ, states[k],
                                      w=w, U=U, cfg=cfg, **kw)
            new.append((bD, bQ))
        halos = new
    return torch.stack([st[5].amax(dim=0) for st in states]).amax(dim=0)


def sw_scores_xsharded(pairs, *, mesh, unroll: int = 16,
                       cfg: SWConfig = SWConfig()) -> np.ndarray:
    """Scores of up to 128 SWPair jobs through the cross-device wavefront
    on ``mesh``: every rank packs the tile, copies its strip of x and the
    stream to its device, and runs ``sw_forward_xsharded``. It refuses a
    substitution matrix."""
    scoring.refuse(cfg, "sw_xstrip")
    pk = pack_sw_xsharded(pairs, mesh.size, unroll=unroll)
    w, k = pk.strip_w, mesh.rank
    sx, sy = trace.to_device(mesh.device, pk.sx[k * w: (k + 1) * w], pk.sy)
    scores = sw_forward_xsharded(sx, sy, mesh=mesh, strip_w=w,
                                 n_diags=pk.n_diags, unroll=pk.unroll,
                                 anchor=pk.anchor, ly_max=tile_ly_max(pk),
                                 cfg=cfg)
    return trace.to_host(scores)[: pk.n_valid]
