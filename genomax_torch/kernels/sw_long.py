"""Long-pair Smith-Waterman: the pack, the wrapper of the hand-written CUDA
kernel ``csrc/sw_long.cu`` and the per-tile loop, with the contracts of
``genomax.kernels.sw_long`` (``pack_sw_long``, ``sw_forward_pallas_long``
and ``sw_scores_long``).

The engine sends it the pairs whose x is too long for the lane-tile kernel
(len(x) + 2 past max_device_len, 1,024 rows at the default; or past the
lane tile's 8,192 rows where strips would not take the pair's bucket). The pack cuts x into K strips of
W rows, as the JAX pack does; the kernel walks those K*W rows in sub-strips
of its own height H = threads x R (``geometry``), one after another, the
last row of a sub-strip handing its D and Q over to the next through a
halo. CUDA tensors launch the kernel on the current stream; CPU tensors
take the plain version (``kernels.wavefront.sw_long_forward``, strips of
W). There is no other route: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from genomax_torch import native, scoring, trace
from genomax_torch.config import SWConfig
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import sw_long_forward
from genomax_torch.layout import LANES, PAD_STREAM, PAD_X, SUB_Q
from genomax_torch.pack.bucketing import _full, _reject_pad_codes, _round_up

# Quantum of ny_max and of the layout (genomax.kernels.sw_long.CHUNK).
CHUNK = 256
# Rows per strip of the pack (genomax.kernels.sw_long.STRIP_W).
STRIP_W = 1024
# Rows a thread of the kernel keeps in registers (its template argument,
# the values the build makes), the default, and the most rows a CUDA block
# sweeps at once (threads x R).
ROWS_PER_THREAD = (4, 8, 16)
LONG_R = 8
MAX_ROWS = 4096
WARP = 32

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
             + [ctypes.c_void_p] * 2)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How the kernel sweeps a tile of n_rows = K*W pack rows at R rows a
    thread: ``threads`` a block (whole warps, at most MAX_ROWS / R), so
    sub-strips of ``height`` = threads * R rows, ``n_sub`` of them; and the
    halo, ``halo_entries`` (D, Q) int32 pairs a lane, entry j the last row
    of a sub-strip at column j (1 <= j <= len(y) < ny_max)."""

    threads: int
    height: int
    n_sub: int
    halo_entries: int


def geometry(n_rows: int, ny_max: int, r: int = LONG_R) -> Geometry:
    """The kernel's geometry on a tile of n_rows pack rows whose stream
    holds ny_max rows of y: the rows in as few sub-strips of at most
    MAX_ROWS as will do, split evenly, each rounded up to whole warps of R
    rows a thread."""
    if r not in ROWS_PER_THREAD:
        raise ValueError(f"rows_per_thread={r}: the build makes "
                         f"{ROWS_PER_THREAD}")
    if n_rows < 1 or ny_max < 1:
        raise ValueError(f"n_rows={n_rows}, ny_max={ny_max}: want both "
                         "positive")
    per_sub = -(-n_rows // -(-n_rows // MAX_ROWS))
    threads = _round_up(-(-per_sub // r), WARP)
    height = threads * r
    return Geometry(threads=threads, height=height,
                    n_sub=-(-n_rows // height), halo_entries=ny_max)


def _layout(ny_max: int, w: int):
    """(sweep_chunks, anchor, ndt) of a tile whose longest y needs ny_max
    stream rows, at strip width w: genomax.kernels.sw_long._layout, so the
    pack equals the JAX pack bit for bit. The stream holds y[k] at row
    anchor - 1 - k of ndt rows. The slack around it was sized for the TPU
    kernel's slab copies; the CUDA kernel reads rows anchor - j for
    1 <= j < ny_max only."""
    ny_q = _round_up(max(ny_max, 1), CHUNK)
    sweep = -(-(ny_q + 2 * w + 2 * CHUNK) // CHUNK)
    anchor = _round_up(sweep * CHUNK + CHUNK, SUB_Q)
    ndt = _round_up(anchor + w + 2 * CHUNK, SUB_Q)
    return sweep, anchor, ndt


@dataclasses.dataclass
class SWLongPacked:
    """One tile of up to 128 long pairs, x in K strips of W rows.

    sx : (K*W, 128) int8 codes, row p of lane l holding that pair's
         sx[p-1] (pads 1)
    sy : (NDt, 128) int8 reversed stream, codes at [A-len, A) with A the
         anchor of ``_layout(ny_max, strip_w)``
    nx, ny : (128,) int32 matrix dimensions len + 1 (1 on empty lanes)
    """

    sx: np.ndarray
    sy: np.ndarray
    n_strips: int
    strip_w: int
    n_diags: int
    ny_max: int
    nx: np.ndarray
    ny: np.ndarray
    n_valid: int


def pack_sw_long(pairs, strip_w: int = STRIP_W,
                 codes: np.ndarray | None = None) -> SWLongPacked:
    """Pack up to 128 long pairs for the strip kernel: the arrays of
    genomax.kernels.sw_long.pack_sw_long at the same strip_w. ``codes``
    (``scoring.code_lut``, under a matrix) encodes the residues first, in
    a ``pack.encode`` span, and raises ``scoring.ResidueError`` naming
    the pair of the tile."""
    if not 0 < len(pairs) <= LANES:
        raise ValueError(f"{len(pairs)} pairs: a tile takes 1 to {LANES}")
    w = _round_up(strip_w, SUB_Q)
    k = max(1, -(-(max(len(p.sx) for p in pairs) + 2) // w))
    nd = max(len(p.sx) + len(p.sy) + 1 for p in pairs)
    ny_max = _round_up(max(len(p.sy) for p in pairs) + 1, CHUNK)
    _, anchor, ndt = _layout(ny_max, w)

    sx = _full((k * w, LANES), PAD_X, np.int8)
    sy = _full((ndt, LANES), PAD_STREAM, np.int8)
    nx = np.ones(LANES, np.int32)
    ny = np.ones(LANES, np.int32)
    if codes is not None:
        with trace.span("pack.encode"):
            xs = _encoded([p.sx for p in pairs], codes)
            ys = _encoded([p.sy for p in pairs], codes)
    else:
        xs = [np.frombuffer(p.sx, np.uint8) for p in pairs]
        ys = [np.frombuffer(p.sy, np.uint8) for p in pairs]
    for lane, p in enumerate(pairs):
        if codes is None:
            _reject_pad_codes(xs[lane], "sx")
            _reject_pad_codes(ys[lane], "sy")
        sx[1 : len(p.sx) + 1, lane] = xs[lane]
        sy[anchor - len(p.sy) : anchor, lane] = ys[lane][::-1]
        nx[lane] = len(p.sx) + 1
        ny[lane] = len(p.sy) + 1
    return SWLongPacked(
        sx=sx, sy=sy, n_strips=k, strip_w=w, n_diags=nd, ny_max=ny_max,
        nx=nx, ny=ny, n_valid=len(pairs),
    )


def _encoded(seqs, codes):
    """The codes of each sequence, one native pass over them all."""
    data, off = native._concat_with_offsets(seqs)
    enc = native.encode(data, off, codes, "pair")
    return [enc[a:b] for a, b in zip(off[:-1], off[1:])]


def sw_forward_long(sx: torch.Tensor, sy: torch.Tensor, nx: torch.Tensor,
                    ny: torch.Tensor, *, k_strips: int, strip_w: int,
                    ny_max: int, cfg: SWConfig = SWConfig(),
                    table: torch.Tensor | None = None,
                    _rows_per_thread: int = LONG_R) -> torch.Tensor:
    """(128,) int32 scores of one packed tile of long pairs, on the
    inputs' device, the kernel's sub-strips as ``geometry`` gives them.
    ``_rows_per_thread`` picks the kernel's R among those the build makes,
    for its tests and timing.

    sx: (K*W, 128) int8 x codes; sy: (NDt, 128) int8 reversed stream
    anchored at ``_layout(ny_max, strip_w)``'s anchor, NDt its ndt.
    nx, ny: (128,) int32 matrix dimensions of each pair
    (``SWLongPacked.nx/ny``): a pair sweeps only its own strips and
    diagonals. Under ``cfg.matrix`` the codes are ``scoring``'s and
    ``table`` the code table on the device (``scoring.device_table``;
    copied per call where None).
    """
    if strip_w < SUB_Q or strip_w % SUB_Q:
        raise ValueError(f"sw_forward_long: strip_w={strip_w} must be a "
                         f"positive multiple of {SUB_Q}, as the pack makes "
                         "it")
    if k_strips < 1 or ny_max < 1:
        raise ValueError(f"sw_forward_long: k_strips={k_strips}, "
                         f"ny_max={ny_max} must be positive")
    _, anchor, ndt = _layout(ny_max, strip_w)
    kw = k_strips * strip_w
    tensors = (sx, sy, nx, ny)
    want = ((kw, LANES), (ndt, LANES), (LANES,), (LANES,))
    got = tuple(tuple(t.shape) for t in tensors)
    if got != want:
        raise ValueError(f"sw_forward_long: shapes {got}, want {want}")
    want = (torch.int8, torch.int8, torch.int32, torch.int32)
    got = tuple(t.dtype for t in tensors)
    if got != want:
        raise TypeError(f"sw_forward_long: dtypes {got}, want {want}")
    if any(t.device != sx.device for t in tensors):
        raise ValueError("sw_forward_long: every input must lie on one "
                         f"device (got {[str(t.device) for t in tensors]})")
    geo = geometry(kw, ny_max, _rows_per_thread)
    if sx.device.type == "cpu":
        return sw_long_forward(sx, sy, nx, ny, k_strips, strip_w, anchor, cfg)
    return _launch(sx, sy, nx, ny, kw, anchor, geo, _rows_per_thread, cfg,
                   scoring.device_table(cfg, sx.device, table))


@trace.traced("launch")
def _launch(sx, sy, nx, ny, n_rows, anchor, geo: Geometry, r,
            cfg: SWConfig, table) -> torch.Tensor:
    launch = _build.load("sw_long", "sw_long_launch", _ARGTYPES)
    tensors = (sx, sy, nx, ny)
    if not sx.is_cuda:
        raise ValueError(f"sw_forward_long: device {sx.device} is neither "
                         "cpu nor cuda")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sw_forward_long: every input must be contiguous")
    nh = geo.halo_entries
    # (D, Q) of each sub-strip's last row per column, per pair; the kernel
    # reads only entries it has written, so no initial value.
    halo = torch.empty((LANES, nh, 2), dtype=torch.int32, device=sx.device)
    out = torch.empty((LANES,), dtype=torch.int32, device=sx.device)
    with torch.cuda.device(sx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(*(t.data_ptr() for t in tensors), halo.data_ptr(),
                     out.data_ptr(), n_rows, r, geo.threads, anchor, nh,
                     cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_extend,
                     scoring.table_ptr(table), stream)
    if err != 0:
        raise RuntimeError(f"sw_long launch failed: cudaError {err}")
    trace.count("launches.sw_long")
    return out


def tile_to_torch(b: SWLongPacked, device):
    """(sx, sy, nx, ny) of a packed tile as tensors on ``device``."""
    return trace.to_device(device, b.sx, b.sy, b.nx, b.ny)


def tile_launches(pairs, cfg: SWConfig = SWConfig(), *, device,
                  strip_w: int = STRIP_W, table: torch.Tensor | None = None):
    """Yield (base, n, launch) for each tile of 128 pairs in input order,
    packed on the host and copied to ``device`` as it is reached;
    ``launch()`` is the kernel call alone, returning the tile's (128,)
    scores, the first n of them its pairs'. ``sw_scores_long`` and the
    sweep (``bench/sweep.py``) share it. Under ``cfg.matrix`` each tile's
    residues are encoded in its pack (a ``scoring.ResidueError`` names
    the pair's index in ``pairs``), and ``table`` is as in
    ``sw_forward_long``."""
    device = torch.device(device)
    name = scoring.matrix_of(cfg)
    codes = None if name is None else scoring.code_lut(name)
    table = scoring.device_table(cfg, device, table)
    for base in range(0, len(pairs), LANES):
        with trace.span("pack.fill"):
            try:
                b = pack_sw_long(pairs[base : base + LANES], strip_w, codes)
            except scoring.ResidueError as e:
                raise scoring.ResidueError(
                    f"byte {bytes([e.byte])!r} ({e.byte}) of pair "
                    f"{base + e.index} is not a residue of {name}",
                    base + e.index, e.byte) from None
        t = tile_to_torch(b, device)
        yield base, b.n_valid, functools.partial(
            sw_forward_long, *t, k_strips=b.n_strips, strip_w=b.strip_w,
            ny_max=b.ny_max, cfg=cfg, table=table)


def sw_scores_long(pairs, cfg: SWConfig = SWConfig(), *, device,
                   strip_w: int = STRIP_W,
                   table: torch.Tensor | None = None) -> np.ndarray:
    """Scores of SWPair jobs of any length, in order: tiles of 128 in input
    order, packed on the host, copied to ``device`` and scored there, each
    launched as soon as it is packed, all before the first copy back."""
    pending = [(base, n, launch()) for base, n, launch in tile_launches(
        pairs, cfg, device=device, strip_w=strip_w, table=table)]
    out = np.zeros(len(pairs), np.int32)
    for base, n, r in pending:
        out[base : base + n] = trace.to_host(r)[:n]
    return out
