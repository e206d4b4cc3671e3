"""Long-read PairHMM: the pack, the wrapper of the hand-written CUDA kernel
``csrc/pairhmm_long.cu`` and the per-tile driver, with the contracts of
``genomax.kernels.pairhmm_long`` (``pack_pairhmm_long``,
``pairhmm_forward_pallas_long`` and ``pairhmm_long``).

The engine sends it the jobs whose reads are too long for the lane-tile
kernel (``csrc/pairhmm_tile.cu``: reads past max_device_len // 2 - 2
bases, 510 at the default, or past its tallest bucket's 8,190). The kernel sweeps a
job's strips at once, one warp a strip with R rows a thread
(``long_geometry``). CUDA tensors launch the kernel on the current stream;
CPU tensors take the plain version (``kernels.wavefront.phmm_long_forward``).
There is no other route: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from genomax_torch import trace
from genomax_torch.io.phred import phred_to_error_prob
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import LONG_CHUNK, phmm_long_forward
from genomax_torch.layout import LANES, PAD_STREAM, PAD_X, SUB_Q
from genomax_torch.pack.bucketing import (_full, _reject_bad_read,
                                          _reject_pad_codes, _round_up)

# Rows per strip (genomax.kernels.pairhmm_long.STRIP_W): one warp of the
# kernel a strip, at most 32 threads x 32 rows.
STRIP_W = 256
# Diagonals per rescale block, the default of the JAX engine's call.
UNROLL = 16
# Rows a thread of the kernel keeps in registers (its template argument,
# the values the build makes), the warp width and the most strips a block
# sweeps at once.
LONG_R = (1, 2, 4, 8, 16, 32)
WARP = 32
LONG_WARPS = 8

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class LongGeometry:
    """How the kernel sweeps a tile of K strips of W rows: ``rows_per_thread``
    (R) rows a thread, ``threads_per_strip`` = ceil(W / R) <= 32 threads of
    the strip's warp, ``warps`` = min(K, 8) strips at once, and
    ``halo_rows`` diagonals of the global seam between rounds of strips (0
    when one round holds every strip)."""

    rows_per_thread: int
    threads_per_strip: int
    warps: int
    halo_rows: int


def long_geometry(k_strips: int, strip_w: int, ny_max: int,
                  r: int | None = None) -> LongGeometry:
    """The kernel's geometry on a tile of k_strips strips of strip_w rows
    whose haplotypes need ny_max stream rows, at R rows a thread (by
    default the fewest with which one warp holds a strip). Raises
    ValueError for an R the build does not make or a strip a warp cannot
    hold."""
    if not 1 <= strip_w <= WARP * LONG_R[-1]:
        raise ValueError(f"strip_w={strip_w}: one warp a strip, at most "
                         f"{WARP} threads x {LONG_R[-1]} rows")
    if r is None:
        r = next(r for r in LONG_R if -(-strip_w // r) <= WARP)
    if r not in LONG_R:
        raise ValueError(f"rows_per_thread={r}: the build makes {LONG_R}")
    ts = -(-strip_w // r)
    if ts > WARP:
        raise ValueError(f"rows_per_thread={r}: strip_w={strip_w} needs "
                         f"{ts} threads a strip, more than a warp")
    warps = min(k_strips, LONG_WARPS)
    halo = k_strips * strip_w + ny_max + 2 * WARP if k_strips > warps else 0
    return LongGeometry(rows_per_thread=r, threads_per_strip=ts, warps=warps,
                        halo_rows=halo)


def long_layout(ny_max: int, w: int):
    """(sweep_chunks, anchor, ndt) of a tile whose haplotypes need ny_max
    stream rows (genomax.kernels.sw_long._layout, the one place pack and
    kernel take the geometry from). Per strip k the sweep covers
    diagonals [floor(kW/C)*C, + sweep*C); the anchor keeps every stream
    window row >= 0, and ndt covers the highest."""
    ny_q = _round_up(max(ny_max, 1), LONG_CHUNK)
    sweep = -(-(ny_q + 2 * w + 2 * LONG_CHUNK) // LONG_CHUNK)
    anchor = _round_up(sweep * LONG_CHUNK + LONG_CHUNK, SUB_Q)
    ndt = _round_up(anchor + w + 2 * LONG_CHUNK, SUB_Q)
    return sweep, anchor, ndt


def pack_pairhmm_long(jobs, phred_offset: float = 33.0,
                      strip_w: int = STRIP_W):
    """Up to 128 (PairHMMRead, haplotype bytes) jobs -> (arrays, statics)
    for ``pairhmm_long_forward``, array for array the JAX pack: rchar
    (K*W, 128) int8, qual (6*K*W, 128) fp32 (qr, 1-(qi+qd), 1-qg, qi, qd,
    qg), hap (NDt, 128) int8 reversed stream, meta (8, 128) int32 (hl 1
    on empty lanes); statics k_strips, strip_w, ny_max."""
    if not 0 < len(jobs) <= LANES:
        raise ValueError(f"{len(jobs)} jobs: a tile takes 1 to {LANES}")
    w = _round_up(strip_w, SUB_Q)
    k = max(1, -(-(max(len(rd.bases) for rd, _ in jobs) + 2) // w))
    ny_max = _round_up(max(len(h) for _, h in jobs) + 1, LONG_CHUNK)
    _, anchor, ndt = long_layout(ny_max, w)
    kw = k * w
    rchar = _full((kw, LANES), PAD_X, np.int8)
    qual = np.zeros((6 * kw, LANES), np.float32)
    hap = _full((ndt, LANES), PAD_STREAM, np.int8)
    meta = np.zeros((8, LANES), np.int32)
    meta[1, :] = 1
    for lane, (rd, h) in enumerate(jobs):
        n = len(rd.bases)
        _reject_bad_read(rd, phred_offset)
        _reject_pad_codes(np.frombuffer(rd.bases, np.uint8), "read bases")
        _reject_pad_codes(np.frombuffer(h, np.uint8), "haplotype")
        rchar[1:n + 1, lane] = np.frombuffer(rd.bases, np.uint8)
        qr, qi, qd, qg = (
            phred_to_error_prob(np.frombuffer(q, np.uint8), phred_offset)
            for q in (rd.base_q, rd.ins_q, rd.del_q, rd.gcp_q))
        for j, v in enumerate((qr, 1.0 - (qi + qd), 1.0 - qg, qi, qd, qg)):
            qual[j * kw + 1:j * kw + n + 1, lane] = v
        hap[anchor - len(h):anchor, lane] = np.frombuffer(h, np.uint8)[::-1]
        meta[0, lane] = n
        meta[1, lane] = len(h)
    arrays = dict(rchar=rchar, qual=qual, hap=hap, meta=meta)
    return arrays, dict(k_strips=k, strip_w=w, ny_max=ny_max)


def pairhmm_long_forward(rchar, qual, hap, meta, *, k_strips: int,
                         strip_w: int, ny_max: int, unroll: int = UNROLL,
                         mm_div: float = 1.0,
                         _rows_per_thread: int | None = None) -> torch.Tensor:
    """(128,) fp32 log10 likelihoods of one packed tile of long jobs, on
    the inputs' device (the arrays and statics of ``pack_pairhmm_long``).
    ``unroll`` is the rescale block in diagonals; mm_div 3 is the GATK
    mismatch emission. ``_rows_per_thread`` picks the kernel's R (a test
    and timing hook; ``long_geometry``); an R the build does not make
    raises on every device."""
    if LONG_CHUNK % unroll or unroll > 32:
        raise ValueError(f"unroll={unroll} must divide {LONG_CHUNK} and be "
                         "<= 32")
    if _rows_per_thread is not None:
        long_geometry(k_strips, strip_w, ny_max, _rows_per_thread)
    sweep, anchor, ndt = long_layout(ny_max, strip_w)
    kw = k_strips * strip_w
    want = ((kw, LANES), (6 * kw, LANES), (ndt, LANES), (8, LANES))
    got = tuple(tuple(t.shape) for t in (rchar, qual, hap, meta))
    if got != want:
        raise ValueError(f"pairhmm_long_forward: shapes {got}, want {want}")
    if rchar.device.type == "cpu":
        return phmm_long_forward(rchar, qual, hap, meta, k_strips, strip_w,
                                 anchor, sweep, unroll, mm_div)
    return _launch(rchar, qual, hap, meta, k_strips, strip_w, ny_max, anchor,
                   ndt, unroll, mm_div, _rows_per_thread)


@trace.traced("launch")
def _launch(rchar, qual, hap, meta, k_strips, strip_w, ny_max, anchor, ndt,
            unroll, mm_div, rows_per_thread) -> torch.Tensor:
    launch = _build.load("pairhmm_long", "pairhmm_long_launch", _ARGTYPES)
    tensors = (rchar, qual, hap, meta)
    if not rchar.is_cuda or any(t.device != rchar.device for t in tensors):
        raise ValueError("pairhmm_long_forward: every input must lie on one "
                         f"CUDA device (got {[str(t.device) for t in tensors]})")
    want = (torch.int8, torch.float32, torch.int8, torch.int32)
    got = tuple(t.dtype for t in tensors)
    if got != want:
        raise TypeError(f"pairhmm_long_forward: dtypes {got}, want {want}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pairhmm_long_forward: every input must be "
                         "contiguous")
    try:
        geo = long_geometry(k_strips, strip_w, ny_max, rows_per_thread)
    except ValueError as e:
        raise ValueError(f"pairhmm_long_forward: {e}") from None
    halo = torch.empty((4, max(geo.halo_rows, 1), LANES),
                       dtype=torch.float32, device=rchar.device)
    out = torch.empty((LANES,), dtype=torch.float32, device=rchar.device)
    with torch.cuda.device(rchar.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(*(t.data_ptr() for t in tensors), halo.data_ptr(),
                     out.data_ptr(), k_strips, strip_w, anchor, ndt,
                     halo.shape[1], unroll, float(mm_div),
                     geo.rows_per_thread, geo.warps, stream)
    if err != 0:
        raise RuntimeError(f"pairhmm_long launch failed: cudaError {err}")
    trace.count("launches.pairhmm_long")
    return out


def pairhmm_long(jobs, phred_offset: float = 33.0, *, device,
                 strip_w: int = STRIP_W, unroll: int = UNROLL,
                 mm_div: float = 1.0) -> np.ndarray:
    """log10 likelihoods of (PairHMMRead, haplotype bytes) jobs of any read
    length, in order: tiles of 128 packed on the host, copied to
    ``device`` and scored there, all tiles launched before the first copy
    back."""
    device = torch.device(device)
    pending = []
    for base in range(0, len(jobs), LANES):
        tile = jobs[base:base + LANES]
        with trace.span("pack.fill"):
            arrays, statics = pack_pairhmm_long(tile, phred_offset, strip_w)
        t = trace.to_device(device, *(arrays[name] for name in (
            "rchar", "qual", "hap", "meta")))
        pending.append((base, len(tile), pairhmm_long_forward(
            *t, unroll=unroll, mm_div=mm_div, **statics)))
    out = np.zeros(len(jobs), np.float32)
    for base, n, r in pending:
        out[base:base + n] = trace.to_host(r)[:n]
    return out
