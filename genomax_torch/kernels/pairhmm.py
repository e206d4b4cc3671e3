"""PairHMM bucket scoring: the wrapper of the hand-written CUDA kernel
``csrc/pairhmm_tile.cu``, with the contract of
``genomax.kernels.pairhmm_pallas.pairhmm_forward_pallas``.

CUDA tensors launch the kernel on the current stream; CPU tensors take the
plain version (``kernels.wavefront.phmm_forward_tiles``). There is no other
route: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from genomax_torch.config import MAX_PHMM_ROWS, RESCALE_PERIODS
from genomax_torch.kernels import _build
from genomax_torch.kernels.wavefront import phmm_forward_tiles
from genomax_torch.layout import LANES

# Kernel launches made by pairhmm_forward (CUDA tensors only).
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])


def pairhmm_forward(rchar, qr, mmv, gapm, qi, qd, qg, hap, meta, ndiag_tile,
                    rescale_period: int = 32, mm_div: float = 1.0,
                    bitmask: bool = False) -> torch.Tensor:
    """log10 likelihoods of a packed PairHMM bucket.

    rchar: (NT, NXs, 128) int8 read codes, row i holding base i-1; qr, mmv,
    gapm, qi, qd, qg: (NT, NXs, 128) fp32; hap: (NT, NDs, 128) int8
    reversed haplotype stream with anchor NDs - NXs past every pair's last
    diagonal plus 32 (the pack guarantees it); meta: (NT, 8, 128) int32,
    row 0 read_len, row 1 hap_len; ndiag_tile: (NT,) int32. mm_div 3 is
    the GATK mismatch emission; bitmask: the codes are the pack's one-hot
    match bitmasks. Returns (NT, 128) fp32, slot-major, relative to the
    reference's constant, on the inputs' device.
    """
    if rchar.device.type == "cpu":
        return phmm_forward_tiles(rchar, qr, mmv, gapm, qi, qd, qg, hap, meta,
                                  ndiag_tile, rescale_period, mm_div, bitmask)
    return _launch(rchar, (qr, mmv, gapm, qi, qd, qg), hap, meta, ndiag_tile,
                   rescale_period, mm_div, bitmask)


def _launch(rchar, quals, hap, meta, ndiag_tile, rescale_period, mm_div,
            bitmask) -> torch.Tensor:
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
    out = torch.empty((nt, LANES), dtype=torch.float32, device=rchar.device)
    if nt == 0:
        return out
    with torch.cuda.device(rchar.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(*(t.data_ptr() for t in tensors), out.data_ptr(), nt, nxs,
                     nds, rescale_period, float(mm_div), int(bool(bitmask)),
                     stream)
    if err != 0:
        raise RuntimeError(f"pairhmm_tile launch failed: cudaError {err}")
    launches += 1
    return out
