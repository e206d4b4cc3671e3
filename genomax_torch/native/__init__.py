"""ctypes loader of the port's native golden library (``golden.cpp``, a
copy of ``genomax/native/golden.cpp``): the exact int32 Smith-Waterman and
fp64 PairHMM models the engine offloads to and the kernels are held
against, and the C fill loops of the packers.

The library is built with g++ at first use into ``genomax_torch/_build/``,
keyed on a hash of the source and the flags, never beside the source. A
failed build raises :class:`NativeBuildError` with the compiler's
messages: every host the port runs on has a C++ compiler (nvcc needs
one), so there is no slower route to hide a broken build behind.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import subprocess
import threading

import numpy as np

from genomax_torch import scoring
from genomax_torch.config import SWConfig
from genomax_torch.io.phred import phred_to_error_prob

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "golden.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """The native golden library could not be built or loaded."""


def build() -> str:
    """Path of the library built from golden.cpp; compiled unless the
    library of this source and these flags is already there."""
    with open(SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"golden-{key.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC],
                              capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"cannot run {cxx} to build {SRC}: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"{cxx} failed on {SRC} (rc {proc.returncode})"
                               f":\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def load():
    """The loaded library with its argument types set, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        c32, c64 = ctypes.c_int32, ctypes.c_int64
        lib.gx_sw_scores_batch.restype = None
        lib.gx_sw_scores_batch.argtypes = [
            u8p, i64p, u8p, i64p, c64, c32, c32, c32, c32, i32p,
        ]
        lib.gx_sw_scores_batch_matrix.restype = None
        lib.gx_sw_scores_batch_matrix.argtypes = [
            u8p, i64p, u8p, i64p, c64, i32p, c32, c32, c32, i32p,
        ]
        lib.gx_encode.restype = c64
        lib.gx_encode.argtypes = [u8p, c64, u8p, u8p]
        lib.gx_pairhmm_batch.restype = None
        lib.gx_pairhmm_batch.argtypes = [
            u8p, i64p, f64p, f64p, f64p, f64p, u8p, i64p, i64p, i64p,
            c64, f64p, ctypes.c_double,
        ]
        lib.gx_pack_sw_fill.restype = None
        lib.gx_pack_sw_fill.argtypes = [
            u8p, i64p, u8p, i64p, i64p, c64, c64, c64, c64,
            i8p, i8p, i32p, i32p,
        ]
        lib.gx_pack_phmm_fill.restype = None
        lib.gx_pack_phmm_fill.argtypes = [
            u8p, i64p, u8p, u8p, u8p, u8p, u8p, i64p, i64p, i64p, i64p,
            c64, c64, c64, c64, ctypes.c_double,
            i8p, f32p, f32p, f32p, f32p, f32p, f32p, i8p, i32p, i32p,
        ]
        lib.gx_pack_phmm_fill_bytes.restype = None
        lib.gx_pack_phmm_fill_bytes.argtypes = [
            u8p, i64p, u8p, u8p, u8p, u8p, u8p, i64p, i64p, i64p, i64p,
            c64, c64, c64, c64,
            i8p, i8p, i8p, i32p, i32p,
        ]
        lib.gx_pack_phmm_fill_factored.restype = None
        lib.gx_pack_phmm_fill_factored.argtypes = [
            u8p, i64p, u8p, u8p, u8p, u8p, u8p, i64p, i64p, c64, i64p, c64,
            c64, c64, c64, i8p, i8p, i8p, i8p,
        ]
        lib.gx_rows_ok.restype = None
        lib.gx_rows_ok.argtypes = [u8p, i64p, c64, u8p, u8p]
        _lib = lib
        return _lib


def _concat_with_offsets(items, lengths=None, keep=None):
    """(data, off): the byte strings of ``items`` joined into one uint8
    array (one zero byte when they are all empty, so that it has an
    address), item i at data[off[i]:off[i + 1]]. ``lengths``: their
    lengths where the caller has them; ``keep`` (bool, len(items)): the
    items where it is False are left out, as empty slices."""
    off = np.zeros(len(items) + 1, dtype=np.int64)
    if lengths is None:
        lengths = np.fromiter(map(len, items), np.int64, len(items))
    if keep is None:
        np.cumsum(lengths, out=off[1:])
        joined = b"".join(items)
    else:
        np.cumsum(np.where(keep, lengths, 0), out=off[1:])
        joined = b"".join(itertools.compress(items, keep))
    data = np.frombuffer(joined, dtype=np.uint8)
    if data.size == 0:
        data = np.zeros(1, dtype=np.uint8)
    return data, off


def encode(data: np.ndarray, off: np.ndarray, lut: np.ndarray,
           what: str) -> np.ndarray:
    """The codes of the residues ``data`` (sequence k at data[off[k]:
    off[k + 1]]) through ``lut`` (``scoring.code_lut``), in one native
    pass; raises ``scoring.ResidueError`` naming the first byte outside
    the alphabet and its sequence, ``what`` k."""
    n = int(off[-1])
    out = np.empty(max(n, 1), np.uint8)
    bad = load().gx_encode(data, n, lut, out) if n else -1
    if bad >= 0:
        k = int(np.searchsorted(off, bad, side="right")) - 1
        b = int(data[bad])
        raise scoring.ResidueError(f"byte {bytes([b])!r} ({b}) of {what} {k} "
                                   "is not a residue of the matrix",
                                   index=k, byte=b)
    return out


def sw_scores_native(pairs, cfg=None) -> np.ndarray:
    """Batch SW scores through the native golden model (exact int32).
    Under ``cfg.matrix`` the residues are encoded (``encode``) and scored
    by the matrix's code table."""
    cfg = cfg or SWConfig()
    lib = load()
    sx_data, sx_off = _concat_with_offsets([p.sx for p in pairs])
    sy_data, sy_off = _concat_with_offsets([p.sy for p in pairs])
    out = np.zeros(len(pairs), dtype=np.int32)
    name = scoring.matrix_of(cfg)
    if name is not None:
        lut = scoring.code_lut(name)
        lib.gx_sw_scores_batch_matrix(
            encode(sx_data, sx_off, lut, "pair"), sx_off,
            encode(sy_data, sy_off, lut, "pair"), sy_off, len(pairs),
            scoring.code_table(name), scoring.STRIDE, cfg.gap_open,
            cfg.gap_extend, out)
        return out
    lib.gx_sw_scores_batch(
        sx_data, sx_off, sy_data, sy_off, len(pairs),
        cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_extend, out,
    )
    return out


def pairhmm_native(batches, phred_offset: float = 33.0,
                   gatk_emission: bool = False) -> np.ndarray:
    """Batch PairHMM log10 likelihoods (fp64) in reference output order.
    gatk_emission: True = Qr/3 mismatch emission (the real GATK; see
    PairHMMConfig.gatk_emission), False = reference parity."""
    from genomax_torch.pack.bucketing import _reject_bad_read

    # The packers' validation, and load-bearing here: gx_pairhmm_batch
    # indexes the flat quality arrays with the bases' offsets, so a read
    # whose quality strings are shorter than its bases would be read past
    # the allocation.
    for b in batches:
        for rd in b.reads:
            _reject_bad_read(rd, phred_offset)

    lib = load()
    reads, haps, job_r, job_h = [], [], [], []
    quals = [[], [], [], []]
    for b in batches:
        r0, h0 = len(reads), len(haps)
        for rd in b.reads:
            reads.append(rd.bases)
            for qlist, raw in zip(quals, (rd.base_q, rd.ins_q, rd.del_q, rd.gcp_q)):
                qlist.append(
                    phred_to_error_prob(np.frombuffer(raw, np.uint8), phred_offset)
                )
        haps.extend(b.haplotypes)
        for ri in range(len(b.reads)):
            for hi in range(len(b.haplotypes)):
                job_r.append(r0 + ri)
                job_h.append(h0 + hi)

    read_data, read_off = _concat_with_offsets(reads)
    hap_data, hap_off = _concat_with_offsets(haps)
    qarr = [
        np.ascontiguousarray(np.concatenate(q) if q else np.zeros(1)) for q in quals
    ]
    out = np.zeros(len(job_r), dtype=np.float64)
    lib.gx_pairhmm_batch(
        read_data, read_off, qarr[0], qarr[1], qarr[2], qarr[3],
        hap_data, hap_off,
        np.ascontiguousarray(np.array(job_r, np.int64)),
        np.ascontiguousarray(np.array(job_h, np.int64)),
        len(job_r), out, 3.0 if gatk_emission else 1.0,
    )
    return out
