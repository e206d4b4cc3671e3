"""Build of the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled by
``nvcc`` into ``genomax_torch/_build/<name>-<hash>.so``, keyed on a hash of
the source, every header it includes with quotes (``sw_cell.cuh``) and the
flags, so a later run that finds the library skips the build and an edit
to a header builds anew, and loaded with ``ctypes``. Nothing is built when
a module is imported, and a failed build raises :class:`BuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# Every kernel source of the port (csrc/<name>.cu).
KERNELS = ("sw_tile", "sw_long", "sw_strips", "sw_rotor", "sw_stacked",
           "sw_conveyor", "sw_xstrip", "pairhmm_tile", "pairhmm_long")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_fns: dict[str, ctypes._CFuncPtr] = {}


class BuildError(RuntimeError):
    """A CUDA source of the port could not be built or loaded."""


def nvcc() -> str | None:
    """The nvcc on PATH, else the one under $CUDA_HOME (default
    /usr/local/cuda); None when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.access(cand, os.X_OK) else None


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def key(name: str) -> str:
    """Hash of csrc/<name>.cu, of every header it includes with quotes
    (followed recursively, resolved beside the including file) and of the
    flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [os.path.join(CSRC, name + ".cu")], set()
    while todo:
        path = os.path.normpath(todo.pop(0))
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(os.path.basename(path).encode() + b"\0" + text)
        todo += [os.path.join(os.path.dirname(path), inc.decode())
                 for inc in _INCLUDE.findall(text)]
    return h.hexdigest()[:16]


def build(name: str) -> tuple[str, str]:
    """(path of the library built from csrc/<name>.cu, nvcc's messages).
    The messages are empty when the library of this source already
    existed."""
    src = os.path.join(CSRC, name + ".cu")
    path = os.path.join(BUILD_DIR, f"{name}-{key(name)}.so")
    if os.path.exists(path):
        return path, ""
    exe = nvcc()
    if exe is None:
        raise BuildError(f"nvcc not found on PATH or under $CUDA_HOME; "
                         f"cannot build {src}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([exe, *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed on {src} (rc {proc.returncode}):\n"
                         f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, proc.stdout + proc.stderr


def load(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``fn`` of csrc/<name>.cu, built at first use, with
    ``argtypes`` set and an int return (a cudaError_t)."""
    with _lock:
        if fn not in _fns:
            path, _ = build(name)
            try:
                f = getattr(ctypes.CDLL(path), fn)
            except (OSError, AttributeError) as e:
                raise BuildError(f"cannot load {fn} from {path}: {e}") from e
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            _fns[fn] = f
        return _fns[fn]
