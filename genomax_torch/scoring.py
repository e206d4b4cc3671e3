"""Substitution matrices of the SW path: the tables, the alphabet, and the
codes the packs and kernels score them by.

``SWConfig.matrix`` names a table here (``MATRICES``); None keeps the
equality scoring (``match`` / ``mismatch``). Under a matrix the packs
encode every residue once, on the host (``native.encode`` through
``code_lut``, the ``pack.encode`` span): the k-th letter of the alphabet
becomes code ``CODE0 + k``, and any byte outside the alphabet raises
:class:`ResidueError`. The packs, the kernels, their CPU twins and the native
offload then see codes, never residues, and score a cell by a lookup in
the code table (``code_table``): entry ``STRIDE * x + y`` for x code x
and y code y. The pad codes of the layout (``PAD_X`` 1, ``PAD_STREAM`` 0)
lie below ``CODE0``, so the packs' rule that bytes 0 and 1 never occur
inside a sequence holds for codes too.

The pad entries. A cell outside a pair's matrix reads a pad code on one
side. With equality scoring it mismatches; here its entry is ``pad_score``,
the table's least score. What the kernels need of it is that it is at most
0: a cell before the pair's first column (j <= 0, the stream pad against
a real x) then stays D = 0 with P, Q <= open + extend, so the pair's
first column sees the boundary it would see with -inf there (max(0 + oge,
P + ge) = oge); a cell past the pair's last row or column gets D <= the
largest D of its three neighbours (P and Q add a negative gap, the
diagonal a score <= 0), so by induction it never exceeds the pair's real
maximum; and no real cell reads a cell past the pair's end, since a cell
reads only up and to the left. So the cells outside decay, as under
equality scoring, and the running best of every kernel that takes its
maximum over unmasked pad cells is the pair's own. ``DEAD`` (code
``DEAD_CODE``, never in a pack) is -inf: the rotor kernel's columns past
its period carry it, so that they stay D = 0 whatever their left
neighbour holds.
"""

from __future__ import annotations

import functools

import numpy as np

from genomax_torch.layout import PAD_STREAM, PAD_X

# NCBI's BLOSUM62 (ftp.ncbi.nlm.nih.gov/blast/matrices/BLOSUM62), the
# table of BLAST+ blastp and MMseqs2 by default, in its own letter order.
BLOSUM62_TEXT = """\
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
R -1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
N -2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
D -2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
C  0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
Q -1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
E -1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
G  0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
H -2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
I -1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
L -1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
K -1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
M -1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
F -2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
P -1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
S  1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
T  0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
W -3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
Y -2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
V  0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
B -2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
Z -1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
X  0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
* -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""

# The first residue code: 0 and 1 are the layout's pad codes.
CODE0 = 2
# Row stride of the code table: 33, not 32, so that on the card the 32
# lanes of a warp, each at its own (x, y), spread over the shared-memory
# banks by x + y and not by y alone.
STRIDE = 33
# Codes a table covers: x codes 0 .. CODES - 1, y codes likewise.
CODES = 32
DEAD_CODE = CODES - 1
# -inf of a dead column (sw_cell.cuh's kSwNeg).
DEAD = -(1 << 28)


def parse(text: str) -> tuple[bytes, np.ndarray]:
    """(alphabet, scores) of a table in NCBI's text form: a header of
    letters, then one row a letter, the letter first."""
    lines = [ln.split() for ln in text.splitlines()
             if ln.strip() and not ln.startswith("#")]
    letters = "".join(lines[0])
    rows = lines[1:]
    if [r[0] for r in rows] != list(letters):
        raise ValueError("a matrix's rows must follow its header's letters")
    scores = np.array([[int(v) for v in r[1:]] for r in rows], np.int32)
    if scores.shape != (len(letters), len(letters)):
        raise ValueError(f"a {len(letters)}-letter matrix must be square, "
                         f"got {scores.shape}")
    return letters.encode(), scores


MATRICES = {"BLOSUM62": BLOSUM62_TEXT}


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


@functools.lru_cache(maxsize=None)
def matrix(name: str) -> tuple[bytes, np.ndarray]:
    """(alphabet, scores) of the table ``name``, read-only."""
    if name not in MATRICES:
        raise ValueError(f"matrix {name!r}: want one of {sorted(MATRICES)}")
    alphabet, scores = parse(MATRICES[name])
    return alphabet, _frozen(scores)


@functools.lru_cache(maxsize=None)
def code_lut(name: str) -> np.ndarray:
    """uint8[256], read-only: residue byte -> code, 0 for a byte outside
    the alphabet (no residue has code 0)."""
    alphabet, _ = matrix(name)
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(alphabet, np.uint8)] = np.arange(
        CODE0, CODE0 + len(alphabet), dtype=np.uint8)
    return _frozen(lut)


def pad_score(name: str) -> int:
    """PAD, the score of a pad code against anything: the table's least,
    at most 0 (the module's docstring says why that suffices)."""
    return min(int(matrix(name)[1].min()), 0)


@functools.lru_cache(maxsize=None)
def code_table(name: str) -> np.ndarray:
    """int32[CODES * STRIDE], read-only: the score of x code x against y
    code y at ``STRIDE * x + y``. Residue codes score as the table, pad codes as
    ``pad_score``, y code ``DEAD_CODE`` as ``DEAD``."""
    alphabet, scores = matrix(name)
    # Every entry with a pad code (x 1, y 0; and the unused codes) is the
    # pad score, at most 0: the cells outside a pair then decay and never
    # feed a real cell (the module's docstring has the argument).
    t = np.full((CODES, STRIDE), pad_score(name), np.int32)
    n = len(alphabet)
    t[CODE0:CODE0 + n, CODE0:CODE0 + n] = scores
    t[:, DEAD_CODE] = DEAD
    return _frozen(t.reshape(-1))


class ResidueError(ValueError):
    """A byte of a sequence that the matrix's alphabet lacks: ``byte``, of
    sequence ``index`` of the encoded batch (``native.encode``)."""

    def __init__(self, msg: str, index: int, byte: int):
        super().__init__(msg)
        self.index = index
        self.byte = byte


assert PAD_X < CODE0 and PAD_STREAM < CODE0


def matrix_of(cfg) -> str | None:
    """The matrix an SW config names; None for equality scoring, and for
    the JAX package's SWConfig, which has no such field."""
    return getattr(cfg, "matrix", None)


def device_table(cfg, device, table=None):
    """The code table of ``cfg.matrix`` as an int32 tensor on ``device``
    for a kernel launch: ``table`` where the caller holds one (the
    engine copies its own once), else copied now (``trace.to_device``);
    None under equality scoring, where a table given is an error."""
    name = matrix_of(cfg)
    if name is None:
        if table is not None:
            raise ValueError("a code table for an SW config without a "
                             "matrix")
        return None
    if table is not None:
        return table
    from genomax_torch import trace

    return trace.to_device(device, code_table(name).copy())[0]


def table_ptr(table) -> int:
    """The launch argument of a code table: its device address, or 0 (a
    null pointer, equality scoring) for None."""
    return 0 if table is None else table.data_ptr()


def refuse(cfg, path: str) -> None:
    """Raise, before any work, where ``cfg`` names a matrix: ``path`` is
    an opt-in SW path that scores by equality only."""
    name = matrix_of(cfg)
    if name is not None:
        raise ValueError(f"{path} does not score a substitution matrix "
                         f"({name}); the engine's default route does")
