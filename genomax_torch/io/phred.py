"""Phred+33 quality decode.

Reference: partition_read() at pairHMM/pairHMMmatrix.c:20-30 computes, per
quality char c, the error probability Q = 10 ** (-(c - 33) / 10) in fp64.
We precompute a 256-entry lookup table once (the reference calls pow() per
base per pair; a table is both faster and bit-identical for byte inputs).
"""

from __future__ import annotations

import numpy as np

_TABLES: dict[float, np.ndarray] = {}


def _table(offset: float) -> np.ndarray:
    tab = _TABLES.get(offset)
    if tab is None:
        codes = np.arange(256, dtype=np.float64)
        tab = np.power(10.0, -(codes - offset) * 0.1)
        _TABLES[offset] = tab
    return tab


def phred_to_error_prob(quals: np.ndarray, offset: float = 33.0) -> np.ndarray:
    """Decode a uint8 array of phred+33 chars to fp64 error probabilities."""
    q = np.asarray(quals)
    if q.dtype != np.uint8:
        q = q.astype(np.uint8)
    return _table(offset)[q]
