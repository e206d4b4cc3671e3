"""Tile-sharded scoring: each rank scores its share of every bucket's tiles
and the ranks all-gather the scores (the counterpart of
``genomax.dist.sharded``).

A bucket, padded to a multiple of the mesh's size (``pad_tiles_to``), is cut
into equal runs of tiles, run r on rank r. Each rank scores its run through
the local engine's routing (``route``: the strips, rotor, stacked or
lane-tile kernel for SW, the PairHMM kernel for PairHMM), which may decide
per run: a route returns the same scores whatever kernel takes them. A
factored PairHMM run keeps the unique-row tables whole and slices their
gather indices; an SW stream packed as a band slices its band. One
all-gather in rank order then gives every bucket's scores in its tile
order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomax_torch.engine.executor import _run_buckets
from genomax_torch.layout import LANES
from genomax_torch.pack.bucketing import StreamBand, pad_tiles_to

# Fields of a pack that are not indexed by tile: the factored unique-row
# tables, needed whole by every rank's gather.
_WHOLE = ("rchar_u", "qb_u", "hap_u")


def tile_slice(bucket, rank: int, size: int):
    """Rank ``rank``'s run of the tiles of ``bucket``, whose tile count
    divides by ``size``: a bucket of the same type holding tiles
    [rank*n, (rank+1)*n), n = NT / size, whose ``perm`` and ``n_valid``
    index the run's live slots. A StreamBand stream keeps its ``lo`` and
    ``nds`` and slices its band; a field of any other type that is not an
    array or a scalar raises TypeError rather than reach every rank
    whole."""
    nt = bucket.ndiag_tile.shape[0]
    if nt % size:
        raise ValueError(f"{nt} tiles do not split over {size} ranks; pad "
                         "with pad_tiles_to first")
    n = nt // size
    t0, t1 = rank * n, (rank + 1) * n
    kw = {}
    for f in dataclasses.fields(bucket):
        v = getattr(bucket, f.name)
        if v is None or f.name in _WHOLE or isinstance(v, int):
            kw[f.name] = v  # bitmask_codes; n_valid is set below
        elif isinstance(v, StreamBand):
            kw[f.name] = dataclasses.replace(v, band=v.band[t0:t1])
        elif not isinstance(v, np.ndarray):
            raise TypeError(f"field {f.name} ({type(v).__name__}) is neither "
                            "an array nor a StreamBand: no way to slice it "
                            "by tile")
        elif f.name == "perm":
            kw[f.name] = v[t0 * LANES: t1 * LANES]
        elif v.shape[0] == nt:
            kw[f.name] = v[t0:t1]
        elif v.ndim == 1 and v.shape[0] == nt * LANES:
            kw[f.name] = v[t0 * LANES: t1 * LANES]
        else:
            raise ValueError(f"field {f.name} of shape {v.shape} is not "
                             f"indexed by the bucket's {nt} tiles")
    kw["n_valid"] = len(kw["perm"])
    return type(bucket)(**kw)


def _fit_rows(r: torch.Tensor, n: int) -> torch.Tensor:
    """The first n rows of a route's (rows, 128) result, zero rows past
    its end: a route may return pad rows past the run's tiles (the stacked
    kernel) or only the rows of its live tiles (the rotor)."""
    if r.shape[0] >= n:
        return r[:n]
    pad = torch.zeros((n - r.shape[0], r.shape[1]), dtype=r.dtype,
                      device=r.device)
    return torch.cat([r, pad])


def _forward_sharded(stage, buckets, mesh, route) -> list[np.ndarray]:
    if not buckets:
        return []
    buckets = [pad_tiles_to(b, mesh.size) for b in buckets]
    runs = [tile_slice(b, mesh.rank, mesh.size) for b in buckets]
    local = _run_buckets(
        stage, runs,
        lambda p: _fit_rows(route(p), p.ndiag_tile.shape[0]), mesh.device)
    flat = np.concatenate([r.reshape(-1) for r in local])
    parts = [t.cpu().numpy() for t in
             mesh.all_gather(torch.from_numpy(flat).to(mesh.device))]
    out, at = [], 0
    for p in runs:
        n = p.ndiag_tile.shape[0] * LANES
        out.append(np.concatenate([q[at: at + n] for q in parts])
                   .reshape(-1, LANES))
        at += n
    return out


def sw_forward_sharded(buckets, *, mesh, route) -> list[np.ndarray]:
    """(NT, 128) int32 scores of each SW bucket, every rank scoring its run
    of each bucket's tiles with ``route`` (a run -> (rows, 128) scores on
    the mesh's device) and the runs all-gathered; the same lists on every
    rank."""
    return _forward_sharded("sw-sharded", buckets, mesh, route)


def pairhmm_forward_sharded(buckets, *, mesh, route) -> list[np.ndarray]:
    """(NT, 128) float32 log10 likelihoods of each PairHMM bucket (factored
    packs: the tables stay whole, the gather indices are sliced), as
    ``sw_forward_sharded``."""
    return _forward_sharded("pairhmm-sharded", buckets, mesh, route)
