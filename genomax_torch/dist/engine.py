"""``ShardedEngine``: the port's ``Engine`` over a device mesh (the
counterpart of ``genomax.dist.engine.ShardedEngine``), one process a device.

Every rank parses and packs the whole job list, as the JAX engine's hosts
do; each scores its run of every bucket's tiles through the local engine's
routing and the ranks all-gather the scores (``dist.sharded``), so every rank
returns the same results in input order. The offload masks, the long-pair
kernels, the native model and the PairHMM fp64 fallback are the local
engine's, and so is ``RunStats``.

With ``EngineConfig.xshard_min_len`` set, offloaded SW pairs whose x has at
least that many bases score through the cross-device wavefront
(``dist.xsharded``, ``csrc/sw_xstrip.cu``), in tiles of 128 in input order;
the other offloaded pairs take the long-pair kernel or the native model.
A failure of the cross-device path raises :class:`EngineError`: nothing
reroutes its pairs.
"""

from __future__ import annotations

import numpy as np

from genomax_torch import scoring, trace
from genomax_torch.config import EngineConfig, PairHMMConfig, SWConfig
from genomax_torch.dist.sharded import (pairhmm_forward_sharded,
                                        sw_forward_sharded)
from genomax_torch.dist.xsharded import sw_scores_xsharded
from genomax_torch.engine.executor import Engine, EngineError
from genomax_torch.layout import LANES


class ShardedEngine(Engine):
    """``Engine`` on ``mesh`` (``dist.mesh.make_mesh``): the mesh's device
    is the engine's, and every bucket is scored tile-sharded over the
    mesh."""

    def __init__(self, mesh, cfg: EngineConfig = EngineConfig(),
                 sw_cfg: SWConfig = SWConfig(),
                 phmm_cfg: PairHMMConfig = PairHMMConfig()):
        scoring.refuse(sw_cfg, "ShardedEngine (its tile-sharded buckets "
                       "and the cross-device sw_xstrip path)")
        super().__init__(cfg, sw_cfg, phmm_cfg, device=mesh.device)
        self.mesh = mesh

    def _sw_run(self, buckets):
        return sw_forward_sharded(buckets, mesh=self.mesh,
                                  route=self._sw_bucket)

    def _phmm_run(self, buckets):
        return pairhmm_forward_sharded(buckets, mesh=self.mesh,
                                       route=self._phmm_bucket)

    def _sw_offload_post(self, pairs, out, off, stats):
        """The local engine's post-pass, with the pairs whose x has at
        least ``cfg.xshard_min_len`` bases taken out first for the
        cross-device wavefront."""
        xmin = self.cfg.xshard_min_len
        if off is None or xmin is None:
            return super()._sw_offload_post(pairs, out, off, stats)
        idx = np.nonzero(off)[0]
        xidx = np.array([i for i in idx if len(pairs[i].sx) >= xmin],
                        dtype=np.int64)
        rest = off.copy()
        if len(xidx):
            trace.count("cells.xstrip", sum(
                len(pairs[i].sx) * len(pairs[i].sy) for i in xidx))
            try:
                for s in range(0, len(xidx), LANES):
                    tile = xidx[s: s + LANES]
                    out[tile] = sw_scores_xsharded(
                        [pairs[i] for i in tile], mesh=self.mesh,
                        unroll=self.cfg.unroll, cfg=self.sw_cfg)
            except Exception as e:
                raise EngineError("sw_xsharded", 0, (len(xidx),), e) from e
            rest[xidx] = False
            stats.xsharded_jobs += len(xidx)
            stats.offloaded_jobs += len(xidx)
        if rest.any():
            super()._sw_offload_post(pairs, out, rest, stats)
