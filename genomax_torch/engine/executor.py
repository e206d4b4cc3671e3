"""Per-device execution engine of the port: the Smith-Waterman path of
``genomax.engine.executor.Engine``.

parse -> offload mask -> ``pack_sw_pairs`` -> one kernel launch per bucket
-> one synchronize -> ``unpack_scores`` -> native model for the offloaded
pairs. It scores what the JAX engine scores with
``EngineConfig(sw_strips=False, sw_rotor=False)``: every bucket takes the
resident lane-tile kernel (here ``csrc/sw_tile.cu``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from genomax import native
from genomax.config import SWConfig
from genomax.engine.executor import EngineError, RunStats, sw_bucket_stats
from genomax.io.formats import parse_sw_file
from genomax.pack.bucketing import pack_sw_pairs, unpack_scores

from genomax_torch.config import EngineConfig
from genomax_torch.kernels.sw import sw_forward
from genomax_torch.pack import sw_bucket_to_torch


def _run_buckets(stage, buckets, dispatch, device: torch.device):
    """Launch every bucket, synchronize once, then copy the results back.
    A bucket whose launch or copy raises is dispatched once more; a second
    failure raises :class:`EngineError` naming the bucket."""

    def retried(i, b, first, retry):
        try:
            return first()
        except Exception:
            try:
                return retry()
            except Exception as e:
                raise EngineError(stage, i, b.sx.shape, e) from e

    pending = [(i, b, retried(i, b, lambda: dispatch(b), lambda: dispatch(b)))
               for i, b in enumerate(buckets)]
    if device.type == "cuda" and pending:
        torch.cuda.synchronize(device)
    return [retried(i, b, lambda: r.cpu().numpy(),
                    lambda: dispatch(b).cpu().numpy())
            for i, b, r in pending]


class Engine:
    def __init__(self, cfg: EngineConfig = EngineConfig(),
                 sw_cfg: SWConfig = SWConfig(), device="cuda"):
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device {self.device}: want cuda or cpu")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: torch finds no CUDA "
                               "device on this host")
        self.cfg = cfg
        self.sw_cfg = sw_cfg.validate()
        self.last_stats: RunStats | None = None

    def _sw_bucket(self, b):
        sx, sy, ndiag = sw_bucket_to_torch(b, self.device)
        return sw_forward(sx, sy, ndiag, self.sw_cfg)

    def _sw_offload_mask(self, pairs):
        """True = too big for the device kernel; scored by the native
        model (the predicate of the JAX engine)."""
        L, D = self.cfg.max_device_len, self.cfg.max_device_diags
        m = np.array(
            [len(p.sx) + 2 > L or len(p.sx) + len(p.sy) + 1 > D for p in pairs]
        )
        return m if m.any() else None

    def sw_scores(self, pairs) -> np.ndarray:
        """Scores for SWPair jobs, in input order."""
        stats = RunStats(n_jobs=len(pairs))
        off = self._sw_offload_mask(pairs)
        t0 = time.perf_counter()
        buckets = pack_sw_pairs(pairs, job_mask=None if off is None else ~off,
                                stream_band=False)
        stats.pack_s = time.perf_counter() - t0
        stats.buckets = len(buckets)
        sw_bucket_stats(stats, buckets)
        t0 = time.perf_counter()
        results = _run_buckets("sw", buckets, self._sw_bucket, self.device)
        stats.exec_s = time.perf_counter() - t0
        out = unpack_scores(buckets, results, len(pairs), np.int32)
        if off is not None:
            # The JAX engine sends these to sw_long on its Pallas backend;
            # the port of sw_long is ROADMAP queue 1 item 8.
            idx = np.nonzero(off)[0]
            out[idx] = native.sw_scores_native([pairs[i] for i in idx],
                                               self.sw_cfg)
            stats.offloaded_jobs += len(idx)
        self.last_stats = stats
        return out

    def sw_scores_file(self, path: str) -> np.ndarray:
        return self.sw_scores(parse_sw_file(path))
