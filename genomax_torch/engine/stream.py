"""Streaming pipeline of the port: chunked scoring with the host pack of the
next chunk overlapped against the device run of this one (the counterpart
of ``genomax.engine.stream``).

    chunk i:    [mask + pack (worker thread)] -> [launch] -> [synchronize]
    chunk i+1:        [mask + pack (overlapped with chunk i's run)] ...

One worker thread packs a chunk ahead of the caller. Only numpy and
native work crosses threads (the offload mask, the job list and
``pack_sw_pairs`` / ``Engine._phmm_pack``, whose fills are the native
library's and release the GIL, while their bucketing in Python holds it,
so the two threads contend for it); every torch call, kernel launch and
synchronize stays on the caller's thread, and so do the strips, rotor and
stacked preps, which run inside ``Engine._sw_bucket`` as in the one-shot
engine. Host memory holds about two chunks of packed buffers instead of
the whole workload.

The results equal the one-shot engine's, in input order: SW scores
exactly; PairHMM values to fp32 tolerance (each chunk buckets its own
jobs), as float64 when any chunk's offload or fallback promoted it, as
``Engine.pairhmm`` returns them on the whole list. The long pairs and the
fp64 fallback are handled per chunk on the caller's thread; a failing
long-pair kernel raises :class:`EngineError` as in the one-shot engine.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from genomax_torch.engine.executor import (RunStats, _jobs, _run_buckets,
                                           phmm_bucket_stats, sw_bucket_stats)
from genomax_torch.pack import pack_sw_pairs, unpack_scores


def sw_scores_stream(engine, pairs, chunk_pairs: int = 65536) -> np.ndarray:
    """``engine.sw_scores`` over chunks of ``chunk_pairs`` pairs with the
    pack overlapped. Returns the scores in input order; ``engine.last_stats``
    sums every chunk, with ``pack_s`` the time spent waiting for the
    worker and ``exec_s`` the time around the bucket runs."""
    if chunk_pairs < 1:
        raise ValueError(f"chunk_pairs must be >= 1, got {chunk_pairs}")
    n = len(pairs)
    out = np.zeros(n, np.int32)
    stats = RunStats(n_jobs=n)
    spans = [(s, min(s + chunk_pairs, n)) for s in range(0, n, chunk_pairs)]
    if not spans:  # empty workload: as Engine.sw_scores([])
        engine.last_stats = stats
        return out

    def prep(span):
        chunk = pairs[span[0]:span[1]]
        off = engine._sw_offload_mask(chunk)
        return chunk, off, pack_sw_pairs(
            chunk, job_mask=None if off is None else ~off,
            stream_band=engine._stream_band())

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(prep, spans[0])
        for i, (s, e) in enumerate(spans):
            t0 = time.perf_counter()
            chunk, off, buckets = fut.result()
            stats.pack_s += time.perf_counter() - t0  # the wait only
            if i + 1 < len(spans):
                fut = pool.submit(prep, spans[i + 1])
            stats.buckets += len(buckets)
            sw_bucket_stats(stats, buckets)
            t1 = time.perf_counter()
            results = _run_buckets("sw-stream", buckets, engine._sw_bucket,
                                   engine.device)
            # exec_s strictly around the runs, as in Engine.sw_scores
            stats.exec_s += time.perf_counter() - t1
            part = unpack_scores(buckets, results, len(chunk), np.int32)
            engine._sw_offload_post(chunk, part, off, stats)
            out[s:e] = part
    engine.last_stats = stats
    return out


def pairhmm_stream(engine, batches, chunk_batches: int = 64) -> np.ndarray:
    """``engine.pairhmm`` over chunks of ``chunk_batches`` batches with the
    pack overlapped. The reference's output order (batches in file order,
    read-major within a batch) holds: chunks are contiguous runs of
    batches."""
    if chunk_batches < 1:
        raise ValueError(f"chunk_batches must be >= 1, got {chunk_batches}")
    spans = [batches[s:s + chunk_batches]
             for s in range(0, len(batches), chunk_batches)]
    stats = RunStats()
    if not spans:  # empty workload: as Engine.pairhmm([])
        engine.last_stats = stats
        return np.zeros(0, np.float32)

    def prep(chunk):
        jobs = _jobs(chunk)
        off = engine._phmm_offload_mask(jobs)
        buckets, n = engine._phmm_pack(chunk, None if off is None else ~off)
        return jobs, off, buckets, n

    outs = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(prep, spans[0])
        for i in range(len(spans)):
            t0 = time.perf_counter()
            jobs, off, buckets, n = fut.result()
            stats.pack_s += time.perf_counter() - t0
            if i + 1 < len(spans):
                fut = pool.submit(prep, spans[i + 1])
            stats.n_jobs += n
            stats.buckets += len(buckets)
            phmm_bucket_stats(stats, buckets)
            t1 = time.perf_counter()
            results = _run_buckets("pairhmm-stream", buckets,
                                   engine._phmm_bucket, engine.device)
            stats.exec_s += time.perf_counter() - t1
            part = unpack_scores(buckets, results, n, np.float32)
            part, native_done = engine._phmm_offload_post(jobs, part, off,
                                                          stats)
            outs.append(engine._phmm_fallback(jobs, part, stats,
                                              native_done=native_done))
    engine.last_stats = stats
    return np.concatenate(outs)
