"""Per-device execution engine of the port: the Smith-Waterman and PairHMM
paths of ``genomax.engine.executor.Engine``.

parse -> offload mask -> pack -> one kernel launch per bucket -> one
synchronize -> ``unpack_scores`` -> the long-pair kernels and the native
model for the offloaded jobs (and, for PairHMM, the fp64 fallback). SW
routes each bucket in the JAX engine's order: with ``sw_strips`` on, a
bucket of at least ``strips_min_nxs`` rows takes the strip-mined kernel
(``csrc/sw_strips.cu``) unless its prep declines it; then, with
``sw_rotor`` on and ``sw_stack`` below 2, a bucket of short pairs that the
rotor's predicate takes goes to the column-stationary rotor kernel
(``csrc/sw_rotor.cu``); then, with ``sw_stack`` >= 2, a bucket of at most
``stack_max_nxs`` rows that the stacked prep takes goes to the
sublane-stacked kernel (``csrc/sw_stacked.cu``); every other bucket takes
the lane-tile kernel (``csrc/sw_tile.cu``, at any stream length); pairs
whose x is too long for these (past ``max_device_len``, or past the lane
tile's 8,192 rows where strips would not take their bucket) take the
long-pair kernel (``csrc/sw_long.cu``) on the same device, and only pairs
past ``max_device_diags`` go to the native model. PairHMM
packs as the JAX engine's Pallas backend does (byte qualities, factored,
bitmask codes), expands on the device and runs ``csrc/pairhmm_tile.cu``
on every bucket; the reads too long for it (past ``max_device_len`` // 2
- 2 or 8,190 bases) take the long-read kernel (``csrc/pairhmm_long.cu``)
on the same device, and only jobs past ``max_device_diags`` go to the
native model.

An SW bucket's stream is packed as its live band
(``pack.bucketing.StreamBand``, the JAX engine's ``stream_band_transfer``)
and rebuilt on the device by ``pack.nibble.ship_stream``, so every kernel
sees the full buffer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomax_torch import native, scoring, trace
from genomax_torch.config import (MAX_KERNEL_ROWS, MAX_PHMM_ROWS,
                                  EngineConfig, PairHMMConfig, SWConfig)
from genomax_torch.io.formats import (PairHMMBatch, parse_pairhmm_file,
                                      parse_sw_file)
from genomax_torch.kernels.pairhmm import pairhmm_forward
from genomax_torch.kernels.pairhmm_long import pairhmm_long
from genomax_torch.kernels.sw import sw_forward
from genomax_torch.kernels.sw_long import sw_scores_long
from genomax_torch.kernels.sw_rotor import (maybe_prep_rotor,
                                            sw_forward_rotor_bucket)
from genomax_torch.kernels.sw_stacked import (maybe_prep_stacked,
                                              sw_forward_stacked)
from genomax_torch.kernels.sw_strips import (maybe_prep_strips,
                                             sw_forward_strips, takes)
from genomax_torch.pack import (pack_pairhmm_batches, pack_sw_pairs,
                                phmm_bucket_to_torch, sw_bucket_to_torch,
                                sw_rotor_to_torch, sw_stacked_to_torch,
                                sw_strips_to_torch, unpack_scores)
from genomax_torch.pack.bucketing import bucket_levels, bucket_rows, sw_sides


class EngineError(RuntimeError):
    """Structured engine failure: which stage and bucket failed, and the
    cause. A bucket gets one retry before this surfaces."""

    def __init__(self, stage: str, bucket: int, shape, cause: Exception):
        super().__init__(
            f"{stage} failed on bucket {bucket} (shape {shape}): {cause!r}"
        )
        self.stage = stage
        self.bucket = bucket
        self.cause = cause


@dataclasses.dataclass
class RunStats:
    """Per-run metrics: the pack/execute split, cell counts, padding
    efficiency. The fields and ``as_dict`` keys are those of the JAX
    engine's RunStats."""

    n_jobs: int = 0
    dp_cells: int = 0  # true interior DP cells
    padded_cells: int = 0  # rows * diagonals actually swept
    pack_s: float = 0.0
    exec_s: float = 0.0
    buckets: int = 0
    fallback_jobs: int = 0  # PairHMM pairs recomputed in native fp64
    offloaded_jobs: int = 0  # jobs too big for the lane-tile kernels
    xsharded_jobs: int = 0  # SW pairs scored across devices (ShardedEngine)

    @property
    def gcups(self) -> float:
        return self.dp_cells / max(self.exec_s, 1e-12) / 1e9

    @property
    def padding_efficiency(self) -> float:
        return self.dp_cells / max(self.padded_cells, 1)

    def as_dict(self) -> dict:
        return {
            "n_jobs": self.n_jobs,
            "dp_cells": self.dp_cells,
            "pack_s": round(self.pack_s, 6),
            "exec_s": round(self.exec_s, 6),
            "gcups": round(self.gcups, 3),
            "padding_efficiency": round(self.padding_efficiency, 4),
            "buckets": self.buckets,
            "fallback_jobs": self.fallback_jobs,
            "offloaded_jobs": self.offloaded_jobs,
            "xsharded_jobs": self.xsharded_jobs,
        }


def sw_bucket_stats(stats, buckets):
    """Add the true and the padded cell counts of SW buckets to stats."""
    for b in buckets:
        stats.dp_cells += int(((b.nx - 1).astype(np.int64) * (b.ny - 1)).sum())
        stats.padded_cells += int(b.sx.shape[1]) * 128 * int(
            b.ndiag_tile.astype(np.int64).sum()
        )


def phmm_bucket_stats(stats, buckets):
    for b in buckets:
        stats.dp_cells += int((b.rl.astype(np.int64) * b.hl).sum())
        stats.padded_cells += int(b.nxs) * 128 * int(
            b.ndiag_tile.astype(np.int64).sum()
        )


def _sw_cells(b) -> int:
    """The real DP cells of an SW bucket's pairs: sum of len(x) * len(y)
    (an empty slot's nx and ny are 1)."""
    return int(((b.nx - 1).astype(np.int64) * (b.ny - 1)).sum())


def _pair_cells(pairs) -> int:
    return sum(len(p.sx) * len(p.sy) for p in pairs)


def _residue_error(e: scoring.ResidueError, index, n: int) -> EngineError:
    """The engine's error for a byte outside the matrix's alphabet, naming
    the byte and the pair by its index in the call (``index`` maps the
    batch's to it)."""
    k = int(index[e.index]) if index is not None else e.index
    return EngineError("encode", 0, (n,), scoring.ResidueError(
        f"byte {bytes([e.byte])!r} ({e.byte}) of pair {k} is not a residue "
        "of the substitution matrix", k, e.byte))


def _shape(b):
    """The tile shape an error names: sx of an SW bucket, rchar (or the
    factored rchar_u) of a PairHMM bucket."""
    for name in ("sx", "rchar", "rchar_u"):
        a = getattr(b, name, None)
        if a is not None:
            return a.shape
    return None


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
                raise EngineError(stage, i, _shape(b), e) from e

    def dispatched(b):
        with trace.span("dispatch"):
            return dispatch(b)

    pending = [(i, b, retried(i, b, lambda: dispatched(b),
                              lambda: dispatched(b)))
               for i, b in enumerate(buckets)]
    if device.type == "cuda" and pending:
        trace.synchronize(device)
    return [retried(i, b, lambda: trace.to_host(r),
                    lambda: trace.to_host(dispatched(b)))
            for i, b, r in pending]


@trace.traced("plan")
def _jobs(batches):
    """(read, haplotype) of every PairHMM job, in the flat read-major order
    of the reference's output."""
    return [(rd, hp) for b in batches for rd in b.reads
            for hp in b.haplotypes]


class Engine:
    def __init__(self, cfg: EngineConfig = EngineConfig(),
                 sw_cfg: SWConfig = SWConfig(),
                 phmm_cfg: PairHMMConfig = PairHMMConfig(), device="cuda"):
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device {self.device}: want cuda or cpu")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: torch finds no CUDA "
                               "device on this host")
        self.cfg = cfg
        self.sw_cfg = sw_cfg.validate()
        self.phmm_cfg = phmm_cfg
        self.last_stats: RunStats | None = None
        # Under a substitution matrix: its name, the residue codes the
        # packs encode by, and its code table on the engine's device,
        # copied once.
        self._matrix = scoring.matrix_of(sw_cfg)
        if self._matrix is not None and cfg.sw_stack >= 2:
            raise ValueError(
                f"sw_stack={cfg.sw_stack}: the stacked route (sw_stacked) "
                f"does not score a substitution matrix ({self._matrix}); "
                "leave sw_stack below 2")
        self._codes = (None if self._matrix is None
                       else scoring.code_lut(self._matrix))
        self._sub_table = scoring.device_table(sw_cfg, self.device)

    # -- Smith-Waterman ----------------------------------------------------

    def _stream_band(self):
        """The stream-band gate of ``pack_sw_pairs`` (the JAX engine's
        ``_stream_band`` with ``stream_band_transfer`` on), shared by the
        engine, the stream and the sweep so that it cannot drift: under
        ``sw_stack`` >= 2 a predicate of the bucket's nxs that keeps the
        band only past ``stack_max_nxs``, where no bucket stacks (the
        stacked re-pack slices the full host stream); True otherwise. The
        CPU route packs the same band as the card."""
        if self.cfg.sw_stack >= 2:
            return lambda nxs: nxs > self.cfg.stack_max_nxs
        return True

    def _sw_prep(self, b):
        """(route, launch) of bucket b: the prep and the copies to the
        device done, ``launch()`` the kernel call alone, returning its
        (rows, 128) scores. The routing of
        genomax.engine.executor.Engine._sw_bucket: "strips" where its
        predicate takes the bucket, then "rotor" where its predicate does
        (never under sw_stack >= 2), then "stacked" where its predicate
        does, else "tile", the lane-tile kernel. The rotor's and the stacked
        kernel's rows come back in bucket tile order (the stack's pad tiles
        last, past n_valid), so unpack_scores needs no change. The engine
        and the sweep (``bench/sweep.py``) share it."""
        tab = self._sub_table
        prep = maybe_prep_strips(self.cfg, b, self._matrix is not None)
        if prep is not None:
            (_, _, _, nyt), statics = prep
            t, ny_max = sw_strips_to_torch(prep, b, self.device), int(nyt.max())
            return "strips", lambda: sw_forward_strips(
                *t, ny_max=ny_max, cfg=self.sw_cfg, table=tab, **statics)
        prep = maybe_prep_rotor(self.cfg, b)
        if prep is not None:
            t = sw_rotor_to_torch(prep, self.device)
            return "rotor", lambda: sw_forward_rotor_bucket(
                *t, cfg=self.sw_cfg, table=tab, **prep[1])
        prep = maybe_prep_stacked(self.cfg, b)
        if prep is not None:
            t = sw_stacked_to_torch(prep, self.device)
            return "stacked", lambda: sw_forward_stacked(
                *t, cfg=self.sw_cfg, **prep[1])
        t = sw_bucket_to_torch(b, self.device)
        return "tile", lambda: sw_forward(*t, self.sw_cfg, table=tab)

    def _sw_bucket(self, b):
        """Bucket b scored on its route; its real cells counted under
        ``cells.<route>``."""
        route, launch = self._sw_prep(b)
        trace.count("cells." + route, _sw_cells(b))
        return launch()

    @trace.traced("plan")
    def _sw_offload_mask(self, pairs):
        """True = not for the bucket path; ``_sw_offload_post`` scores
        these. The JAX engine's predicate (len(x) + 2 past max_device_len,
        or the diagonals past max_device_diags), and a pair past the lane
        tile's tallest bucket (MAX_KERNEL_ROWS: a CUDA block's 1,024
        threads) whose bucket strips would not take (``sw_strips.takes``
        on the bucket the pack makes of the pair's x level), so that the
        lane tile is never handed a bucket it cannot hold."""
        L, D = self.cfg.max_device_len, self.cfg.max_device_diags
        _, lx = sw_sides(pairs, "sx")
        _, ly = sw_sides(pairs, "sy")
        m = (lx + 2 > L) | (lx + ly + 1 > D)
        tall = ~m & (lx + 2 > MAX_KERNEL_ROWS)
        if tall.any():
            level = bucket_levels(lx)
            for v in np.unique(level[tall]):
                b = ~m & (level == v)
                nxs = bucket_rows(int(lx[b].max()))
                if not takes(self.cfg, nxs, int(ly[b].max()) + 1,
                             self._matrix is not None):
                    m |= tall & (level == v)
        return m if m.any() else None

    @trace.traced("call")
    def sw_scores(self, pairs) -> np.ndarray:
        """Scores for SWPair jobs, in input order. Under a substitution
        matrix a byte outside its alphabet raises :class:`EngineError`
        (stage "encode") naming the byte and the pair."""
        stats = RunStats(n_jobs=len(pairs))
        off = self._sw_offload_mask(pairs)
        with trace.timed("pack") as t:
            try:
                buckets = pack_sw_pairs(
                    pairs, job_mask=None if off is None else ~off,
                    stream_band=self._stream_band(), codes=self._codes)
            except scoring.ResidueError as e:
                raise _residue_error(e, None, len(pairs)) from e
        stats.pack_s = t.seconds
        stats.buckets = len(buckets)
        sw_bucket_stats(stats, buckets)
        with trace.timed("execute") as t:
            results = self._sw_run(buckets)
        stats.exec_s = t.seconds
        out = unpack_scores(buckets, results, len(pairs), np.int32)
        self._sw_offload_post(pairs, out, off, stats)
        self.last_stats = stats
        return out

    def _sw_run(self, buckets) -> list[np.ndarray]:
        """(NT, 128) scores of each bucket on the host (``ShardedEngine``
        shares them over its mesh)."""
        return _run_buckets("sw", buckets, self._sw_bucket, self.device)

    def _sw_long_ok(self, pairs, idx) -> np.ndarray:
        """True where the offloaded pair pairs[i], i in idx, takes the
        long-pair kernel on the device, False where the native model."""
        return np.array([len(pairs[i].sx) + len(pairs[i].sy)
                         <= self.cfg.max_device_diags for i in idx],
                        dtype=bool)

    @trace.traced("offload")
    def _sw_offload_post(self, pairs, out, off, stats):
        """Score the pairs the lane-tile kernel does not take, pair by
        pair: the long-pair kernel on the engine's device up to
        ``max_device_diags`` (in tiles of 128, in input order), the native
        model past it. A failure of the long-pair kernel raises
        :class:`EngineError`; nothing falls back to the native model."""
        if off is None:
            return
        idx = np.nonzero(off)[0]
        stats.offloaded_jobs += len(idx)
        dev_ok = self._sw_long_ok(pairs, idx)
        if dev_ok.any():
            didx = idx[dev_ok]
            long_pairs = [pairs[i] for i in didx]
            trace.count("cells.sw_long", _pair_cells(long_pairs))
            kw = {} if self._matrix is None else {"table": self._sub_table}
            try:
                out[didx] = sw_scores_long(long_pairs, self.sw_cfg,
                                           device=self.device, **kw)
            except scoring.ResidueError as e:
                raise _residue_error(e, didx, len(pairs)) from e
            except Exception as e:
                raise EngineError("sw_long", 0, (len(didx),), e) from e
        nat = idx[~dev_ok]
        if len(nat):
            nat_pairs = [pairs[i] for i in nat]
            trace.count("cells.native", _pair_cells(nat_pairs))
            try:
                out[nat] = native.sw_scores_native(nat_pairs, self.sw_cfg)
            except scoring.ResidueError as e:
                raise _residue_error(e, nat, len(pairs)) from e

    def sw_scores_file(self, path: str) -> np.ndarray:
        return self.sw_scores(parse_sw_file(path))

    # -- PairHMM -----------------------------------------------------------

    def _phmm_prep(self, b):
        """``launch`` of bucket b: the copies to the device and the
        expansion done, ``launch()`` the kernel call alone, returning its
        (NT, 128) log10 likelihoods. The engine and the sweep share it."""
        t = phmm_bucket_to_torch(b, self.device,
                                 float(self.phmm_cfg.phred_offset))
        return lambda: pairhmm_forward(*t,
                                       rescale_period=self.cfg.rescale_period,
                                       mm_div=self.phmm_cfg.mm_div,
                                       bitmask=b.bitmask_codes)

    def _phmm_bucket(self, b):
        return self._phmm_prep(b)()

    def _phmm_pack(self, batches, job_mask=None):
        """(buckets, n_jobs): the engine's pack of PairHMM batches (byte
        qualities, factored, bitmask codes), jobs where job_mask is False
        left out. Every route that packs PairHMM (the engine, the stream,
        the sweep) packs here."""
        return pack_pairhmm_batches(
            batches, self.phmm_cfg.phred_offset, job_mask=job_mask,
            byte_quals=True, factored=True, bitmask_codes=True)

    @trace.traced("plan")
    def _phmm_offload_mask(self, jobs):
        """True = too big for the lane-tile kernel. PairHMM applies half
        the SW bounds, as the JAX engine does, so that kernel sees at most
        max_device_len // 2 read rows (512 at the default: one warp a pair
        up to 512, a block of warps past it), and no more than its tallest
        bucket (MAX_PHMM_ROWS: reads past 8,190 bases take the long-read
        kernel)."""
        L = min(self.cfg.max_device_len // 2, MAX_PHMM_ROWS)
        D = self.cfg.max_device_diags // 2
        off = np.array([len(rd.bases) + 2 > L or len(rd.bases) + len(hp) + 1 > D
                        for rd, hp in jobs], dtype=bool)
        return off if off.any() else None

    @trace.traced("call")
    def pairhmm(self, batches) -> np.ndarray:
        """log10 likelihoods of every read x haplotype job across batches,
        in the reference's output order (batches in file order, read-major
        within a batch)."""
        stats = RunStats()
        jobs = _jobs(batches)
        off = self._phmm_offload_mask(jobs)
        with trace.timed("pack") as t:
            buckets, n = self._phmm_pack(batches,
                                         None if off is None else ~off)
        stats.pack_s = t.seconds
        stats.n_jobs = n
        stats.buckets = len(buckets)
        phmm_bucket_stats(stats, buckets)
        with trace.timed("execute") as t:
            results = self._phmm_run(buckets)
        stats.exec_s = t.seconds
        out = unpack_scores(buckets, results, n, np.float32)
        out, native_done = self._phmm_offload_post(jobs, out, off, stats)
        out = self._phmm_fallback(jobs, out, stats, native_done=native_done)
        self.last_stats = stats
        return out

    def _phmm_run(self, buckets) -> list[np.ndarray]:
        """(NT, 128) log10 likelihoods of each bucket on the host."""
        return _run_buckets("pairhmm", buckets, self._phmm_bucket,
                            self.device)

    @trace.traced("offload")
    def _phmm_offload_post(self, jobs, out, off, stats):
        """Score the jobs the lane-tile kernel does not take: the long-read
        kernel on the device up to ``max_device_diags``, the native fp64
        model past it. Returns (out, native_done), native_done marking the
        jobs already exact (the long-read kernel's results still take the
        fallback). A failure of the long-read kernel raises
        :class:`EngineError`; nothing falls back to the native model."""
        if off is None:
            return out, None
        idx = np.nonzero(off)[0]
        stats.offloaded_jobs += len(idx)
        dev_ok = np.array([len(jobs[i][0].bases) + len(jobs[i][1]) + 1
                           <= self.cfg.max_device_diags for i in idx],
                          dtype=bool)
        if dev_ok.any():
            didx = idx[dev_ok]
            try:
                out[didx] = pairhmm_long([jobs[i] for i in didx],
                                         self.phmm_cfg.phred_offset,
                                         device=self.device,
                                         mm_div=self.phmm_cfg.mm_div)
            except Exception as e:
                raise EngineError("pairhmm_long", 0, (len(didx),), e) from e
        nat = idx[~dev_ok]
        if not len(nat):
            return out, None
        out = self._phmm_native_subset(jobs, out, nat)
        native_done = np.zeros(len(out), bool)
        native_done[nat] = True
        return out, native_done

    def _phmm_native_subset(self, jobs, out, idx):
        """Recompute the flat job indices ``idx`` with the native fp64 model
        and scatter them into out, promoted to float64."""
        exact = native.pairhmm_native(
            [PairHMMBatch(reads=[jobs[i][0]], haplotypes=[jobs[i][1]])
             for i in idx],
            self.phmm_cfg.phred_offset, self.phmm_cfg.gatk_emission)
        out = out.astype(np.float64)
        out[idx] = exact
        return out

    @trace.traced("fallback")
    def _phmm_fallback(self, jobs, out, stats, native_done=None):
        """Recompute results below the threshold, or not finite, in native
        fp64: the fp32 path holds 1e-4 only above about -50 log10. Jobs the
        native model already scored are skipped."""
        thr = self.cfg.phmm_fallback_threshold
        if thr is None:
            return out
        mask = ~np.isfinite(out) | (out < thr)
        if native_done is not None:
            mask &= ~native_done
        if not mask.any():
            return out
        stats.fallback_jobs += int(mask.sum())
        return self._phmm_native_subset(jobs, out, np.nonzero(mask)[0])

    def pairhmm_file(self, path: str) -> np.ndarray:
        return self.pairhmm(parse_pairhmm_file(path))

    # -- Streaming (chunked, the pack overlapped with the run) -------------

    @trace.traced("call")
    def sw_scores_stream(self, pairs, chunk_pairs: int = 65536) -> np.ndarray:
        """``sw_scores`` over chunks, the next chunk packed in a worker
        thread while this one runs (``engine/stream.py``). It does not
        score a substitution matrix: such a config raises before any
        work."""
        from genomax_torch.engine.stream import sw_scores_stream

        scoring.refuse(self.sw_cfg, "sw_scores_stream")
        return sw_scores_stream(self, pairs, chunk_pairs)

    @trace.traced("call")
    def pairhmm_stream(self, batches, chunk_batches: int = 64) -> np.ndarray:
        """``pairhmm`` over chunks of batches with the pack overlapped."""
        from genomax_torch.engine.stream import pairhmm_stream

        return pairhmm_stream(self, batches, chunk_batches)
