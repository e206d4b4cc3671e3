"""Ragged-length packing: bucket, pad and lay out alignment jobs as dense
tiles for the wavefront kernels. A copy of ``genomax/pack/bucketing.py``
that produces the same arrays bit for bit, the stream band
(:class:`StreamBand`, ``pack_sw_pairs(stream_band=...)``) included; the
pure-Python fill loops are left out: the native fill always runs, see
``native``.

Ragged lengths are handled exactly by the kernels' pad-code decay (see
kernels/wavefront.py); bucketing by padded shape only controls padding
waste and the number of launches.

Layout (layout.py): a tile is 128 pairs side by side on the last axis;
the x/read sequence runs along the row axis, padded to a multiple of 8.

Pairs inside a bucket are sorted by diagonal count so that each 128-pair
tile runs only as many wavefront steps as its longest member; the
original order is restored through ``perm`` at unpack time.

PairHMM read x haplotype cross-products are materialized as index maps
into per-read and per-haplotype tables, not re-parsed per pair like the
reference host loop.
"""

from __future__ import annotations

import dataclasses
import operator

import numpy as np

from genomax_torch import native, trace
from genomax_torch.layout import (LANES, MAX_UNROLL, PAD_STREAM, PAD_X,
                                  STREAM_CHUNK, SUB_Q)

# One-hot match-bitmask code table (PairHMMPacked.bitmask_codes): byte ->
# 4-bit base mask; N -> all four; everything else (incl. both pad codes)
# -> 0 = matches nothing. _BM_OK marks the bytes whose translated
# semantics are EXACTLY the reference's byte-equality + N-wildcard rules.
_BM_LUT = np.zeros(256, np.int8)
_BM_LUT[ord("A")] = 1
_BM_LUT[ord("C")] = 2
_BM_LUT[ord("G")] = 4
_BM_LUT[ord("T")] = 8
_BM_LUT[ord("N")] = 15
_BM_OK = np.zeros(256, bool)
for _b in (ord("A"), ord("C"), ord("G"), ord("T"), ord("N"), PAD_X,
           PAD_STREAM):
    _BM_OK[_b] = True
_BM_OK_U8 = _BM_OK.view(np.uint8)  # for gx_rows_ok
_RAW_CODES = np.arange(256, dtype=np.uint8).view(np.int8)  # byte -> itself


def _bitmask_translate(rchar, hap):
    """Translate packed byte codes to match-bitmask codes in place.
    Returns True on success, False (arrays untouched) when any byte
    falls outside the ACGTN+pad alphabet (exact byte-equality semantics
    then require the two-compare emission path)."""
    ru = rchar.view(np.uint8)
    hu = hap.view(np.uint8)
    if not (_BM_OK[ru].all() and _BM_OK[hu].all()):
        return False
    np.take(_BM_LUT, ru, out=rchar)
    np.take(_BM_LUT, hu, out=hap)
    return True


def _round_up(x: int, q: int) -> int:
    return max(q, ((x + q - 1) // q) * q)


def _reject_pad_codes(data: np.ndarray, what: str) -> None:
    """Sequences must not contain the pad byte values (0 and 1): the
    mask-free kernels rely on pads mismatching every real code. The
    reference's own strlen-based parsing cannot produce such bytes
    inside a sequence (NUL terminates the line, SOH never appears in
    text), so this only fires on corrupt/non-reference inputs — loudly,
    instead of silently mis-scoring. One min() pass; real code bytes
    are ASCII >= 10."""
    if data.size and int(data.min()) <= max(PAD_X, PAD_STREAM):
        bad = int(data[(data == PAD_X) | (data == PAD_STREAM)][0])
        raise ValueError(
            f"{what} contains reserved byte {bad!r}: sequence bytes 0 and 1 "
            f"are pad codes (cannot appear in reference-format inputs)"
        )


def _reject_bad_read(rd, phred_offset: float) -> None:
    """Shared read validation for every PairHMM packer (batched, long).
    Mismatched quality lengths and out-of-range quality bytes are
    rejected loudly, same policy as pad codes: a qual byte below the
    phred offset decodes to an error probability > 1 in the reference
    (pairHMMmatrix.c:20-30 does 10^(-(c-33)/10) on whatever byte
    arrives) and > 127 wraps negative through its signed char — both
    malformed inputs that genomax's several decode paths (fp32 tables,
    byte-shipping, phred LUT) would otherwise decode differently from
    the reference and from each other."""
    L = len(rd.bases)
    if not (len(rd.base_q) == len(rd.ins_q) == len(rd.del_q)
            == len(rd.gcp_q) == L):
        raise ValueError(
            f"read with {L} bases has quality strings of lengths "
            f"{len(rd.base_q)}/{len(rd.ins_q)}/{len(rd.del_q)}/"
            f"{len(rd.gcp_q)} — all five fields must match "
            f"(pairHMMmatrix.c:214: len = (strlen-4)/5)"
        )
    if L:
        qcat = np.frombuffer(
            rd.base_q + rd.ins_q + rd.del_q + rd.gcp_q, np.uint8)
        if int(qcat.min()) < int(phred_offset) or qcat.max() > 127:
            raise ValueError(
                f"quality byte out of range [{int(phred_offset)}, "
                f"127] in read quals (got min {int(qcat.min())}, "
                f"max {int(qcat.max())}); phred+{int(phred_offset)} "
                f"qualities cannot decode to probabilities > 1"
            )


def _reject_bad_reads(reads, base_off, quals, phred_offset: float) -> None:
    """``_reject_bad_read`` on every read at once, from the joined fields:
    the offsets of the four quality strings (``quals``: (data, off) pairs)
    must be the bases' (``base_off``), and every quality byte must lie in
    range. On a failure ``_reject_bad_read`` runs read by read, so that
    the first bad read raises its own message."""
    ok = all(np.array_equal(off, base_off) for _, off in quals)
    if ok and base_off[-1]:
        lo, n = int(phred_offset), base_off[-1]
        ok = all(int(q[:n].min()) >= lo and int(q[:n].max()) <= 127
                 for q, _ in quals)
    if not ok:
        for rd in reads:
            _reject_bad_read(rd, phred_offset)


# ~x1.41 padding ladder (one octave), anchored so the common 512bp+"\n"
# case (515 rows) lands on 544 (5.6% padding). Scaled by powers of two.
_LADDER = (16, 24, 32, 48, 64, 96, 136, 192, 272, 384, 544, 768)


def _level(x: int) -> int:
    """Geometric padding level: the smallest ladder element >= x, floored
    at 64. Bounds the number of buckets (about 2 per octave) while capping
    per-dim padding waste at about 41%. The floor merges tiny-read
    buckets: their compute is negligible and every bucket is a launch.
    The ladder is the JAX package's, so both sides bucket alike."""
    x = max(x, 64)
    scale = 1
    while True:
        for lvl in _LADDER:
            if lvl * scale >= x:
                return lvl * scale
        scale *= 2


def bucket_levels(lengths) -> np.ndarray:
    """The bucket of each job: the ladder level (``_level``) of its x or
    read length plus 2 rows. The packs group by it, and the engine's SW
    offload mask asks it which pairs share a bucket. ``_level`` runs once
    per distinct length."""
    u, inv = np.unique(np.asarray(lengths, np.int64), return_inverse=True)
    return np.array([_level(int(n) + 2) for n in u], np.int64)[inv]


def bucket_rows(max_len: int) -> int:
    """The rows of a bucket whose longest x or read has max_len bases."""
    return _round_up(max_len + 2, SUB_Q)


def _quantize_tiles(n: int) -> int:
    """Pad a bucket's tile count to a quarter-octave level (1,2,3,4,5,6,
    8,10,12,16,20,24,32,...), as the JAX package does to bound its
    compiled shapes. Padding tiles sweep 1 diagonal."""
    t = max(1, (n + LANES - 1) // LANES)
    if t <= 8:
        return t
    p = 1
    while p * 2 < t:
        p *= 2
    return _round_up(t, max(1, p // 4))


@dataclasses.dataclass
class StreamBand:
    """The live band of a reversed stream buffer (``pack_sw_pairs``
    ``stream_band=True``): the full (NT, NDs, 128) buffer is zeros outside
    rows [A - max_len, A), because the anchor A is STREAM_CHUNK-quantized
    well above the longest stream and everything above A is the top pad
    region. Copying only the band to the device cuts the largest SW copy
    (the band is about max_len rows of NDs = A + NXs);
    ``pack.nibble.ship_stream`` rebuilds the full buffer on the device bit
    for bit (zeros and one slice insert), so no kernel changes.

    band : (NT, A - lo, 128) int8, rows [lo, A) of the full buffer; the
           codes of stream k at band row (A - lo) - 1 - k
    lo   : full-buffer row of band row 0 (SUB_Q-quantized, > 0)
    nds  : rows of the full buffer (= anchor + NXs)
    """

    band: np.ndarray
    lo: int
    nds: int

    @property
    def shape(self) -> tuple:
        # the full buffer's, for the routing reads that take only a shape
        # (the strips and stacked preps' geometry)
        return (self.band.shape[0], self.nds, self.band.shape[2])

    @property
    def dtype(self):
        return self.band.dtype

    def materialize(self) -> np.ndarray:
        """The full host buffer, byte for byte a stream_band=False pack's
        (for host consumers: the stacked re-pack, tests)."""
        nt, rows, lanes = self.band.shape
        full = np.zeros((nt, self.nds, lanes), self.band.dtype)
        full[:, self.lo: self.lo + rows, :] = self.band
        return full


@dataclasses.dataclass
class SWPacked:
    """One shape-bucket of SW jobs, densely packed.

    sx   : (NT, NXs, 128) int8 — row p of lane l holds that pair's
           sx[p-1]; out-of-range cells pad with code 1 (the stream pads
           with 0, so padded cells always mismatch and the kernels need
           no length masks)
    sy   : (NT, NDs, 128) int8 — the reversed diagonal stream, anchored
           at A = NDs - NXs (STREAM_CHUNK-quantized; layout.py): row
           A-1-k holds sy[k], so cell (x=p, y=j) compares against row
           A-j.
           A :class:`StreamBand` of it under ``stream_band``.
    nx,ny: (NP,) int32 — true matrix dims (len+1); padding rows use 1
    ndiag_tile: (NT,) int32 — max nx+ny-1 within each 128-pair tile
    perm : (n_valid,) int64 — original pair index of packed slot r
           (slot r = tile r//128, lane r%128)
    """

    sx: np.ndarray
    sy: np.ndarray
    nx: np.ndarray
    ny: np.ndarray
    ndiag_tile: np.ndarray
    perm: np.ndarray
    n_valid: int

    @property
    def max_diags(self) -> int:
        return int(self.ndiag_tile.max())


@dataclasses.dataclass
class PairHMMPacked:
    """One shape-bucket of read×haplotype jobs.

    The row axis is the read position (row i holds base/quality index
    i-1). rchar: (NT, NXs, 128) int8; qr/mmv/gapm/qi/qd/qg: same shape
    float32; hap: (NT, NDs, 128) int8 reversed diagonal stream (see
    SWPacked.sy); meta: (NT, 8, 128) int32, row 0 = read_len, row 1 =
    hap_len; rl/hl: (NP,) int32 true lengths (flat, for stats).

    byte_quals packs carry qb (NT, 4, NXs, 128) int8 instead — the RAW
    phred+33 bytes in planes base/ins/del/gcp, pads byte 0 — and
    qr..qg are None: the engine expands qb on the device
    (kernels.expand.expand_byte_quals) and copies fewer bytes to it.

    factored packs (byte_quals only) go further: the read×haplotype
    cross-product (pairHMMmatrix.c:207-258 — every read scores against
    every haplotype) means each read's bytes appear in NH job slots, so
    the pack ships each UNIQUE read/hap once — rchar_u (NRu+1, NXs),
    qb_u (NRu+1, 4, NXs), hap_u (NHu+1, NDs; reversed stream rows) —
    plus per-slot gather indices ridx/hidx (NT, 128) int32 (the +1 row
    is all-pads for padded lanes). The engine rebuilds the job tiles on
    the device (kernels.expand.expand_factored). rchar/qb/hap are None
    then."""

    rchar: np.ndarray | None
    qr: np.ndarray | None
    mmv: np.ndarray | None
    gapm: np.ndarray | None
    qi: np.ndarray | None
    qd: np.ndarray | None
    qg: np.ndarray | None
    hap: np.ndarray | None
    meta: np.ndarray
    rl: np.ndarray
    hl: np.ndarray
    ndiag_tile: np.ndarray
    perm: np.ndarray
    n_valid: int
    # True when rchar/hap carry one-hot MATCH-BITMASK codes instead of
    # raw bytes (A=1 C=2 G=4 T=8 N=15, pads 0): the kernels' emission
    # test becomes ONE and+compare, (bm & oh) != 0, replacing the
    # two-compare-plus-or byte form — including the hap-'N'
    # matches-everything rule (15 & anything-live != 0) and the read-'N'
    # rule (bm 15). Packs containing bytes outside {A,C,G,T,N} keep raw
    # bytes (False) for exact reference byte-equality semantics.
    bitmask_codes: bool = False
    qb: np.ndarray | None = None
    rchar_u: np.ndarray | None = None
    qb_u: np.ndarray | None = None
    hap_u: np.ndarray | None = None
    ridx: np.ndarray | None = None
    hidx: np.ndarray | None = None

    @property
    def max_diags(self) -> int:
        return int(self.ndiag_tile.max())

    @property
    def nxs(self) -> int:
        """Rows of the read axis, valid for both pack forms."""
        return (self.rchar if self.rchar is not None else self.rchar_u
                ).shape[1]

    @property
    def nds(self) -> int:
        """Stream-buffer rows (hap axis), valid for both pack forms."""
        return (self.hap if self.hap is not None else self.hap_u).shape[1]


def _tile_ndiags(ndiags: np.ndarray) -> np.ndarray:
    return ndiags.reshape(-1, LANES).max(axis=1).astype(np.int32)


def _full(shape, fill, dtype):
    """np.full through calloc'd pages: np.zeros + fill, which for the
    large pack buffers (most of them zero-filled) avoids touching
    malloc'd pages twice."""
    a = np.zeros(shape, dtype)
    if fill:
        a.fill(fill)
    return a


def pad_tiles_to(bucket, multiple: int):
    """Pad a packed bucket's tile count to a multiple (the stacked SW
    re-pack stacks ``multiple`` tiles deep; ``ShardedEngine`` splits the
    tiles over a mesh). Pad tiles carry all-pad codes and sweep a single
    diagonal; per-slot nx/ny/hl pad with 1, the rest with 0, a
    :class:`StreamBand`'s band with 0 (its lo and nds kept), and
    perm/n_valid still index the original job list."""
    nt = bucket.ndiag_tile.shape[0]
    want = _round_up(nt, multiple)
    if want == nt:
        return bucket
    extra = want - nt

    def padt(a, fill):
        pad = _full((extra,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, pad], axis=0)

    kw = {}
    for f in dataclasses.fields(bucket):
        v = getattr(bucket, f.name)
        if v is None:
            kw[f.name] = None
        elif f.name in ("perm", "n_valid"):
            kw[f.name] = v  # index into the ORIGINAL job list; never pad
        elif f.name == "ndiag_tile":
            kw[f.name] = padt(v, 1)
        elif f.name in ("sx", "rchar"):
            kw[f.name] = padt(v, PAD_X)
        elif f.name in ("sy", "hap"):
            if isinstance(v, StreamBand):
                kw[f.name] = dataclasses.replace(
                    v, band=padt(v.band, PAD_STREAM))
            else:
                kw[f.name] = padt(v, PAD_STREAM)
        elif f.name == "ridx":
            # Factored gather indices: pad tiles must point at the
            # all-pad row (last), NOT row 0 (a real read's bytes).
            kw[f.name] = padt(v, bucket.rchar_u.shape[0] - 1)
        elif f.name == "hidx":
            kw[f.name] = padt(v, bucket.hap_u.shape[0] - 1)
        elif f.name in ("rchar_u", "qb_u", "hap_u"):
            kw[f.name] = v  # unique-row tables are not tile-indexed
        elif isinstance(v, np.ndarray) and v.ndim >= 2 and v.shape[0] == nt:
            kw[f.name] = padt(v, 0)
        elif (isinstance(v, np.ndarray) and v.ndim == 1
              and v.shape[0] == nt * LANES):
            fill = 1 if f.name in ("hl", "nx", "ny") else 0
            pad = np.full(extra * LANES, fill, v.dtype)
            kw[f.name] = np.concatenate([v, pad])
        else:
            kw[f.name] = v
    return type(bucket)(**kw)


def sw_sides(pairs, side: str):
    """(seqs, lengths) of one side ("sx" or "sy") of SWPair jobs: the list
    of its byte strings and their lengths (int64), each in one pass that
    runs no Python a pair."""
    seqs = list(map(operator.attrgetter(side), pairs))
    return seqs, np.fromiter(map(len, seqs), np.int64, len(seqs))


def pack_sw_pairs(pairs, job_mask=None, stream_band=False,
                  codes: np.ndarray | None = None) -> list[SWPacked]:
    """Bucket and pack SWPair jobs. Sequences are raw bytes (the '\\n'
    quirk is preserved upstream by the parser: a trailing newline byte is
    part of the sequence). ``job_mask`` (bool, len(pairs)): pack only the
    True jobs; perm still indexes the original pair list, so results
    scatter back alongside jobs computed elsewhere (the long-pair kernel,
    the native offload).

    ``stream_band``: pack the stream as a :class:`StreamBand` (only the
    live rows [A - max_len, A); the engine rebuilds the full buffer on the
    device through ``pack.nibble.ship_stream``). A bool applies to every
    bucket; a callable is a predicate of the bucket's nxs
    (``Engine._stream_band``'s carve-out for the stacked re-pack).

    ``codes`` (``scoring.code_lut``, under a substitution matrix): the
    residues are encoded to the matrix's codes after the concat, in a
    ``pack.encode`` span, and a byte outside the alphabet raises
    ``scoring.ResidueError`` naming it and its pair; the packs hold the
    codes. None packs the bytes as they are.

    The per-pair fill loop is the native library's (gx_pack_sw_fill)."""
    lib = native.load()
    n = len(pairs)
    with trace.span("pack.flatten"):
        xs, sx_len = sw_sides(pairs, "sx")
        ys, sy_len = sw_sides(pairs, "sy")
    with trace.span("pack.concat"):
        # Masked-out pairs contribute empty slices: the fill never reads
        # their bytes, so they are not copied.
        keep = None if job_mask is None else np.asarray(job_mask, bool)
        sx_data, sx_off = native._concat_with_offsets(xs, sx_len, keep)
        sy_data, sy_off = native._concat_with_offsets(ys, sy_len, keep)
        if codes is None:
            _reject_pad_codes(sx_data[: sx_off[-1]], "sx")
            _reject_pad_codes(sy_data[: sy_off[-1]], "sy")
    if codes is not None:
        with trace.span("pack.encode"):
            sx_data = native.encode(sx_data, sx_off, codes, "pair")
            sy_data = native.encode(sy_data, sy_off, codes, "pair")
    with trace.span("pack.bucket"):
        # Bucket by the x (row) level only; see pack_pairhmm_batches.
        nxq = bucket_levels(sx_len)
        if job_mask is not None:
            nxq = np.where(np.asarray(job_mask), nxq, -1)
            n = int(np.asarray(job_mask).sum())
        levels = np.unique(nxq).tolist()

    out = []
    for lvl in levels:
        if lvl < 0:
            continue
        with trace.span("pack.bucket"):
            idx = np.nonzero(nxq == lvl)[0]
            # The ladder only groups; pad to the bucket's actual max
            # (8-quantum): the 512bp+newline case packs at 520 rows, not
            # 544.
            nxs = bucket_rows(int(sx_len[idx].max()))
            ndiags = (sx_len[idx] + sy_len[idx] + 1).astype(np.int64)
            order = np.argsort(ndiags, kind="stable")
            idx = idx[order]
            nt = _quantize_tiles(len(idx))
            slots = nt * LANES
            # Stream anchor A: codes at [A-len, A), cell (p, j) reads row
            # A-j. A >= ndiags + MAX_UNROLL keeps every sweep read in
            # bounds.
            anchor = _round_up(int(ndiags.max()) + MAX_UNROLL, STREAM_CHUNK)
            nds = anchor + nxs

        with trace.span("pack.fill"):
            # Tile layout (NT, rows, 128) written directly by the native
            # fill. PAD_STREAM is 0, so the big stream buffer comes
            # straight off calloc pages.
            sx = _full((nt, nxs, LANES), PAD_X, np.int8)
            band = stream_band(nxs) if callable(stream_band) else stream_band
            if band:
                # The live band only: codes occupy [anchor - max_len,
                # anchor); lo is SUB_Q-quantized and > 0 (anchor >=
                # ndiags.max() + MAX_UNROLL > max_len + 32). The fill
                # writes through a local anchor A' = anchor - lo with the
                # band's own row count, so the band's bytes are the full
                # buffer's.
                band_lo = (anchor - int(sy_len[idx].max())) // SUB_Q * SUB_Q
                if band_lo <= 0:  # a raise, not an assert: it must survive -O
                    raise AssertionError(
                        f"stream-band invariant violated: band_lo={band_lo} "
                        f"(anchor={anchor}, max_len={int(sy_len[idx].max())}"
                        "): the anchor no longer lies past max_len + "
                        "MAX_UNROLL")
                fill_anchor = fill_rows = anchor - band_lo
            else:
                fill_anchor, fill_rows = anchor, nds
            sy = _full((nt, fill_rows, LANES), PAD_STREAM, np.int8)
            nx = np.ones(slots, dtype=np.int32)
            ny = np.ones(slots, dtype=np.int32)
            lib.gx_pack_sw_fill(
                sx_data, sx_off, sy_data, sy_off,
                np.ascontiguousarray(idx), len(idx), nxs, fill_rows,
                fill_anchor, sx, sy, nx, ny,
            )
            if band:
                sy = StreamBand(band=sy, lo=band_lo, nds=nds)
            ndiag = (nx.astype(np.int64) + ny - 1).astype(np.int32)
            ndiag[len(idx):] = 1
            out.append(
                SWPacked(
                    sx=sx,
                    sy=sy,
                    nx=nx,
                    ny=ny,
                    ndiag_tile=_tile_ndiags(ndiag),
                    perm=idx,
                    n_valid=len(idx),
                )
            )
    assert sum(b.n_valid for b in out) == n
    return out


@trace.traced("unpack")
def unpack_scores(buckets, results, n_total: int, dtype=np.int32) -> np.ndarray:
    """Scatter per-bucket kernel outputs back to original pair order.
    Kernel outputs are (NT, 128) per bucket; slot r = (r//128, r%128)."""
    out = np.zeros(n_total, dtype=dtype)
    for b, r in zip(buckets, results):
        flat = np.asarray(r).reshape(-1)
        out[b.perm] = flat[: b.n_valid]
    return out


def _cross_jobs(n_reads: np.ndarray, n_haps: np.ndarray):
    """(jobs_r, jobs_h): the read-major cross-product of each batch's reads
    and haplotypes (batch b has n_reads[b] x n_haps[b] jobs), as indices
    into the reads and haplotypes of all batches in order."""
    per_read = np.repeat(n_haps, n_reads)  # the jobs of each read
    first_h = np.repeat(np.cumsum(n_haps) - n_haps, n_reads)
    first_job = np.cumsum(per_read) - per_read
    jobs_r = np.repeat(np.arange(len(per_read)), per_read)
    jobs_h = (np.arange(int(per_read.sum()))
              + np.repeat(first_h - first_job, per_read))
    return jobs_r, jobs_h


def _rows_with_codes(lib, data: np.ndarray, off: np.ndarray) -> np.ndarray:
    """Per row of joined byte strings (row k at data[off[k]:off[k + 1]]):
    True where every byte has a match-bitmask code (``_BM_OK``)."""
    ok = np.empty(len(off) - 1, np.uint8)
    lib.gx_rows_ok(data, off, len(ok), _BM_OK_U8, ok)
    return ok.view(bool)


def _unique_rows(rows: np.ndarray, n: int):
    """``np.unique(rows, return_inverse=True)`` of indices below n, through
    a mask of the n rows instead of a sort."""
    seen = np.zeros(n, bool)
    seen[rows] = True
    return np.flatnonzero(seen), (np.cumsum(seen) - 1)[rows]


def pack_pairhmm_batches(
    batches,
    phred_offset: float = 33.0,
    job_mask=None,
    byte_quals: bool = False,
    factored: bool = False,
    bitmask_codes: bool = False,
) -> tuple[list[PairHMMPacked], int]:
    """Flatten batches into the global read-major pair list (the reference
    output order, pairHMMmatrix.c:207-258), then bucket and pack the
    read×haplotype cross-product, with array work over all jobs and no
    Python loop over jobs or reads. The fill (with the phred decode) is the
    native library's: gx_pack_phmm_fill and gx_pack_phmm_fill_bytes per
    job, gx_pack_phmm_fill_factored per unique read and haplotype.

    byte_quals=True skips the phred decode and packs the raw quality
    bytes into PairHMMPacked.qb for expansion on the device (see the
    dataclass docstring); host consumers of qr..qg pack with the default.

    factored=True (implies byte_quals) also de-duplicates the
    cross-product: unique read/hap byte rows + per-slot gather indices,
    rebuilt into job tiles on the device (see the dataclass docstring).

    bitmask_codes=True opts in to translating ACGTN alphabets to 4-bit
    match-bitmask codes (PairHMMPacked.bitmask_codes). The default keeps
    raw byte codes, so a direct kernel caller that never reads the flag
    (kernels default bitmask=False) stays byte-equality-exact; the engine
    opts in and passes the flag on."""
    if factored:
        byte_quals = True
    lib = native.load()
    with trace.span("pack.flatten"):
        reads, haps, n_reads, n_haps = [], [], [], []
        for b in batches:
            reads += b.reads
            haps += b.haplotypes
            n_reads.append(len(b.reads))
            n_haps.append(len(b.haplotypes))
        fields = ([rd.bases for rd in reads], [rd.base_q for rd in reads],
                  [rd.ins_q for rd in reads], [rd.del_q for rd in reads],
                  [rd.gcp_q for rd in reads])
        jobs_r, jobs_h = _cross_jobs(np.array(n_reads, np.int64),
                                     np.array(n_haps, np.int64))
        n = len(jobs_r)
    with trace.span("pack.concat"):
        (rd_data, rd_off), *quals = map(native._concat_with_offsets, fields)
        _reject_bad_reads(reads, rd_off, quals, phred_offset)
        bq_data, iq_data, dq_data, gq_data = (q for q, _ in quals)
        _reject_pad_codes(rd_data[: rd_off[-1]], "read bases")
        hp_data, hp_off = native._concat_with_offsets(haps)
        _reject_pad_codes(hp_data[: hp_off[-1]], "haplotype")
        read_len = np.diff(rd_off)
        rlen = read_len[jobs_r]
        hlen = np.diff(hp_off)[jobs_h]
    with trace.span("pack.bucket"):
        # Bucket by the read (row) level only: the haplotype length only
        # sizes the per-bucket stream buffer and each tile's sweep bound
        # (tiles are sorted by diagonal count), so splitting on it would
        # just multiply kernel launches.
        nxq = bucket_levels(read_len)[jobs_r]
        if job_mask is not None:
            nxq = np.where(np.asarray(job_mask), nxq, -1)
        levels = np.unique(nxq)
    if factored and bitmask_codes:
        with trace.span("pack.translate"):
            read_ok = _rows_with_codes(lib, rd_data, rd_off)
            hap_ok = _rows_with_codes(lib, hp_data, hp_off)

    out = []
    for lvl in levels:
        if lvl < 0:
            continue
        with trace.span("pack.bucket"):
            idx = np.nonzero(nxq == lvl)[0]
            nxs = bucket_rows(int(rlen[idx].max()))  # see pack_sw_pairs
            order = np.argsort(rlen[idx] + hlen[idx], kind="stable")
            idx = idx[order]
            nt = _quantize_tiles(len(idx))
            slots = nt * LANES
            # Stream anchor: see pack_sw_pairs.
            anchor = _round_up(
                int((rlen[idx] + hlen[idx] + 1).max()) + MAX_UNROLL,
                STREAM_CHUNK)
            nds = anchor + nxs
            if factored:
                # Unique-row layout + gather indices (dataclass
                # docstring): NRu/NHu rows of bytes, one extra all-pad row
                # at the end for padded lanes. Row-major per read; the
                # device gather transposes back to the (NT, rows, 128) job
                # tiles.
                u_r, ridx_l = _unique_rows(jobs_r[idx], len(reads))
                u_h, hidx_l = _unique_rows(jobs_h[idx], len(haps))

        if factored:
            with trace.span("pack.fill"):
                # Bitmask codes only where every byte of the bucket's
                # unique rows has one (the pads always do); the fill
                # writes the codes.
                bm = bitmask_codes and bool(read_ok[u_r].all()
                                            and hap_ok[u_h].all())
                code = _BM_LUT if bm else _RAW_CODES
                nru, nhu = len(u_r), len(u_h)
                rchar_u = _full((nru + 1, nxs), code[PAD_X], np.int8)
                qb_u = np.zeros((nru + 1, 4, nxs), dtype=np.int8)
                hap_u = _full((nhu + 1, nds), code[PAD_STREAM], np.int8)
                lib.gx_pack_phmm_fill_factored(
                    rd_data, rd_off, bq_data, iq_data, dq_data, gq_data,
                    hp_data, hp_off, u_r, nru, u_h, nhu, nxs, nds, anchor,
                    code, rchar_u, qb_u, hap_u)
                ridx = np.full(slots, nru, dtype=np.int32)
                hidx = np.full(slots, nhu, dtype=np.int32)
                ridx[: len(idx)] = ridx_l
                hidx[: len(idx)] = hidx_l
                rl = np.zeros(slots, dtype=np.int32)
                hl = np.ones(slots, dtype=np.int32)
                rl[: len(idx)] = rlen[idx]
                hl[: len(idx)] = hlen[idx]
                ndiag = (rl.astype(np.int64) + hl + 1).astype(np.int32)
                ndiag[len(idx):] = 1
                meta = np.zeros((nt, 8, LANES), dtype=np.int32)
                meta[:, 0, :] = rl.reshape(nt, LANES)
                meta[:, 1, :] = hl.reshape(nt, LANES)
            out.append(
                PairHMMPacked(
                    rchar=None, qr=None, mmv=None, gapm=None, qi=None,
                    qd=None, qg=None, hap=None, meta=meta, rl=rl, hl=hl,
                    ndiag_tile=_tile_ndiags(ndiag),
                    perm=idx, n_valid=len(idx), bitmask_codes=bm,
                    rchar_u=rchar_u, qb_u=qb_u, hap_u=hap_u,
                    ridx=ridx.reshape(nt, LANES),
                    hidx=hidx.reshape(nt, LANES),
                )
            )
            continue

        with trace.span("pack.fill"):
            # Tile layout written directly (see pack_sw_pairs).
            rchar = _full((nt, nxs, LANES), PAD_X, np.int8)
            hap = _full((nt, nds, LANES), PAD_STREAM, np.int8)
            rl = np.zeros(slots, dtype=np.int32)
            hl = np.ones(slots, dtype=np.int32)
            fill_args = (rd_data, rd_off, bq_data, iq_data, dq_data,
                         gq_data, hp_data, hp_off, jobs_r, jobs_h,
                         np.ascontiguousarray(idx), len(idx), nxs, nds,
                         anchor)
            if byte_quals:
                qb = np.zeros((nt, 4, nxs, LANES), dtype=np.int8)
                qr = mmv = gapm = qi = qd = qg = None
                lib.gx_pack_phmm_fill_bytes(*fill_args, rchar, qb, hap, rl,
                                            hl)
            else:
                qb = None
                qr, mmv, gapm, qi, qd, qg = (
                    np.zeros((nt, nxs, LANES), dtype=np.float32)
                    for _ in range(6))
                lib.gx_pack_phmm_fill(*fill_args, phred_offset, rchar, qr,
                                      mmv, gapm, qi, qd, qg, hap, rl, hl)
            ndiag = (rl.astype(np.int64) + hl + 1).astype(np.int32)
            ndiag[len(idx):] = 1
            meta = np.zeros((nt, 8, LANES), dtype=np.int32)
            meta[:, 0, :] = rl.reshape(nt, LANES)
            meta[:, 1, :] = hl.reshape(nt, LANES)
        with trace.span("pack.translate"):
            bm = bitmask_codes and _bitmask_translate(rchar, hap)
        out.append(
            PairHMMPacked(
                rchar=rchar,
                qr=qr,
                mmv=mmv,
                gapm=gapm,
                qi=qi,
                qd=qd,
                qg=qg,
                hap=hap,
                meta=meta,
                rl=rl,
                hl=hl,
                ndiag_tile=_tile_ndiags(ndiag),
                perm=idx,
                n_valid=len(idx),
                bitmask_codes=bm,
                qb=qb,
            )
        )
    packed = sum(b.n_valid for b in out)
    assert packed == (n if job_mask is None else int(np.asarray(job_mask).sum()))
    return out, n
