"""Seeded cases shared by chip_smoke.py and the port's kernel tests.
PairHMM: ragged batches and deep-decay pairs for the lane-tile kernel, a
bucket whose haplotype stream is longer than the JAX engine's resident
limit, and jobs for the long-read kernel, some ending on a strip seam.
Smith-Waterman: a ragged tile for the long-pair kernel, pairs whose y
stream passes the same resident limit, ragged buckets
of 128 rows or more for the strips kernel, pairs ending on and next to
the sub-strip seams of the lane-tile and strips kernels, short buckets with the
queue adversaries for the rotor kernel, short buckets with the
ghost-read adversary for the stacked kernel, short pairs with the
queue-leak adversary and windows past one warp for the conveyor kernel,
and the cross-device wavefront's cases of tests/test_xsharded.py. Imports no jax and nothing of
the JAX package."""

import numpy as np

from genomax_torch.io.formats import PairHMMBatch, PairHMMRead, SWPair

def phmm_batches(seed, alphabet=b"ACGT", n_batches=12, max_read=500):
    """Ragged PairHMM batches: haplotypes of 1-700bp, variants of one
    locus, and reads of 1-`max_read`bp, most drawn from the locus with
    errors and some unrelated; N runs in reads and haplotypes; one
    all-mismatch deep-decay pair."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(alphabet, np.uint8)

    def noisy(s, rate):
        s = s.copy()
        hit = rng.random(len(s)) < rate
        s[hit] = rng.choice(abc, int(hit.sum()))
        if len(s) and rng.random() < 0.2:
            k = int(rng.integers(0, len(s)))
            s[k: k + int(rng.integers(1, 30))] = ord("N")
        return s

    def qual(n):
        return (rng.integers(10, 41, n) + 33).astype(np.uint8).tobytes()

    out = []
    for _ in range(n_batches):
        locus = rng.choice(abc, int(rng.integers(1, 701)))
        haps = [noisy(locus[int(rng.integers(0, max(1, len(locus) // 4))):],
                      0.01).tobytes()
                for _ in range(int(rng.integers(1, 9)))]
        reads = []
        for _ in range(int(rng.integers(1, 40))):
            n = int(rng.integers(1, max_read + 1))
            if rng.random() < 0.8:
                a = int(rng.integers(0, max(1, len(locus) - n + 1)))
                bases = noisy(locus[a: a + n], 0.005)
            else:
                bases = rng.choice(abc, n)
            m = len(bases)
            reads.append(PairHMMRead(bases=bases.tobytes(), base_q=qual(m),
                                     ins_q=qual(m), del_q=qual(m),
                                     gcp_q=qual(m)))
        out.append(PairHMMBatch(reads=reads, haplotypes=haps))
    q = bytes([73] * 60)
    out.append(PairHMMBatch(reads=[PairHMMRead(
        bases=b"A" * 60, base_q=q, ins_q=q, del_q=q, gcp_q=q)],
        haplotypes=[b"C" * 70]))
    return out


def short_phmm_batches(seed, alphabet=b"ACGT"):
    """Ragged batches of reads of 1-30bp (without phmm_batches' 60bp
    deep-decay pair): cut to their rows (tight_rows), a bucket a warp holds
    at one row a thread."""
    return phmm_batches(seed, alphabet, 3, max_read=30)[:-1]


def deep_decay_batches():
    """All-mismatch pairs in Q40 (A reads against C haplotypes) of 28bp and
    60bp, one a batch: every value decays by about 2^-13 a row, so a pair
    rescales at every period and its window can underflow inside one
    block. Packed one batch at a time and cut to their rows (tight_rows),
    buckets of 32 and 64 rows, so every R of the lane-tile kernel meets
    one."""
    out = []
    for n, h in ((28, 40), (60, 70)):
        q = bytes([73] * n)
        out.append(PairHMMBatch(reads=[PairHMMRead(
            bases=b"A" * n, base_q=q, ins_q=q, del_q=q, gcp_q=q)],
            haplotypes=[b"C" * h]))
    return out


def tight_rows(tensors, rl):
    """A packed bucket's tensors (phmm_bucket_to_torch's ten) cut to the
    fewest rows a multiple of 8 that hold its longest read (rl + 2), the
    stream kept at its anchor; the pack's padding ladder starts at 64
    rows, so this is how a bucket of 8-56 rows is made. Returns the
    tensors and the row count."""
    rchar, *planes, hap, meta, ndiag = tensors
    nxs = rchar.shape[1]
    n = min(nxs, -(-(int(rl.max()) + 2) // 8) * 8)
    anchor = hap.shape[1] - nxs
    return ([rchar[:, :n].contiguous()]
            + [q[:, :n].contiguous() for q in planes]
            + [hap[:, :anchor + n].contiguous(), meta, ndiag]), n


def _read(rng, bases, lo=10, hi=41):
    def qual():
        return (rng.integers(lo, hi, len(bases)) + 33).astype(np.uint8).tobytes()

    return PairHMMRead(bases=bytes(bases), base_q=qual(), ins_q=qual(),
                       del_q=qual(), gcp_q=qual())


def _noisy(rng, s, rate, abc):
    s = np.array(s, np.uint8)
    hit = rng.random(len(s)) < rate
    s[hit] = rng.choice(abc, int(hit.sum()))
    return s


def streamed_batches(seed, n_reads=24, read_len=151, hap_lens=(7000, 10000)):
    """One batch of 151bp reads against haplotypes of 7-10kbp: the packed
    haplotype stream is longer than the 6,144 rows the JAX engine keeps
    resident, so there these buckets take pairhmm_pallas._kernel_streamed.
    Reads are drawn from the haplotypes with errors, one holds an N run."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    locus = rng.choice(abc, hap_lens[1])
    haps = [_noisy(rng, locus[: int(n)], 0.01, abc)
            for n in np.linspace(hap_lens[0], hap_lens[1], 3).astype(int)]
    reads = []
    for k in range(n_reads):
        h = haps[k % len(haps)]
        a = int(rng.integers(0, len(h) - read_len))
        bases = _noisy(rng, h[a: a + read_len], 0.005, abc)
        if k == 0:
            bases[40:52] = ord("N")
        reads.append(_read(rng, bases))
    return [PairHMMBatch(reads=reads, haplotypes=[h.tobytes() for h in haps])]


def tall_phmm_batches(seed, n_reads=48, read_lens=(513, 2046),
                      hap_extra=300):
    """One batch for the lane-tile kernel's block form (buckets past 512
    rows, up to 2,048): reads of 513-2,046bp drawn with errors from three
    variants of one locus hap_extra bases longer than the longest read,
    some unrelated, N runs in reads and haplotypes; and one batch of two
    all-mismatch deep-decay pairs in Q40, 600bp and 1,500bp, whose window
    the block must rescale at every period (and can lose inside one)."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    locus = rng.choice(abc, read_lens[1] + hap_extra)
    haps = [_noisy(rng, locus, 0.01, abc) for _ in range(3)]
    haps[1][int(rng.integers(0, len(locus) - 40)):][:40] = ord("N")
    reads = []
    for k in range(n_reads):
        n = (read_lens[1] if k == 0 else
             int(rng.integers(read_lens[0], read_lens[1] + 1)))
        if k % 9 == 4:
            bases = rng.choice(abc, n)
        else:
            a = int(rng.integers(0, len(locus) - n + 1))
            bases = _noisy(rng, locus[a: a + n], 0.005, abc)
        if k % 6 == 1:
            bases[int(rng.integers(0, n - 30)):][:30] = ord("N")
        reads.append(_read(rng, bases))
    deep = [_read(rng, np.full(n, ord("A"), np.uint8), 40, 41)
            for n in (600, 1500)]
    return [PairHMMBatch(reads=reads, haplotypes=[h.tobytes() for h in haps]),
            PairHMMBatch(reads=deep, haplotypes=[b"C" * 1560])]


def tall_sw_pairs(seed, height, n_pairs=256, y_extra=1000, y_short=False,
                  x_min=None, y_less=200):
    """One bucket of ``height`` rows for the lane-tile and strips kernels
    past 1,024 rows: x of 3/4 height (or x_min: then the pairs span more
    than one ladder level, and so more than one bucket) to height - 2
    bases (the longest is height - 2), y planted with x with errors on two
    pairs in three, from x - y_less to x + y_extra bases long, or with
    y_short of 100 to 1,000 bases (a stream the JAX engine keeps resident
    at 2,048 rows). The last four pairs are an identical pair (its maximum
    runs through every warp's seam), a tandem repeat of a 300bp unit (its
    copies straddle the seams at every R), an all-mismatch pair and a
    one-base y."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    lo = 3 * height // 4 if x_min is None else x_min
    pairs = []
    for k in range(n_pairs - 4):
        n = height - 2 if k == 0 else int(rng.integers(lo, height - 1))
        x = rng.choice(abc, n)
        m = (int(rng.integers(100, 1001)) if y_short
             else int(rng.integers(n - y_less, n + y_extra + 1)))
        y = rng.choice(abc, m)
        if k % 3:
            w = min(n, m)
            a = int(rng.integers(0, m - w + 1))
            y[a: a + w] = _noisy(rng, x[:w], 0.05, abc)
        pairs.append(SWPair(sx=x.tobytes(), sy=y.tobytes()))
    same = rng.choice(abc, height - 2).tobytes()
    pairs.append(SWPair(sx=same, sy=same[: 1000] if y_short else same))
    unit = rng.choice(abc, 300).tobytes()
    x = (rng.choice(abc, lo - 600).tobytes() + unit * 3)[: height - 2]
    y = unit + rng.choice(abc, 41).tobytes() + unit * 2
    pairs.append(SWPair(sx=x, sy=y))
    pairs.append(SWPair(sx=b"A" * lo, sy=b"C" * (500 if y_short else lo)))
    pairs.append(SWPair(sx=same[:lo], sy=b"G"))
    return pairs


def hc_long_batches(seed, n_jobs, read_lens, hap_extra=(100, 400)):
    """PairHMM jobs of long reads as HaplotypeCaller scores them (amplicons
    and long-read windows of 2-8kbp), one batch a job: a haplotype of
    random DNA and a read drawn from it with one substitution a 1,000
    bases (about 0.1%), base qualities of 30-40, insertion and deletion
    qualities of 45 and gap continuation of 10, so that each job scores
    well above the engine's fp64 fallback threshold of -45 (random pairs
    would all take it). Reads of read_lens[0] to read_lens[1] bases, the
    first of the longest; haplotypes hap_extra longer."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for k in range(n_jobs):
        n = (read_lens[1] if k == 0 else
             int(rng.integers(read_lens[0], read_lens[1] + 1)))
        h = rng.choice(abc, n + int(rng.integers(*hap_extra)))
        a = int(rng.integers(0, len(h) - n + 1))
        bases = h[a: a + n].copy()
        for i in rng.choice(n, max(1, round(n / 1000)), replace=False):
            bases[i] = abc[(np.nonzero(abc == bases[i])[0][0]
                            + int(rng.integers(1, 4))) % 4]

        def qual(lo, hi):
            return (rng.integers(lo, hi + 1, n) + 33).astype(
                np.uint8).tobytes()

        read = PairHMMRead(bases=bases.tobytes(), base_q=qual(30, 40),
                           ins_q=qual(45, 45), del_q=qual(45, 45),
                           gcp_q=qual(10, 10))
        out.append(PairHMMBatch(reads=[read], haplotypes=[h.tobytes()]))
    return out


def long_jobs(seed, n_jobs=128, read_lens=(511, 1500), hap_max=2000):
    """(PairHMMRead, haplotype) jobs for the long-read kernel: reads of
    511-1500bp drawn with errors from haplotypes up to 2kbp, some
    unrelated; N runs in reads and haplotypes; an identical pair and an
    all-mismatch deep-decay pair."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    jobs = []
    for k in range(n_jobs - 2):
        n = int(rng.integers(read_lens[0], read_lens[1] + 1))
        h = _noisy(rng, rng.choice(abc, int(rng.integers(n, hap_max + 1))),
                   0.0, abc)
        if k % 5 == 0:
            h[int(rng.integers(0, len(h) - 20)):][:20] = ord("N")
        if k % 7 == 3:
            bases = rng.choice(abc, n)
        else:
            a = int(rng.integers(0, len(h) - n + 1))
            bases = _noisy(rng, h[a: a + n], 0.005, abc)
        if k % 4 == 1:
            bases[int(rng.integers(0, n - 30)):][:30] = ord("N")
        jobs.append((_read(rng, bases), h.tobytes()))
    same = rng.choice(abc, read_lens[0] + 89)
    jobs.append((_read(rng, same, 40, 41), same.tobytes()))
    jobs.append((_read(rng, np.full(700, ord("A"), np.uint8), 40, 41),
                 b"C" * 760))
    return jobs


def long_seam_jobs(seed, strip_w=256):
    """Long-read jobs whose reads end on a strip seam (the last row of strip
    k, so strip k+1 runs with no live row of its own and only rescales):
    one strip (W - 1 bases), two and three strips, the three-strip read an
    all-mismatch deep-decay pair; and a read of one base past the seam."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    jobs = []
    for k in (1, 2):
        h = rng.choice(abc, k * strip_w + 150)
        a = int(rng.integers(0, 100))
        jobs.append((_read(rng, _noisy(rng, h[a:a + k * strip_w - 1], 0.01,
                                       abc)), h.tobytes()))
    n = 3 * strip_w - 1
    jobs.append((_read(rng, np.full(n, ord("A"), np.uint8), 40, 41),
                 b"C" * (n + 60)))
    h = rng.choice(abc, 2 * strip_w + 200)
    jobs.append((_read(rng, _noisy(rng, h[50:50 + 2 * strip_w], 0.01, abc)),
                 h.tobytes()))
    return jobs


def long_sw_pairs(seed, n_pairs=128, x_lens=(1023, 4000), y_max=5000,
                  seam=1024):
    """One tile for the long-pair SW kernel: x of 1,023-4,000bp, too long
    for the lane-tile kernel, against y up to 5kbp, x planted in y with
    errors on two pairs in three. The last four pairs are an identical pair
    (its maximum runs through every strip seam), a tandem repeat laid
    across row ``seam`` (a wrong Q hand-over there changes the score), an
    all-mismatch pair and a one-base pair."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for k in range(n_pairs - 4):
        x = rng.choice(abc, int(rng.integers(x_lens[0], x_lens[1] + 1)))
        y = rng.choice(abc, int(rng.integers(len(x), y_max + 1)))
        if k % 3:
            a = int(rng.integers(0, len(y) - len(x) + 1))
            y[a: a + len(x)] = _noisy(rng, x, 0.05, abc)
        pairs.append(SWPair(sx=x.tobytes(), sy=y.tobytes()))
    same = rng.choice(abc, x_lens[1]).tobytes()
    pairs.append(SWPair(sx=same, sy=same))
    unit = rng.choice(abc, 200).tobytes()
    head = rng.choice(abc, seam - 100).tobytes()  # copy 2 straddles the seam
    pairs.append(SWPair(
        sx=head + unit + unit,
        sy=head + unit + rng.choice(abc, 57).tobytes() + unit + unit))
    pairs.append(SWPair(sx=b"A" * x_lens[0], sy=b"C" * y_max))
    pairs.append(SWPair(sx=b"G", sy=b"G"))
    return pairs


def streamed_sw_pairs(seed, n_pairs=256, x_lens=(30, 600),
                      y_lens=(6000, 10000)):
    """Pairs whose y is 6-10kbp against x of 30-600bp planted in it with
    errors: the packed stream of every bucket passes the 6,144 rows the JAX
    engine keeps resident, so there these buckets take
    sw_pallas._kernel_streamed."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(n_pairs):
        x = rng.choice(abc, int(rng.integers(x_lens[0], x_lens[1] + 1)))
        y = rng.choice(abc, int(rng.integers(y_lens[0], y_lens[1] + 1)))
        a = int(rng.integers(0, len(y) - len(x) + 1))
        y[a: a + len(x)] = _noisy(rng, x, 0.03, abc)
        pairs.append(SWPair(sx=x.tobytes() + b"\n", sy=y.tobytes() + b"\n"))
    return pairs


def strips_sw_pairs(seed, n_pairs=300, x_lens=(126, 1000), y_extra=300):
    """Pairs whose buckets have 128 rows or more, the strips kernel's: x of
    126-1,000bp against y from half as long to y_extra longer, x planted in
    y with errors on two pairs in three. The last six pairs are an
    identical pair of x_lens[1] (its maximum runs through every strip
    seam), a tandem repeat of a 150bp unit (each copy straddles several
    seams at any strip width up to 150), an all-mismatch pair, a long x
    against a one-base y, a long x against an empty y (a lane that scores
    0 in a live bucket) and a one-base pair (in a small bucket)."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for k in range(n_pairs - 6):
        x = rng.choice(abc, int(rng.integers(x_lens[0], x_lens[1] + 1)))
        y = rng.choice(abc, int(rng.integers(len(x) // 2,
                                             len(x) + y_extra + 1)))
        if k % 3 and len(y) >= len(x):
            a = int(rng.integers(0, len(y) - len(x) + 1))
            y[a: a + len(x)] = _noisy(rng, x, 0.05, abc)
        pairs.append(SWPair(sx=x.tobytes(), sy=y.tobytes()))
    same = rng.choice(abc, x_lens[1]).tobytes()
    pairs.append(SWPair(sx=same, sy=same))
    unit = rng.choice(abc, 150).tobytes()
    pairs.append(SWPair(sx=rng.choice(abc, 37).tobytes() + unit + unit,
                        sy=unit + rng.choice(abc, 41).tobytes() + unit + unit))
    pairs.append(SWPair(sx=b"A" * 200, sy=b"C" * 300))
    pairs.append(SWPair(sx=same[:300], sy=b"G"))
    pairs.append(SWPair(sx=same[:400], sy=b""))
    pairs.append(SWPair(sx=b"T", sy=b"T"))
    return pairs


def height_sw_pairs(seed, heights, max_len=270, y_lens=(40, 300)):
    """Pairs whose x ends on or next to a seam of every sub-strip height
    H in `heights` (len x in kH - 1, kH, kH + 1 below max_len: the last
    row of the kernels' sub-strip k, rows 1 + kH .. start the next), y of
    y_lens bases, then a tandem repeat whose copies straddle the seams, an
    identical pair of 257 bases, an all-mismatch pair, a one-base y and an
    empty y (in that order, last)."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)

    def dna(n):
        return rng.choice(abc, n).tobytes()

    lens = sorted({k * h + e for h in heights for k in (1, 2, 3)
                   for e in (-1, 0, 1) if k * h + 1 < max_len})
    pairs = [SWPair(sx=dna(n), sy=dna(int(rng.integers(y_lens[0],
                                                        y_lens[1] + 1))))
             for n in lens]
    unit = dna(70)
    pairs.append(SWPair(sx=dna(37) + unit * 3, sy=unit + dna(41) + unit * 3))
    same = dna(257)
    pairs += [SWPair(sx=same, sy=same), SWPair(sx=b"A" * 200, sy=b"C" * 250),
              SWPair(sx=same[:150], sy=b"G"), SWPair(sx=same[:120], sy=b"")]
    return pairs


def rotor_sw_pairs(seed, length, n_pairs=640):
    """Short pairs for the rotor kernel: x of 3/4 length to length bases
    against y of half length to length, x planted in y with errors on two
    pairs in three. The last four pairs are an identical pair of ``length``
    (at the period's edge, nx = ny = T - 1, where length + 1 is a multiple
    of 8), an all-mismatch pair of that length, a long x against a
    one-base y and a one-base pair (in a bucket of its own)."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for k in range(n_pairs - 4):
        x = rng.choice(abc, int(rng.integers(3 * length // 4, length + 1)))
        y = rng.choice(abc, int(rng.integers(length // 2, length + 1)))
        if k % 3:
            n = min(len(x), len(y))
            a = int(rng.integers(0, len(y) - n + 1))
            y[a: a + n] = _noisy(rng, x[:n], 0.05, abc)
        pairs.append(SWPair(sx=x.tobytes(), sy=y.tobytes()))
    same = rng.choice(abc, length).tobytes()
    pairs.append(SWPair(sx=same, sy=same))
    pairs.append(SWPair(sx=b"A" * length, sy=b"C" * length))
    pairs.append(SWPair(sx=same, sy=b"G"))
    pairs.append(SWPair(sx=b"G", sy=b"G"))
    return pairs


def rotor_leak_pairs(seed, length, n_tiles=4):
    """The rotor's queue-leak adversary as one bucket: tiles of 128
    identical pairs of ``length`` and of 128 all-mismatch pairs of the
    same length, in turns. Every pair has the same diagonal count, so the
    pack keeps this order, and bucket tiles t and t+1 are consecutive
    slots of one lane queue wherever t % P < P - 1: a chain that crossed
    the boundary slot from the maximum-scoring pair would give the
    all-mismatch pair behind it a score above 0."""
    g = np.random.default_rng(seed).choice(
        np.frombuffer(b"ACGT", np.uint8), length).tobytes()
    tile = [[SWPair(sx=g, sy=g)] * 128,
            [SWPair(sx=b"A" * length, sy=b"T" * length)] * 128]
    return [p for k in range(n_tiles) for p in tile[k % 2]]


def stacked_sw_pairs(seed, max_x, n_pairs=600):
    """Short pairs for the stacked kernel, in one bucket of
    h = round_up(max_x + 2, 8) rows (max_x <= 94): x of max_x // 2 to
    max_x bases (63 to max_x past 62, the bucket ladder's step) against y
    of 1 to max_x + 2 (every y fits one region), x planted in y with
    errors on two pairs in three. The last pairs are an identical pair of
    max_x, an all-mismatch pair of that length, x of max_x against a
    one-base y and, where it joins the bucket (max_x <= 62), a one-base
    pair. 600 pairs fill five tiles, a count that 2, 3 and 4 do not divide
    (pad tiles)."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    same = rng.choice(abc, max_x).tobytes()
    special = [SWPair(sx=same, sy=same),
               SWPair(sx=b"A" * max_x, sy=b"C" * max_x),
               SWPair(sx=same, sy=b"G")]
    if max_x <= 62:
        special.append(SWPair(sx=b"G", sy=b"G"))
    lo = 63 if max_x > 62 else max(1, max_x // 2)
    pairs = []
    for k in range(n_pairs - len(special)):
        x = rng.choice(abc, int(rng.integers(lo, max_x + 1)))
        y = rng.choice(abc, int(rng.integers(1, max_x + 3)))
        if k % 3:
            n = min(len(x), len(y))
            a = int(rng.integers(0, len(y) - n + 1))
            y[a: a + n] = _noisy(rng, x[:n], 0.05, abc)
        pairs.append(SWPair(sx=x.tobytes(), sy=y.tobytes()))
    return pairs + special


def stacked_ghost_pairs(seed):
    """The directed ghost-read adversary of the stacked kernel
    (tests/test_pallas_interpret.py): 256 pairs of one shape, so the pack
    keeps their order and a stack of 2 puts pair l and pair 128 + l in
    adjacent regions of lane l. Pair l is A*50 against a 54-base y without
    an A; pair 128 + l is that y's first 50 bases against A*54. Every
    pair is all-mismatch against its own y and scores 0; a region that
    read its neighbour's stream would score up to 50."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    region0 = [SWPair(sx=b"A" * 50, sy=rng.choice(abc[1:], 54).tobytes())
               for _ in range(128)]
    region1 = [SWPair(sx=p.sy[:50], sy=b"A" * 54) for p in region0]
    return region0 + region1


# Lengths of x and y in the conveyor's kinds: ragged short pairs, y past the
# window (T > nxs), x longer than y, and x of at most 5 bases and a '\n' (a
# window of 8 rows, which one lane of 8 rows holds).
CONVEYOR_KINDS = {"ragged": ((5, 50), (5, 50)), "long-y": ((5, 19), (60, 99)),
                  "long-x": ((30, 60), (5, 25)), "tiny": ((1, 5), (1, 20))}


def conveyor_sw_pairs(seed, kind, n_pairs=300):
    """Short pairs for the conveyor kernel (kernels/sw_conveyor.py): x and
    y lengths from CONVEYOR_KINDS[kind], x planted in y with errors on two
    pairs in three, a trailing '\\n' on every other pair (a base of both
    sequences, as in a file). 300 pairs queue two slots deep at
    max_slots 2 and three deep from 3. The last five pairs are an
    identical pair, an all-mismatch pair, a one-base pair, a one-base x
    against the longest y and the longest x against a one-base y, none
    with a '\\n'. "long-y" packs T = 104 > nxs = 24, so some steps have no
    switching row."""
    (xlo, xhi), (ylo, yhi) = CONVEYOR_KINDS[kind]
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for k in range(n_pairs - 5):
        x = rng.choice(abc, int(rng.integers(xlo, xhi + 1)))
        y = rng.choice(abc, int(rng.integers(ylo, yhi + 1)))
        if k % 3:
            n = min(len(x), len(y))
            a = int(rng.integers(0, len(y) - n + 1))
            b = int(rng.integers(0, len(x) - n + 1))
            y[a: a + n] = _noisy(rng, x[b: b + n], 0.05, abc)
        nl = b"\n" if k % 2 else b""
        pairs.append(SWPair(sx=x.tobytes() + nl, sy=y.tobytes() + nl))
    n = min(xhi, yhi)
    same = rng.choice(abc, n).tobytes()
    pairs += [SWPair(sx=same, sy=same), SWPair(sx=b"A" * n, sy=b"C" * n),
              SWPair(sx=b"G", sy=b"G"),
              SWPair(sx=b"T", sy=rng.choice(abc, yhi).tobytes()),
              SWPair(sx=rng.choice(abc, xhi).tobytes(), sy=b"A")]
    return pairs


def conveyor_tall_pairs(seed, x_max, n_pairs=160):
    """Pairs whose window is past one warp's 512 rows, for the conveyor
    kernel's block form: x of 600 .. x_max bases (the last pair exactly
    x_max, so nxs = round_up(x_max + 2, 8): 1,024 at x_max 1,022), y of
    600-1,000 bases with x planted in it with errors on two pairs in three,
    an identical pair and an all-mismatch pair. 160 pairs queue two slots
    deep in one tile at max_slots 2."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for k in range(n_pairs - 3):
        x = rng.choice(abc, int(rng.integers(600, x_max + 1)))
        y = rng.choice(abc, int(rng.integers(600, 1001)))
        if k % 3:
            n = min(len(x), len(y))
            a = int(rng.integers(0, len(y) - n + 1))
            b = int(rng.integers(0, len(x) - n + 1))
            y[a: a + n] = _noisy(rng, x[b: b + n], 0.05, abc)
        pairs.append(SWPair(sx=x.tobytes(), sy=y.tobytes()))
    same = rng.choice(abc, 600).tobytes()
    pairs += [SWPair(sx=same, sy=same), SWPair(sx=b"A" * 600, sy=b"C" * 800),
              SWPair(sx=rng.choice(abc, x_max).tobytes(),
                     sy=rng.choice(abc, 1000).tobytes())]
    return pairs


def conveyor_leak_pairs(seed, x_len, y_len):
    """The conveyor's queue-leak adversary: 128 pairs that score
    x_len * match (x the first x_len bases of y), 128 all-mismatch pairs
    of the same lengths, and both again. All have one y length, so the
    pack's stable sort keeps this order, and slot q of lane l holds pair
    128 q + l: at max_slots 2 and 4 every lane's queue runs
    maximum-scoring, all-mismatch in turns. A chain or a running max
    that crossed the switch row from a maximum-scoring pair would give the
    all-mismatch pair behind it a score above 0."""
    g = np.random.default_rng(seed).choice(
        np.frombuffer(b"ACGT", np.uint8), y_len).tobytes()
    same, miss = (SWPair(sx=g[:x_len], sy=g),
                  SWPair(sx=b"A" * x_len, sy=b"T" * y_len))
    return ([same] * 128 + [miss] * 128) * 2


def _xs_ragged(rng, n, lo, hi):
    pairs = []
    for _ in range(n):
        a = rng.choice(list(b"ATGC"), int(rng.integers(lo, hi)))
        b = rng.choice(list(b"ATGC"), int(rng.integers(lo, hi)))
        a, b = a.astype(np.uint8).tobytes(), b.astype(np.uint8).tobytes()
        if len(a) > len(b):
            a, b = b, a
        pairs.append(SWPair(sx=a, sy=b))
    return pairs


def xshard_cases():
    """(name, pairs, unroll) of the cross-device wavefront: the cases of
    tests/test_xsharded.py, from their seeds. Ragged 150-400bp pairs, an
    identical and a disjoint pair (the largest and the zero score across
    every strip seam), tiny pairs, unrolls 1, 2, 4 (the pack's anchor
    round-up) and 64, and a tandem repeat (a halo handed over a block late
    or from the wrong strip changes its score)."""
    rng = np.random.default_rng(5)
    x = rng.choice(list(b"ATGC"), 150).astype(np.uint8).tobytes()
    junk = rng.choice(list(b"ATGC"), 160).astype(np.uint8).tobytes()
    s = np.random.default_rng(1).choice(list(b"ATGC"), 300)
    s = s.astype(np.uint8).tobytes()
    small = _xs_ragged(np.random.default_rng(77), 6, 100, 260)
    return [
        ("ragged", _xs_ragged(np.random.default_rng(31), 16, 150, 400), 16),
        ("identical_disjoint",
         [SWPair(sx=s, sy=s), SWPair(sx=b"A" * 250, sy=b"T" * 350)], 16),
        ("tiny", [SWPair(sx=b"ACGT", sy=b"ACGTACGT"),
                  SWPair(sx=b"A", sy=b"A")], 8),
        ("unroll1", small, 1), ("unroll2", small, 2), ("unroll4", small, 4),
        ("unroll64", _xs_ragged(np.random.default_rng(3), 4, 150, 300), 64),
        ("tandem", [SWPair(sx=x, sy=x + junk + x)], 16),
    ]


def xstrip_inputs(seed, w, unroll, lanes=128):
    """Seeded inputs of one block of the cross-device strip kernel, as
    numpy arrays: x codes (w, lanes) and a stream slab (w+U, lanes) int8
    over ACGT with pad codes mixed in (1 in x, 0 in the stream), halos
    hD >= 0 and hQ (U, lanes) int32, and six (w, lanes) int32 state
    arrays of small signed values."""
    rng = np.random.default_rng(seed)
    codes = np.frombuffer(b"ACGT", np.uint8).astype(np.int8)
    sxb = rng.choice(np.append(codes, 1), (w, lanes)).astype(np.int8)
    slab = rng.choice(np.append(codes, 0), (w + unroll, lanes)).astype(np.int8)
    hD = rng.integers(0, 40, (unroll, lanes)).astype(np.int32)
    hQ = rng.integers(-40, 20, (unroll, lanes)).astype(np.int32)
    state = tuple(rng.integers(-40, 40, (w, lanes)).astype(np.int32)
                  for _ in range(6))
    return sxb, slab, hD, hQ, state
