"""Synthetic input generators.

Mirrors the capabilities of smithWaterman/generator.py:8-26 (random ATGC
pairs) but seeded and parameterized (the reference hardcodes MIN/MAX_LEN
450-500 and 500 alignments, and ignores the CLI args its sweep harness
hiprun.sh:20 tries to pass).
"""

from __future__ import annotations

import numpy as np

from genomax_torch.io.formats import (PairHMMBatch, PairHMMRead,
                                      write_sw_input)

_ALPHA = np.frombuffer(b"ATGC", dtype=np.uint8)


def random_dna(rng: np.random.Generator, length: int) -> bytes:
    return rng.choice(_ALPHA, size=length).tobytes()


def generate_sw_sequences(
    num_alignments: int = 500,
    min_len: int = 450,
    max_len: int = 500,
    seed: int = 0,
) -> list[bytes]:
    """2*num_alignments random sequences (the generator writes pairs as
    consecutive lines)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2 * num_alignments):
        out.append(random_dna(rng, int(rng.integers(min_len, max_len + 1))))
    return out


def write_sw_file(
    path: str,
    num_alignments: int = 500,
    min_len: int = 450,
    max_len: int = 500,
    seed: int = 0,
) -> None:
    """generator.py-equivalent file: header counts ALL written sequences so
    every pair is actually scored (the reference generator's header N with
    2N lines makes the C binaries skip half the file)."""
    seqs = generate_sw_sequences(num_alignments, min_len, max_len, seed)
    write_sw_input(path, seqs)


def generate_pairhmm_batch(
    num_reads: int,
    num_haps: int,
    read_len: int,
    hap_len: int,
    seed: int = 0,
    from_haps: bool = False,
):
    """A synthetic PairHMM batch with plausible phred ranges.

    from_haps=True generates the shape of real HaplotypeCaller input:
    the candidate haplotypes are SNP-variants (~1%) of one locus
    sequence, and each read is a substring of one of them with a
    ~0.5% substitution-error rate — so every read×hap pair in the
    cross product scores in a realistic band (reference test data
    10s.in trips the engine's -45 fp64 fallback on only 24/3550
    pairs). Independent random reads vs random haps (the default)
    score ~-300 and push EVERY pair through the fallback — useful for
    stressing that path, pathological as a throughput workload."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if from_haps:
        base = np.frombuffer(random_dna(rng, hap_len), np.uint8)
        hap_arrs = []
        for _ in range(num_haps):
            h = base.copy()
            snps = rng.random(hap_len) < 0.01
            if snps.any():
                h[snps] = acgt[rng.integers(0, 4, int(snps.sum()))]
            hap_arrs.append(h)
        haps = [h.tobytes() for h in hap_arrs]
    else:
        haps = [random_dna(rng, hap_len) for _ in range(num_haps)]
    reads = []
    for _ in range(num_reads):
        if from_haps:
            src = hap_arrs[int(rng.integers(len(hap_arrs)))]
            off = int(rng.integers(0, max(1, len(src) - read_len + 1)))
            bases = src[off : off + read_len].copy()
            errs = rng.random(len(bases)) < 0.005
            if errs.any():
                bases[errs] = rng.choice(acgt, int(errs.sum()))
            bases = bases.tobytes()
        else:
            bases = random_dna(rng, read_len)
        # quals must match len(bases), which from_haps clamps to the
        # haplotype length when read_len > hap_len
        L = len(bases)
        reads.append(
            PairHMMRead(
                bases=bases,
                base_q=(rng.integers(20, 41, L) + 33).astype(np.uint8).tobytes(),
                ins_q=(rng.integers(30, 46, L) + 33).astype(np.uint8).tobytes(),
                del_q=(rng.integers(30, 46, L) + 33).astype(np.uint8).tobytes(),
                gcp_q=(np.full(L, 10) + 33).astype(np.uint8).tobytes(),
            )
        )
    return PairHMMBatch(reads=reads, haplotypes=haps)
