"""Input/output file formats, reproducing the reference parsers faithfully.

Two formats exist in the reference:

* **SW pairs file** (smithWaterman/antidiagonalSmithWaterman.c:195-244,
  smithWaterman.cu:397-452): first line = an integer ``line_num``; then
  sequences one per line. The C loop ``for (i = 0; i < line_num; i += 2)``
  consumes two lines per iteration, so ``line_num`` counts *sequences
  consumed*, not pairs — a file whose header understates the number of
  lines silently ignores the tail (generator.py writes 2N sequences with
  header N, so the reference only ever scores the first N of them).

  ⚠ Parity-critical quirk: lengths are ``strlen()`` of the raw fgets line,
  so the trailing ``'\\n'`` is part of the sequence and matches itself
  (verified: ``AAAA`` vs ``TTTT`` scores 1 with trailing newlines). We keep
  sequences as raw bytes including that newline.

* **PairHMM batch file** (pairHMM/pairHMMmatrix.c:167-315): repeated
  batches of a ``"num_read num_haplotypes"`` header line, then ``num_read``
  read lines (five space-separated equal-length fields:
  ``bases baseQ insQ delQ gcpQ``; len = (strlen-4)/5, pairHMMmatrix.c:214),
  then ``num_haplotypes`` haplotype lines. The reference implements this
  with two offset streams over the same file; the layout itself is plainly
  sequential and that is how we parse it. Output: one ``"%f\\n"``
  log10-likelihood per read×haplotype pair, read-major, batches in file
  order (pairHMMmatrix.c:240-258).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SWPair:
    """One alignment job: sx = columns (shorter), sy = rows (longer).

    The host-side swap rule is ``if strlen(line1) > strlen(line2)`` then
    sx=line2 else sx=line1 (antidiagonalSmithWaterman.c:229-244): ties keep
    line1 as sx.
    """

    sx: bytes
    sy: bytes


@dataclasses.dataclass
class PairHMMRead:
    bases: bytes
    base_q: bytes  # raw phred+33 chars
    ins_q: bytes
    del_q: bytes
    gcp_q: bytes


@dataclasses.dataclass
class PairHMMBatch:
    reads: list
    haplotypes: list  # list[bytes]


def _sw_lines(data: bytes):
    """Split like repeated fgets(): every line keeps its trailing b'\\n'
    (the final line may lack one)."""
    lines = data.split(b"\n")
    out = [ln + b"\n" for ln in lines[:-1]]
    if lines[-1]:
        out.append(lines[-1])
    return out


def parse_sw_file(path: str) -> list[SWPair]:
    with open(path, "rb") as f:
        lines = _sw_lines(f.read())
    if not lines:
        raise ValueError("empty SW input file")
    try:
        line_num = int(lines[0])
        if line_num < 0:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"SW input must start with a sequence count line, got "
            f"{lines[0][:40]!r}"
        ) from None
    pairs = []
    li = 1
    i = 0
    while i < line_num:
        if li >= len(lines):
            break
        l1 = lines[li]
        li += 1
        if li >= len(lines):
            break  # odd tail: reference prints the orphan line and stops
        l2 = lines[li]
        li += 1
        if len(l1) > len(l2):
            pairs.append(SWPair(sx=l2, sy=l1))
        else:
            pairs.append(SWPair(sx=l1, sy=l2))
        i += 2
    return pairs


def write_sw_input(path: str, sequences: list[bytes], header: int | None = None):
    """Write a SW input file (generator.py-compatible: header then one
    sequence per line, '\\n'-terminated)."""
    with open(path, "wb") as f:
        n = len(sequences) if header is None else header
        f.write(str(n).encode() + b"\n")
        for s in sequences:
            f.write(s.rstrip(b"\n") + b"\n")


def parse_pairhmm_file(path: str) -> list[PairHMMBatch]:
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    batches = []
    li = 0
    while li < len(lines):
        header = lines[li].strip()
        li += 1
        if not header:
            continue
        parts = header.split()
        try:
            num_read, num_hap = int(parts[0]), int(parts[1])
            if num_read < 0 or num_hap < 0:
                raise ValueError
        except (ValueError, IndexError):
            raise ValueError(
                f"batch {len(batches)}: expected 'num_reads num_haplotypes' "
                f"header, got {header[:40]!r}"
            ) from None
        if li + num_read + num_hap > len(lines):
            raise ValueError(
                f"batch {len(batches)}: header promises {num_read} reads + "
                f"{num_hap} haplotypes but the file ends early"
            )
        reads = []
        for _ in range(num_read):
            line = lines[li].rstrip(b"\r")
            li += 1
            # len = (strlen - 4) / 5 over the newline-stripped line
            # (pairHMMmatrix.c:213-214); fields split on whitespace like
            # sscanf %s (pairHMMmatrix.c:22).
            fields = line.split()
            if len(fields) != 5:
                raise ValueError(
                    f"batch {len(batches)}: read line has {len(fields)} "
                    f"fields, want 5 (bases baseQ insQ delQ gcpQ)"
                )
            reads.append(
                PairHMMRead(
                    bases=fields[0],
                    base_q=fields[1],
                    ins_q=fields[2],
                    del_q=fields[3],
                    gcp_q=fields[4],
                )
            )
        haps = []
        for _ in range(num_hap):
            haps.append(lines[li].rstrip(b"\r"))
            li += 1
        batches.append(PairHMMBatch(reads=reads, haplotypes=haps))
        # skip trailing blank-only tail
        while li < len(lines) and not lines[li].strip():
            li += 1
    return batches


def format_pairhmm_values(values) -> str:
    """One '%f' (6-decimal) value per line, matching pairHMMmatrix.c:258.
    The single place the reference-parity output format is encoded."""
    return "".join("%f\n" % float(v) for v in np.asarray(values).reshape(-1))


def write_pairhmm_output(path: str, values) -> None:
    with open(path, "w") as f:
        f.write(format_pairhmm_values(values))
