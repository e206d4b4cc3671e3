"""Protein database search with a benchmark query set: every query of the
set scanned against a chunk of the database, every pair scored by local
SW under a substitution matrix (SWIPE and CUDASW++ scan Swiss-Prot so).

Parameters of the mix (``traffic/<mix>.json``):

``query_lengths``  the lengths of the query set's proteins.
``rounds``         the database chunk a call: ``rounds`` subjects of each
                   of those lengths, ``rounds`` * len(query_lengths)
                   subjects in all, round r the subjects r * n .. r * n +
                   n - 1 in the order of ``query_lengths``.

Round 0 is the queries themselves: every query meets its own database
entry, as a scan of the database that holds them does. The other rounds
are independent draws. Every query is paired with every subject, query
major, so a call holds n * rounds * n pairs: x is the shorter of query and
subject (the query on a tie), y the other. Residues are the 20 standard
amino acids at UniProtKB/Swiss-Prot's composition (``sw_protein``). The
seed draws the residues of the queries and of rounds 1 onward; the pairs'
lengths, and their order, are the same for every seed.
"""

from __future__ import annotations

import numpy as np

from gxbench import generate
from gxbench.kinds.sw_protein import residues


def make(mix, rng):
    lens = [int(n) for n in mix["query_lengths"]]
    rounds = int(mix["rounds"])
    if rounds < 1 or not lens or min(lens) < 1:
        raise ValueError(f"sw_query_set: want rounds >= 1 and positive "
                         f"lengths, got {rounds} and {lens}")
    total = sum(lens)
    buf = residues(rng, total * rounds).tobytes()
    ends = np.cumsum(lens * rounds).tolist()
    subjects = [buf[e - n:e] for e, n in zip(ends, lens * rounds)]
    queries = subjects[:len(lens)]
    xs, ys = [], []
    for q in queries:
        for s in subjects:
            x, y = (q, s) if len(q) <= len(s) else (s, q)
            xs.append(x)
            ys.append(y)
    return generate.SWPairs(x=xs, y=ys)
