"""The protein-search configuration and the 64bp cell: the query-set kind,
the matrix reference and its controls, the new per-layer readers, and the
harness driven end to end on both new cells, with sound, broken and stale
entries, at sizes a test run holds."""

import hashlib

import numpy as np
import pytest

from gxbench import generate, harness
from gxbench.kinds import sw_protein
from gxbench.metrics import encode_ms, sw_long_matrix_roofline
from gxbench.metrics import sw_strips_matrix_roofline
from gxbench.program_trace import KEY
from gxbench.reference import sw_matrix
from genomax_torch.engine.executor import Engine

PROT = generate.load_mix("prot-cudasw-20x320")
BLAST = {"matrix": "BLOSUM62", "gap_open": -11, "gap_extend": -1}
# A query set of three proteins against two rounds: 18 pairs.
SMALL_PROT = {"kind": "sw_query_set", "query_lengths": [30, 45, 60],
              "rounds": 2, "entry": "sw_scores"}
SMALL_READS = {"kind": "sw_reads", "pairs": 40, "x_len": [64, 64],
               "y_extra": [0, 0], "sub_rate": 0.04, "indel_rate": 0.01,
               "entry": "sw_scores"}
CELLS = [("prot-cudasw-20x320", SMALL_PROT), ("sw-64bp", SMALL_READS)]


def _digest(mix, seed):
    h = hashlib.sha256()
    for tr in generate.sets(mix, seed, 2):
        for b in tr.x + tr.y:
            h.update(len(b).to_bytes(8, "little"))
            h.update(b)
    return h.hexdigest()[:32]


@pytest.mark.parametrize("seed,digest", [
    (1, "a053addaad66410308ead637f5492781"),
    (2**31 + 12345, "187f7d331b7727b53973db90cf4ed1b4")])
def test_query_set_keeps_its_bytes(seed, digest):
    assert _digest(PROT, seed) == digest


def test_query_set_shape():
    """6,400 pairs and 27.89 G cells a call; every seed the same (len x,
    len y) pairs in the same order; round 0 the queries themselves; x the
    shorter, the query on a tie; only the 20 standard residues."""
    a, b = generate.generate(PROT, 3), generate.generate(PROT, 2**40 + 1)
    assert len(a) == 6400 and a.cells() == 27_891_672_064 == 41752**2 * 16
    lens = PROT["query_lengths"]
    assert ([(len(x), len(y)) for x, y in zip(a.x, a.y)]
            == [(len(x), len(y)) for x, y in zip(b.x, b.y)]
            == [(min(q, s), max(q, s)) for q in lens for s in lens * 16])
    for tr in (a, b):
        for k, n in enumerate(lens):
            self_hit = k * 320 + k
            assert tr.x[self_hit] == tr.y[self_hit]
            assert len(tr.x[self_hit]) == n
        assert set(b"".join(tr.x[:320])) <= set(sw_protein.LETTERS.tolist())
    assert a.x != b.x


def test_query_set_rounds_are_drawn():
    """Round 1 holds subjects of the queries' lengths, drawn anew: pair
    (query 0, subject 3) ties, so x is the query and y the new draw."""
    tr = generate.generate(SMALL_PROT, 7)
    assert tr.x[0] == tr.y[0] and len(tr.x[0]) == 30
    assert tr.x[3] == tr.x[0] and len(tr.y[3]) == 30 and tr.y[3] != tr.x[0]


def test_reference_blocks_and_controls():
    """Scores do not depend on the blocks; under BLOSUM62 a protein's
    self-hit passes int8 but not int16, and the equality control fails
    most pairs."""
    tr = generate.generate(SMALL_PROT, 5)
    a = sw_matrix.scores(tr.x, tr.y, BLAST, "cpu")
    b = sw_matrix.scores(tr.x, tr.y, BLAST, "cpu", max_elems=100)
    assert (a == b).all()
    diag = [k * 6 + k for k in range(3)]
    assert (a[diag] > 127).all()
    wrong = {c: int((sw_matrix.scores(tr.x, tr.y, BLAST, "cpu",
                                      **sw_matrix.CONTROLS[c]) != a).sum())
             for c in sw_matrix.CONTROLS}
    assert wrong["int16"] == 0 and wrong["int8"] >= 3
    assert wrong["equality"] > len(a) // 2


def test_int16_control_fails_a_path_past_its_range():
    """No score of the protein cell's traffic reaches 2^15 (its self-hits
    stop near 28,300), so there the int16 control reads as int32 does: the
    cell cannot tell a kernel of 16-bit lanes. A planted path can: 3,000
    tryptophans against themselves score 33,000 in int32, which int16
    saturates at 32,767, and the judge counts that one pair."""
    x, short = b"W" * 3000, b"MKWVTFISLL"
    exp = sw_matrix.scores([x, short], [x, short], BLAST, "cpu")
    assert exp.tolist() == [11 * 3000, 52]
    got = sw_matrix.scores([x, short], [x, short], BLAST, "cpu",
                           **sw_matrix.CONTROLS["int16"])
    assert got.tolist() == [(1 << 15) - 1, 52]
    assert sw_matrix.judge([got], [exp], 0) == (1, [False])
    assert sw_matrix.judge([exp], [exp], 0) == (0, [True])


def _ctx(counts, kernel_s, calls=2, cells_per_call=100):
    return {"trace": {"calls": calls, "kernel_s": kernel_s},
            "cells_per_call": cells_per_call,
            KEY: (calls, {"pack.encode": 0.004}, counts)}


def test_route_rooflines_read_only_a_full_count():
    """The readers divide the bound of the route's counted cells by the
    kernel's time, only where the counters sum to the harness's cells."""
    full = {"cells.sw_long": 150, "cells.strips": 50, "launches.tile": 3}
    ks = {"sw_long_kernel": 1e-9, "sw_strips_kernel": 2e-9}
    long_ = sw_long_matrix_roofline.read(_ctx(full, ks))
    assert long_ == pytest.approx(
        100 * 150 * 7.5 / 16.72704e12 / 1e-9, rel=1e-3)
    assert sw_strips_matrix_roofline.read(_ctx(full, ks)) == pytest.approx(
        long_ * 50 / 150 / 2)
    short = {"cells.sw_long": 150, "cells.strips": 40}
    assert sw_long_matrix_roofline.read(_ctx(short, ks)) is None
    assert sw_strips_matrix_roofline.read(_ctx(full, {})) is None
    assert sw_long_matrix_roofline.read({"trace": None,
                                         "cells_per_call": 1}) is None
    assert encode_ms.read(_ctx(full, ks)) == pytest.approx(2.0)


def _run(cell, mix):
    return harness.run(cell, 2**31 + 7, 0.3, False, device="cpu", mix=mix)


@pytest.mark.parametrize("cell,mix", CELLS, ids=[c for c, _ in CELLS])
def test_sound_run_is_correct(cell, mix):
    r = _run(cell, mix)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert {"gcups", "setup_s"} <= set(r["metrics"]) <= {
        "gcups", "call_ms_p95", "setup_s"}


# Faults of the broken-path test: outputs never computed, half left out,
# one altered; and on the matrix cell, scores as a kernel that kept the
# equality score would give them.
FAULTS = [(c, m, f) for c, m in CELLS
          for f in ["unchanged", "half_left_out", "answer_altered"]
          + (["equality"] if c == "prot-cudasw-20x320" else [])]


@pytest.mark.parametrize("cell,mix,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, _, f in FAULTS])
def test_broken_path_is_not_correct(monkeypatch, cell, mix, fault):
    real = Engine.sw_scores

    def broken(self, pairs):
        out = np.asarray(real(self, pairs)).copy()
        if fault == "unchanged":
            return np.zeros_like(out)
        if fault == "half_left_out":
            out[len(out) // 2:] = 0
        elif fault == "answer_altered":
            out[len(out) // 3] += 1
        else:
            out = sw_matrix.scores([p.sx for p in pairs],
                                   [p.sy for p in pairs], BLAST, "cpu",
                                   **sw_matrix.CONTROLS["equality"])
        return out

    monkeypatch.setattr(Engine, "sw_scores", broken)
    r = _run(cell, mix)
    assert not r["correct"] and r["failed"] == r["attempted"]


@pytest.mark.parametrize("cell,mix", CELLS, ids=[c for c, _ in CELLS])
def test_stale_answers_are_not_correct(monkeypatch, cell, mix):
    real, first = Engine.sw_scores, []

    def stale(self, pairs):
        if not first:
            first.append(real(self, pairs))
        return first[0]

    monkeypatch.setattr(Engine, "sw_scores", stale)
    r = _run(cell, mix)
    assert r["attempted"] >= 2 and not r["correct"]
    assert r["failed"] >= r["attempted"] * (harness.SETS - 1) // harness.SETS
