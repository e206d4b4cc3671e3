"""The SW path under a substitution matrix (``SWConfig.matrix``) on the CPU:
every route of ``Engine.sw_scores`` exact against the benchmark's plain
reference (``gxbench/reference/sw_matrix.py``) and the port's oracle, the
table as NCBI's file has it, the residue check, and the opt-in paths that
refuse a matrix before any work."""

import os
import sys

import numpy as np
import pytest

from genomax_torch import native, scoring, trace
from genomax_torch.cli.main import main
from genomax_torch.config import EngineConfig, SWConfig
from genomax_torch.engine.executor import Engine, EngineError
from genomax_torch.io.formats import SWPair
from genomax_torch.kernels import oracle
from genomax_torch.pack import pack_sw_pairs
from _torch_cpu import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gxbench.reference import sw_matrix  # noqa: E402

BLAST = SWConfig(matrix="BLOSUM62", gap_open=-11, gap_extend=-1)
AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYVBZX*", np.uint8)
# One engine reaches every route: short pairs of near-equal lengths the
# rotor (a period of at most 136 that its gate takes), x of 70-90 against
# y of about 200 the lane tile, x of 142-150 the strips (152 rows), x past
# max_device_len - 2 the long-pair kernel's twin, and lx + ly past
# max_device_diags the native model.
ENGINE = EngineConfig(max_device_len=160, max_device_diags=420)
ROUTES = {"rotor": [((50, 62), (0, 4), 10)],
          "tile": [((70, 90), (110, 130), 6)],
          "strips": [((142, 150), (0, 60), 6)],
          "sw_long": [((160, 180), (0, 40), 4)],
          "native": [((30, 60), (380, 420), 3)]}


def _pairs(groups, seed, alpha=AA):
    rng = np.random.default_rng(seed)
    out = []
    for (xlo, xhi), (elo, ehi), n in groups:
        for _ in range(n):
            lx = int(rng.integers(xlo, xhi + 1))
            ly = lx + int(rng.integers(elo, ehi + 1))
            x = alpha[rng.integers(0, len(alpha), lx)]
            y = alpha[rng.integers(0, len(alpha), ly)]
            if rng.random() < 0.5:  # a homolog of x inside y
                at = int(rng.integers(0, ly - lx + 1))
                keep = rng.random(lx) < 0.7
                y[at:at + lx] = np.where(keep, x, y[at:at + lx])
            out.append(SWPair(sx=x.tobytes(), sy=y.tobytes()))
    return out


def _reference(pairs, cfg):
    scoring_ = {"matrix": cfg.matrix, "gap_open": cfg.gap_open,
                "gap_extend": cfg.gap_extend}
    return sw_matrix.scores([p.sx for p in pairs], [p.sy for p in pairs],
                            scoring_, "cpu")


def _scored(pairs, cfg, ecfg=ENGINE):
    with trace.recording() as spans:
        out = Engine(ecfg, cfg, device="cpu").sw_scores(pairs)
    cells = {}
    for s in spans:
        for k, v in (s.counts or {}).items():
            if k.startswith("cells."):
                cells[k[6:]] = cells.get(k[6:], 0) + v
    return out, cells


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_route_exact(route):
    """Each route's pairs, alone in a call, score as the plain reference
    and the oracle say, and the call's cells are counted under that
    route."""
    pairs = _pairs(ROUTES[route], 11)
    out, cells = _scored(pairs, BLAST)
    ref = _reference(pairs, BLAST)
    assert out.tolist() == ref.tolist()
    assert out.tolist() == oracle.sw_scores_pairs(pairs, BLAST).tolist()
    assert cells.get(route, 0) > 0
    assert sum(cells.values()) == sum(len(p.sx) * len(p.sy) for p in pairs)


@pytest.mark.parametrize("gaps", [(-11, -1), (-5, -2), (0, -3)],
                         ids=["blast", "open5_extend2", "open0"])
def test_ragged_call_exact(gaps):
    """Every route in one call, in shuffled order, under three gap models:
    nothing is fixed to 11/1."""
    cfg = SWConfig(matrix="BLOSUM62", gap_open=gaps[0], gap_extend=gaps[1])
    pairs = _pairs([g for gs in ROUTES.values() for g in gs], 5)
    order = np.random.default_rng(1).permutation(len(pairs))
    pairs = [pairs[i] for i in order]
    out, cells = _scored(pairs, cfg)
    assert out.tolist() == _reference(pairs, cfg).tolist()
    assert out.tolist() == native.sw_scores_native(pairs, cfg).tolist()
    assert set(cells) == set(ROUTES)


@pytest.mark.parametrize("ecfg", [EngineConfig(max_device_len=64),
                                  EngineConfig(max_device_len=64,
                                               max_device_diags=1000)],
                         ids=["sw_long", "native"])
def test_scores_past_int16_are_exact(ecfg):
    """A self-hit past 2^15 (3,000 tryptophans, 33,000) scores exactly in
    int32 on the long-pair kernel's twin and on the native model: nothing
    on the path narrows to 16 bits."""
    pairs = [SWPair(sx=b"W" * 3000, sy=b"W" * 3000),
             SWPair(sx=b"MKWVTFISLL", sy=b"MKWVTFISLL")]
    out, cells = _scored(pairs, BLAST, ecfg)
    assert out.tolist() == [33000, 52]
    assert cells["sw_long" if ecfg.max_device_diags > 6001
                 else "native"] == 3000 * 3000


def test_table_is_ncbis():
    alphabet, t = scoring.matrix("BLOSUM62")
    assert alphabet == b"ARNDCQEGHILKMFPSTWYVBZX*"
    assert (t == t.T).all()
    assert np.diag(t).tolist() == [4, 5, 6, 6, 9, 5, 5, 6, 8, 4, 4, 5, 5, 6,
                                   7, 4, 5, 11, 7, 4, 4, 4, -1, 1]
    assert (t.min(), t.max()) == (-4, 11)
    assert t[:20, :20].sum() == -426 and t.sum() == -726
    ref_alphabet, ref = sw_matrix.table("BLOSUM62")
    assert ref_alphabet == alphabet and (ref == t).all()


def test_code_table_pads_decay():
    """Residue codes score as the table; every pad entry is at most 0;
    the dead code is -inf."""
    _, t = scoring.matrix("BLOSUM62")
    ct = scoring.code_table("BLOSUM62").reshape(scoring.CODES, scoring.STRIDE)
    n = len(t)
    c0 = scoring.CODE0
    assert (ct[c0:c0 + n, c0:c0 + n] == t).all()
    pads = np.ones_like(ct, bool)
    pads[c0:c0 + n, c0:c0 + n] = False
    pads[:, scoring.DEAD_CODE] = False
    assert (ct[pads] <= 0).all()
    assert (ct[:, scoring.DEAD_CODE] == scoring.DEAD).all()


@pytest.mark.parametrize("byte", [b"a", b"U", b"O", b"J", b"\n", b"\x00"],
                         ids=["lower", "U", "O", "J", "newline", "nul"])
@pytest.mark.parametrize("route", ["strips", "sw_long", "native"])
def test_byte_outside_alphabet_raises(byte, route):
    pairs = _pairs(ROUTES[route], 3)
    k = len(pairs) - 1
    y = pairs[k].sy
    pairs[k] = SWPair(sx=pairs[k].sx, sy=y[:5] + byte + y[6:])
    with pytest.raises(EngineError,
                       match=rf"of pair {k} is not a residue") as e:
        Engine(ENGINE, BLAST, device="cpu").sw_scores(pairs)
    assert e.value.stage == "encode" and e.value.cause.byte == byte[0]


def test_pack_encodes_and_dna_pack_unchanged():
    """Under a matrix the pack holds codes; without one, the bytes as
    they were."""
    pairs = _pairs(ROUTES["strips"], 2, np.frombuffer(b"ACGT", np.uint8))
    (raw,) = pack_sw_pairs(pairs)
    (enc,) = pack_sw_pairs(pairs, codes=scoring.code_lut("BLOSUM62"))
    lut = scoring.code_lut("BLOSUM62")
    real = raw.sx > 1
    assert (enc.sx[real] == lut[raw.sx[real].view(np.uint8)]).all()
    assert (enc.sx[~real] == raw.sx[~real]).all()
    (again,) = pack_sw_pairs(pairs)
    assert raw.sx.tobytes() == again.sx.tobytes()


@pytest.mark.parametrize("kw,msg", [
    (dict(matrix="PAM250"), "unsupported SW matrix"),
    (dict(matrix="BLOSUM62", match=2), "match and mismatch are not read"),
    (dict(matrix="BLOSUM62", mismatch=-2), "match and mismatch are not read"),
    (dict(matrix="BLOSUM62", gap_open=1), "gap_open <= 0"),
    (dict(matrix="BLOSUM62", gap_extend=0), "gap_extend < 0")],
    ids=["unknown", "match", "mismatch", "open", "extend"])
def test_validate_matrix(kw, msg):
    with pytest.raises(ValueError, match=msg):
        SWConfig(**kw).validate()


def test_opt_in_paths_refuse():
    """The stacked route, the stream entry, ShardedEngine and the library
    entries of the conveyor, stacked and cross-device kernels raise before
    any work."""
    from genomax_torch.dist.engine import ShardedEngine
    from genomax_torch.dist.xsharded import sw_scores_xsharded
    from genomax_torch.kernels.sw_conveyor import sw_scores_conveyor
    from genomax_torch.kernels.sw_stacked import run_bucket_stacked

    pairs = _pairs(ROUTES["rotor"], 4)
    with pytest.raises(ValueError, match="sw_stacked"):
        Engine(EngineConfig(sw_stack=2), BLAST, device="cpu")
    with pytest.raises(ValueError, match="sw_scores_stream"):
        Engine(ENGINE, BLAST, device="cpu").sw_scores_stream(pairs)
    with pytest.raises(ValueError, match="ShardedEngine"):
        ShardedEngine(None, ENGINE, BLAST)
    with pytest.raises(ValueError, match="sw_conveyor"):
        sw_scores_conveyor(pairs, BLAST, device="cpu")
    with pytest.raises(ValueError, match="sw_stacked"):
        run_bucket_stacked(None, 2, BLAST, device="cpu")
    with pytest.raises(ValueError, match="sw_xstrip"):
        sw_scores_xsharded(pairs, mesh=None, cfg=BLAST)


def test_dna_counts_cells_too():
    """The cells counters count an equality config's routes alike."""
    pairs = _pairs(ROUTES["rotor"] + ROUTES["sw_long"], 6,
                   np.frombuffer(b"ACGT", np.uint8))
    out, cells = _scored(pairs, SWConfig())
    assert out.tolist() == native.sw_scores_native(pairs).tolist()
    assert set(cells) == {"rotor", "sw_long"}
    assert sum(cells.values()) == sum(len(p.sx) * len(p.sy) for p in pairs)


def test_cli_matrix(tmp_path, capsys):
    """``sw --matrix BLOSUM62 --gap-open -11 --gap-extend -1`` scores a
    pairs file through the engine's matrix path: its lines' newlines are
    not residues."""
    pairs = _pairs(ROUTES["rotor"] + ROUTES["tile"], 8)
    path = tmp_path / "prot.in"
    body = b"".join(p.sx + b"\n" + p.sy + b"\n" for p in pairs)
    path.write_bytes(str(2 * len(pairs)).encode() + b"\n" + body)
    rc = main(["sw", str(path), "--device", "cpu", "--matrix", "BLOSUM62",
               "--gap-open", "-11", "--gap-extend", "-1"])
    assert rc == 0
    got = [int(ln.split()[1]) for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("Score: ")]
    assert got == _reference(pairs, BLAST).tolist()


@pytest.fixture(scope="module")
def card():
    import torch

    from genomax_torch.kernels import _build

    if not torch.cuda.is_available():
        pytest.skip("torch.cuda finds no CUDA device")
    if _build.nvcc() is None:
        pytest.skip("nvcc not found on PATH or under $CUDA_HOME")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("gaps", [(-11, -1), (-5, -2)],
                         ids=["blast", "open5_extend2"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_card_route_exact(card, route, gaps):
    """On the card, each route's matrix instantiation scores a few hundred
    pairs as the native model and the plain reference do."""
    cfg = SWConfig(matrix="BLOSUM62", gap_open=gaps[0], gap_extend=gaps[1])
    groups = [(lens, extra, 40 * n) for lens, extra, n in ROUTES[route]]
    pairs = _pairs(groups, 13)
    with trace.recording() as spans:
        out = Engine(ENGINE, cfg, device=card).sw_scores(pairs)
    counted = {k for s in spans for k in (s.counts or {})}
    assert f"cells.{route}" in counted
    assert out.tolist() == native.sw_scores_native(pairs, cfg).tolist()
    assert out.tolist() == _reference(pairs, cfg).tolist()
