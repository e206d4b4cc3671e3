"""The conveyor path of the port on the CPU: the pack and the unpack
against ``genomax.kernels.sw_conveyor`` array for array; the plain conveyor
sweep (``wavefront.sw_conveyor_forward_tiles`` through the wrapper)
against the JAX conveyor kernel in interpret mode on the first P rows of
every block, the oracle and the native model, on ragged queues two and
three slots deep, y past the window (T > nxs), x longer than y, one-base
pairs, pairs without a '\\n' and the queue-leak adversary, under the three
scorings of chip_smoke.py (int32, exact: no tolerance); the library entry
against the JAX entry; the wrapper's contract; and the no-fallback rule of
the CUDA branch. The CUDA kernel itself is held against this plain version
on the card (tests/test_torch_kernel.py, chip_smoke.py)."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from genomax.config import SWConfig as JaxSWConfig
from genomax.io.formats import SWPair as JaxSWPair
from genomax.kernels import oracle
from genomax.kernels import sw_conveyor as jax_conveyor

from genomax_torch import native
from genomax_torch.config import SWConfig
from genomax_torch.io.formats import SWPair
from genomax_torch.kernels import _build
from genomax_torch.kernels import sw_conveyor as torch_conveyor
from _phmm_cases import conveyor_leak_pairs, conveyor_sw_pairs
from _torch_cpu import one_torch_thread  # noqa: F401

# The scorings of chip_smoke.CFGS.
CFGS = [dict(match=1, mismatch=-1, gap_open=-3, gap_extend=-1),
        dict(match=2, mismatch=-3, gap_open=-5, gap_extend=-2),
        dict(match=3, mismatch=-1, gap_open=0, gap_extend=-2)]
CFG_IDS = ["default", "m2x3o5e2", "m3x1o0e2"]


def _case(name):
    """The seeded pairs of a case: the three kinds of conveyor_sw_pairs
    and the queue-leak adversary at T = nxs = 48 and at T = 48 > nxs = 24
    (x of 20 bases, y of 45)."""
    if name == "leak":
        return conveyor_leak_pairs(31, 45, 45)
    if name == "leak-long-y":
        return conveyor_leak_pairs(32, 20, 45)
    return conveyor_sw_pairs(30, name)


CASES = ["ragged", "long-y", "long-x", "leak", "leak-long-y"]
# Queues two slots deep (max_slots 2) and up to four (max_slots 4).
SLOTS = {"ragged": 2, "long-y": 4, "long-x": 2, "leak": 2, "leak-long-y": 4}


def _jax_pairs(pairs):
    return [JaxSWPair(sx=p.sx, sy=p.sy) for p in pairs]


def _assert_packs_equal(ours, theirs):
    for f in dataclasses.fields(theirs):
        a, w = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(w, np.ndarray):
            assert a.dtype == w.dtype and a.shape == w.shape, f.name
            np.testing.assert_array_equal(a, w)
        else:
            assert a == w, f.name


def _subset(n):
    return np.random.default_rng(5).choice(n, n // 2, replace=False)


@pytest.mark.parametrize("subset", [False, True], ids=["all", "idx"])
@pytest.mark.parametrize("max_slots", [1, 2, 3, 4, 64])
@pytest.mark.parametrize("case", ["ragged", "long-y", "leak"])
def test_pack_equals_jax_pack(case, max_slots, subset):
    pairs = _case(case)
    idx = _subset(len(pairs)) if subset else None
    ours = torch_conveyor.pack_sw_conveyor(pairs, idx, max_slots)
    theirs = jax_conveyor.pack_sw_conveyor(_jax_pairs(pairs), idx, max_slots)
    _assert_packs_equal(ours, theirs)
    assert ours.n_slots == -(-ours.n_valid // (128 * ours.sched.shape[0]))


def test_pack_geometry_of_the_traps():
    """The cases hold what they are for: P >= 2 queues at the tests'
    depths, T > nxs for long y, x longer than y, the leak in one lane."""
    for case in CASES:
        b = torch_conveyor.pack_sw_conveyor(_case(case),
                                            max_slots=SLOTS[case])
        assert b.n_slots >= 2, case
        assert b.period % torch_conveyor.UNROLL == 0 and b.period >= b.nxs
    b = torch_conveyor.pack_sw_conveyor(_case("long-y"), max_slots=4)
    assert (b.nxs, b.period) == (24, 104)
    b = torch_conveyor.pack_sw_conveyor(_case("leak-long-y"), max_slots=4)
    assert (b.nxs, b.period, b.n_slots) == (24, 48, 4)
    pairs = _case("long-x")
    assert sum(len(p.sx) > len(p.sy) for p in pairs) > len(pairs) // 2
    b = torch_conveyor.pack_sw_conveyor(_case("leak"), max_slots=2)
    assert (b.nxs, b.period, b.n_slots) == (48, 48, 2)
    np.testing.assert_array_equal(b.perm, np.arange(512))


@pytest.mark.parametrize("subset", [False, True], ids=["all", "idx"])
def test_unpack_equals_jax_unpack(subset):
    pairs = _case("ragged")
    idx = _subset(len(pairs)) if subset else None
    b = torch_conveyor.pack_sw_conveyor(pairs, idx, max_slots=2)
    p8 = -(-b.n_slots // 8) * 8
    res = np.random.default_rng(1).integers(0, 1000, (
        b.sched.shape[0] * p8, 128)).astype(np.int32)
    got = torch_conveyor.unpack_conveyor(b, res, len(pairs))
    np.testing.assert_array_equal(
        got, jax_conveyor.unpack_conveyor(b, res, len(pairs)))
    if subset:
        left_out = np.setdiff1d(np.arange(len(pairs)), idx)
        assert not got[left_out].any()


def _first_p_rows(res, p):
    """Rows 0..P-1 of each (P8, 128) block: the JAX kernel never writes
    the others."""
    p8 = -(-p // 8) * 8
    return np.asarray(res).reshape(-1, p8, 128)[:, :p]


_JAX_RUNS = {}


def _jax_kernel(case, ci):
    """The JAX conveyor kernel in interpret mode on the case's pack, once
    per case and scoring."""
    key = (case, ci)
    if key not in _JAX_RUNS:
        b = torch_conveyor.pack_sw_conveyor(_case(case),
                                            max_slots=SLOTS[case])
        _JAX_RUNS[key] = np.asarray(jax_conveyor.sw_forward_pallas_conveyor(
            b.sched, b.sy, cfg=JaxSWConfig(**CFGS[ci]), nxs=b.nxs,
            n_slots=b.n_slots, period=b.period, a0=b.a0, interpret=True))
    return _JAX_RUNS[key]


@pytest.mark.parametrize("ci", range(len(CFGS)), ids=CFG_IDS)
@pytest.mark.parametrize("case", CASES)
def test_plain_equals_jax_conveyor_kernel(case, ci):
    """sw_forward_conveyor on CPU tensors (the plain sweep) == the JAX
    conveyor kernel in interpret mode on the first P rows of every block,
    rows P..P8-1 are 0, and after unpack_conveyor == the oracle == the
    native model; in the leak cases every all-mismatch pair, each right
    behind a maximum-scoring pair in its lane, scores exactly 0."""
    pairs = _case(case)
    cfg = SWConfig(**CFGS[ci])
    b = torch_conveyor.pack_sw_conveyor(pairs, max_slots=SLOTS[case])
    got = torch_conveyor.sw_forward_conveyor(
        torch.from_numpy(b.sched), torch.from_numpy(b.sy), nxs=b.nxs,
        n_slots=b.n_slots, period=b.period, a0=b.a0, cfg=cfg).numpy()
    p8 = -(-b.n_slots // 8) * 8
    assert got.shape == (b.sched.shape[0] * p8, 128)
    assert got.dtype == np.int32
    assert not _first_p_rows(got, p8)[:, b.n_slots:].any()
    np.testing.assert_array_equal(
        _first_p_rows(got, b.n_slots),
        _first_p_rows(_jax_kernel(case, ci), b.n_slots))
    scores = torch_conveyor.unpack_conveyor(b, got, len(pairs))
    np.testing.assert_array_equal(
        scores, oracle.sw_scores_pairs(_jax_pairs(pairs),
                                       JaxSWConfig(**CFGS[ci])))
    np.testing.assert_array_equal(scores, native.sw_scores_native(pairs, cfg))
    if case.startswith("leak"):
        miss = np.array([p.sx.startswith(b"A" * 20) for p in pairs])
        assert not scores[miss].any()
        assert (scores[~miss] == len(pairs[0].sx) * cfg.match).all()


def test_pad_slots_score_zero_and_are_not_read():
    """130 pairs at max_slots 2: slot 1 holds two pairs and 126 lanes of
    pad codes, which score 0 and which unpack_conveyor never reads."""
    pairs = _case("ragged")[:130]
    b = torch_conveyor.pack_sw_conveyor(pairs, max_slots=2)
    assert (b.sched.shape[0], b.n_slots, b.n_valid) == (1, 2, 130)
    got = torch_conveyor.sw_forward_conveyor(
        torch.from_numpy(b.sched), torch.from_numpy(b.sy), nxs=b.nxs,
        n_slots=b.n_slots, period=b.period, a0=b.a0).numpy()
    assert not got[1, 2:].any()
    np.testing.assert_array_equal(
        torch_conveyor.unpack_conveyor(b, got, len(pairs)),
        native.sw_scores_native(pairs))


@pytest.mark.parametrize("case,ci,max_slots,subset", [
    ("ragged", 1, 2, False), ("long-x", 2, 3, True)])
def test_library_entry_equals_jax_entry(case, ci, max_slots, subset):
    pairs = _case(case)
    idx = _subset(len(pairs)) if subset else None
    got = torch_conveyor.sw_scores_conveyor(
        pairs, SWConfig(**CFGS[ci]), idx, max_slots, device="cpu")
    want = jax_conveyor.sw_scores_conveyor(
        _jax_pairs(pairs), JaxSWConfig(**CFGS[ci]), idx, max_slots,
        interpret=True)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_library_entry_has_no_device_default():
    sig = inspect.signature(torch_conveyor.sw_scores_conveyor)
    device = sig.parameters["device"]
    assert device.kind is inspect.Parameter.KEYWORD_ONLY
    assert device.default is inspect.Parameter.empty
    assert "interpret" not in sig.parameters
    with pytest.raises(TypeError):
        torch_conveyor.sw_scores_conveyor(_case("ragged")[:4])


def _inputs():
    b = torch_conveyor.pack_sw_conveyor(_case("leak"), max_slots=2)
    return ((torch.from_numpy(b.sched), torch.from_numpy(b.sy)),
            dict(nxs=b.nxs, n_slots=b.n_slots, period=b.period, a0=b.a0))


@pytest.mark.parametrize("bad,match", [
    (dict(nxs=44), "nxs"), (dict(nxs=1032, period=1032), "nxs"),
    (dict(nxs=0), "nxs"), (dict(period=52), "period"),
    (dict(nxs=56), "period"), (dict(n_slots=0), "n_slots"),
    (dict(a0=100), "a0"), (dict(a0=10**6), "a0"), (dict(n_slots=3), "SR")],
    ids=["nxs-not-8", "nxs-past-1024", "nxs-0", "period-not-8",
         "period-below-nxs", "slots-0", "a0-short", "a0-past-nb",
         "sched-short"])
def test_wrapper_rejects_geometry(bad, match):
    """Each violation raises ValueError before any sweep or launch, on the
    CPU as on the card; nxs past 1,024 (the kernel's threads a block)
    among them."""
    t, st = _inputs()
    with pytest.raises(ValueError, match=match):
        torch_conveyor.sw_forward_conveyor(*t, **{**st, **bad})


def test_wrapper_rejects_dtypes_shapes_and_devices():
    (s, y), st = _inputs()
    with pytest.raises(TypeError, match="dtypes"):
        torch_conveyor.sw_forward_conveyor(s.to(torch.int32), y, **st)
    with pytest.raises(ValueError, match="shapes"):
        torch_conveyor.sw_forward_conveyor(s, y[:, :, :64], **st)
    with pytest.raises(ValueError, match="shapes"):
        torch_conveyor.sw_forward_conveyor(s[0], y, **st)
    with pytest.raises(ValueError, match="shapes"):
        torch_conveyor.sw_forward_conveyor(s, torch.cat([y, y]), **st)
    with pytest.raises(ValueError, match="one device"):
        torch_conveyor.sw_forward_conveyor(s, y.to("meta"), **st)


def test_cuda_branch_raises_on_build_failure(monkeypatch):
    """On a device that is not the CPU the wrapper launches its kernel or
    raises: a failed build reaches the caller as BuildError, from the
    wrapper and from the library entry, and neither returns the plain
    version's scores nor counts a launch."""
    def fail(*args, **kwargs):
        raise _build.BuildError("nvcc failed (simulated)")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a device tensor")

    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(torch_conveyor, "sw_conveyor_forward_tiles", plain)
    (s, y), st = _inputs()
    before = torch_conveyor.launches
    # Stand-ins for device tensors on a host without a card.
    with pytest.raises(_build.BuildError):
        torch_conveyor.sw_forward_conveyor(s.to("meta"), y.to("meta"), **st)
    with pytest.raises(_build.BuildError):
        torch_conveyor.sw_scores_conveyor(_case("ragged"), device="meta")
    assert torch_conveyor.launches == before


def test_a_device_that_is_neither_cpu_nor_cuda_raises(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda *a, **k: None)
    (s, y), st = _inputs()
    with pytest.raises(ValueError, match="neither cpu nor cuda"):
        torch_conveyor.sw_forward_conveyor(s.to("meta"), y.to("meta"), **st)


def test_pack_rejects_pad_codes():
    with pytest.raises(ValueError):
        torch_conveyor.pack_sw_conveyor([SWPair(sx=b"AC\x01", sy=b"ACG")])
    with pytest.raises(ValueError):
        torch_conveyor.pack_sw_conveyor([SWPair(sx=b"AC", sy=b"A\x00G")])
