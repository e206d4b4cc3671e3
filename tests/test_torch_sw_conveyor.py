"""The conveyor path of the port on the CPU: the pack and the unpack
against ``genomax.kernels.sw_conveyor`` array for array; the plain conveyor
sweep (``wavefront.sw_conveyor_forward_tiles`` through the wrapper)
against the JAX conveyor kernel in interpret mode on the first P rows of
every block, the oracle and the native model, on ragged queues two and
three slots deep, y past the window (T > nxs), x longer than y, one-base
pairs, pairs without a '\\n' and the queue-leak adversary, under the three
scorings of chip_smoke.py (int32, exact: no tolerance); the library entry
against the JAX entry; the wrapper's contract; and the no-fallback rule of
the CUDA branch. The CUDA kernel's geometry (``geometry``, the private
``_geometry`` hook) is held to the build's instances, and a model of the
kernel's schedule (the sweep by period, lane and register, the switch by
predicate, no roll, the pinned rows past the window, the harvest a lane)
written here in torch is held against the plain sweep and the JAX kernel.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_kernel.py, chip_smoke.py)."""

import dataclasses
import inspect
import os
import shutil

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
from genomax_torch.kernels.wavefront import KILL
from genomax_torch.layout import PAD_X
from _phmm_cases import conveyor_leak_pairs, conveyor_sw_pairs
from _torch_cpu import one_torch_thread  # noqa: F401

# The scorings of chip_smoke.CFGS.
CFGS = [dict(match=1, mismatch=-1, gap_open=-3, gap_extend=-1),
        dict(match=2, mismatch=-3, gap_open=-5, gap_extend=-2),
        dict(match=3, mismatch=-1, gap_open=0, gap_extend=-2)]
CFG_IDS = ["default", "m2x3o5e2", "m3x1o0e2"]


def _case(name):
    """The seeded pairs of a case: the four kinds of conveyor_sw_pairs
    and the queue-leak adversary at T = nxs = 48 and at T = 48 > nxs = 24
    (x of 20 bases, y of 45)."""
    if name == "leak":
        return conveyor_leak_pairs(31, 45, 45)
    if name == "leak-long-y":
        return conveyor_leak_pairs(32, 20, 45)
    return conveyor_sw_pairs(30, name)


CASES = ["ragged", "long-y", "long-x", "tiny", "leak", "leak-long-y"]
# Queues two slots deep (max_slots 2) and up to four (max_slots 4).
SLOTS = {"ragged": 2, "long-y": 4, "long-x": 2, "tiny": 2, "leak": 2,
         "leak-long-y": 4}


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


def _fewest(g, nxs):
    """The fewest rows a lane at which G queues a warp hold a window of
    nxs rows."""
    return -(-nxs // (32 // g))


@pytest.mark.parametrize("n_queues", [128, 512, 6272])
def test_geometry_at_every_window(n_queues):
    """At every window the pack can give (8 .. 1,024 rows in steps of 8):
    a geometry the build makes, whose lanes hold the window at the fewest
    rows a lane for its G and W, the warp form up to one warp's 32 x 16
    rows and the block form past it, at the fewest warps of 8 rows a
    lane."""
    for nxs in range(8, 1025, 8):
        geo = torch_conveyor.geometry(nxs, n_queues)
        g, r, w = geo.queues_per_warp, geo.rows, geo.warps_per_queue
        assert (g, r, w) in torch_conveyor.GEOMETRIES, nxs
        assert (32 // g) * r * w >= nxs, nxs
        if nxs <= 32 * torch_conveyor.MAX_ROWS[1]:
            assert w == 1 and r == _fewest(g, nxs), (nxs, geo)
            wpb, warps = geo.warps_per_block, -(-n_queues // g)
            assert 1 <= wpb <= torch_conveyor.MAX_WARPS
            # a block on each SM where the warps allow it, never more
            assert (-(-warps // wpb) <= torch_conveyor.SMS
                    or wpb == torch_conveyor.MAX_WARPS), (nxs, geo)
        else:
            assert g == 1 and r == torch_conveyor.BLOCK_ROWS, (nxs, geo)
            assert w == -(-nxs // (32 * r)), (nxs, geo)
            assert 3 <= w == geo.warps_per_block <= torch_conveyor.MAX_WARPS


def test_geometries_are_the_builds_instances():
    """One warp a queue at G = 1, R = 1 .. 16 and G = 2, 4, R = 1 .. 10,
    and the block form at R = 8 with the 3 or 4 warps that a window past
    512 rows takes: every window up to 1,024 rows fits."""
    geos = torch_conveyor.GEOMETRIES
    assert len(geos) == len(set(geos)) == 16 + 10 + 10 + 2
    assert {(g, r) for g, r, w in geos if w == 1} == {
        (g, r) for g in (1, 2, 4) for r in range(1, 17 if g == 1 else 11)}
    assert {(g, r, w) for g, r, w in geos if w > 1} == {
        (1, 8, w) for w in (3, 4)}
    assert max((32 // g) * r * w for g, r, w in geos) >= 1024


@pytest.mark.parametrize("slots,n_queues,want", [
    (4, 6272, (4, 9, 1)), (16, 1664, (2, 5, 1)), (64, 512, (1, 3, 1))])
def test_geometry_on_the_64bp_depths(slots, n_queues, want):
    """The picks on chip_smoke.py phase 29's pack of 25,000 pairs of 64bp
    (nxs = T = 72) at max_slots 4, 16 and 64."""
    geo = torch_conveyor.geometry(72, n_queues)
    assert (geo.queues_per_warp, geo.rows, geo.warps_per_queue) == want


@pytest.mark.parametrize("geo,match", [
    ((3, 4, 1), "the build makes"), ((1, 17, 1), "the build makes"),
    ((4, 11, 1), "the build makes"), ((2, 8, 2), "the build makes"),
    ((1, 16, 2), "the build makes"), ((1, 8, 5), "the build makes"),
    ((1, 8, 2), "the build makes"),
    ((4, 8, 1), "cannot hold"), ((1, 2, 1), "cannot hold"),
    ((1, 8, 3), "cannot hold")],
    ids=["g3", "g1-r17", "g4-r11", "block-g2", "block-r16", "block-w5",
         "block-w2", "g4-short", "g1-short", "block-short"])
def test_geometry_refuses(geo, match):
    """A geometry the build does not make, or one whose lanes cannot hold
    a window of 1,024 rows (... or 72 for the warp forms), raises."""
    nxs = 1024 if geo[2] > 1 else 72
    with pytest.raises(ValueError, match=match):
        torch_conveyor.geometry(nxs, 512, *geo)


def test_geometry_refuses_partial_and_out_of_range():
    with pytest.raises(ValueError, match="none of them"):
        torch_conveyor.geometry(72, 512, 4, 9)
    for nxs in (0, 1032):
        with pytest.raises(ValueError, match="window"):
            torch_conveyor.geometry(nxs, 512)
    with pytest.raises(ValueError, match="queue"):
        torch_conveyor.geometry(72, 0)


def test_geometry_hook_raises_on_every_device(monkeypatch):
    """sw_forward_conveyor(_geometry=) raises for an unbuilt geometry and a
    short one, on CPU tensors and on the card path (before any build); a
    geometry that holds the window changes nothing on the CPU."""
    (s, y), st = _inputs()  # nxs = 48
    for geo, match in (((3, 4, 1), "the build makes"),
                       ((4, 5, 1), "cannot hold")):
        with pytest.raises(ValueError, match=match):
            torch_conveyor.sw_forward_conveyor(s, y, **st, _geometry=geo)

    def fail(*args, **kwargs):
        raise AssertionError("the hook's check came after the build")

    monkeypatch.setattr(_build, "load", fail)
    for geo in ((3, 4, 1), (4, 5, 1)):
        with pytest.raises(ValueError):
            torch_conveyor.sw_forward_conveyor(s.to("meta"), y.to("meta"),
                                               **st, _geometry=geo)
    want = torch_conveyor.sw_forward_conveyor(s, y, **st)
    assert torch.equal(torch_conveyor.sw_forward_conveyor(
        s, y, **st, _geometry=(4, 6, 1)), want)


def test_build_key_covers_the_shared_cell(monkeypatch, tmp_path):
    """csrc/sw_conveyor.cu includes sw_cell.cuh: an edit to the header
    gives a new build key, so no stale library is loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = _build.key("sw_conveyor")
    with open(csrc / "sw_cell.cuh", "ab") as f:
        f.write(b"// edited\n")
    assert _build.key("sw_conveyor") != before
    assert os.path.exists(csrc / "sw_conveyor.cu")


def _model_sweep(sched, sy, *, nxs, n_slots, period, a0, geo, cfg):
    """The schedule of csrc/sw_conveyor.cu at geometry (G, R, W), in torch:
    (NT * P8, 128) int32 as the wrapper's. A queue's L = 32 W / G lanes
    hold R rows each, L R rows h = kR + j in all; the rows from nxs-1 on
    take the pins (sub and open + extend -KILL). A step computes every
    row from the step before, row 0's row above being (D 0, Q' -inf, the
    stream's y code) and row h's row h-1 (no roll); register J of lane k
    switching (D and P' of the left boundary, the diagonal 0, the x code
    from sched). The running best is an accumulator a register pair of a
    lane; at register 2g's switch the lane's `done` takes the pair's
    accumulator and row 2g+1's new cell, and the accumulator restarts at
    row 2g's. The sweep runs by period: step mT (no switch), then lane k's
    registers in turn for rows 0 .. T-2, then the rows past the lanes' (no
    switch); the harvest, the max of `done` over the queue's lanes, before
    each period from the third, and once after the last."""
    g, r, w = geo
    lanes = 32 // g * w
    nt, _, _ = sched.shape
    T, P, R, H = period, n_slots, r, lanes * r
    ng = (R + 1) // 2
    p8 = -(-P // 8) * 8
    cols = nt * 128
    sf = sched.to(torch.int32).permute(1, 0, 2).reshape(-1, cols)
    yf = sy.to(torch.int32).permute(1, 0, 2).reshape(-1, cols)
    pin = (torch.arange(H) >= nxs - 1).unsqueeze(1)

    def pinned(v):
        return torch.where(pin, -KILL, torch.full((H, 1), v))

    subm, subx = pinned(cfg.match), pinned(cfg.mismatch)
    ogev, ge = pinned(cfg.gap_open + cfg.gap_extend), cfg.gap_extend
    z = torch.zeros((H, cols), dtype=torch.int32)
    D, Pp, Q, U2, Y = z, z, z, z, z
    X = z + PAD_X
    acc = torch.zeros((lanes, ng, cols), dtype=torch.int32)
    done = torch.zeros((lanes, cols), dtype=torch.int32)
    out = torch.zeros((nt, p8, 128), dtype=torch.int32)
    zero_row = torch.zeros((1, cols), dtype=torch.int32)

    def step(d, k=None, j=None):
        nonlocal D, Pp, Q, U2, Y, X, acc, done
        aD = torch.cat([zero_row, D[:-1]])
        aQ = torch.cat([zero_row - KILL, Q[:-1]])
        aY = torch.cat([yf[a0 - d: a0 - d + 1], Y[:-1]])
        dl, pl, dg = D, Pp, U2
        if j is not None:  # register j of lane k switches
            h = k * R + j
            dl, pl, dg, X = dl.clone(), pl.clone(), dg.clone(), X.clone()
            dl[h], pl[h], dg[h], X[h] = 0, -KILL, 0, sf[d]
        pn = torch.maximum(pl + ge, dl)
        qn = torch.maximum(aQ + ge, aD)
        sub = torch.where(X == aY, subm, subx)
        dn = torch.clamp_min(torch.maximum(torch.maximum(pn, qn) + ogev,
                                           dg + sub), 0)
        U2, Y, D, Pp, Q = aD, aY, dn, pn, qn
        regs = D.view(lanes, R, cols)
        if R % 2:  # the last register alone: its pair's other row is 0
            regs = torch.cat([regs, torch.zeros((lanes, 1, cols),
                                                dtype=torch.int32)], 1)
        lo, hi = regs[:, 0::2], regs[:, 1::2]
        added = torch.maximum(acc, torch.maximum(lo, hi))
        if j is not None and j % 2 == 0:
            done = done.clone()
            done[k] = torch.maximum(done[k], torch.maximum(acc[k, j // 2],
                                                           hi[k, j // 2]))
            added[k, j // 2] = lo[k, j // 2]
        acc = added

    for m in range(P + 2):
        if m >= 2:
            out[:, m - 2] = done.amax(dim=0).view(nt, 128)
        done = torch.zeros_like(done)
        if m > P:
            break
        d0 = m * T
        step(d0)
        for h in range(min(H, T - 1)):
            step(d0 + 1 + h, h // R, h % R)
        for e in range(H + 1, T):
            step(d0 + e)
    return out.reshape(nt * p8, 128)


def _model_geometries(nxs):
    """Each G at its fewest rows a lane, G = 2 at 10 (most lanes all
    pinned) and the block form at R = 8, W = 3 (seams between warps)."""
    return [(4, _fewest(4, nxs), 1), (2, _fewest(2, nxs), 1),
            (1, _fewest(1, nxs), 1), (2, 10, 1), (1, 8, 3)]


@pytest.mark.parametrize("gi", range(5),
                         ids=["g4", "g2", "g1", "g2-r10", "block"])
@pytest.mark.parametrize("case", CASES)
def test_model_of_the_kernel_schedule(case, gi):
    """The kernel's schedule (``_model_sweep``) == the plain sweep and the
    JAX conveyor kernel in interpret mode on every row, on every case kind
    (T = nxs in the leak, T > nxs and T > L R in long-y and the leak
    behind it), at five geometries, under the scorings in turn."""
    ci = gi % len(CFGS)
    cfg = SWConfig(**CFGS[ci])
    b = torch_conveyor.pack_sw_conveyor(_case(case), max_slots=SLOTS[case])
    geo = _model_geometries(b.nxs)[gi]
    assert geo in torch_conveyor.GEOMETRIES
    t = (torch.from_numpy(b.sched), torch.from_numpy(b.sy))
    st = dict(nxs=b.nxs, n_slots=b.n_slots, period=b.period, a0=b.a0)
    got = _model_sweep(*t, **st, geo=geo, cfg=cfg)
    assert torch.equal(got, torch_conveyor.sw_forward_conveyor(*t, **st,
                                                               cfg=cfg))
    np.testing.assert_array_equal(_first_p_rows(got.numpy(), b.n_slots),
                                  _first_p_rows(_jax_kernel(case, ci),
                                                b.n_slots))
