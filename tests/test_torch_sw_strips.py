"""The strips route of the port on the CPU: the plain strip sweep of a
packed bucket against ``genomax.kernels.sw_strips`` in interpret mode, the
lane-tile plain version, the oracle and the native model across strip
seams and re-padded last strips (int32, exact: no tolerance); the prep
against the JAX prep array for array; the router against the JAX
predicate; the engine with ``sw_strips=True`` against the JAX engine in
the same configuration; the wrapper's checks; and the build key over the
kernel's headers. The CUDA kernel itself is held against this plain
version on the card (tests/test_torch_kernel.py, chip_smoke.py)."""

import os
import shutil

import numpy as np
import pytest
import torch

import genomax
from genomax import native
from genomax.config import EngineConfig as JaxEngineConfig
from genomax.config import SWConfig as JaxSWConfig
from genomax.io.formats import SWPair
from genomax.kernels import oracle
from genomax.kernels import sw_strips as jax_strips
from genomax.pack.bucketing import pack_sw_pairs as jax_pack_sw_pairs

from genomax_torch.config import EngineConfig, SWConfig
from genomax_torch.engine import executor
from genomax_torch.engine.executor import Engine, EngineError
from genomax_torch.kernels import _build
from genomax_torch.kernels import sw_strips as torch_strips
from genomax_torch.kernels.wavefront import (sw_forward_tiles,
                                             sw_strips_forward_tiles)
from genomax_torch.layout import PAD_STREAM, PAD_X
from genomax_torch.pack import (pack_sw_pairs, sw_strips_to_torch,
                                unpack_scores)
from _phmm_cases import height_sw_pairs
from _torch_cpu import one_torch_thread  # noqa: F401

# The scorings of tests/test_pallas_interpret.py's strips cases.
CFGS = [dict(), dict(match=2, mismatch=-3, gap_open=0, gap_extend=-1),
        dict(match=3, mismatch=-2, gap_open=-7, gap_extend=-2)]
CFG_IDS = ["default", "m2x3o0e1", "m3x2o7e2"]


def _dna(rng, n):
    return rng.choice(np.frombuffer(b"ATGC", np.uint8), n).tobytes()


def _seam_pairs(seed=12, lo=40, hi=90):
    """Ragged pairs of lo-hi bases, then the adversaries of the JAX strips
    test: a tandem repeat whose second copy crosses a seam of 24 and 40
    rows, an all-mismatch pair, an identical pair (its maximum runs through
    every seam), a one-base pair, and an empty pair."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(12):
        a, b = _dna(rng, int(rng.integers(lo, hi))), _dna(
            rng, int(rng.integers(lo, hi)))
        pairs.append(SWPair(sx=min(a, b, key=len), sy=max(a, b, key=len)))
    x = _dna(rng, 30)
    pairs.append(SWPair(sx=x + x, sy=_dna(rng, 7) + x + _dna(rng, 11) + x + x))
    pairs.append(SWPair(sx=b"A" * 70, sy=b"T" * 90))
    s = _dna(rng, 80)
    pairs.append(SWPair(sx=s, sy=s))
    pairs.append(SWPair(sx=b"A", sy=b"A"))
    pairs.append(SWPair(sx=b"", sy=b""))
    return pairs


def _plain(b, cfg, strip_w):
    """Scores of bucket b by the port's prep and plain strip sweep."""
    prep = torch_strips.prep_bucket_strips(b, strip_w)
    (_, _, _, nyt), st = prep
    t = sw_strips_to_torch(prep, b, "cpu")
    return torch_strips.sw_forward_strips(
        *t, ny_max=int(nyt.max()), cfg=cfg, **st).numpy(), st


@pytest.mark.parametrize("strip_w", [16, 29], ids=["w16", "w29"])
@pytest.mark.parametrize("c", CFGS, ids=CFG_IDS)
def test_plain_equals_jax_strips_kernel(c, strip_w):
    """Three to six strips; the last re-padded (K*W = 96 against NXs 88 at
    W = 16, 87 and 116 against 64 and 88 at W = 29): the plain strip sweep
    == the JAX strips kernel in interpret mode == the lane-tile plain
    version == the oracle == the native model, slot by slot."""
    pairs = _seam_pairs()
    cfg, jcfg = SWConfig(**c), JaxSWConfig(**c)
    buckets = pack_sw_pairs(pairs)
    assert [b.sx.shape[1] for b in buckets] == [64, 88]
    res = []
    for b in buckets:
        got, st = _plain(b, cfg, strip_w)
        assert st["k_strips"] >= 3
        assert ((st["k_strips"] * strip_w != b.sx.shape[1])
                == (strip_w == 29 or b.sx.shape[1] == 88))
        want = np.asarray(jax_strips.run_bucket_strips(
            b, cfg=jcfg, strip_w=strip_w, unroll=8, interpret=True))
        np.testing.assert_array_equal(got, want)
        tiles = sw_forward_tiles(*(torch.from_numpy(a) for a in
                                   (b.sx, b.sy, b.ndiag_tile)), cfg)
        np.testing.assert_array_equal(got, tiles.numpy())
        res.append(got)
    scores = unpack_scores(buckets, res, len(pairs))
    np.testing.assert_array_equal(scores, oracle.sw_scores_pairs(pairs, jcfg))
    np.testing.assert_array_equal(scores,
                                  native.sw_scores_native(pairs, jcfg))
    assert scores[-3] == 80 * cfg.match and scores[-1] == 0


@pytest.mark.parametrize("strip_w", [1, 24, 40, 64, 88],
                         ids=["w1", "w24", "w40", "w64", "w88"])
def test_prep_equals_jax_prep(strip_w):
    (b,) = [b for b in pack_sw_pairs(_seam_pairs()) if b.sx.shape[1] == 88]
    (jb,) = [b for b in jax_pack_sw_pairs(_seam_pairs())
             if b.sx.shape[1] == 88]
    ours = torch_strips.prep_bucket_strips(b, strip_w)
    theirs = jax_strips.prep_bucket_strips(jb, strip_w)
    assert ours[1] == theirs[1]
    for a, w in zip(ours[0], theirs[0]):
        assert a.dtype == w.dtype and a.shape == w.shape
        np.testing.assert_array_equal(a, w)


def _bucket(rng, nx_len, ny_len, n=3):
    """One bucket of n pairs with x of nx_len and y of ny_len bases."""
    pairs = [SWPair(sx=_dna(rng, nx_len), sy=_dna(rng, ny_len))
             for _ in range(n)]
    (b,) = pack_sw_pairs(pairs)
    return b


_SHAPES = [(40, 60), (100, 300), (117, 130), (126, 126), (134, 2000),
           (200, 900), (518, 514), (700, 1500), (1000, 1100)]


@pytest.mark.parametrize("sw_strips,min_nxs", [(True, 128), (True, 64),
                                               (True, 256), (False, 128)],
                         ids=["on-128", "on-64", "on-256", "off"])
def test_router_takes_the_jax_predicates_buckets(sw_strips, min_nxs):
    """Below the JAX predicate's two TPU capacity gates (a stream of at
    most stream_vmem_rows, a VMEM footprint inside STRIPS_VMEM_BUDGET),
    maybe_prep_strips takes exactly the buckets the JAX one takes."""
    rng = np.random.default_rng(3)
    ours = EngineConfig(sw_strips=sw_strips, strips_min_nxs=min_nxs)
    theirs = JaxEngineConfig(sw_strips=sw_strips, strips_min_nxs=min_nxs)
    taken = []
    for nx_len, ny_len in _SHAPES:
        b = _bucket(rng, nx_len, ny_len)
        assert b.sy.shape[1] <= theirs.stream_vmem_rows
        # None below 72 rows by the JAX width rule (W >= 64), not a gate
        assert (jax_strips.prep_bucket_strips(b) is None) == (nx_len < 64)
        got = torch_strips.maybe_prep_strips(ours, b)
        want = jax_strips.maybe_prep_strips(theirs, b)
        assert (got is None) == (want is None), (nx_len, ny_len)
        taken.append(got is not None)
    assert any(taken) == sw_strips


def test_router_declines_what_shared_memory_cannot_hold():
    """A bucket whose longest y needs more seam ring than a block's shared
    memory holds goes to the lane-tile kernel; so it does in the JAX
    engine, past its stream gate."""
    b = _bucket(np.random.default_rng(4), 200, 26000, n=1)
    assert torch_strips.smem_bytes(26001) > torch_strips.MAX_SMEM_BYTES
    assert torch_strips.maybe_prep_strips(EngineConfig(), b) is None
    assert jax_strips.maybe_prep_strips(JaxEngineConfig(), b) is None


@pytest.mark.parametrize("nxs,nyt,want", [
    (32, 40, None), (33, 40, None), (40, 40, 40), (136, 129, 136),
    (520, 514, 520), (1008, 1001, 1008), (136, 2001, 136)])
def test_pick_strip_w(nxs, nyt, want):
    assert torch_strips.pick_strip_w(nxs, nyt) == want


@pytest.mark.parametrize("strip_w", [0, 89])
def test_strip_w_outside_one_to_nxs_raises(strip_w):
    (b,) = [b for b in pack_sw_pairs(_seam_pairs()) if b.sx.shape[1] == 88]
    with pytest.raises(ValueError, match="strip_w"):
        torch_strips.prep_bucket_strips(b, strip_w)
    with pytest.raises(ValueError, match="strip_w"):
        jax_strips.prep_bucket_strips(b, strip_w)


def test_anchor_of_the_bucket_before_the_repad():
    """anchor = NDs - NXs of the bucket as packed: taking it after the
    re-pad (NDs - K*W) shifts every y code and changes the scores."""
    (b,) = [b for b in pack_sw_pairs(_seam_pairs()) if b.sx.shape[1] == 88]
    prep = torch_strips.prep_bucket_strips(b, 40)
    (sx, _, _, _), st = prep
    assert st["anchor"] == b.sy.shape[1] - 88 != b.sy.shape[1] - sx.shape[1]
    t = sw_strips_to_torch(prep, b, "cpu")
    good = sw_strips_forward_tiles(*t, k_strips=3, strip_w=40,
                                   anchor=st["anchor"])
    bad = sw_strips_forward_tiles(*t, k_strips=3, strip_w=40,
                                  anchor=b.sy.shape[1] - sx.shape[1])
    assert not torch.equal(good, bad)


def _engine_pairs(seed):
    """Buckets under and over 128 rows: pairs of 130-250 bases, ragged,
    and a tandem repeat, beside the short pairs and adversaries of
    _seam_pairs."""
    rng = np.random.default_rng(seed)
    pairs = _seam_pairs(seed, 20, 60)
    for _ in range(14):
        a, b = _dna(rng, int(rng.integers(130, 250))), _dna(
            rng, int(rng.integers(130, 250)))
        pairs.append(SWPair(sx=min(a, b, key=len), sy=max(a, b, key=len)))
    x = _dna(rng, 100)
    pairs.append(SWPair(sx=x + x + b"\n", sy=_dna(rng, 50) + x + x + b"\n"))
    return pairs


@pytest.mark.parametrize("c", CFGS[:2], ids=CFG_IDS[:2])
def test_engine_matches_jax_engine_strips(monkeypatch, c):
    """Engine(EngineConfig(sw_strips=True, strips_min_nxs=128)) on the CPU
    == the JAX engine with sw_strips=True, sw_rotor=False and its floor of
    128 rows (interpret mode) == native, with
    the same buckets and dp_cells; the buckets of 128 rows or more take
    the strips wrapper, the others the lane-tile wrapper."""
    pairs = _engine_pairs(7)
    cfg, jcfg = SWConfig(**c), JaxSWConfig(**c)
    routed = []
    for name in ("sw_forward", "sw_forward_strips"):
        real = getattr(executor, name)
        monkeypatch.setattr(
            executor, name,
            lambda *a, _n=name, _f=real, **k: routed.append(
                (_n, tuple(a[0].shape))) or _f(*a, **k))
    jax_eng = genomax.Engine(
        JaxEngineConfig(backend="pallas", sw_strips=True, sw_rotor=False,
                        unroll=4), sw_cfg=jcfg, interpret=True)
    eng = Engine(EngineConfig(sw_strips=True, strips_min_nxs=128,
                              sw_rotor=False), sw_cfg=cfg, device="cpu")
    got = eng.sw_scores(pairs)
    np.testing.assert_array_equal(got, jax_eng.sw_scores(pairs))
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs, jcfg))
    assert eng.last_stats.buckets == jax_eng.last_stats.buckets
    assert eng.last_stats.dp_cells == jax_eng.last_stats.dp_cells
    assert eng.last_stats.padded_cells == jax_eng.last_stats.padded_cells
    rows = sorted(b.sx.shape[1] for b in pack_sw_pairs(pairs))
    assert len(routed) == len(rows) and rows[0] < 128 <= rows[-2]
    assert sorted(s[1] for n, s in routed if n == "sw_forward") == [
        r for r in rows if r < 128]
    assert len([n for n, _ in routed if n == "sw_forward_strips"]) == len(
        [r for r in rows if r >= 128])


def test_engine_strips_off_takes_the_lane_tile_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(executor, "sw_forward_strips",
                        lambda *a, **k: calls.append(1))
    pairs = _engine_pairs(8)
    got = Engine(EngineConfig(sw_strips=False), device="cpu").sw_scores(pairs)
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs))
    assert calls == []


def test_strips_build_failure_raises_engine_error(monkeypatch):
    """On a device that is not the CPU the strips wrapper launches its
    kernel or raises: a build failure reaches the caller as EngineError,
    and no bucket is scored on the CPU."""
    def fail(*args, **kwargs):
        raise _build.BuildError("nvcc failed (simulated)")

    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    eng = Engine(EngineConfig(sw_strips=True), device="cuda")
    # Stand-in for device tensors on a host without a card.
    monkeypatch.setattr(
        executor, "sw_strips_to_torch",
        lambda prep, b, device: tuple(t.to("meta") for t in
                                      sw_strips_to_torch(prep, b, "cpu")))
    rng = np.random.default_rng(0)
    with pytest.raises(EngineError) as err:
        eng.sw_scores([SWPair(sx=_dna(rng, 150), sy=_dna(rng, 160))])
    assert isinstance(err.value.cause, _build.BuildError)


def _inputs():
    (b,) = [b for b in pack_sw_pairs(_seam_pairs()) if b.sx.shape[1] == 88]
    prep = torch_strips.prep_bucket_strips(b, 40)
    (_, _, _, nyt), st = prep
    return sw_strips_to_torch(prep, b, "cpu"), dict(st, ny_max=int(nyt.max()))


@pytest.mark.parametrize("what", ["sx", "sy", "nx"])
def test_wrapper_rejects_dtypes(what):
    t, st = _inputs()
    t = dict(zip(("sx", "sy", "nx", "ny"), t))
    t[what] = t[what].to(torch.int64)
    with pytest.raises(TypeError, match="dtypes"):
        torch_strips.sw_forward_strips(*t.values(), **st)


@pytest.mark.parametrize("bad", [dict(k_strips=4), dict(strip_w=1025),
                                 dict(ny_max=1), dict(ny_max=10**6),
                                 dict(anchor=10**6)],
                         ids=["k", "w", "ny-short", "ny-huge", "anchor"])
def test_wrapper_rejects_geometry(bad):
    t, st = _inputs()
    with pytest.raises(ValueError):
        torch_strips.sw_forward_strips(*t, **{**st, **bad})


def test_wrapper_needs_the_lengths_and_ny_max():
    t, st = _inputs()
    del st["ny_max"]
    with pytest.raises(TypeError):
        torch_strips.sw_forward_strips(*t, **st)
    with pytest.raises(TypeError):
        torch_strips.sw_forward_strips(t[0], t[1], **st, ny_max=100)


def test_build_key_covers_the_included_header(monkeypatch, tmp_path):
    """The library's key hashes sw_cell.cuh too: an edit to the header
    alone gives a new key, so no stale library is loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    keys = {n: _build.key(n) for n in ("sw_tile", "sw_long", "sw_strips",
                                       "sw_rotor", "pairhmm_tile")}
    with open(csrc / "sw_cell.cuh", "ab") as f:
        f.write(b"// edited\n")
    for name, k in keys.items():
        assert (_build.key(name) != k) == name.startswith("sw_"), name
    assert set(keys) <= set(_build.KERNELS)
    assert os.path.exists(csrc / "sw_strips.cu")


# (K*W rows, ny_max) -> (R, pairs a block) of the kernel's default pick:
# phase 19's and 20's buckets, phase 4's 520 rows (R = 3, the fastest
# there on one H100), a long y that leaves an SM one pair's ring a block,
# and the longest y one pair holds.
@pytest.mark.parametrize("n_rows,ny_max,r,pairs", [
    (88, 91, 3, 8), (144, 145, 2, 8), (136, 2001, 5, 6), (264, 300, 3, 8),
    (520, 514, 3, 8), (608, 600, 2, 7), (1008, 1001, 4, 5),
    (520, 20000, 6, 1), (1024, 25798, 8, 1)])
def test_geometry_picks_r_and_pairs(n_rows, ny_max, r, pairs):
    geo = torch_strips.geometry(n_rows, ny_max)
    assert (geo.rows_per_thread, geo.pairs) == (r, pairs)
    assert geo.smem == pairs * torch_strips.smem_bytes(ny_max)
    assert geo.smem <= torch_strips.MAX_SMEM_BYTES


@pytest.mark.parametrize("r", torch_strips.ROWS_PER_THREAD)
def test_geometry_at_every_built_r_within_shared_memory(r):
    for n_rows, ny_max in [(34, 2), (520, 514), (1024, 1025), (200, 25798)]:
        geo = torch_strips.geometry(n_rows, ny_max, r)
        assert geo.rows_per_thread == r
        assert 1 <= geo.pairs <= torch_strips.PAIRS_PER_BLOCK
        assert geo.smem <= torch_strips.MAX_SMEM_BYTES


@pytest.mark.parametrize("bad", [dict(r=7), dict(r=16), dict(ny_max=25827)],
                         ids=["r7", "r16", "ring-past-smem"])
def test_geometry_rejects(bad):
    with pytest.raises(ValueError):
        torch_strips.geometry(520, bad.get("ny_max", 514), bad.get("r"))
    t, st = _inputs()
    if "r" in bad:
        with pytest.raises(ValueError, match="rows_per_thread"):
            torch_strips.sw_forward_strips(*t, **st,
                                           _rows_per_thread=bad["r"])


def _old_router_takes(nxs, nyt):
    """The strips predicate of the one-thread-a-row kernel this one
    replaced: a strip width of 32-1,024 rows that paid against the lane
    tile, and 6W int32 + 8 ny + ny rounded to 16 bytes within 227 KB less
    256."""
    tile_steps = -(-nxs // 32) * 32 * (nxs + nyt - 1)
    best, bw = None, None
    for w in range(32, min(1024, nxs - 1) + 1, 32):
        k = -(-nxs // w)
        cost = k * (w + nyt) * (w + 32)
        if k * w * (w + nyt) < tile_steps and (best is None or cost < best):
            best, bw = cost, w
    return (bw is not None
            and 24 * bw + 8 * nyt + -(-nyt // 16) * 16 <= 232448 - 256)


def test_every_bucket_the_old_router_took_is_still_taken():
    """Over bucket heights of 2-1,024 rows and longest y of 1-26,000
    columns, every (NXs, nyt) the old predicate took, the new one takes
    (a strip width and one pair's ring within shared memory)."""
    taken = 0
    for nxs in (2, 33, 34, 40, 72, 136, 144, 520, 1008, 1024):
        for nyt in (2, 100, 1001, 10000, 20000, 25000, 25700, 25713, 25714,
                    25798, 25799, 26000):
            if _old_router_takes(nxs, nyt):
                taken += 1
                assert torch_strips.pick_strip_w(nxs, nyt) is not None
                assert (torch_strips.smem_bytes(nyt)
                        <= torch_strips.MAX_SMEM_BYTES), (nxs, nyt)
    assert taken > 40


@pytest.fixture(scope="module")
def jax_height_case():
    """height_sw_pairs' buckets of 72 rows or more, each prepared by the JAX
    prep at its own strip width and scored once by the JAX strips kernel
    in interpret mode."""
    pairs = height_sw_pairs(
        21, [32 * r for r in torch_strips.ROWS_PER_THREAD])
    jcfg = JaxSWConfig(**CFGS[2])
    out = []
    for b in pack_sw_pairs(pairs):
        if b.sx.shape[1] < 72:
            continue
        prep = jax_strips.prep_bucket_strips(b)
        (sx, sy, ndt, nyt), st = prep
        want = np.asarray(jax_strips.sw_forward_pallas_strips(
            sx, sy, ndt, nyt, cfg=jcfg, unroll=8, interpret=True, **st))
        out.append((b, prep, want))
    return out


@pytest.mark.parametrize("r", torch_strips.ROWS_PER_THREAD)
def test_plain_sweep_at_every_kernel_height_equals_jax_strips(
        jax_height_case, r):
    """The pack's K*W rows, made at the JAX strip width, re-cut into strips
    of the kernel's sub-strip height H = 32R (the rows padded with PAD_X to
    whole strips of H, the stream with PAD_STREAM rows that only dead cells
    read): the plain strip sweep == the JAX strips kernel in interpret mode,
    slot by slot, so the pack's W does not shape the result. Heights that
    do not divide K*W and pairs ending on and next to a seam included."""
    h = 32 * r
    cfg = SWConfig(**CFGS[2])
    assert len(jax_height_case) >= 2
    cut = 0
    for b, ((sx, sy, _, nyt), st), want in jax_height_case:
        kw = sx.shape[1]
        k = -(-kw // h)
        cut += k * h != kw
        sx = np.concatenate([sx, np.full((sx.shape[0], k * h - kw, 128),
                                         PAD_X, sx.dtype)], axis=1)
        sy = np.concatenate([sy, np.full((sy.shape[0], max(0, h - (
            sy.shape[1] - st["anchor"])), 128), PAD_STREAM, sy.dtype)],
            axis=1)
        got = sw_strips_forward_tiles(
            *(torch.from_numpy(a) for a in (sx, sy, b.nx, b.ny)),
            k_strips=k, strip_w=h, anchor=st["anchor"], cfg=cfg)
        np.testing.assert_array_equal(got.numpy(), want)
    assert cut >= 1


def test_build_key_covers_the_rows_header(monkeypatch, tmp_path):
    """sw_rows.cuh, the R-rows step that sw_tile.cu, sw_strips.cu and
    sw_stacked.cu include: an edit to it alone gives those three new keys
    and no other kernel a new one."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    keys = {n: _build.key(n) for n in _build.KERNELS}
    with open(csrc / "sw_rows.cuh", "ab") as f:
        f.write(b"// edited\n")
    changed = {n for n, k in keys.items() if _build.key(n) != k}
    assert changed == {"sw_tile", "sw_strips", "sw_stacked"}


def test_plain_sweep_stops_at_the_last_live_diagonal():
    """A bucket whose longest x and longest y are two pairs' (x 540 by y
    560, and a tandem-repeat y of 809 over x 400): the tile's longest x
    plus its longest y, 1,349, passes the stream anchor of 1,280, which
    only each pair's own x + y (at most 1,209) must stay under. The plain
    strip sweep, the engine's CPU route, stops each strip at its last live
    diagonal and scores both pairs exactly; it once read a stream window
    past the anchor there and raised."""
    rng = np.random.default_rng(7)
    x = _dna(rng, 400)
    pairs = [SWPair(sx=_dna(rng, 540), sy=_dna(rng, 560)),
             SWPair(sx=x, sy=x + _dna(rng, 9) + x)]
    (b,) = pack_sw_pairs(pairs)
    prep = torch_strips.maybe_prep_strips(EngineConfig(), b)
    st = prep[1]
    assert (st["k_strips"], b.sx.shape[1], st["anchor"]) == (1, 544, 1280)
    assert 540 + 809 > st["anchor"] >= max(len(p.sx) + len(p.sy) + 1
                                           for p in pairs) + 32
    got = Engine(device="cpu").sw_scores(pairs)
    np.testing.assert_array_equal(got, oracle.sw_scores_pairs(pairs))
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs))
