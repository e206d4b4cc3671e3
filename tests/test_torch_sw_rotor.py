"""The rotor route of the port on the CPU: the pack, the prep, the router,
``_pick_unroll`` and the unpack against ``genomax.kernels.sw_rotor`` array
for array; the plain rotor sweep (``wavefront.sw_rotor_forward_tiles``
through both wrappers) against the JAX rotor kernel in interpret mode on
its own cases (ragged queues, the queue-leak and period-edge adversaries)
under two scorings and unrolls 8 and 16, and against the oracle (int32,
exact: no tolerance); the engine with ``sw_rotor=True`` against the JAX
engine in the same configuration, bucket by bucket; the three traps of the
JAX rotor; and the wrappers' checks. The CUDA kernel itself is held
against this plain version on the card (tests/test_torch_kernel.py,
chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import genomax
from genomax import native
from genomax.config import EngineConfig as JaxEngineConfig
from genomax.config import SWConfig as JaxSWConfig
from genomax.io.formats import SWPair
from genomax.kernels import oracle
from genomax.kernels import sw_rotor as jax_rotor
from genomax.pack.bucketing import pack_sw_pairs as jax_pack_sw_pairs

from genomax_torch.config import EngineConfig, SWConfig
from genomax_torch.engine import executor
from genomax_torch.engine.executor import Engine, EngineError
from genomax_torch.kernels import _build
from genomax_torch.kernels import sw_rotor as torch_rotor
from genomax_torch.pack import pack_sw_pairs, sw_rotor_to_torch, unpack_scores
from _torch_cpu import one_torch_thread  # noqa: F401

CFGS = [dict(), dict(match=2, mismatch=-3, gap_open=0, gap_extend=-1)]
CFG_IDS = ["default", "m2x3o0e1"]
ABC = np.frombuffer(b"ATGC", np.uint8)


def _dna(rng, n):
    return rng.choice(ABC, n).tobytes()


def _ragged(seed=7):
    """The ragged queue of tests/test_pallas_interpret.py's rotor test:
    pairs of 3-60 bases with '\\n', an identical pair, an all-mismatch
    pair and a one-base x."""
    rng = np.random.default_rng(seed)
    pairs = [SWPair(sx=_dna(rng, int(rng.integers(3, 60))) + b"\n",
                    sy=_dna(rng, int(rng.integers(3, 60))) + b"\n")
             for _ in range(40)]
    s = _dna(rng, 50)
    pairs[5] = SWPair(sx=s, sy=s)
    pairs[9] = SWPair(sx=b"A" * 30, sy=b"T" * 55)
    pairs[13] = SWPair(sx=b"A", sy=b"ACGT")
    return pairs


def _leak(seed=7):
    """The wrap-row adversary of tests/test_pallas_interpret.py: identical
    and all-mismatch pairs in turns at nx = ny = T - 1 of the period
    T = 64, 288 pairs in queues of 3. Slot s of a rotor tile is queue
    s // 128 of lane s % 128, so this order puts pairs of one kind in each
    lane's queue."""
    g = _dna(np.random.default_rng(seed), 63)
    return [SWPair(sx=g, sy=g), SWPair(sx=b"A" * 63, sy=b"T" * 63)] * 144


def _queued_leak(seed=7):
    """The queue-leak adversary proper: 128 identical pairs, 128
    all-mismatch pairs, 32 identical pairs, so that each lane's queue runs
    maximum-scoring, all-mismatch (which must score exactly 0), and for
    lanes 0-31 maximum-scoring again; T = 64, queues of 3."""
    g = _dna(np.random.default_rng(seed), 63)
    same, miss = SWPair(sx=g, sy=g), SWPair(sx=b"A" * 63, sy=b"T" * 63)
    return [same] * 128 + [miss] * 128 + [same] * 32


_CASES = {"ragged": _ragged, "leak": _leak, "queued-leak": _queued_leak}


def _pack_both(pairs, max_slots, unroll):
    return (torch_rotor.pack_sw_rotor(pairs, max_slots=max_slots,
                                      unroll=unroll),
            jax_rotor.pack_sw_rotor(pairs, max_slots=max_slots,
                                    unroll=unroll))


@pytest.mark.parametrize("unroll", [8, 16, 24, 32])
@pytest.mark.parametrize("case,max_slots", [("ragged", 3), ("leak", 4)])
def test_pack_equals_jax_pack(case, max_slots, unroll):
    pairs = _CASES[case]()
    ours, theirs = _pack_both(pairs, max_slots, unroll)
    for f in dataclasses.fields(theirs):
        a, w = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(w, np.ndarray):
            assert a.dtype == w.dtype and a.shape == w.shape, f.name
            np.testing.assert_array_equal(a, w)
        else:
            assert a == w, f.name
    assert ours.period % unroll == 0


def test_pick_unroll_equals_jax():
    for T in range(8, 201, 8):
        assert torch_rotor._pick_unroll(T) == jax_rotor._pick_unroll(T), T


def _run_jax(b, cfg, unroll=None):
    """The JAX rotor kernel in interpret mode on a pack (the port's or the
    JAX one: they are equal)."""
    return np.asarray(jax_rotor.sw_forward_pallas_rotor(
        b.xrev, b.ybuf, cfg=cfg, period=b.period, n_slots=b.n_slots,
        anchor=b.anchor, unroll=unroll or b.unroll, interpret=True))


def _first_p_rows(res, p):
    """Rows 0..P-1 of each (P8, 128) block: the JAX kernel never writes
    the others."""
    p8 = -(-p // 8) * 8
    return np.asarray(res).reshape(-1, p8, 128)[:, :p]


@pytest.mark.parametrize("unroll", [8, 16])
@pytest.mark.parametrize("c", CFGS, ids=CFG_IDS)
@pytest.mark.parametrize("case,max_slots", [("ragged", 3), ("leak", 4),
                                            ("queued-leak", 4)])
def test_plain_equals_jax_rotor_kernel(case, max_slots, c, unroll):
    """sw_forward_rotor on CPU tensors (the plain sweep) == the JAX rotor
    kernel in interpret mode on the first P rows of every block == the
    oracle after unpack_rotor; every all-mismatch pair scores exactly 0,
    in the queued case right behind a maximum-scoring pair."""
    pairs = _CASES[case]()
    cfg, jcfg = SWConfig(**c), JaxSWConfig(**c)
    b = torch_rotor.pack_sw_rotor(pairs, max_slots=max_slots, unroll=unroll)
    got = torch_rotor.sw_forward_rotor(
        torch.from_numpy(b.xrev), torch.from_numpy(b.ybuf), period=b.period,
        n_slots=b.n_slots, anchor=b.anchor, unroll=b.unroll, cfg=cfg).numpy()
    p8 = -(-b.n_slots // 8) * 8
    assert got.shape == (b.xrev.shape[0] * p8, 128) and got.dtype == np.int32
    assert not _first_p_rows(got, p8)[:, b.n_slots:].any()
    np.testing.assert_array_equal(_first_p_rows(got, b.n_slots),
                                  _first_p_rows(_run_jax(b, jcfg), b.n_slots))
    scores = torch_rotor.unpack_rotor(b, got, len(pairs))
    np.testing.assert_array_equal(scores, oracle.sw_scores_pairs(pairs, jcfg))
    np.testing.assert_array_equal(
        scores, torch_rotor.sw_scores_rotor(pairs, cfg, max_slots=max_slots,
                                            unroll=unroll, device="cpu"))
    if case != "ragged":
        miss = np.array([p.sx == b"A" * 63 for p in pairs])
        assert b.n_slots == 3 and not scores[miss].any()
        assert (scores[~miss] == 63 * cfg.match).all()


def test_unpack_equals_jax_unpack():
    pairs = _leak()
    b = torch_rotor.pack_sw_rotor(pairs, max_slots=4)
    res = np.random.default_rng(1).integers(0, 1000, (
        b.xrev.shape[0] * 8, 128)).astype(np.int32)
    np.testing.assert_array_equal(torch_rotor.unpack_rotor(b, res, 300),
                                  jax_rotor.unpack_rotor(b, res, 300))


def _buckets(pairs):
    """The port's buckets and the JAX pack's, which are equal."""
    ours, theirs = pack_sw_pairs(pairs), jax_pack_sw_pairs(pairs)
    assert len(ours) == len(theirs)
    return ours, theirs


def _short_pairs(seed, n=300, lo=3, hi=90):
    rng = np.random.default_rng(seed)
    return [SWPair(sx=_dna(rng, int(rng.integers(lo, hi))) + b"\n",
                   sy=_dna(rng, int(rng.integers(lo, hi))) + b"\n")
            for _ in range(n)]


def _assert_prep_equal(ours, theirs):
    assert (ours is None) == (theirs is None)
    if ours is None:
        return
    assert ours[1] == theirs[1]
    for a, w in zip(ours[0], theirs[0]):
        assert a.dtype == w.dtype and a.shape == w.shape
        np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("max_slots,n_shards", [(32, 1), (2, 1), (3, 2),
                                                (1, 8)])
def test_prep_equals_jax_prep(max_slots, n_shards):
    """Statics and both arrays, bucket by bucket, with tiles queued two or
    three deep and the tile count rounded to the shards."""
    pairs = _short_pairs(11, n=900)
    n_deep = 0
    for b, jb in zip(*_buckets(pairs)):
        T = torch_rotor._round_up(max(int(b.nx.max()), int(b.ny.max())), 8)
        ours = torch_rotor.prep_bucket_rotor(b, T, max_slots,
                                             n_shards=n_shards)
        theirs = jax_rotor.prep_bucket_rotor(jb, T, max_slots,
                                             n_shards=n_shards)
        _assert_prep_equal(ours, theirs)
        assert ours[0][0].shape[0] % n_shards == 0
        n_deep += ours[1]["n_slots"] > 1
    assert n_deep or max_slots == 1


def test_router_takes_the_jax_predicates_buckets():
    """maybe_prep_rotor routes or declines the same buckets as the JAX
    predicate, on square short buckets, the ragged short-x/long-y bucket
    that the geometry gate declines, buckets past rotor_max_period, with
    the rotor off, and for a sharded engine of 8 devices."""
    rng = np.random.default_rng(12)
    ragged = [SWPair(sx=b"ACGT" * 10 + b"\n", sy=_dna(rng, 120) + b"\n")
              for _ in range(8)]
    pairs = _short_pairs(13) + ragged + _short_pairs(14, n=20, lo=130,
                                                     hi=200)
    ours_b, theirs_b = _buckets(pairs)
    routed = {}
    for on, max_period, n_shards in [(True, 136, 1), (True, 136, 8),
                                     (True, 64, 1), (False, 136, 1)]:
        ours = EngineConfig(sw_rotor=on, rotor_max_period=max_period,
                            rotor_max_slots=3)
        theirs = JaxEngineConfig(sw_rotor=on, rotor_max_period=max_period,
                                 rotor_max_slots=3)
        for i, (b, jb) in enumerate(zip(ours_b, theirs_b)):
            got = torch_rotor.maybe_prep_rotor(ours, b, n_shards)
            _assert_prep_equal(got, jax_rotor.maybe_prep_rotor(theirs, jb,
                                                               n_shards))
            routed[(on, max_period, n_shards, i)] = got is not None
    taken = [routed[(True, 136, 1, i)] for i in range(len(ours_b))]
    assert any(taken) and not all(taken)
    (rb,) = pack_sw_pairs(ragged)
    assert torch_rotor.maybe_prep_rotor(EngineConfig(sw_rotor=True),
                                        rb) is None
    assert not any(v for k, v in routed.items() if not k[0])
    assert sum(routed[(True, 64, 1, i)] for i in range(len(ours_b))) < sum(
        taken)


@pytest.mark.parametrize("ly,routes", [(12, True), (11, False)],
                         ids=["equality-routes", "one-past-declines"])
def test_geometry_gate_equality_routes(ly, routes):
    """x of 11 and y of 12 bases: T = 16, NXs = 16, 24 diagonals, so
    3 T^2 == 2 NXs max_diags exactly, and the JAX code routes it (its
    comment says <, its code > declines); y of 11 gives 23 diagonals and
    declines in both."""
    pairs = [SWPair(sx=b"A" * 11, sy=b"C" * ly)]
    (b,), (jb,) = _buckets(pairs)
    T = 16
    assert (3 * T * T == 2 * b.sx.shape[1] * b.max_diags) == routes
    ours = torch_rotor.maybe_prep_rotor(EngineConfig(sw_rotor=True), b)
    theirs = jax_rotor.maybe_prep_rotor(JaxEngineConfig(sw_rotor=True), jb)
    assert (ours is not None) == (theirs is not None) == routes


def test_bucket_without_live_tiles_declines():
    """A bucket with no live tile: the JAX prep divides by zero, the
    port's prep and predicate return None."""
    (b,), (jb,) = _buckets(_short_pairs(15, n=5, lo=50, hi=51))
    b = dataclasses.replace(b, n_valid=0, perm=b.perm[:0])
    jb = dataclasses.replace(jb, n_valid=0, perm=jb.perm[:0])
    assert torch_rotor.prep_bucket_rotor(b, 96) is None
    assert torch_rotor.maybe_prep_rotor(EngineConfig(sw_rotor=True),
                                        b) is None
    with pytest.raises(ZeroDivisionError):
        jax_rotor.prep_bucket_rotor(jb, 96)


def _inputs():
    b = torch_rotor.pack_sw_rotor(_leak(), max_slots=4)
    return ((torch.from_numpy(b.xrev), torch.from_numpy(b.ybuf)),
            dict(period=b.period, n_slots=b.n_slots, anchor=b.anchor,
                 unroll=b.unroll))


@pytest.mark.parametrize("wrapper", ["sw_forward_rotor",
                                     "sw_forward_rotor_bucket"])
@pytest.mark.parametrize("pack_unroll,unroll", [(8, 24), (24, 16), (8, 12)],
                         ids=["T64-u24", "T72-u16", "T64-u12"])
def test_period_not_a_multiple_of_unroll_raises(wrapper, pack_unroll,
                                                unroll):
    """A period that unroll does not divide: the JAX kernel's harvest
    blocks miss period boundaries and it scores 0 without a word; the
    port raises, on every device, before any sweep or launch."""
    b = torch_rotor.pack_sw_rotor(_leak(), max_slots=4, unroll=pack_unroll)
    assert b.period % unroll
    with pytest.raises(ValueError, match="unroll"):
        getattr(torch_rotor, wrapper)(
            torch.from_numpy(b.xrev), torch.from_numpy(b.ybuf),
            period=b.period, n_slots=b.n_slots, anchor=b.anchor,
            unroll=unroll)


@pytest.mark.parametrize("bad", [dict(period=168), dict(n_slots=0),
                                 dict(anchor=10), dict(anchor=10**6),
                                 dict(n_slots=40)],
                         ids=["period", "slots-0", "anchor-short",
                              "anchor-past-nb", "slots-past-buffers"])
def test_wrapper_rejects_geometry(bad):
    t, st = _inputs()
    st = {**st, **bad}
    if bad.get("period") == 168:
        st["unroll"] = 24
    with pytest.raises(ValueError):
        torch_rotor.sw_forward_rotor(*t, **st)


def test_wrapper_rejects_dtypes_and_shapes():
    (x, y), st = _inputs()
    with pytest.raises(TypeError, match="dtypes"):
        torch_rotor.sw_forward_rotor(x.to(torch.int32), y, **st)
    with pytest.raises(ValueError, match="shapes"):
        torch_rotor.sw_forward_rotor(x, y[:, :, :64], **st)
    with pytest.raises(ValueError, match="one device"):
        torch_rotor.sw_forward_rotor(x, y.to("meta"), **st)


@pytest.mark.parametrize("c", CFGS, ids=CFG_IDS)
def test_bucket_wrapper_equals_jax_bucket_wrapper(c):
    """sw_forward_rotor_bucket on a prepared bucket, tiles queued three
    deep, == sw_forward_pallas_rotor_bucket in interpret mode, row for row
    in bucket tile order, == the lane-tile plain version's scores."""
    pairs = _short_pairs(16, n=700, lo=40, hi=64)
    cfg, jcfg = SWConfig(**c), JaxSWConfig(**c)
    (b,) = [b for b in pack_sw_pairs(pairs) if b.n_valid > 384]
    assert max(int(b.nx.max()), int(b.ny.max())) == 65
    prep = torch_rotor.prep_bucket_rotor(b, 72, 2)
    assert prep[1]["n_slots"] == 2 and prep[0][0].shape[0] >= 2
    got = torch_rotor.sw_forward_rotor_bucket(
        *sw_rotor_to_torch(prep, "cpu"), cfg=cfg, **prep[1]).numpy()
    want = np.asarray(jax_rotor.sw_forward_pallas_rotor_bucket(
        *prep[0], cfg=jcfg, interpret=True, **prep[1]))
    np.testing.assert_array_equal(got, want)
    tiles = executor.sw_forward(*(torch.from_numpy(a) for a in (
        b.sx, b.sy, b.ndiag_tile)), cfg).numpy()
    n = -(-b.n_valid // 128)
    np.testing.assert_array_equal(got[:n], tiles[:n])


def _engine_pairs(seed):
    """Short buckets the rotor takes, the ragged bucket its gate declines,
    and buckets of 128 rows and more for the strips kernel."""
    rng = np.random.default_rng(seed)
    pairs = _short_pairs(seed, n=400)
    pairs += [SWPair(sx=b"ACGT" * 10 + b"\n", sy=_dna(rng, 120) + b"\n")
              for _ in range(6)]
    g = _dna(rng, 63)
    pairs += [SWPair(sx=g, sy=g), SWPair(sx=b"A" * 63, sy=b"T" * 63)] * 4
    pairs += [SWPair(sx=_dna(rng, int(rng.integers(130, 200))),
                     sy=_dna(rng, int(rng.integers(130, 200))))
              for _ in range(8)]
    pairs += [SWPair(sx=b"", sy=b""), SWPair(sx=b"A", sy=b"A")]
    return pairs


@pytest.mark.parametrize("c", CFGS, ids=CFG_IDS)
def test_engine_matches_jax_engine_rotor(monkeypatch, c):
    """Engine(EngineConfig(sw_rotor=True, strips_min_nxs=128)) on the CPU
    == the JAX engine with sw_rotor=True and sw_strips=True (interpret
    mode) == native, with the same buckets and dp_cells; each bucket
    reaches the wrapper the JAX predicates pick for it."""
    pairs = _engine_pairs(9)
    cfg, jcfg = SWConfig(**c), JaxSWConfig(**c)
    routed = []
    for name in ("sw_forward", "sw_forward_strips", "sw_forward_rotor_bucket"):
        real = getattr(executor, name)
        monkeypatch.setattr(
            executor, name,
            lambda *a, _n=name, _f=real, **k: routed.append(_n) or _f(*a, **k))
    jcfg_e = JaxEngineConfig(backend="pallas", sw_rotor=True, sw_strips=True,
                             unroll=4)
    jax_eng = genomax.Engine(jcfg_e, sw_cfg=jcfg, interpret=True)
    eng = Engine(EngineConfig(sw_rotor=True, strips_min_nxs=128), sw_cfg=cfg,
                 device="cpu")
    got = eng.sw_scores(pairs)
    np.testing.assert_array_equal(got, jax_eng.sw_scores(pairs))
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs, jcfg))
    assert eng.last_stats.buckets == jax_eng.last_stats.buckets
    assert eng.last_stats.dp_cells == jax_eng.last_stats.dp_cells
    from genomax.kernels.sw_strips import maybe_prep_strips as jax_strips
    want = []
    for jb in jax_pack_sw_pairs(pairs):
        if jax_strips(jcfg_e, jb) is not None:
            want.append("sw_forward_strips")
        elif jax_rotor.maybe_prep_rotor(jcfg_e, jb) is not None:
            want.append("sw_forward_rotor_bucket")
        else:
            want.append("sw_forward")
    assert routed == want
    assert set(routed) == {"sw_forward", "sw_forward_strips",
                           "sw_forward_rotor_bucket"}


def test_engine_rotor_on_equals_off():
    pairs = _engine_pairs(10)
    on = Engine(EngineConfig(sw_rotor=True), device="cpu").sw_scores(pairs)
    off = Engine(EngineConfig(sw_rotor=False), device="cpu").sw_scores(pairs)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, native.sw_scores_native(pairs))


def test_rotor_build_failure_raises_engine_error(monkeypatch):
    """On a device that is not the CPU the rotor wrapper launches its
    kernel or raises: a build failure reaches the caller as EngineError,
    and the bucket goes neither to the lane-tile kernel nor to the CPU."""
    def fail(*args, **kwargs):
        raise _build.BuildError("nvcc failed (simulated)")

    tile_calls = []
    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(executor, "sw_forward",
                        lambda *a, **k: tile_calls.append(1))
    # Stand-in for device tensors on a host without a card.
    monkeypatch.setattr(
        executor, "sw_rotor_to_torch",
        lambda prep, device: tuple(t.to("meta") for t in
                                   sw_rotor_to_torch(prep, "cpu")))
    eng = Engine(EngineConfig(sw_rotor=True), device="cuda")
    with pytest.raises(EngineError) as err:
        eng.sw_scores(_short_pairs(17, n=20, lo=50, hi=60))
    assert isinstance(err.value.cause, _build.BuildError)
    assert tile_calls == []


def test_unpack_scores_reads_bucket_tile_order():
    """The bucket wrapper's rows are bucket tiles: unpack_scores of the
    rotor result equals the native model for a bucket of three tiles
    queued two deep (the last queue slot a pad queue)."""
    pairs = _short_pairs(18, n=300, lo=20, hi=30)
    buckets = pack_sw_pairs(pairs)
    res = []
    for b in buckets:
        prep = torch_rotor.prep_bucket_rotor(b, 32, 2)
        assert prep is not None
        res.append(torch_rotor.sw_forward_rotor_bucket(
            *sw_rotor_to_torch(prep, "cpu"), **prep[1]).numpy())
    np.testing.assert_array_equal(unpack_scores(buckets, res, len(pairs)),
                                  native.sw_scores_native(pairs))


# The kernel's geometry: G queues a warp and C columns a lane
# (kernels/sw_rotor.geometry). No card needed.

@pytest.mark.parametrize("period", list(range(8, 161, 8)))
@pytest.mark.parametrize("n_queues", [128, 1024, 6272])
def test_geometry_holds_every_router_period(period, n_queues):
    """At every period the router produces and a bucket of one rotor tile,
    of eight, and the 25,000 x 64bp bucket's 49 at four slots: a
    geometry the build makes, at the fewest columns a lane with which its
    segments hold the period's T - 1 columns, a block of 1-4 warps."""
    g = torch_rotor.geometry(period, n_queues)
    lanes = 32 // g.queues_per_warp
    assert (g.queues_per_warp, g.cols) in torch_rotor.GEOMETRIES
    assert lanes * g.cols >= period - 1 > lanes * (g.cols - 1)
    assert 1 <= g.warps_per_block <= torch_rotor.MAX_WARPS_PER_BLOCK


@pytest.mark.parametrize("period,n_queues,want", [
    (72, 6272, (4, 9, 4)), (72, 128, (1, 3, 1)), (136, 6272, (2, 9, 4)),
    (72, 1664, (2, 5, 4)), (40, 1024, (1, 2, 4)), (8, 12544, (4, 1, 4))],
    ids=["main-path", "one-tile", "T136", "T72-16-slots", "T40-eight-tiles",
         "T8"])
def test_geometry_choices(period, n_queues, want):
    """The picker packs queues into warps where the bucket fills the
    card's schedulers (the 64bp bucket at 4 slots: G = 4, C = 9, the
    fastest there) and fewer queues a warp where it does not (at 16
    slots, 13 rotor tiles: G = 2, C = 5, the fastest there; one rotor
    tile: a queue a warp)."""
    g = torch_rotor.geometry(period, n_queues)
    assert (g.queues_per_warp, g.cols, g.warps_per_block) == want


@pytest.mark.parametrize("geo", [(1, 6), (8, 1), (3, 4), (2, 11), (2, 0)],
                         ids=["G1-C6", "G8", "G3", "G2-C11", "C0"])
def test_geometry_refuses_what_the_build_does_not_make(geo):
    with pytest.raises(ValueError, match="build makes"):
        torch_rotor.geometry(72, 6272, *geo)


@pytest.mark.parametrize("period,geo", [(72, (2, 4)), (40, (4, 4)),
                                        (160, (1, 4))])
def test_geometry_refuses_a_segment_short_of_the_period(period, geo):
    with pytest.raises(ValueError, match="cannot hold"):
        torch_rotor.geometry(period, 128, *geo)


@pytest.mark.parametrize("wrapper", ["sw_forward_rotor",
                                     "sw_forward_rotor_bucket"])
@pytest.mark.parametrize("geo,match", [((1, 6), "build makes"),
                                       ((4, 7), "cannot hold")],
                         ids=["unbuilt", "short"])
def test_geometry_hook_raises_on_every_device(wrapper, geo, match):
    """The private _geometry= hook raises before any sweep for a
    geometry the build does not make or that cannot hold the period (T =
    64 here), on the CPU as on the card."""
    t, st = _inputs()
    assert st["period"] == 64
    with pytest.raises(ValueError, match=match):
        getattr(torch_rotor, wrapper)(*t, **st, _geometry=geo)


def test_geometry_hook_on_the_cpu_takes_the_plain_version():
    """On the CPU a geometry the build makes changes nothing: the plain
    sweep, equal to the call without it."""
    t, st = _inputs()
    want = torch_rotor.sw_forward_rotor_bucket(*t, **st)
    got = torch_rotor.sw_forward_rotor_bucket(*t, **st, _geometry=(2, 4))
    assert torch.equal(got, want)
