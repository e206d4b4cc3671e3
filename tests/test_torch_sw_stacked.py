"""The stacked route of the port on the CPU: the re-stack and the router
against ``genomax.kernels.sw_stacked`` array for array (statics, declines
and errors included); the rotor's predicate under ``sw_stack``; the plain
stacked sweep (``wavefront.sw_stacked_forward_tiles`` through
``sw_forward_stacked``) against the JAX stacked kernel in interpret mode
and the oracle on ragged buckets and the ghost-read adversaries, under
three scorings (int32, exact: no tolerance); the engine with
``sw_stack=4`` against the JAX engine in the same configuration; the
config's thread limit and the wrapper's checks. The CUDA kernel itself is
held against this plain version on the card (tests/test_torch_kernel.py,
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
from genomax.kernels import sw_stacked as jax_stacked
from genomax.pack.bucketing import pack_sw_pairs as jax_pack_sw_pairs

from genomax_torch.config import EngineConfig, SWConfig
from genomax_torch.engine import executor
from genomax_torch.engine.executor import Engine, EngineError
from genomax_torch.kernels import _build
from genomax_torch.kernels import sw_rotor as torch_rotor
from genomax_torch.kernels import sw_stacked as torch_stacked
from genomax_torch.pack import (pack_sw_pairs, sw_stacked_to_torch,
                                unpack_scores)
from _phmm_cases import stacked_ghost_pairs, stacked_sw_pairs
from _torch_cpu import one_torch_thread  # noqa: F401

CFGS = [dict(), dict(match=2, mismatch=-3, gap_open=0, gap_extend=-1),
        dict(match=3, mismatch=-1, gap_open=-5, gap_extend=-2)]
CFG_IDS = ["default", "m2x3o0e1", "m3x1o5e2"]
ABC = np.frombuffer(b"ATGC", np.uint8)


def _dna(rng, n):
    return rng.choice(ABC, n).tobytes()


def _ragged(seed=44, n=260):
    """The random set and ghost adversaries of
    tests/test_pallas_interpret.py's stacked test: x of 3-59 and y of
    3-63 bases (the shorter as x), over two tiles so a stack of 2
    interleaves; an x equal to another pair's y against an all-mismatch y
    and the reverse (a leak of the neighbour's stream would score about
    len x); an identical pair and a one-base pair."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        a = _dna(rng, int(rng.integers(3, 60)))
        b = _dna(rng, int(rng.integers(3, 64)))
        if len(a) > len(b):
            a, b = b, a
        pairs.append(SWPair(sx=a, sy=b))
    ghost_y = _dna(rng, 60)
    pairs.append(SWPair(sx=b"A" * 50, sy=ghost_y))
    pairs.append(SWPair(sx=ghost_y, sy=b"T" * 60))
    s = _dna(rng, 55)
    pairs.append(SWPair(sx=s, sy=s))
    pairs.append(SWPair(sx=b"A", sy=b"A"))
    return pairs


def _buckets(pairs):
    """The port's buckets and the JAX pack's, which are equal."""
    ours, theirs = pack_sw_pairs(pairs), jax_pack_sw_pairs(pairs)
    assert len(ours) == len(theirs)
    return ours, theirs


def _assert_prep_equal(ours, theirs):
    assert (ours is None) == (theirs is None)
    if ours is None:
        return
    assert ours[1] == theirs[1]
    for a, w in zip(ours[0], theirs[0]):
        assert a.dtype == w.dtype and a.shape == w.shape
        np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("max_x", [14, 62, 94])
@pytest.mark.parametrize("stack", [2, 3, 4])
def test_prep_equals_jax_prep(stack, max_x):
    """Statics and the three arrays on ragged buckets of five tiles (pad
    tiles at every stack), and on the two-tile ragged bucket."""
    cases = [stacked_sw_pairs(stack, max_x)]
    if max_x == 62:
        cases.append(_ragged())
    for pairs in cases:
        for b, jb in zip(*_buckets(pairs)):
            ours = torch_stacked.prep_bucket_stacked(b, stack)
            _assert_prep_equal(ours, jax_stacked.prep_bucket_stacked(jb,
                                                                     stack))
            assert ours is not None
            (sx, _, ndt), st = ours
            assert sx.shape[0] * stack >= b.sx.shape[0] and st["h"] == \
                b.sx.shape[1]
            assert ndt.max() == b.ndiag_tile.max()


def _router_buckets():
    """Buckets the router takes, one past stack_max_nxs (x of 100-120,
    y within h), one whose y passes h (x of 40 against y of 300) and one
    of a single tile."""
    rng = np.random.default_rng(12)
    out = {"short": _ragged(), "one-tile": _ragged(n=60)}
    out["past-max-nxs"] = [SWPair(sx=_dna(rng, int(rng.integers(100, 121))),
                                  sy=_dna(rng, 100)) for _ in range(300)]
    out["long-y"] = [SWPair(sx=_dna(rng, 40), sy=_dna(rng, 300))
                     for _ in range(300)]
    return out


@pytest.mark.parametrize("sw_stack", [0, 1, 2, 4])
def test_router_takes_the_jax_predicates_buckets(sw_stack):
    """maybe_prep_stacked routes or declines as the JAX predicate does:
    off below 2, past stack_max_nxs, a y past h, one tile."""
    ours_cfg = EngineConfig(sw_stack=sw_stack)
    theirs_cfg = JaxEngineConfig(sw_stack=sw_stack)
    taken = {}
    for name, pairs in _router_buckets().items():
        (b,), (jb,) = _buckets(pairs)
        got = torch_stacked.maybe_prep_stacked(ours_cfg, b)
        _assert_prep_equal(got, jax_stacked.maybe_prep_stacked(theirs_cfg,
                                                               jb))
        taken[name] = got is not None
    assert taken == {"short": sw_stack >= 2, "one-tile": False,
                     "past-max-nxs": False, "long-y": False}


def test_window_past_anchor_raises():
    """h > a0: both preps raise 'stream anchor' (a hand-built bucket)."""
    (b,), (jb,) = _buckets(_ragged(n=256))
    bad = dataclasses.replace(b, sy=b.sy[:, : b.sx.shape[1] - 1, :])
    jbad = dataclasses.replace(jb, sy=jb.sy[:, : jb.sx.shape[1] - 1, :])
    with pytest.raises(ValueError, match="stream anchor"):
        jax_stacked.prep_bucket_stacked(jbad, 2)
    with pytest.raises(ValueError, match="stream anchor"):
        torch_stacked.prep_bucket_stacked(bad, 2)


@pytest.mark.parametrize("sw_stack", [0, 1, 2, 4])
def test_rotor_declines_under_stack_as_jax(sw_stack):
    """The rotor predicate's third gate: sw_stack >= 2 declines every
    bucket, below 2 the rotor takes the short buckets, in both packages."""
    taken = []
    for pairs in _router_buckets().values():
        (b,), (jb,) = _buckets(pairs)
        ours = torch_rotor.maybe_prep_rotor(
            EngineConfig(sw_rotor=True, sw_stack=sw_stack), b)
        theirs = jax_rotor.maybe_prep_rotor(
            JaxEngineConfig(sw_rotor=True, sw_stack=sw_stack), jb)
        assert (ours is None) == (theirs is None)
        taken.append(ours is not None)
    assert any(taken) == (sw_stack < 2)


def _plain(b, stack, cfg):
    prep = torch_stacked.prep_bucket_stacked(b, stack)
    return torch_stacked.sw_forward_stacked(
        *sw_stacked_to_torch(prep, "cpu"), cfg=cfg, **prep[1]).numpy()


@pytest.mark.parametrize("c", CFGS, ids=CFG_IDS)
@pytest.mark.parametrize("stack", [2, 4])
def test_plain_equals_jax_stacked_kernel(stack, c):
    """sw_forward_stacked on CPU tensors == run_bucket_stacked in
    interpret mode, row for row (pad regions included) == the oracle
    after unpack_scores, on the ragged set with its ghost adversaries."""
    pairs = _ragged() if not c else _ragged(45, n=130)
    cfg, jcfg = SWConfig(**c), JaxSWConfig(**c)
    buckets, jbuckets = _buckets(pairs)
    res = []
    for b, jb in zip(buckets, jbuckets):
        got = _plain(b, stack, cfg)
        want = np.asarray(jax_stacked.run_bucket_stacked(
            jb, stack, cfg=jcfg, unroll=8, interpret=True))
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        res.append(got)
    scores = unpack_scores(buckets, res, len(pairs))
    np.testing.assert_array_equal(scores, oracle.sw_scores_pairs(pairs, jcfg))


def test_ghost_read_directed_scores_zero():
    """The directed adversary: region 1's x is region 0's stream in the
    same lane. Every pair scores 0, in the port's plain sweep and in the
    JAX kernel alike; without the window mask region 1 would score 50."""
    pairs = stacked_ghost_pairs(47)
    (b,), (jb,) = _buckets(pairs)
    assert b.sx.shape[0] == 2
    got = _plain(b, 2, SWConfig())
    np.testing.assert_array_equal(got, np.asarray(
        jax_stacked.run_bucket_stacked(jb, 2, unroll=8, interpret=True)))
    scores = unpack_scores([b], [got], len(pairs))
    assert not scores.any()
    np.testing.assert_array_equal(scores, oracle.sw_scores_pairs(pairs))


def test_run_bucket_stacked_on_the_cpu():
    pairs = stacked_sw_pairs(3, 30)
    (b,) = pack_sw_pairs(pairs)
    got = torch_stacked.run_bucket_stacked(b, 3, device="cpu")
    assert got.shape == (2 * 3, 128)
    np.testing.assert_array_equal(
        unpack_scores([b], [got.numpy()], len(pairs)),
        native.sw_scores_native(pairs))
    with pytest.raises(ValueError, match="cannot stack"):
        torch_stacked.run_bucket_stacked(b, 1, device="cpu")


def _engine_pairs(seed):
    """A short bucket the stacked router takes (64 rows), one of 96 rows
    it declines (six of its y pass h), and buckets of 128 rows and more
    for the strips kernel."""
    rng = np.random.default_rng(seed)
    pairs = _ragged(seed, n=300)
    pairs += [SWPair(sx=b"ACGT" * 20 + b"\n", sy=_dna(rng, 120) + b"\n")
              for _ in range(6)]
    pairs += [SWPair(sx=_dna(rng, int(rng.integers(70, 94))),
                     sy=_dna(rng, int(rng.integers(40, 94))))
              for _ in range(200)]
    pairs += [SWPair(sx=_dna(rng, int(rng.integers(130, 200))),
                     sy=_dna(rng, int(rng.integers(130, 200))))
              for _ in range(8)]
    pairs += [SWPair(sx=b"", sy=b""), SWPair(sx=b"A", sy=b"A")]
    return pairs


@pytest.mark.parametrize("c", CFGS[:2], ids=CFG_IDS[:2])
def test_engine_matches_jax_engine_stacked(monkeypatch, c):
    """Engine(EngineConfig(sw_stack=4, strips_min_nxs=128)) on the CPU ==
    the JAX engine with sw_stack=4 (interpret mode; its strips floor is
    128) == the oracle, with the same buckets and dp_cells; each bucket
    reaches the wrapper the JAX predicates pick."""
    pairs = _engine_pairs(48)
    cfg, jcfg = SWConfig(**c), JaxSWConfig(**c)
    routed = []
    for name in ("sw_forward", "sw_forward_strips", "sw_forward_rotor_bucket",
                 "sw_forward_stacked"):
        real = getattr(executor, name)
        monkeypatch.setattr(
            executor, name,
            lambda *a, _n=name, _f=real, **k: routed.append(_n) or _f(*a, **k))
    jcfg_e = JaxEngineConfig(backend="pallas", sw_stack=4, unroll=8)
    jax_eng = genomax.Engine(jcfg_e, sw_cfg=jcfg, interpret=True)
    eng = Engine(EngineConfig(sw_stack=4, strips_min_nxs=128), sw_cfg=cfg,
                 device="cpu")
    got = eng.sw_scores(pairs)
    np.testing.assert_array_equal(got, jax_eng.sw_scores(pairs))
    np.testing.assert_array_equal(got, oracle.sw_scores_pairs(pairs, jcfg))
    assert eng.last_stats.buckets == jax_eng.last_stats.buckets
    assert eng.last_stats.dp_cells == jax_eng.last_stats.dp_cells
    from genomax.kernels.sw_strips import maybe_prep_strips as jax_strips
    want = []
    for jb in jax_pack_sw_pairs(pairs):
        if jax_strips(jcfg_e, jb) is not None:
            want.append("sw_forward_strips")
        elif jax_rotor.maybe_prep_rotor(jcfg_e, jb) is not None:
            want.append("sw_forward_rotor_bucket")
        elif jax_stacked.maybe_prep_stacked(jcfg_e, jb) is not None:
            want.append("sw_forward_stacked")
        else:
            want.append("sw_forward")
    assert routed == want
    assert set(routed) == {"sw_forward", "sw_forward_strips",
                           "sw_forward_stacked"}


def test_engine_takes_the_stacked_route_only_when_asked(monkeypatch):
    """With a counting stand-in for sw_forward_stacked: sw_stack=4 sends
    the short buckets there (and none to the rotor), sw_stack=0 none;
    both score alike."""
    calls = []
    real = executor.sw_forward_stacked
    monkeypatch.setattr(executor, "sw_forward_stacked",
                        lambda *a, **k: calls.append(k["stack"])
                        or real(*a, **k))
    pairs = _engine_pairs(49)
    on = Engine(EngineConfig(sw_stack=4), device="cpu").sw_scores(pairs)
    assert calls and set(calls) == {4}
    calls.clear()
    off = Engine(EngineConfig(), device="cpu").sw_scores(pairs)
    assert calls == []
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, native.sw_scores_native(pairs))


def test_stacked_build_failure_raises_engine_error(monkeypatch):
    """On a device that is not the CPU the stacked wrapper launches its
    kernel or raises: a build failure reaches the caller as EngineError,
    and the bucket goes neither to the lane tile nor to the CPU."""
    def fail(*args, **kwargs):
        raise _build.BuildError("nvcc failed (simulated)")

    tile_calls = []
    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(executor, "sw_forward",
                        lambda *a, **k: tile_calls.append(1))
    # Stand-in for device tensors on a host without a card.
    monkeypatch.setattr(
        executor, "sw_stacked_to_torch",
        lambda prep, device: tuple(t.to("meta") for t in
                                   sw_stacked_to_torch(prep, "cpu")))
    eng = Engine(EngineConfig(sw_stack=2), device="cuda")
    with pytest.raises(EngineError) as err:
        eng.sw_scores(stacked_sw_pairs(5, 30, n_pairs=300))
    assert isinstance(err.value.cause, _build.BuildError)
    assert tile_calls == []


@pytest.mark.parametrize("kw", [dict(sw_stack=11), dict(sw_stack=2,
                                                       stack_max_nxs=520),
                                dict(sw_stack=16, stack_max_nxs=72)],
                         ids=["11x96", "2x520", "16x72"])
def test_config_past_the_thread_limit_raises(kw):
    with pytest.raises(ValueError, match="sw_stack"):
        EngineConfig(**kw)


@pytest.mark.parametrize("kw", [dict(sw_stack=10), dict(sw_stack=1,
                                                       stack_max_nxs=2000),
                                dict(sw_stack=16, stack_max_nxs=64)],
                         ids=["10x96", "off", "16x64"])
def test_config_within_the_thread_limit_constructs(kw):
    cfg = EngineConfig(**kw)
    assert cfg.sw_stack == kw["sw_stack"]


def _inputs(stack=2):
    (b,) = pack_sw_pairs(stacked_sw_pairs(6, 30, n_pairs=300))
    prep = torch_stacked.prep_bucket_stacked(b, stack)
    return sw_stacked_to_torch(prep, "cpu"), prep[1]


@pytest.mark.parametrize("bad", [dict(stack=1), dict(stack=3),
                                 dict(h=24), dict(stack=40, h=32)],
                         ids=["stack-1", "rows-not-stack-x-h", "h-off",
                              "past-1024"])
def test_wrapper_rejects_geometry(bad):
    t, st = _inputs()
    with pytest.raises(ValueError):
        torch_stacked.sw_forward_stacked(*t, **{**st, **bad})


def test_wrapper_rejects_dtypes_devices_and_shapes():
    (x, y, nd), st = _inputs()
    with pytest.raises(TypeError, match="dtypes"):
        torch_stacked.sw_forward_stacked(x.to(torch.int32), y, nd, **st)
    with pytest.raises(TypeError, match="dtypes"):
        torch_stacked.sw_forward_stacked(x, y, nd.long(), **st)
    with pytest.raises(ValueError, match="one device"):
        torch_stacked.sw_forward_stacked(x, y.to("meta"), nd, **st)
    with pytest.raises(ValueError, match="shapes"):
        torch_stacked.sw_forward_stacked(x, y[:, :, :64], nd, **st)
    with pytest.raises(ValueError, match="shapes"):
        torch_stacked.sw_forward_stacked(x, y, nd[:1], **st)
    with pytest.raises(ValueError, match="anchor"):
        torch_stacked.sw_forward_stacked(x, y[:, : 2 * st["h"] + 8], nd,
                                         **st)
    with pytest.raises(ValueError, match="diagonals"):
        torch_stacked.sw_forward_stacked(x, y[:, : 3 * st["h"]], nd, **st)


# The kernel's geometry: R rows a thread, the regions a warp holds and
# the warps a stack (kernels/sw_stacked.geometry). No card needed.

@pytest.mark.parametrize("h", list(range(8, 97, 8)))
@pytest.mark.parametrize("stack", [2, 3, 4, 5, 6, 7, 8])
def test_geometry_at_router_heights(stack, h):
    """At every bucket height up to stack_max_nxs (96) and stack 2-8: an
    R the build makes, a region's rows 1 .. h-1 on lanes of one warp,
    the warp's regions within its 32 lanes, every region in a warp."""
    g = torch_stacked.geometry(stack, h)
    assert g.rows_per_thread in torch_stacked.ROWS_PER_THREAD
    assert g.lanes_per_region == -(-(h - 1) // g.rows_per_thread) <= 32
    assert g.regions_per_warp * g.lanes_per_region <= 32
    assert g.regions_per_warp * g.warps_per_stack >= stack
    assert (g.regions_per_warp - 1) * g.warps_per_stack < stack


@pytest.mark.parametrize("stack,h,want", [
    (4, 72, (9, 8, 4, 1)), (2, 72, (5, 15, 2, 1)), (8, 72, (9, 8, 4, 2)),
    (2, 512, (16, 32, 1, 2)), (128, 8, (8, 1, 32, 4))],
    ids=["main-S4", "main-S2", "main-S8", "tallest", "deepest"])
def test_geometry_choices(stack, h, want):
    """The main path's stacks fill one warp's rows (S = 4: four regions of
    8 lanes at R = 9) or two; the contract's extremes still fit."""
    g = torch_stacked.geometry(stack, h)
    assert (g.rows_per_thread, g.lanes_per_region, g.regions_per_warp,
            g.warps_per_stack) == want


@pytest.mark.parametrize("stack,h,r,match", [
    (4, 72, 7, "build makes"), (4, 72, 1, "build makes"),
    (2, 512, 8, "past a warp"), (2, 96, 2, "past a warp")],
    ids=["R7", "R1", "h512-R8", "h96-R2"])
def test_geometry_refuses_what_the_build_does_not_make(stack, h, r, match):
    with pytest.raises(ValueError, match=match):
        torch_stacked.geometry(stack, h, r)


@pytest.mark.parametrize("r", [7, 11, 32])
def test_rows_per_thread_hook_raises_on_every_device(r):
    """The private _rows_per_thread= hook raises before any sweep for an R
    the build does not make, on the CPU as on the card."""
    t, st = _inputs()
    with pytest.raises(ValueError, match="build makes"):
        torch_stacked.sw_forward_stacked(*t, **st, _rows_per_thread=r)


def test_rows_per_thread_hook_on_the_cpu_takes_the_plain_version():
    t, st = _inputs()
    want = torch_stacked.sw_forward_stacked(*t, **st)
    got = torch_stacked.sw_forward_stacked(*t, **st, _rows_per_thread=16)
    assert torch.equal(got, want)
