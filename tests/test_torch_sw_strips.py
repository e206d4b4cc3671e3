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
from genomax_torch.pack import (pack_sw_pairs, sw_strips_to_torch,
                                unpack_scores)
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
    assert torch_strips.smem_bytes(32, 26001) > torch_strips.MAX_SMEM_BYTES
    assert torch_strips.maybe_prep_strips(EngineConfig(), b) is None
    assert jax_strips.maybe_prep_strips(JaxEngineConfig(), b) is None


@pytest.mark.parametrize("nxs,nyt,want", [
    (32, 40, None), (33, 40, None), (40, 40, 32), (136, 129, 32),
    (520, 514, 96), (1008, 1001, 128), (136, 2001, 32)])
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
