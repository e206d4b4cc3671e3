"""The lane-tile route of the port on the CPU: the kernel's host geometry
(``kernels.sw.tile_geometry``: R rows a thread, warps a pair, pairs a
block) for each bucket shape, the R the build makes, the router's choice of
the lane tile for the default route's short-read bucket (x 100bp against y
300bp), and the wrapper's plain version at every R against
``genomax.kernels.sw_pallas`` in interpret mode and the native model
(int32, exact). The CUDA kernel itself is held against this plain version
on the card (tests/test_torch_kernel.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from genomax import native
from genomax.config import SWConfig as JaxSWConfig
from genomax.kernels.sw_pallas import sw_forward_pallas

from genomax_torch.config import MAX_KERNEL_ROWS, EngineConfig, SWConfig
from genomax_torch.engine import executor
from genomax_torch.engine.executor import Engine
from genomax_torch.io.formats import SWPair
from genomax_torch.kernels import sw
from genomax_torch.kernels.sw_rotor import maybe_prep_rotor
from genomax_torch.kernels.sw_stacked import maybe_prep_stacked
from genomax_torch.kernels.sw_strips import maybe_prep_strips
from genomax_torch.pack import pack_sw_pairs, sw_bucket_to_torch, unpack_scores
from _torch_cpu import one_torch_thread  # noqa: F401


def _dna(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()


# (NXs, R, warps a pair, pairs a block) of the default pick: a pair one
# warp holds is one warp at the fewest rows a thread that hold it, eight
# pairs a block; a taller one a block of warps at the R that wastes fewest
# rows (phase 5's 520 rows, phase 15's streamed 608-row bucket).
@pytest.mark.parametrize("nxs,r,warps,pairs", [
    (2, 2, 1, 8), (40, 2, 1, 8), (72, 3, 1, 8), (104, 4, 1, 8),
    (136, 5, 1, 8), (144, 5, 1, 8), (200, 8, 1, 8), (256, 8, 1, 8),
    (264, 5, 2, 1), (520, 6, 3, 1), (608, 5, 4, 1), (1024, 8, 4, 1),
    (2048, 8, 8, 1), (4096, 8, 16, 1), (4097, 8, 16, 1), (4098, 8, 17, 1),
    (6000, 8, 24, 1), (8192, 8, 32, 1), (8193, 8, 32, 1)])
def test_tile_geometry_picks_r_warps_and_pairs(nxs, r, warps, pairs):
    geo = sw.tile_geometry(nxs)
    assert (geo.rows_per_thread, geo.warps, geo.pairs) == (r, warps, pairs)
    assert geo.warps * sw.WARP * geo.rows_per_thread >= nxs - 1
    assert geo.warps == 1 or (geo.warps - 1) * sw.WARP * r < nxs - 1


@pytest.mark.parametrize("r", sw.ROWS_PER_THREAD)
def test_tile_geometry_at_every_built_r_holds_every_bucket(r):
    """At each R the build makes, every bucket height up to the kernel's
    8,193 rows that MAX_WARPS warps hold at R gets whole warps that hold
    its rows, at most MAX_WARPS a block (1,024 threads, the launch bound of
    the kernel's blocks past 16 warps); a taller one raises. At R = 8 that
    is every height; the engine's tallest bucket is MAX_KERNEL_ROWS."""
    assert sw.max_rows() == 8193 and sw.MAX_WARPS == 32
    assert MAX_KERNEL_ROWS == sw.max_rows() // 8 * 8
    for nxs in range(2, sw.max_rows() + 1):
        if nxs - 1 > sw.MAX_WARPS * sw.WARP * r:
            with pytest.raises(ValueError, match="warps a pair"):
                sw.tile_geometry(nxs, r)
            continue
        geo = sw.tile_geometry(nxs, r)
        assert geo.rows_per_thread == r
        assert geo.warps * sw.WARP * r >= nxs - 1
        assert (geo.warps - 1) * sw.WARP * r < nxs - 1
        assert 1 <= geo.warps <= sw.MAX_WARPS
        assert geo.pairs == (sw.PAIRS_PER_BLOCK if geo.warps == 1 else 1)
        assert geo.pairs * geo.warps * sw.WARP <= 1024


@pytest.mark.parametrize("bad", [dict(nxs=1), dict(nxs=8194),
                                 dict(nxs=72, r=7), dict(nxs=72, r=1)],
                         ids=["nxs-1", "nxs-8194", "r7", "r1"])
def test_tile_geometry_rejects(bad):
    with pytest.raises(ValueError):
        sw.tile_geometry(bad["nxs"], bad.get("r"))


def test_wrapper_rejects_an_r_the_build_does_not_make():
    (b,) = pack_sw_pairs([SWPair(sx=b"ACGT", sy=b"ACGT")])
    with pytest.raises(ValueError, match="rows_per_thread"):
        sw.sw_forward(*sw_bucket_to_torch(b, "cpu"), _rows_per_thread=7)


def _tile_pairs(seed):
    """Ragged pairs of 60-300 bases (buckets of 64-304 rows: one warp and
    a block of warps at every R), a tandem repeat whose copies straddle the
    32R-row group seams, an identical pair, an all-mismatch pair, a
    one-base y and an empty y."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(40):
        a = _dna(rng, int(rng.integers(60, 301)))
        b = _dna(rng, int(rng.integers(60, 301)))
        pairs.append(SWPair(sx=min(a, b, key=len), sy=max(a, b, key=len)))
    unit = _dna(rng, 70)
    pairs.append(SWPair(sx=_dna(rng, 37) + unit * 3,
                        sy=unit + _dna(rng, 41) + unit * 3))
    same = _dna(rng, 290)
    pairs += [SWPair(sx=same, sy=same), SWPair(sx=b"A" * 200, sy=b"C" * 250),
              SWPair(sx=same[:150], sy=b"G"), SWPair(sx=same[:120], sy=b"")]
    return pairs


CFG = dict(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)


@pytest.fixture(scope="module")
def jax_tile_case():
    """_tile_pairs' buckets, each scored once by the JAX lane-tile kernel
    in interpret mode, and the native model's scores."""
    pairs = _tile_pairs(5)
    buckets = pack_sw_pairs(pairs)
    jcfg = JaxSWConfig(**CFG)
    want = [np.asarray(sw_forward_pallas(b.sx, b.sy, b.ndiag_tile, cfg=jcfg,
                                         interpret=True)) for b in buckets]
    return pairs, buckets, want, native.sw_scores_native(pairs, jcfg)


@pytest.mark.parametrize("r", sw.ROWS_PER_THREAD)
def test_wrapper_plain_at_every_r_equals_jax_kernel(jax_tile_case, r):
    """sw_forward on the CPU at each R (its plain version: the score does
    not depend on the geometry) == the JAX lane-tile kernel in interpret
    mode == the native model, slot by slot and pair by pair."""
    pairs, buckets, want, nat = jax_tile_case
    cfg = SWConfig(**CFG)
    assert max(b.sx.shape[1] for b in buckets) > sw.WARP * 8
    results = []
    for b, w in zip(buckets, want):
        got = sw.sw_forward(*sw_bucket_to_torch(b, "cpu"), cfg,
                            _rows_per_thread=r).numpy()
        np.testing.assert_array_equal(got, w)
        results.append(got)
    scores = unpack_scores(buckets, results, len(pairs))
    np.testing.assert_array_equal(scores, nat)
    assert scores[-4] == 290 * cfg.match and scores[-3] == 0


def test_default_router_sends_short_reads_against_windows_to_the_tile(
        monkeypatch):
    """The default route's short-read bucket (x 100bp + '\\n' against y
    300bp + '\\n', 104 rows): strips, the rotor and the stacked kernel
    decline it, the engine scores it through sw_forward, and the kernel
    sweeps it with one warp a pair at R = 4, eight pairs a block."""
    rng = np.random.default_rng(9)
    pairs = [SWPair(sx=_dna(rng, 100) + b"\n", sy=_dna(rng, 300) + b"\n")
             for _ in range(200)]
    (b,) = pack_sw_pairs(pairs)
    cfg = EngineConfig()
    assert b.sx.shape[1] == 104
    assert maybe_prep_strips(cfg, b) is None
    assert maybe_prep_rotor(cfg, b) is None
    assert maybe_prep_stacked(cfg, b) is None
    assert sw.tile_geometry(104) == sw.TileGeometry(4, 1, 8)
    calls = []
    real = executor.sw_forward
    monkeypatch.setattr(executor, "sw_forward",
                        lambda *a, **k: calls.append(a[0].shape)
                        or real(*a, **k))
    got = Engine(cfg, device="cpu").sw_scores(pairs)
    assert calls == [torch.Size([2, 104, 128])]
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs))
