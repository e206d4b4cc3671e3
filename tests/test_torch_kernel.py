"""The CUDA kernels against their plain PyTorch versions on the card:
csrc/sw_tile.cu, csrc/sw_long.cu, csrc/sw_strips.cu, csrc/sw_rotor.cu,
csrc/sw_stacked.cu, csrc/sw_conveyor.cu and csrc/sw_xstrip.cu (int32
scores and states, exact; the cross-device ring at K = 1-8 strips on one
card, and ShardedEngine on a one-rank mesh),
csrc/pairhmm_tile.cu and
csrc/pairhmm_long.cu (within 1e-4 in log10, or two fp32 ulps of values
below -512: nvcc contracts a*b+c into FMAs, the plain version rounds each
operation). Needs a CUDA device and nvcc; skips without them. This file
imports no jax, so on a machine without jax it runs as
`python -m pytest --noconftest tests/test_torch_kernel.py`."""

import numpy as np
import pytest
import torch

from genomax_torch import native, trace
from genomax_torch.config import EngineConfig, PairHMMConfig, SWConfig
from genomax_torch.io.formats import SWPair
from genomax_torch.io.generator import generate_pairhmm_batch
from genomax_torch.pack.bucketing import (pack_pairhmm_batches,
                                          pack_sw_pairs, unpack_scores)

from _phmm_cases import (CONVEYOR_KINDS, conveyor_leak_pairs,
                         conveyor_sw_pairs, conveyor_tall_pairs,
                         deep_decay_batches, hc_long_batches,
                         height_sw_pairs, long_jobs,
                         long_seam_jobs, long_sw_pairs, phmm_batches,
                         rotor_leak_pairs, rotor_sw_pairs, short_phmm_batches,
                         stacked_ghost_pairs, stacked_sw_pairs,
                         streamed_batches, streamed_sw_pairs, strips_sw_pairs,
                         tall_phmm_batches, tall_sw_pairs, tight_rows,
                         xshard_cases, xstrip_inputs)
from genomax_torch.dist import xsharded
from genomax_torch.engine.executor import Engine
from genomax_torch.kernels import (_build, pairhmm, pairhmm_long, sw,
                                   sw_conveyor, sw_long, sw_rotor, sw_stacked,
                                   sw_strips)
from genomax_torch.kernels.wavefront import (phmm_forward_tiles,
                                             phmm_long_forward,
                                             sw_conveyor_forward_tiles,
                                             sw_forward_tiles,
                                             sw_long_forward,
                                             sw_long_forward_dense,
                                             sw_rotor_forward_tiles,
                                             sw_stacked_forward_tiles,
                                             sw_strips_forward_tiles,
                                             sw_xstrip_block)
from genomax_torch.pack import (phmm_bucket_to_torch, sw_bucket_to_torch,
                                sw_rotor_to_torch, sw_stacked_to_torch,
                                sw_strips_to_torch)

pytestmark = pytest.mark.cuda

CFGS = [SWConfig(), SWConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2),
        SWConfig(match=3, mismatch=-1, gap_open=0, gap_extend=-2)]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda finds no CUDA device")
    if _build.nvcc() is None:
        pytest.skip("nvcc not found on PATH or under $CUDA_HOME")
    return torch.device("cuda")


def _ragged_pairs(seed, n=300, hi=700):
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = [SWPair(sx=b"", sy=b""), SWPair(sx=b"\n", sy=b"A\n")]
    for _ in range(n):
        a = rng.choice(abc, int(rng.integers(1, hi))).tobytes() + b"\n"
        b = rng.choice(abc, int(rng.integers(1, hi))).tobytes() + b"\n"
        pairs.append(SWPair(sx=min(a, b, key=len), sy=max(a, b, key=len)))
    x = rng.choice(abc, 250).tobytes()
    pairs.append(SWPair(sx=x, sy=x + rng.choice(abc, 256).tobytes() + x))
    return pairs


@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_kernel_equals_plain_version(device, cfg):
    pairs = _ragged_pairs(3)
    buckets = pack_sw_pairs(pairs)
    before = trace.launched("tile")
    results = []
    for b in buckets:
        sx, sy, nd = sw_bucket_to_torch(b, device)
        got = sw.sw_forward(sx, sy, nd, cfg)
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == torch.int32
        want = sw_forward_tiles(sx, sy, nd, cfg)
        assert torch.equal(got, want)
        results.append(got.cpu().numpy())
    assert trace.launched("tile") - before == len(buckets)
    np.testing.assert_array_equal(unpack_scores(buckets, results, len(pairs)),
                                  native.sw_scores_native(pairs, cfg))


def test_wrapper_rejects_bad_inputs(device):
    (b,) = pack_sw_pairs([SWPair(sx=b"ACGT", sy=b"ACGT")])
    sx, sy, nd = sw_bucket_to_torch(b, device)
    with pytest.raises(TypeError):
        sw.sw_forward(sx.to(torch.int32), sy, nd)
    wide = torch.ones((1, 1032, 128), dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="NXs"):
        sw.sw_forward(wide, torch.zeros((1, 2048, 128), dtype=torch.int8,
                                        device=device), nd)


def test_kernel_streamed_bucket_equals_plain_version(device):
    """x of 30-600bp against y of 6-10kbp: every bucket's stream passes
    the 6,144 rows the JAX engine keeps resident (its _kernel_streamed
    buckets); the CUDA kernel reads the stream from global memory at any
    length."""
    pairs = streamed_sw_pairs(4, n_pairs=200)
    buckets = pack_sw_pairs(pairs)
    assert min(b.sy.shape[1] for b in buckets) > 6144
    results = []
    for b in buckets:
        sx, sy, nd = sw_bucket_to_torch(b, device)
        got = sw.sw_forward(sx, sy, nd)
        torch.cuda.synchronize()
        assert torch.equal(got, sw_forward_tiles(sx, sy, nd))
        results.append(got.cpu().numpy())
    np.testing.assert_array_equal(unpack_scores(buckets, results, len(pairs)),
                                  native.sw_scores_native(pairs))


def _seam_buckets(seed):
    """Ragged pairs of up to 700bp and pairs ending on and next to the
    sub-strip seams of every R, with a tandem repeat across the seams, an
    identical pair, an all-mismatch pair, a one-base y and an empty y:
    buckets of one warp a pair at every R and, past 32 R rows, of a block
    of warps."""
    heights = [32 * r for r in sw.ROWS_PER_THREAD]
    pairs = _ragged_pairs(11, n=80) + height_sw_pairs(12, heights,
                                                      max_len=600)
    return pairs, pack_sw_pairs(pairs)


@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_tile_kernel_every_r_equals_plain_version(device, cfg):
    """The lane-tile kernel at every R the build makes == its plain version
    on every bucket of _seam_buckets (8-608 rows), exact, one launch a
    bucket; the scores == native."""
    pairs, buckets = _seam_buckets(4)
    assert max(b.sx.shape[1] for b in buckets) > 32 * max(sw.ROWS_PER_THREAD)
    want = [sw_forward_tiles(*sw_bucket_to_torch(b, device), cfg)
            for b in buckets]
    for r in sw.ROWS_PER_THREAD:
        before = trace.launched("tile")
        for b, w in zip(buckets, want):
            got = sw.sw_forward(*sw_bucket_to_torch(b, device), cfg,
                                _rows_per_thread=r)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32
            assert torch.equal(got, w), (r, b.sx.shape)
        assert trace.launched("tile") - before == len(buckets)
    scores = unpack_scores(buckets, [w.cpu().numpy() for w in want],
                           len(pairs))
    np.testing.assert_array_equal(scores, native.sw_scores_native(pairs, cfg))
    assert scores[-4] == 257 * cfg.match and scores[-3] == 0


def test_sw_tile_kernel_every_r_streamed_bucket(device):
    """Streams past 6,144 rows (x 30-600bp in y of 6-10kbp): every R ==
    the plain version, exact."""
    pairs = streamed_sw_pairs(6, n_pairs=60)
    buckets = pack_sw_pairs(pairs)
    assert min(b.sy.shape[1] for b in buckets) > 6144
    for b in buckets:
        t = sw_bucket_to_torch(b, device)
        want = sw_forward_tiles(*t)
        for r in sw.ROWS_PER_THREAD:
            got = sw.sw_forward(*t, _rows_per_thread=r)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (r, b.sx.shape)


@pytest.mark.parametrize("height,y_short", [
    (2048, True), (2048, False), (4096, False)],
    ids=["2048-resident", "2048-streamed", "4096-streamed"])
def test_sw_tile_and_strips_past_1024_rows(device, height, y_short):
    """Buckets of 2,048 and 4,096 rows (max_device_len up to 4,096): the
    lane tile's block form at every R that 32 warps hold it at (8 to 32
    warps) and the strips kernel == the plain lane-tile sweep, exact, under
    two configs; the scores == native."""
    pairs = tall_sw_pairs(7, height, n_pairs=128, y_short=y_short)
    (b,) = pack_sw_pairs(pairs)
    assert b.sx.shape[1] == height
    t = sw_bucket_to_torch(b, device)
    for cfg in CFGS[:2]:
        want = sw_forward_tiles(*t, cfg)
        rs = [r for r in sw.ROWS_PER_THREAD
              if height - 1 <= sw.MAX_WARPS * sw.WARP * r]
        for r in rs:
            assert sw.tile_geometry(height, r).warps >= 8
            got = sw.sw_forward(*t, cfg, _rows_per_thread=r)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (r, cfg)
        st, kw = _strips_inputs(b, device, None)
        got = sw_strips.sw_forward_strips(*st, cfg=cfg, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), cfg
        scores = unpack_scores([b], [want.cpu().numpy()], len(pairs))
        np.testing.assert_array_equal(scores,
                                      native.sw_scores_native(pairs, cfg))


@pytest.mark.parametrize("level", [0, 1, 2],
                         ids=["4328-rows", "6112-rows", "8192-rows"])
def test_sw_tile_and_strips_past_4096_rows(device, level):
    """The three buckets of x of 4,100-8,190bp against y of x to x +
    1,000bp (4,328, 6,112 and 8,192 rows): the lane tile's blocks of 17-32
    warps (17, 24 and 32 at R = 8) at every R that 32 warps hold them at,
    and the strips kernel, == the plain lane-tile sweep, exact; the scores
    == native."""
    pairs = tall_sw_pairs(7, 8192, n_pairs=128, x_min=4100, y_less=0)
    b = pack_sw_pairs(pairs)[level]
    height = b.sx.shape[1]
    t = sw_bucket_to_torch(b, device)
    want = sw_forward_tiles(*t)
    rs = [r for r in sw.ROWS_PER_THREAD
          if height - 1 <= sw.MAX_WARPS * sw.WARP * r]
    assert 8 in rs and sw.tile_geometry(height).warps > 16
    before = trace.launched("tile")
    for r in rs:
        got = sw.sw_forward(*t, _rows_per_thread=r)
        torch.cuda.synchronize()
        assert torch.equal(got, want), r
    assert trace.launched("tile") == before + len(rs)
    st, kw = _strips_inputs(b, device, None)
    got = sw_strips.sw_forward_strips(*st, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    scores = unpack_scores([b], [want.cpu().numpy()], len(pairs))
    np.testing.assert_array_equal(
        scores[b.perm], native.sw_scores_native([pairs[i] for i in b.perm]))


@pytest.mark.parametrize("strip_w", [None, 88], ids=["router", "w88"])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_strips_kernel_every_r_equals_plain_version(device, cfg, strip_w):
    """The strips kernel at every R the build makes == the plain lane-tile
    sweep on every bucket of _seam_buckets of 88 rows or more, at the
    router's strip width (one strip) and at 88 rows (re-padded strips that
    the sub-strips cut across), exact, one launch a bucket."""
    pairs, buckets = _seam_buckets(5)
    big = [b for b in buckets if b.sx.shape[1] >= 88]
    assert len(big) >= 4
    for b in big:
        want = sw_forward_tiles(*sw_bucket_to_torch(b, device), cfg)
        t, st = _strips_inputs(b, device, strip_w)
        for r in sw_strips.ROWS_PER_THREAD:
            before = trace.launched("strips")
            got = sw_strips.sw_forward_strips(*t, cfg=cfg, **st,
                                              _rows_per_thread=r)
            torch.cuda.synchronize()
            assert trace.launched("strips") - before == 1
            assert torch.equal(got, want), (r, b.sx.shape, st)


@pytest.mark.parametrize("strip_w", [64, 1024], ids=["w64", "w1024"])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_long_kernel_equals_plain_version(device, cfg, strip_w):
    """A ragged tile with an identical pair, a tandem repeat across a strip
    seam, an all-mismatch pair and a one-base pair: kernel == plain (the
    strip sweep and the full-height sweep) == native."""
    pairs = long_sw_pairs(7, n_pairs=24, x_lens=(300, 900), y_max=1200,
                          seam=256 if strip_w == 64 else 1024)
    b = sw_long.pack_sw_long(pairs, strip_w)
    sx, sy, nx, ny = sw_long.tile_to_torch(b, device)
    kw = dict(k_strips=b.n_strips, strip_w=b.strip_w, ny_max=b.ny_max,
              cfg=cfg)
    _, anchor, _ = sw_long._layout(b.ny_max, b.strip_w)
    want = sw_long_forward(sx, sy, nx, ny, b.n_strips, b.strip_w, anchor, cfg)
    assert torch.equal(want, sw_long_forward_dense(sx, sy, b.n_diags,
                                                   b.ny_max, anchor, cfg))
    np.testing.assert_array_equal(want.cpu().numpy()[:len(pairs)],
                                  native.sw_scores_native(pairs, cfg))
    assert int(want[len(pairs) - 4]) == 900 * cfg.match  # the identical pair
    # every R the build makes
    for r in sw_long.ROWS_PER_THREAD:
        before = trace.launched("sw_long")
        got = sw_long.sw_forward_long(sx, sy, nx, ny, **kw,
                                      _rows_per_thread=r)
        torch.cuda.synchronize()
        assert trace.launched("sw_long") - before == 1
        assert got.is_cuda and got.dtype == torch.int32
        assert got.shape == (128,)
        assert torch.equal(got, want), r


@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_long_kernel_seams_at_every_r(device, cfg):
    """A tile taller than MAX_ROWS (5 strips of 1,024 rows, two sub-strips
    of 2,560 at every R), with the tandem repeat laid across the sub-strip
    seam: the kernel at each R == the plain full-height sweep == native."""
    pairs = long_sw_pairs(9, n_pairs=24, x_lens=(4200, 4400), y_max=4600,
                          seam=2560)
    b = sw_long.pack_sw_long(pairs)
    sx, sy, nx, ny = sw_long.tile_to_torch(b, device)
    _, anchor, _ = sw_long._layout(b.ny_max, b.strip_w)
    want = sw_long_forward_dense(sx, sy, b.n_diags, b.ny_max, anchor, cfg)
    np.testing.assert_array_equal(want.cpu().numpy()[:len(pairs)],
                                  native.sw_scores_native(pairs, cfg))
    for r in sw_long.ROWS_PER_THREAD:
        geo = sw_long.geometry(b.n_strips * b.strip_w, b.ny_max, r)
        assert (geo.n_sub, geo.height) == (2, 2560), r
        got = sw_long.sw_forward_long(sx, sy, nx, ny, k_strips=b.n_strips,
                                      strip_w=b.strip_w, ny_max=b.ny_max,
                                      cfg=cfg, _rows_per_thread=r)
        torch.cuda.synchronize()
        assert torch.equal(got, want), r


def test_sw_long_scores_tiles_in_input_order(device):
    pairs = long_sw_pairs(8, n_pairs=130, x_lens=(200, 700), y_max=800,
                          seam=256)
    before = trace.launched("sw_long")
    got = sw_long.sw_scores_long(pairs, device=device, strip_w=256)
    assert trace.launched("sw_long") - before == 2
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs))


def test_sw_long_wrapper_rejects_bad_inputs(device):
    b = sw_long.pack_sw_long(long_sw_pairs(1, n_pairs=5, x_lens=(40, 90),
                                           y_max=120, seam=128), 64)
    sx, sy, nx, ny = sw_long.tile_to_torch(b, device)
    kw = dict(k_strips=b.n_strips, strip_w=b.strip_w, ny_max=b.ny_max)
    with pytest.raises(TypeError):
        sw_long.sw_forward_long(sx.to(torch.int32), sy, nx, ny, **kw)
    with pytest.raises(ValueError, match="strip_w"):
        sw_long.sw_forward_long(sx, sy, nx, ny, **{**kw, "strip_w": 100})
    with pytest.raises(ValueError, match="rows_per_thread"):
        sw_long.sw_forward_long(sx, sy, nx, ny, **kw, _rows_per_thread=6)
    with pytest.raises(ValueError, match="one device"):
        sw_long.sw_forward_long(sx, sy, nx.cpu(), ny, **kw)
    wide = torch.ones((2 * sx.shape[0], 128), dtype=torch.int8,
                      device=device)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        sw_long.sw_forward_long(wide, sy, nx, ny, **kw)


def _strips_inputs(b, device, strip_w=None):
    prep = sw_strips.prep_bucket_strips(b, strip_w)
    (_, _, _, nyt), st = prep
    return sw_strips_to_torch(prep, b, device), dict(st, ny_max=int(nyt.max()))


@pytest.mark.parametrize("strip_w", [None, 88], ids=["router", "w88"])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_strips_kernel_equals_plain_version(device, cfg, strip_w):
    """Ragged buckets of 136-408 rows (an identical pair, a tandem repeat
    across seams, an all-mismatch pair, a one-base y, an empty y): kernel
    == plain strip sweep == plain lane-tile sweep == native, at the
    router's strip width and at 88 rows, where every last strip is
    re-padded."""
    pairs = strips_sw_pairs(3, n_pairs=150, x_lens=(126, 400))
    buckets = pack_sw_pairs(pairs)
    big = [b for b in buckets if b.sx.shape[1] >= 128]
    assert len(big) >= 3
    before = trace.launched("strips")
    results = []
    for b in buckets:
        tiles = sw_bucket_to_torch(b, device)
        want = sw_forward_tiles(*tiles, cfg)
        if b.sx.shape[1] >= 128:
            t, st = _strips_inputs(b, device, strip_w)
            assert (st["k_strips"] * st["strip_w"] != b.sx.shape[1]
                    or strip_w is None)
            got = sw_strips.sw_forward_strips(*t, cfg=cfg, **st)
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == torch.int32
            assert torch.equal(got, want)
            del st["ny_max"]
            assert torch.equal(got, sw_strips_forward_tiles(*t, cfg=cfg,
                                                            **st))
        results.append(want.cpu().numpy())
    assert trace.launched("strips") - before == len(big)
    np.testing.assert_array_equal(unpack_scores(buckets, results, len(pairs)),
                                  native.sw_scores_native(pairs, cfg))


def test_sw_strips_wrapper_rejects_bad_inputs(device):
    b = pack_sw_pairs(strips_sw_pairs(1, n_pairs=10, x_lens=(130, 140)))[-1]
    t, st = _strips_inputs(b, device)
    with pytest.raises(TypeError):
        sw_strips.sw_forward_strips(t[0].to(torch.int32), *t[1:], **st)
    with pytest.raises(ValueError, match="strip_w"):
        sw_strips.sw_forward_strips(*t, **{**st, "strip_w": 2048})
    with pytest.raises(ValueError, match="one device"):
        sw_strips.sw_forward_strips(t[0], t[1], t[2].cpu(), t[3], **st)
    # A ring one entry short for the longest y: the kernel cannot see it
    # from the host without a copy back, so that pair scores -1.
    short = sw_strips.sw_forward_strips(*t, **{**st,
                                               "ny_max": st["ny_max"] - 1})
    torch.cuda.synchronize()
    bad = (t[3] > st["ny_max"] - 1).view(short.shape)
    assert bool(bad.any()) and bool((short[bad] == -1).all())
    assert bool((short[~bad] >= 0).all())


def test_engine_strips_on_equals_off(device):
    """The engine with sw_strips on and off on the card: the same scores,
    equal to native, the buckets of 128 rows or more through the strips
    kernel and the rest through the lane-tile kernel."""
    pairs = strips_sw_pairs(5, n_pairs=400, x_lens=(60, 900))
    n_big = sum(b.sx.shape[1] >= 128 for b in pack_sw_pairs(pairs))
    base = trace.counts()
    on = Engine(EngineConfig(sw_strips=True, strips_min_nxs=128,
                             sw_rotor=False), device=device).sw_scores(pairs)
    assert (trace.launched("tile", base), trace.launched("strips", base)) == (
        len(pack_sw_pairs(pairs)) - n_big, n_big)
    base = trace.counts()
    off = Engine(EngineConfig(sw_strips=False, sw_rotor=False),
                 device=device).sw_scores(pairs)
    assert trace.launched("strips", base) == 0 and trace.launched("tile", base) == len(
        pack_sw_pairs(pairs))
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, native.sw_scores_native(pairs))


def _rotor_prep(b, max_slots):
    """The rotor prep of bucket b at its own period, gate or no gate."""
    T = -(-max(int(b.nx.max()), int(b.ny.max())) // 8) * 8
    return sw_rotor.prep_bucket_rotor(b, T, max_slots)


@pytest.mark.parametrize("max_slots", [2, 32])
@pytest.mark.parametrize("length", [39, 47, 63, 79, 135])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_rotor_kernel_equals_plain_version(device, cfg, length,
                                              max_slots):
    """Ragged short buckets at periods 40-136 (the unrolls 8, 24, 32, 16
    and 8), queues 2 deep and up to 32, an identical pair at the period's
    edge, an all-mismatch pair, a one-base y and a one-base pair: kernel
    == plain rotor sweep == plain lane-tile sweep == native, in both
    wrappers."""
    pairs = rotor_sw_pairs(3, length, n_pairs=400)
    buckets = pack_sw_pairs(pairs)
    before = trace.launched("rotor")
    results = []
    for b in buckets:
        prep = _rotor_prep(b, max_slots)
        x, y = sw_rotor_to_torch(prep, device)
        got = sw_rotor.sw_forward_rotor_bucket(x, y, cfg=cfg, **prep[1])
        full = sw_rotor.sw_forward_rotor(x, y, cfg=cfg, **prep[1])
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == torch.int32
        plain = sw_rotor_forward_tiles(x, y, cfg=cfg, **prep[1])
        assert torch.equal(full, plain)
        p, p8 = prep[1]["n_slots"], -(-prep[1]["n_slots"] // 8) * 8
        assert torch.equal(got, plain.view(-1, p8, 128)[:, :p].reshape(-1,
                                                                     128))
        n = -(-b.n_valid // 128)
        want = sw_forward_tiles(*sw_bucket_to_torch(b, device), cfg)
        assert torch.equal(got[:n], want[:n])
        results.append(got.cpu().numpy())
    assert trace.launched("rotor") - before == 2 * len(buckets)
    np.testing.assert_array_equal(unpack_scores(buckets, results, len(pairs)),
                                  native.sw_scores_native(pairs, cfg))


@pytest.mark.parametrize("length", [63, 71])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_rotor_kernel_holds_the_queue_leak(device, cfg, length):
    """Tiles of identical pairs and of all-mismatch pairs in turns, queued
    two deep: every all-mismatch pair right behind a maximum-scoring one
    scores exactly 0, and the identical pairs length * match."""
    (b,) = pack_sw_pairs(rotor_leak_pairs(5, length))
    prep = _rotor_prep(b, 2)
    assert prep[1]["n_slots"] == 2
    x, y = sw_rotor_to_torch(prep, device)
    got = sw_rotor.sw_forward_rotor_bucket(x, y, cfg=cfg, **prep[1])
    torch.cuda.synchronize()
    plain = sw_rotor_forward_tiles(x, y, cfg=cfg, **prep[1])
    assert torch.equal(got, plain.view(-1, 8, 128)[:, :2].reshape(-1, 128))
    assert bool((got[0::2] == length * cfg.match).all())
    assert not bool(got[1::2].any())


@pytest.mark.parametrize("length", [7, 15, 39, 63, 71, 135])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_rotor_kernel_every_geometry_equals_plain_version(device, cfg,
                                                             length):
    """Ragged short buckets at periods 8-136, queued three deep: the kernel
    at every geometry (G, C) the build makes whose segments hold the
    period == the plain rotor sweep, both wrappers, exact, one launch a
    call; and the queue-leak adversary at T = 64 and 72 at each of its
    geometries, every all-mismatch pair 0."""
    pairs = rotor_sw_pairs(9, length, n_pairs=300)
    n_runs = 0
    before = trace.launched("rotor")
    for b in pack_sw_pairs(pairs):
        prep = _rotor_prep(b, 3)
        x, y = sw_rotor_to_torch(prep, device)
        st = prep[1]
        plain = sw_rotor_forward_tiles(x, y, cfg=cfg, **st)
        p, p8 = st["n_slots"], -(-st["n_slots"] // 8) * 8
        for geo in sw_rotor.GEOMETRIES:
            if (32 // geo[0]) * geo[1] < st["period"] - 1:
                continue
            full = sw_rotor.sw_forward_rotor(x, y, cfg=cfg, **st,
                                             _geometry=geo)
            got = sw_rotor.sw_forward_rotor_bucket(x, y, cfg=cfg, **st,
                                                   _geometry=geo)
            torch.cuda.synchronize()
            assert torch.equal(full, plain), (geo, st)
            assert torch.equal(got, plain.view(-1, p8, 128)[:, :p].reshape(
                -1, 128)), (geo, st)
            n_runs += 2
    assert n_runs and trace.launched("rotor") - before == n_runs
    if length in (63, 71):
        (b,) = pack_sw_pairs(rotor_leak_pairs(5, length))
        prep = _rotor_prep(b, 2)
        x, y = sw_rotor_to_torch(prep, device)
        for geo in sw_rotor.GEOMETRIES:
            if (32 // geo[0]) * geo[1] < prep[1]["period"] - 1:
                continue
            got = sw_rotor.sw_forward_rotor_bucket(x, y, cfg=cfg, **prep[1],
                                                   _geometry=geo)
            torch.cuda.synchronize()
            assert bool((got[0::2] == length * cfg.match).all()), geo
            assert not bool(got[1::2].any()), geo


def test_sw_rotor_out_of_contract(device):
    """The wrappers raise before any launch on a period past 160 or one
    the unroll does not divide; a launch whose buffers are too short for
    the sweep writes -1 to each slot of its queues and nothing else."""
    (b,) = pack_sw_pairs(rotor_leak_pairs(6, 63))
    prep = _rotor_prep(b, 2)
    x, y = sw_rotor_to_torch(prep, device)
    st = prep[1]
    before = trace.launched("rotor")
    with pytest.raises(ValueError, match="period"):
        sw_rotor.sw_forward_rotor(x, y, **{**st, "period": 168,
                                          "unroll": 24})
    with pytest.raises(ValueError, match="unroll"):
        sw_rotor.sw_forward_rotor(x, y, **{**st, "unroll": 24})
    assert trace.launched("rotor") == before
    out = sw_rotor._launch(x, y, st["period"], st["n_slots"], 8, 8,
                           SWConfig(), "test")
    torch.cuda.synchronize()
    assert trace.launched("rotor") == before + 1
    assert bool((out[:, :st["n_slots"]] == -1).all())
    assert not bool(out[:, st["n_slots"]:].any())


def test_engine_rotor_on_equals_off(device):
    """The engine with the rotor on and off on the card: the same scores,
    equal to native; with the rotor on, the buckets its predicate takes
    launch the rotor kernel and no other."""
    pairs = (rotor_sw_pairs(7, 63, n_pairs=300)
             + rotor_sw_pairs(8, 135, n_pairs=200)
             + strips_sw_pairs(9, n_pairs=60, x_lens=(200, 400)))
    cfg_on = EngineConfig(sw_rotor=True, strips_min_nxs=128)
    buckets = pack_sw_pairs(pairs)
    n_strips = sum(sw_strips.maybe_prep_strips(cfg_on, b) is not None
                   for b in buckets)
    n_rotor = sum(sw_strips.maybe_prep_strips(cfg_on, b) is None
                  and sw_rotor.maybe_prep_rotor(cfg_on, b) is not None
                  for b in buckets)
    assert n_rotor >= 2 and n_strips >= 1
    base = trace.counts()
    on = Engine(cfg_on, device=device).sw_scores(pairs)
    assert (trace.launched("rotor", base), trace.launched("strips", base),
            trace.launched("tile", base)) == (
        n_rotor, n_strips, len(buckets) - n_rotor - n_strips)
    base = trace.counts()
    off = Engine(EngineConfig(sw_rotor=False, strips_min_nxs=128),
                 device=device).sw_scores(pairs)
    assert trace.launched("rotor", base) == 0
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, native.sw_scores_native(pairs))


def _stacked(b, stack, device):
    prep = sw_stacked.prep_bucket_stacked(b, stack)
    assert prep is not None
    return sw_stacked_to_torch(prep, device), prep[1]


@pytest.mark.parametrize("max_x", [6, 30, 62, 70, 94])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_stacked_kernel_equals_plain_version(device, cfg, max_x):
    """Ragged buckets of 8-96 rows and five tiles, stacked 2, 3, 4 deep
    and as deep as 1,024 threads allow (pad tiles at each), with an
    identical pair, an all-mismatch pair, a one-base y and (up to 62
    bases) a one-base pair: kernel == plain stacked sweep == plain
    lane-tile sweep == native; the pad tiles score 0."""
    pairs = stacked_sw_pairs(max_x, max_x)
    (b,) = pack_sw_pairs(pairs)
    nt, h = b.sx.shape[:2]
    tiles = sw_forward_tiles(*sw_bucket_to_torch(b, device), cfg)
    want = native.sw_scores_native(pairs, cfg)
    before = trace.launched("stacked")
    stacks = (2, 3, 4, 1024 // h)
    for stack in stacks:
        t, st = _stacked(b, stack, device)
        got = sw_stacked.sw_forward_stacked(*t, cfg=cfg, **st)
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == torch.int32
        assert torch.equal(got, sw_stacked_forward_tiles(*t, cfg=cfg, **st))
        assert torch.equal(got[:nt], tiles)
        assert not bool(got[nt:].any())
        np.testing.assert_array_equal(
            unpack_scores([b], [got.cpu().numpy()], len(pairs)), want)
    assert trace.launched("stacked") - before == len(stacks)


@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_stacked_kernel_reads_no_ghosts(device, cfg):
    """The directed ghost-read adversary, stacked 2 deep: region 1's x is
    region 0's stream in the same lane, and every pair scores 0."""
    (b,) = pack_sw_pairs(stacked_ghost_pairs(47))
    t, st = _stacked(b, 2, device)
    got = sw_stacked.sw_forward_stacked(*t, cfg=cfg, **st)
    torch.cuda.synchronize()
    assert got.shape == (2, 128) and not bool(got.any())


@pytest.mark.parametrize("max_x", [6, 30, 62, 70, 94])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_stacked_kernel_every_r_equals_plain_version(device, cfg, max_x):
    """The buckets of test_sw_stacked_kernel_equals_plain_version stacked
    2, 3, 4, 8 deep and as deep as 1,024 rows allow: the kernel at every R
    the build makes at which a region fits a warp == the plain stacked
    sweep, exact, one launch a call; the ghost-read adversary at every R
    scores 0."""
    (b,) = pack_sw_pairs(stacked_sw_pairs(max_x, max_x))
    h = b.sx.shape[1]
    n_runs, before = 0, trace.launched("stacked")
    for stack in sorted({2, 3, 4, min(8, 1024 // h), 1024 // h}):
        t, st = _stacked(b, stack, device)
        want = sw_stacked_forward_tiles(*t, cfg=cfg, **st)
        for r in sw_stacked.ROWS_PER_THREAD:
            if -(-(h - 1) // r) > 32:
                continue
            got = sw_stacked.sw_forward_stacked(*t, cfg=cfg, **st,
                                                _rows_per_thread=r)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (stack, h, r)
            n_runs += 1
    assert trace.launched("stacked") - before == n_runs
    (b,) = pack_sw_pairs(stacked_ghost_pairs(47))
    t, st = _stacked(b, 2, device)
    for r in sw_stacked.ROWS_PER_THREAD:
        got = sw_stacked.sw_forward_stacked(*t, cfg=cfg, **st,
                                            _rows_per_thread=r)
        torch.cuda.synchronize()
        assert not bool(got.any()), r


def test_sw_stacked_out_of_contract(device):
    """The wrapper raises before any launch past 1,024 threads or below a
    stack of 2; a launch whose tiles sweep past the stream's anchor
    writes -1 to their slots."""
    (b,) = pack_sw_pairs(stacked_sw_pairs(7, 30))
    (x, y, nd), st = _stacked(b, 2, device)
    before = trace.launched("stacked")
    with pytest.raises(ValueError, match="1024"):
        sw_stacked.sw_forward_stacked(x.repeat(1, 17, 1), y, nd, stack=34,
                                      h=32)
    with pytest.raises(ValueError, match="stack"):
        sw_stacked.sw_forward_stacked(x, y, nd, stack=1, h=64)
    assert trace.launched("stacked") == before
    h = st["h"]
    short = y[:, : 3 * h].contiguous()  # anchor h < every tile's diagonals
    assert int(nd.min()) > h
    out = sw_stacked._launch(x, short, nd, 2, h, SWConfig())
    torch.cuda.synchronize()
    assert trace.launched("stacked") == before + 1
    assert bool((out == -1).all())


@pytest.mark.parametrize("stack", [2, 4, 8])
def test_engine_stacked_route(device, stack):
    """EngineConfig(sw_stack=S) on the card: the short buckets launch the
    stacked kernel, none the rotor; the scores equal the default route's
    and the native model's."""
    pairs = (stacked_sw_pairs(8, 62) + stacked_sw_pairs(9, 70)
             + strips_sw_pairs(9, n_pairs=60, x_lens=(200, 400)))
    cfg = EngineConfig(sw_stack=stack)
    buckets = pack_sw_pairs(pairs)
    n_stacked = sum(sw_strips.maybe_prep_strips(cfg, b) is None
                    and sw_stacked.maybe_prep_stacked(cfg, b) is not None
                    for b in buckets)
    assert n_stacked == 2
    base = trace.counts()
    on = Engine(cfg, device=device).sw_scores(pairs)
    assert (trace.launched("stacked", base), trace.launched("rotor", base)) == (
        n_stacked, 0)
    off = Engine(device=device).sw_scores(pairs)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, native.sw_scores_native(pairs))


def _conveyor(pairs, max_slots, device):
    b = sw_conveyor.pack_sw_conveyor(pairs, max_slots=max_slots)
    t = (torch.from_numpy(b.sched).to(device),
         torch.from_numpy(b.sy).to(device))
    return b, t, dict(nxs=b.nxs, n_slots=b.n_slots, period=b.period,
                      a0=b.a0)


def _conveyor_geometries(nxs):
    """The default geometry (None) and every (G, R, W) the build makes
    whose lanes hold a window of nxs rows."""
    return [None, *sw_conveyor.geometries_holding(nxs)]


@pytest.mark.parametrize("max_slots", [1, 2, 4, 64])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_conveyor_kernel_equals_plain_version(device, cfg, max_slots):
    """Ragged short pairs, y past the window (T > nxs, and past the lanes'
    rows at the fewest rows a lane) and x longer than y, each with an
    identical pair, an all-mismatch pair, one-base pairs and pairs without
    a '\\n', queued one to three slots deep: the kernel at its default
    geometry and at every (G, R, W) the build makes that holds the window
    (the block form among them) == plain conveyor sweep on every row (rows
    P..P8-1 are 0) == native."""
    before, runs, past_lanes = trace.launched("conveyor"), 0, False
    for i, kind in enumerate(CONVEYOR_KINDS):
        pairs = conveyor_sw_pairs(40 + i, kind)
        b, t, st = _conveyor(pairs, max_slots, device)
        want = sw_conveyor_forward_tiles(*t, cfg=cfg,
                                         unroll=sw_conveyor.UNROLL, **st)
        p8 = -(-b.n_slots // 8) * 8
        for geo in _conveyor_geometries(b.nxs):
            got = sw_conveyor.sw_forward_conveyor(*t, cfg=cfg, **st,
                                                  _geometry=geo)
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == torch.int32
            assert torch.equal(got, want), (kind, geo)
            assert not bool(got.view(-1, p8, 128)[:, b.n_slots:].any())
            past_lanes |= geo is not None and (
                (32 // geo[0]) * geo[1] * geo[2] < b.period - 1)
            runs += 1
        np.testing.assert_array_equal(
            sw_conveyor.unpack_conveyor(b, got.cpu().numpy(), len(pairs)),
            native.sw_scores_native(pairs, cfg))
    assert past_lanes
    assert trace.launched("conveyor") - before == runs


@pytest.mark.parametrize("x_len", [45, 20])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_conveyor_kernel_holds_the_queue_leak(device, cfg, x_len):
    """Maximum-scoring and all-mismatch pairs in turns in every lane's
    queue, at T = nxs = 48 and at T = 48 > nxs = 24, at the default
    geometry and every one that holds the window: every all-mismatch pair
    scores exactly 0, every other x_len * match."""
    pairs = conveyor_leak_pairs(33, x_len, 45)
    b, t, st = _conveyor(pairs, 4, device)
    assert b.n_slots == 4 and (b.period == b.nxs) == (x_len == 45)
    want = sw_conveyor_forward_tiles(*t, cfg=cfg, unroll=sw_conveyor.UNROLL,
                                     **st)
    for geo in _conveyor_geometries(b.nxs):
        got = sw_conveyor.sw_forward_conveyor(*t, cfg=cfg, **st,
                                              _geometry=geo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), geo
        slots = got.view(8, 128)
        assert bool((slots[0::2][:2] == x_len * cfg.match).all()), geo
        assert not bool(slots[1::2].any()), geo


@pytest.mark.parametrize("x_max", [700, 1022], ids=["nxs704", "nxs1024"])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_conveyor_kernel_tall_window(device, cfg, x_max):
    """Windows past one warp's 512 rows (x of 600 .. x_max bases, queues
    two deep): the default geometry takes the block form, and it and every
    block geometry that holds the window == the plain conveyor sweep on
    every row == native."""
    pairs = conveyor_tall_pairs(35, x_max)
    b, t, st = _conveyor(pairs, 2, device)
    assert b.nxs > 512 and b.n_slots == 2
    assert sw_conveyor.geometry(b.nxs, 128).warps_per_queue > 1
    want = sw_conveyor_forward_tiles(*t, cfg=cfg, unroll=sw_conveyor.UNROLL,
                                     **st)
    geos = _conveyor_geometries(b.nxs)
    assert len(geos) >= 2 and all(g[2] > 1 for g in geos[1:])
    for geo in geos:
        got = sw_conveyor.sw_forward_conveyor(*t, cfg=cfg, **st,
                                              _geometry=geo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), geo
    np.testing.assert_array_equal(
        sw_conveyor.unpack_conveyor(b, got.cpu().numpy(), len(pairs)),
        native.sw_scores_native(pairs, cfg))


def test_sw_conveyor_out_of_contract(device):
    """The wrapper raises before any launch on nxs past 1,024 or a period
    below the window; a launch whose stream is too short for the sweep
    writes -1 to every slot, 0 to the rows past P, and nothing else."""
    b, (s, y), st = _conveyor(conveyor_leak_pairs(34, 45, 45), 4, device)
    before = trace.launched("conveyor")
    with pytest.raises(ValueError, match="nxs"):
        sw_conveyor.sw_forward_conveyor(s, y, **{**st, "nxs": 1032,
                                                 "period": 1032})
    with pytest.raises(ValueError, match="period"):
        sw_conveyor.sw_forward_conveyor(s, y, **{**st, "period": 40})
    assert trace.launched("conveyor") == before
    out = sw_conveyor._launch(s, y, st["nxs"], st["n_slots"], st["period"],
                              10, SWConfig())
    torch.cuda.synchronize()
    assert trace.launched("conveyor") == before + 1
    blocks = out.view(-1, 8, 128)
    assert bool((blocks[:, :st["n_slots"]] == -1).all())
    assert not bool(blocks[:, st["n_slots"]:].any())


def test_sw_scores_conveyor_on_the_card(device):
    """The library entry on the card: one launch, scores == the native
    model, == the entry on the CPU."""
    pairs = conveyor_sw_pairs(44, "ragged", n_pairs=700)
    before = trace.launched("conveyor")
    got = sw_conveyor.sw_scores_conveyor(pairs, max_slots=2, device=device)
    assert trace.launched("conveyor") == before + 1
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs))
    np.testing.assert_array_equal(got, sw_conveyor.sw_scores_conveyor(
        pairs, max_slots=2, device="cpu"))


@pytest.mark.parametrize("alphabet,gatk,period", [
    (b"ACGT", False, 32), (b"ACGT", True, 8), (b"ACGTX", False, 32),
    (b"ACGTX", True, 1)], ids=["bitmask", "bitmask-gatk-p8", "bytes",
                               "bytes-gatk-p1"])
def test_pairhmm_kernel_close_to_plain_version(device, alphabet, gatk, period):
    cfg = PairHMMConfig(gatk_emission=gatk)
    buckets, n = pack_pairhmm_batches(phmm_batches(5, alphabet),
                                      byte_quals=True, factored=True,
                                      bitmask_codes=True)
    assert all(b.bitmask_codes == (alphabet == b"ACGT") for b in buckets)
    _pairhmm_buckets_close(buckets, device, cfg.mm_div, period)


def test_pairhmm_kernel_streamed_bucket_close_to_plain_version(device):
    """151bp reads against 7-10kbp haplotypes: a stream past the 6,144
    rows the JAX engine keeps resident (its _kernel_streamed buckets); the
    CUDA kernel reads the stream from global memory at any length."""
    buckets, _ = pack_pairhmm_batches(streamed_batches(3), byte_quals=True,
                                      factored=True, bitmask_codes=True)
    assert max(b.nds for b in buckets) > 6144
    _pairhmm_buckets_close(buckets, device, 1.0, 32)


def _assert_log10_close(got, want, valid):
    """Pairs too deep for fp32 come out -inf in both (the engine's fallback
    takes them); every finite result agrees within 1e-4, or two fp32 ulps
    of the value below -512 log10, where one ulp is already 6.1e-5 (1.2e-4
    below -1024)."""
    assert got.is_cuda and got.dtype == torch.float32
    got, want = got.reshape(-1)[valid], want.reshape(-1)[valid]
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    torch.testing.assert_close(got[fin], want[fin], rtol=2.0**-22, atol=1e-4)


def _pairhmm_buckets_close(buckets, device, mm_div, period):
    before = trace.launched("pairhmm_tile")
    for b in buckets:
        t = phmm_bucket_to_torch(b, device)
        got = pairhmm.pairhmm_forward(*t, rescale_period=period,
                                      mm_div=mm_div, bitmask=b.bitmask_codes)
        torch.cuda.synchronize()
        want = phmm_forward_tiles(*t, period, mm_div, b.bitmask_codes)
        _assert_log10_close(got, want, torch.from_numpy(b.rl > 0).to(device))
    assert trace.launched("pairhmm_tile") - before == len(buckets)


# Plain results on the card, shared by the R variants of one case.
_PLAIN = {}


def _pairhmm_close_at_r(case, groups, device, mm_div, period, r, bitmask):
    """Every bucket of each group of batches (packed a group at a time), as
    packed and cut to its rows (tight_rows), whose rows fit a warp at R
    rows a thread, or a block of warps at an R of the block form: the
    kernel at R against the plain version; at least one bucket. Returns
    the count run."""
    buckets = [b for g in groups for b in pack_pairhmm_batches(
        g, byte_quals=True, factored=True, bitmask_codes=bitmask)[0]]
    ran = 0
    for i, b in enumerate(buckets):
        full = phmm_bucket_to_torch(b, device)
        for j, (t, nxs) in enumerate(((full, b.nxs),
                                      tight_rows(full, b.rl))):
            if -(-nxs // r) > pairhmm.WARP and r not in pairhmm.BLOCK_R:
                with pytest.raises(ValueError, match="more than a warp"):
                    pairhmm.tile_geometry(nxs, r)
                continue
            before = trace.launched("pairhmm_tile")
            got = pairhmm.pairhmm_forward(*t, rescale_period=period,
                                          mm_div=mm_div,
                                          bitmask=b.bitmask_codes,
                                          _rows_per_thread=r)
            torch.cuda.synchronize()
            assert trace.launched("pairhmm_tile") == before + 1
            key = (case, bitmask, i, j, period, mm_div)
            if key not in _PLAIN:
                _PLAIN[key] = phmm_forward_tiles(*t, period, mm_div,
                                                 b.bitmask_codes)
            _assert_log10_close(got, _PLAIN[key],
                                torch.from_numpy(b.rl > 0).to(device))
            ran += 1
    assert ran
    return ran


@pytest.mark.parametrize("codes", ["bitmask", "bytes-gatk"])
@pytest.mark.parametrize("r", pairhmm.TILE_R)
def test_pairhmm_kernel_every_r_close_to_plain_version(device, r, codes):
    """Ragged buckets of reads of 1-500bp at every R the build makes (each
    on the buckets whose rows a warp holds at that R), bitmask codes with
    mm_div 1 and raw codes with mm_div 3."""
    bitmask = codes == "bitmask"
    alphabet, gatk = (b"ACGT", False) if bitmask else (b"ACGTX", True)
    groups = [phmm_batches(5, alphabet), short_phmm_batches(6, alphabet)]
    _pairhmm_close_at_r(codes, groups, device,
                        PairHMMConfig(gatk_emission=gatk).mm_div, 32, r,
                        bitmask)


@pytest.mark.parametrize("period", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("r", pairhmm.TILE_R)
def test_pairhmm_kernel_every_r_deep_decay(device, r, period):
    """The all-mismatch deep-decay pairs at every R and rescale period, in
    bitmask codes (mm_div 1) and raw codes (mm_div 3): a rescale applied
    twice or missed, or a T scaled in place of its inputs, moves them."""
    groups = [[b] for b in deep_decay_batches()]
    _pairhmm_close_at_r("deep", groups, device, 1.0, period, r, True)
    _pairhmm_close_at_r("deep", groups, device, 3.0, period, r, False)


@pytest.mark.parametrize("codes", ["bitmask", "bytes-gatk"])
@pytest.mark.parametrize("r", pairhmm.BLOCK_R)
def test_pairhmm_kernel_block_form_close_to_plain_version(device, r, codes):
    """Buckets of 736-2,048 rows (reads of 513-2,046bp, N runs, 600bp and
    1,500bp all-mismatch deep-decay pairs) as a block of warps at every R
    of the block form and at rescale periods 32, 8 and 1: the rescale is
    decided for the whole block and the seam hands scaled values."""
    bitmask = codes == "bitmask"
    for period in (32, 8, 1):
        ran = _pairhmm_close_at_r(
            "tall", [tall_phmm_batches(3)], device,
            1.0 if bitmask else 3.0, period, r, bitmask)
        assert ran >= 4


@pytest.mark.parametrize("height,reads", [(4096, (3100, 4090)),
                                          (8192, (6200, 8190))])
def test_pairhmm_tile_block_form_past_2048_rows(device, height, reads):
    """A tile of 128 HaplotypeCaller-shaped jobs at 4,096 rows (16 warps at
    R = 8) and at 8,192 rows (32 warps), at every R of the block form that
    32 warps hold them at (each launch bound's instance), against the plain
    version: finite slots within 1e-4, -inf on the same slots."""
    (b,), _ = pack_pairhmm_batches(hc_long_batches(11, 128, reads),
                                   byte_quals=True, factored=True,
                                   bitmask_codes=True)
    assert b.nxs == height
    t = phmm_bucket_to_torch(b, device)
    want = phmm_forward_tiles(*t, 32, 1.0, True)
    valid = torch.from_numpy(b.rl > 0).to(device)
    rs = [r for r in pairhmm.BLOCK_R
          if -(-height // (32 * r)) <= pairhmm.BLOCK_MAX_WARPS]
    assert pairhmm.tile_geometry(height).warps == height // 256
    for r in (None, *rs):
        got = pairhmm.pairhmm_forward(*t, bitmask=True, _rows_per_thread=r)
        torch.cuda.synchronize()
        _assert_log10_close(got, want, valid)


@pytest.mark.parametrize("strip_w,unroll,gatk", [
    (256, 16, False), (256, 8, True), (96, 32, False)],
    ids=["w256-u16", "w256-u8-gatk", "w96-u32"])
def test_pairhmm_long_kernel_close_to_plain_version(device, strip_w, unroll,
                                                    gatk):
    mm_div = PairHMMConfig(gatk_emission=gatk).mm_div
    jobs = long_jobs(6, n_jobs=40, read_lens=(300, 900), hap_max=1000)
    arrays, st = pairhmm_long.pack_pairhmm_long(jobs, strip_w=strip_w)
    t = {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}
    before = trace.launched("pairhmm_long")
    got = pairhmm_long.pairhmm_long_forward(**t, **st, unroll=unroll,
                                            mm_div=mm_div)
    torch.cuda.synchronize()
    assert trace.launched("pairhmm_long") - before == 1
    sweep, anchor, _ = pairhmm_long.long_layout(st["ny_max"], st["strip_w"])
    want = phmm_long_forward(*t.values(), st["k_strips"], st["strip_w"],
                             anchor, sweep, unroll, mm_div)
    _assert_log10_close(got, want, torch.from_numpy(arrays["meta"][0] > 0)
                        .to(device))


@pytest.mark.parametrize("strip_w,r", [(256, 8), (256, 16), (256, 32),
                                       (96, 4), (96, 8), (24, 1), (40, 2),
                                       (512, 16), (1024, 32)])
def test_pairhmm_long_kernel_every_r_close_to_plain_version(device, strip_w,
                                                            r):
    """Reads ending on a strip seam (one, two and three strips, the last a
    deep-decay pair) and ragged reads at every R the build makes: up to
    1,500bp at strip widths of 256 rows and more, 30-300bp below (over 8
    strips, so the block sweeps them in rounds with the global seam)."""
    if strip_w >= 256:
        jobs = long_seam_jobs(3, strip_w) + long_jobs(
            8, n_jobs=24, read_lens=(300, 1500), hap_max=1600)
    else:
        jobs = long_seam_jobs(3, strip_w) + long_jobs(
            8, n_jobs=24, read_lens=(30, 300), hap_max=400)
    arrays, st = pairhmm_long.pack_pairhmm_long(jobs, strip_w=strip_w)
    t = {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}
    sweep, anchor, _ = pairhmm_long.long_layout(st["ny_max"], st["strip_w"])
    valid = torch.from_numpy(arrays["meta"][0] > 0).to(device)
    for unroll, mm_div in ((16, 1.0), (4, 3.0)):
        before = trace.launched("pairhmm_long")
        got = pairhmm_long.pairhmm_long_forward(
            **t, **st, unroll=unroll, mm_div=mm_div, _rows_per_thread=r)
        torch.cuda.synchronize()
        assert trace.launched("pairhmm_long") - before == 1
        want = phmm_long_forward(*t.values(), st["k_strips"], st["strip_w"],
                                 anchor, sweep, unroll, mm_div)
        _assert_log10_close(got, want, valid)


def test_pairhmm_long_wrapper_rejects_bad_inputs(device):
    arrays, st = pairhmm_long.pack_pairhmm_long(long_jobs(2, n_jobs=3))
    t = {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}
    with pytest.raises(TypeError):
        pairhmm_long.pairhmm_long_forward(
            **{**t, "qual": t["qual"].double()}, **st)
    with pytest.raises(ValueError, match="strip_w"):
        big = pairhmm_long.pack_pairhmm_long(long_jobs(2, n_jobs=3),
                                             strip_w=1056)
        pairhmm_long.pairhmm_long_forward(
            **{k: torch.from_numpy(a).to(device) for k, a in big[0].items()},
            **big[1])


def test_pairhmm_wrapper_rejects_bad_inputs(device):
    (b,), _ = pack_pairhmm_batches(
        [generate_pairhmm_batch(2, 2, read_len=10, hap_len=12)],
        byte_quals=True, factored=True)
    t = list(phmm_bucket_to_torch(b, device))
    with pytest.raises(TypeError):
        pairhmm.pairhmm_forward(t[0].to(torch.int32), *t[1:])
    with pytest.raises(ValueError, match="rescale_period"):
        pairhmm.pairhmm_forward(*t, rescale_period=5)
    t[1] = t[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pairhmm.pairhmm_forward(*t)


def _lane_major(state, offset=0):
    """The state lane-major (strides (1, w)), each array `offset` ints into
    its storage."""
    out = []
    for s in state:
        w = s.shape[0]
        a = torch.empty(offset + w * 128, dtype=s.dtype,
                        device=s.device)[offset:].view(128, w).t()
        a.copy_(s)
        out.append(a)
    return tuple(out)


@pytest.mark.parametrize("w,U", [(24, 1), (24, 8), (25, 8), (1024, 32),
                                 (1032, 8), (1032, 64), (5000, 32)])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_sw_xstrip_kernel_equals_plain_version(device, cfg, w, U):
    sxb, slab, hD, hQ, state = (
        torch.from_numpy(a).to(device) if not isinstance(a, tuple)
        else tuple(torch.from_numpy(s).to(device) for s in a)
        for a in xstrip_inputs(w + U, w, U))
    want = sw_xstrip_block(sxb, slab, hD, hQ, state, w=w, U=U, cfg=cfg)
    before = trace.launched("xstrip")
    lane_major = _lane_major(state)
    # contiguous, lane-major, and lane-major off 16-byte alignment (the
    # kernel's int4 moves give way to one int at a time, as at w = 25)
    for st in (state, lane_major, _lane_major(state, offset=1)):
        got = xsharded.strip_block(sxb, slab, hD, hQ, st, w=w, U=U, cfg=cfg)
        torch.cuda.synchronize()
        for g, e in zip(got[0] + got[1:], want[0] + want[1:]):
            assert torch.equal(g, e)
    # in place, as sw_forward_xsharded updates its state
    st = tuple(s.clone() for s in lane_major)
    got = xsharded.strip_block(sxb, slab, hD, hQ, st, w=w, U=U, cfg=cfg,
                               out=st)
    torch.cuda.synchronize()
    for g, e in zip(st, want[0]):
        assert torch.equal(g, e)
    assert trace.launched("xstrip") - before == 4
    # every R the build makes, whole and on partial windows: the window
    # equals the plain block on the slice (zeros above row g_lo > 0, zero
    # halo out when g_hi < w) and leaves the rows outside bit for bit
    zero = torch.zeros_like(hD)
    for r in xsharded.ROWS_PER_THREAD:
        for g_lo, g_hi in ((0, w), (0, w // 2 + 1), (w // 3, w),
                           (w // 4, w - w // 5), (w - 1, w)):
            if g_lo >= g_hi:
                continue
            sl = slice(g_lo, g_hi)
            top = (hD, hQ) if g_lo == 0 else (zero, zero)
            part = sw_xstrip_block(sxb[sl], slab[g_lo: g_hi + U], *top,
                                   tuple(s[sl] for s in state), w=g_hi - g_lo,
                                   U=U, cfg=cfg)
            st = tuple(s.clone() for s in lane_major)
            before = trace.launched("xstrip")
            got = xsharded.strip_block(sxb, slab, hD, hQ, st, w=w, U=U,
                                       cfg=cfg, out=st, rows=(g_lo, g_hi),
                                       _rows_per_thread=r)
            torch.cuda.synchronize()
            assert trace.launched("xstrip") - before == 1
            for g, e, s in zip(st, part[0], state):
                assert torch.equal(g[sl], e), (r, g_lo, g_hi)
                assert torch.equal(g[:g_lo], s[:g_lo])
                assert torch.equal(g[g_hi:], s[g_hi:])
            for g, e in zip(got[1:], part[1:]):
                assert torch.equal(g, e if g_hi == w else torch.zeros_like(e))


def test_sw_xstrip_kernel_at_the_longest_block(device):
    """U = MAX_UNROLL on a strip of two sub-strips (4,096 rows and the
    rest): the prefetch does not fit beside the block's 5U ints, so the
    kernel moves the lane-major state by int4 straight from memory; ==
    plain at every R."""
    w, U = 8000, xsharded.MAX_UNROLL
    sxb, slab, hD, hQ, state = (
        torch.from_numpy(a).to(device) if not isinstance(a, tuple)
        else tuple(torch.from_numpy(s).to(device) for s in a)
        for a in xstrip_inputs(11, w, U))
    want = sw_xstrip_block(sxb, slab, hD, hQ, state, w=w, U=U)
    for r in xsharded.ROWS_PER_THREAD:
        st = _lane_major(state)
        threads = xsharded._threads(w, r)
        assert xsharded._moves([a.data_ptr() for a in st], 1, w, threads, r,
                               U) == (True, False)
        got = xsharded.strip_block(sxb, slab, hD, hQ, st, w=w, U=U, out=st,
                                   _rows_per_thread=r)
        torch.cuda.synchronize()
        for g, e in zip(got[0] + got[1:], want[0] + want[1:]):
            assert torch.equal(g, e), r


@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_sw_xsharded_ring_on_the_card(device, K):
    for name, pairs, unroll in xshard_cases():
        pk = xsharded.pack_sw_xsharded(pairs, K, unroll=unroll)
        sx = torch.from_numpy(pk.sx).to(device)
        sy = torch.from_numpy(pk.sy).to(device)
        kw = dict(n_strips=K, strip_w=pk.strip_w, n_diags=pk.n_diags,
                  unroll=unroll, anchor=pk.anchor)
        before = trace.launched("xstrip")
        got = xsharded.sw_forward_xsharded_ring(sx, sy, **kw)
        plain = xsharded.sw_forward_xsharded_ring(sx, sy, block=sw_xstrip_block,
                                                  **kw)
        torch.cuda.synchronize()
        assert trace.launched("xstrip") - before == K * xsharded.n_blocks(
            pk.n_diags, unroll, K), name
        assert torch.equal(got, plain), name
        # windowed to the live rows: only the non-empty windows launch
        ly_max = xsharded.tile_ly_max(pk)
        live = sum(
            lo < hi for b in range(xsharded.n_blocks(pk.n_diags, unroll, K))
            for k in range(K)
            for lo, hi in [xsharded.live_rows(k, b, strip_w=pk.strip_w,
                                              unroll=unroll, ly_max=ly_max)])
        before = trace.launched("xstrip")
        windowed = xsharded.sw_forward_xsharded_ring(sx, sy, ly_max=ly_max,
                                                     **kw)
        torch.cuda.synchronize()
        assert trace.launched("xstrip") - before == live, name
        assert torch.equal(windowed, plain), name
        np.testing.assert_array_equal(got.cpu().numpy()[: len(pairs)],
                                      native.sw_scores_native(pairs),
                                      err_msg=name)


def test_sw_xstrip_wrapper_rejects_bad_inputs(device):
    sxb, slab, hD, hQ, state = (
        torch.from_numpy(a).to(device) if not isinstance(a, tuple)
        else tuple(torch.from_numpy(s).to(device) for s in a)
        for a in xstrip_inputs(1, 40, 8))
    with pytest.raises(TypeError):
        xsharded.strip_block(sxb.to(torch.int32), slab, hD, hQ, state, w=40,
                             U=8)
    with pytest.raises(ValueError, match="shapes"):
        xsharded.strip_block(sxb, slab[:-1], hD, hQ, state, w=40, U=8)
    odd = tuple(s[::1, :] for s in state[:5]) + (state[5].t().contiguous().t(),)
    with pytest.raises(ValueError, match="strides"):
        xsharded.strip_block(sxb, slab, hD, hQ, odd, w=40, U=8)


def test_sharded_engine_xshard_on_the_card(device):
    from genomax_torch.dist.engine import ShardedEngine
    from genomax_torch.dist.mesh import make_mesh

    rng = np.random.default_rng(7)
    abc = np.frombuffer(b"ATGC", np.uint8)
    pairs = [SWPair(sx=rng.choice(abc, int(rng.integers(10, 30))).tobytes(),
                    sy=rng.choice(abc, int(rng.integers(30, 60))).tobytes())
             for _ in range(10)]
    pairs += [SWPair(sx=rng.choice(abc, 90).tobytes(),
                     sy=rng.choice(abc, 120).tobytes()),
              SWPair(sx=rng.choice(abc, 100).tobytes(),
                     sy=rng.choice(abc, 100).tobytes())]
    eng = ShardedEngine(make_mesh(1, device="cuda"),
                        EngineConfig(max_device_len=40, xshard_min_len=64))
    before = trace.launched("xstrip")
    got = eng.sw_scores(pairs)
    assert trace.launched("xstrip") > before
    assert eng.last_stats.xsharded_jobs == 2
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs))
