"""The PairHMM kernels' geometry and the wrappers' refusals, on the CPU.

``kernels.pairhmm.tile_geometry`` places a lane-tile pair on a group of G
threads of one warp with R rows a thread; ``kernels.pairhmm_long.
long_geometry`` places a long-read strip on one warp. Both must cover every
row with an R the build makes, and the wrappers must refuse any other R, and
every out-of-contract input, before anything is built or launched. The
kernels themselves are held against their plain versions on the card in
tests/test_torch_kernel.py."""

import numpy as np
import pytest
import torch

from genomax_torch.config import MAX_PHMM_ROWS
from genomax_torch.io.generator import generate_pairhmm_batch
from genomax_torch.kernels import _build, pairhmm, pairhmm_long
from genomax_torch.pack import pack_pairhmm_batches, phmm_bucket_to_torch

from _phmm_cases import long_jobs
from _torch_cpu import one_torch_thread  # noqa: F401


def _check_tile(geo, nxs):
    assert geo.rows_per_thread in pairhmm.TILE_R
    assert geo.group * geo.rows_per_thread >= nxs
    if geo.block:  # one pair a block of the fewest warps that hold it
        assert geo.rows_per_thread in pairhmm.BLOCK_R
        assert geo.group == geo.warps * pairhmm.WARP
        assert (geo.warps - 1) * pairhmm.WARP * geo.rows_per_thread < nxs
        assert geo.warps * pairhmm.WARP <= 1024  # a CUDA block's threads
        assert geo.warps <= max(pairhmm.block_bounds(geo.rows_per_thread))
        assert (geo.pairs_per_warp, geo.lanes_per_block,
                geo.blocks_per_tile) == (0, 1, 128)
        return
    assert 1 <= geo.group <= pairhmm.WARP
    assert geo.pairs_per_warp == pairhmm.WARP // geo.group
    assert geo.lanes_per_block == geo.warps * geo.pairs_per_warp
    assert geo.blocks_per_tile * geo.lanes_per_block >= 128
    assert (geo.blocks_per_tile - 1) * geo.lanes_per_block < 128


def test_tile_geometry_covers_every_bucket_height():
    """The default R holds a pair of every NXs from 2 to 512 in one warp,
    with the fewest rows a thread that does; past 512 rows, up to 8,192,
    a block of warps at the R of BLOCK_R whose step costs least."""
    for nxs in range(2, MAX_PHMM_ROWS + 1):
        geo = pairhmm.tile_geometry(nxs)
        _check_tile(geo, nxs)
        assert geo.block == (nxs > 512)
        smaller = [r for r in pairhmm.TILE_R if r < geo.rows_per_thread]
        assert geo.block or all(-(-nxs // r) > pairhmm.WARP for r in smaller)
    assert pairhmm.tile_geometry(160).rows_per_thread == 5
    assert MAX_PHMM_ROWS == 8192


@pytest.mark.parametrize("nxs,r,warps", [
    (513, 6, 3), (520, 6, 3), (736, 8, 3), (1008, 8, 4), (1504, 8, 6),
    (2048, 8, 8), (4096, 8, 16), (6000, 8, 24), (8192, 8, 32)])
def test_tile_geometry_past_512_rows(nxs, r, warps):
    """Past one warp's 512 rows the default is the block form: warps, R and
    one pair (lane) a block; phase 12's 1,000bp reads (1,008 rows) take 4
    warps at R = 8, the 2,046bp reads of max_device_len 4,096 take 8, the
    reads of 4,094 and 8,190bp 16 and 32. Every R of BLOCK_R with which 32
    warps hold the pair gives the fewest warps that do; the others raise."""
    geo = pairhmm.tile_geometry(nxs)
    assert (geo.rows_per_thread, geo.warps, geo.group) == (r, warps,
                                                           32 * warps)
    assert geo.block and geo.lanes_per_block == 1
    for rr in pairhmm.BLOCK_R:
        if -(-nxs // (32 * rr)) > pairhmm.BLOCK_MAX_WARPS:
            with pytest.raises(ValueError, match="past the block form"):
                pairhmm.tile_geometry(nxs, rr)
            continue
        g = pairhmm.tile_geometry(nxs, rr)
        _check_tile(g, nxs)
        assert g.warps == -(-nxs // (32 * rr))


@pytest.mark.parametrize("r", pairhmm.TILE_R)
def test_tile_geometry_at_every_r(r):
    """At each R the build makes: a geometry wherever a warp holds the pair,
    several pairs a warp once a group is 16 threads or fewer; past a warp
    the block form at the R of BLOCK_R up to 32 warps (4,096 rows at R =
    4), and a ValueError naming the warp at the others, or the block
    form's 32 warps past it."""
    fits = 0
    for nxs in range(2, MAX_PHMM_ROWS + 1):
        if (r in pairhmm.BLOCK_R and -(-nxs // (pairhmm.WARP * r))
                > pairhmm.BLOCK_MAX_WARPS):
            with pytest.raises(ValueError, match="past the block form"):
                pairhmm.tile_geometry(nxs, r)
        elif -(-nxs // r) <= pairhmm.WARP or r in pairhmm.BLOCK_R:
            geo = pairhmm.tile_geometry(nxs, r)
            _check_tile(geo, nxs)
            assert geo.rows_per_thread == r
            assert geo.block == (-(-nxs // r) > pairhmm.WARP)
            assert geo.block or (geo.pairs_per_warp >= 2) == (geo.group <= 16)
            fits += 1
        else:
            with pytest.raises(ValueError, match="more than a warp"):
                pairhmm.tile_geometry(nxs, r)
    assert fits == (min(pairhmm.BLOCK_MAX_WARPS * pairhmm.WARP * r,
                        MAX_PHMM_ROWS) - 1 if r in pairhmm.BLOCK_R
                    else min(pairhmm.WARP * r, MAX_PHMM_ROWS) - 1)


@pytest.mark.parametrize("r", [0, 3, 7, 32])
def test_tile_geometry_rejects_an_r_the_build_does_not_make(r):
    with pytest.raises(ValueError, match="the build makes"):
        pairhmm.tile_geometry(160, r)


@pytest.mark.parametrize("nxs", [0, 1, MAX_PHMM_ROWS + 8])
def test_tile_geometry_rejects_heights_outside_the_kernel(nxs):
    with pytest.raises(ValueError, match="NXs"):
        pairhmm.tile_geometry(nxs)


@pytest.mark.parametrize("strip_w", range(8, 1025, 8))
def test_long_geometry_covers_every_strip_width(strip_w):
    """One warp a strip at every strip width the pack makes (multiples of
    8 up to 1,024), at the default R and at every larger R."""
    geo = pairhmm_long.long_geometry(3, strip_w, 512)
    assert geo.rows_per_thread in pairhmm_long.LONG_R
    assert geo.threads_per_strip * geo.rows_per_thread >= strip_w
    assert geo.threads_per_strip <= pairhmm_long.WARP
    assert geo.warps == 3 and geo.halo_rows == 0
    for r in pairhmm_long.LONG_R:
        if r > geo.rows_per_thread:
            assert pairhmm_long.long_geometry(
                3, strip_w, 512, r).threads_per_strip <= pairhmm_long.WARP
        elif r < geo.rows_per_thread:
            with pytest.raises(ValueError, match="more than a warp"):
                pairhmm_long.long_geometry(3, strip_w, 512, r)


def test_long_geometry_rounds_and_refusals():
    """Past 8 strips the block sweeps them in rounds, with a global seam
    covering every diagonal a job can reach; R outside the build and
    strips a warp cannot hold raise."""
    assert pairhmm_long.long_geometry(4, 256, 1280).rows_per_thread == 8
    geo = pairhmm_long.long_geometry(13, 24, 512)
    assert geo.warps == 8 and geo.halo_rows >= 13 * 24 + 512 + 32
    with pytest.raises(ValueError, match="the build makes"):
        pairhmm_long.long_geometry(2, 256, 256, 12)
    with pytest.raises(ValueError, match="strip_w"):
        pairhmm_long.long_geometry(2, 1056, 256)


def _bucket():
    """A bucket of 40bp reads: 48 rows, more than a warp holds at R = 1."""
    (b,), _ = pack_pairhmm_batches(
        [generate_pairhmm_batch(3, 2, read_len=40, hap_len=46, seed=4)],
        byte_quals=True, factored=True, bitmask_codes=True)
    assert b.nxs == 48
    return b, list(phmm_bucket_to_torch(b, "cpu"))


def _long_tile():
    arrays, st = pairhmm_long.pack_pairhmm_long(
        long_jobs(2, n_jobs=3, read_lens=(30, 60), hap_max=80), strip_w=24)
    return {k: torch.from_numpy(a) for k, a in arrays.items()}, st


@pytest.fixture
def no_build(monkeypatch):
    """Any build or launch fails the test: a refusal must come first."""

    def fail(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(_build, "load", fail)


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_wrappers_refuse_an_unbuilt_r_before_any_launch(no_build, dev):
    """On CPU tensors (the plain version) and on device tensors alike: an R
    the build does not make, and an R at which a warp cannot hold the pair
    or the strip."""
    _, t = _bucket()
    t = [x.to(dev) for x in t]
    lt, st = _long_tile()
    lt = {k: v.to(dev) for k, v in lt.items()}
    before = (pairhmm.launches, pairhmm_long.launches)
    with pytest.raises(ValueError, match="the build makes"):
        pairhmm.pairhmm_forward(*t, _rows_per_thread=3)
    with pytest.raises(ValueError, match="more than a warp"):
        pairhmm.pairhmm_forward(*t, _rows_per_thread=1)
    with pytest.raises(ValueError, match="the build makes"):
        pairhmm_long.pairhmm_long_forward(**lt, **st, _rows_per_thread=12)
    wide, wst = pairhmm_long.pack_pairhmm_long(
        long_jobs(2, n_jobs=2, read_lens=(30, 60), hap_max=80), strip_w=64)
    wide = {k: torch.from_numpy(a).to(dev) for k, a in wide.items()}
    with pytest.raises(ValueError, match="more than a warp"):
        pairhmm_long.pairhmm_long_forward(**wide, **wst, _rows_per_thread=1)
    assert (pairhmm.launches, pairhmm_long.launches) == before


def test_explicit_r_on_the_cpu_takes_the_plain_version(no_build):
    """An R the build makes passes the check; CPU tensors then run the
    plain version, which does not depend on R."""
    b, t = _bucket()
    want = pairhmm.pairhmm_forward(*t)
    for r in (2, 5, 16):
        torch.testing.assert_close(pairhmm.pairhmm_forward(
            *t, _rows_per_thread=r), want, rtol=0, atol=0)
    assert bool(np.isfinite(want.numpy().reshape(-1)[b.rl.reshape(-1) > 0])
                .all())
    lt, st = _long_tile()
    want = pairhmm_long.pairhmm_long_forward(**lt, **st)
    torch.testing.assert_close(pairhmm_long.pairhmm_long_forward(
        **lt, **st, _rows_per_thread=4), want, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["pairhmm_tile", "pairhmm_long"])
def test_build_key_covers_the_shared_cell(monkeypatch, tmp_path, name):
    """Both PairHMM sources include csrc/phmm_cell.cuh: an edit to it gives
    a new build key (so a stale library is never loaded), an edit to the
    SW cell's header does not."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = _build.key(name)
    (csrc / "sw_cell.cuh").write_text((csrc / "sw_cell.cuh").read_text()
                                      + "\n// edited\n")
    assert _build.key(name) == before
    (csrc / "phmm_cell.cuh").write_text((csrc / "phmm_cell.cuh").read_text()
                                        + "\n// edited\n")
    assert _build.key(name) != before
