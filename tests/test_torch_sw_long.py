"""The long-pair SW path of the port on the CPU: ``pack_sw_long`` against
the JAX pack bit for bit, the plain strip sweep ``sw_long_forward`` against
``genomax.kernels.sw_long`` in interpret mode, the oracle and the native
model across strip seams (int32, exact: no tolerance), the full-height
plain sweep against the strip sweep, and the wrapper's input checks. The CUDA kernel itself is held against this plain version on
the card (tests/test_torch_kernel.py, chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from genomax.config import SWConfig as JaxSWConfig
from genomax.io.formats import SWPair
from genomax.kernels import oracle
from genomax.kernels import sw_long as jax_long

from genomax_torch import native, trace
from genomax_torch.config import SWConfig
from genomax_torch.kernels import _build
from genomax_torch.kernels import sw_long as torch_long
from genomax_torch.kernels.wavefront import sw_long_forward_dense
from _torch_cpu import one_torch_thread  # noqa: F401

CFGS = [dict(), dict(match=2, mismatch=-3, gap_open=-5, gap_extend=-2),
        dict(match=3, mismatch=-1, gap_open=0, gap_extend=-2)]
CFG_IDS = ["default", "m2x3o5e2", "m3x1o0e2"]


def _dna(rng, n):
    return rng.choice(list(b"ATGC"), n).astype(np.uint8).tobytes()


def _seam_pairs():
    """The pairs of the JAX package's sw_long test (four random, one
    identical pair whose maximum runs through every seam of 64 rows), a
    tandem repeat laid across a seam, an all-mismatch pair, an empty pair,
    a lone newline and a one-base pair."""
    rng = np.random.default_rng(9)
    ref = _dna(rng, 300)
    pairs = [SWPair(sx=_dna(rng, int(rng.integers(100, 280))),
                    sy=_dna(rng, int(rng.integers(100, 300))))
             for _ in range(4)]
    pairs.append(SWPair(sx=ref, sy=ref))
    x = _dna(rng, 100)  # rows 1-200: the second copy starts before row 128
    pairs.append(SWPair(sx=x + x, sy=_dna(rng, 30) + x + _dna(rng, 28) + x + x))
    pairs.append(SWPair(sx=b"A" * 150, sy=b"C" * 200))
    pairs.append(SWPair(sx=b"", sy=b""))
    pairs.append(SWPair(sx=b"\n", sy=b"ACGT\n"))
    pairs.append(SWPair(sx=b"A", sy=b"A"))
    return pairs


@pytest.mark.parametrize("strip_w", [64, torch_long.STRIP_W, 104],
                         ids=["w64", "default", "jax-default"])
def test_pack_equals_jax_pack(strip_w):
    pairs = _seam_pairs()
    ours = torch_long.pack_sw_long(pairs, strip_w)
    theirs = jax_long.pack_sw_long(pairs, strip_w)
    names = [f.name for f in dataclasses.fields(ours)]
    assert names == [f.name for f in dataclasses.fields(theirs)]
    for name in names:
        a, b = getattr(ours, name), getattr(theirs, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize("ny_max,w", [(1, 64), (256, 64), (512, 1024),
                                      (50176, 1024), (300, 104)])
def test_layout_equals_jax_layout(ny_max, w):
    assert torch_long._layout(ny_max, w) == jax_long._layout(ny_max, w)
    assert torch_long.CHUNK == jax_long.CHUNK


def test_layout_covers_what_the_kernel_reads():
    """The kernel reads stream rows anchor - j for 1 <= j < ny_max and halo
    entries j < ny_max = halo_entries; the shared anchor leaves room."""
    for ny_max, w in [(256, 32), (256, 1024), (50176, 1024)]:
        _, anchor, ndt = torch_long._layout(ny_max, w)
        assert anchor - (ny_max - 1) >= 0 and anchor < ndt
        for r in torch_long.ROWS_PER_THREAD:
            assert torch_long.geometry(w, ny_max, r).halo_entries == ny_max


@pytest.mark.parametrize("cfg", CFGS, ids=CFG_IDS)
def test_plain_equals_jax_interpret_and_oracle(cfg):
    pairs = _seam_pairs()
    got = torch_long.sw_scores_long(pairs, SWConfig(**cfg), device="cpu",
                                    strip_w=64)
    jax_got = jax_long.sw_scores_long(pairs, JaxSWConfig(**cfg), strip_w=64,
                                      interpret=True)
    np.testing.assert_array_equal(got, jax_got)
    np.testing.assert_array_equal(
        got, oracle.sw_scores_pairs(pairs, JaxSWConfig(**cfg)))
    np.testing.assert_array_equal(
        got, native.sw_scores_native(pairs, SWConfig(**cfg)))
    assert got.dtype == np.int32
    assert got[4] == 300 * SWConfig(**cfg).match  # through every seam
    assert got[6] == 0 and got[7] == 0            # all-mismatch, empty


@pytest.mark.parametrize("strip_w", [32, 64, 96, 1024])
def test_plain_is_the_same_at_every_strip_width(strip_w):
    pairs = _seam_pairs()
    got = torch_long.sw_scores_long(pairs, device="cpu", strip_w=strip_w)
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs))


@pytest.mark.parametrize("strip_w", [64, 1024])
@pytest.mark.parametrize("cfg", CFGS, ids=CFG_IDS)
def test_full_height_plain_equals_strip_plain(cfg, strip_w):
    """The full-height sweep of a packed tile (the plain version a 50kbp
    tile is held against on the card) equals the strip sweep on every lane,
    the empty ones too."""
    pairs = _seam_pairs()
    b = torch_long.pack_sw_long(pairs, strip_w)
    sx, sy, nx, ny = torch_long.tile_to_torch(b, "cpu")
    _, anchor, _ = torch_long._layout(b.ny_max, b.strip_w)
    strips = torch_long.sw_forward_long(
        sx, sy, nx, ny, k_strips=b.n_strips, strip_w=b.strip_w,
        ny_max=b.ny_max, cfg=SWConfig(**cfg))
    dense = sw_long_forward_dense(sx, sy, b.n_diags, b.ny_max, anchor,
                                  SWConfig(**cfg))
    assert strips.shape == (128,) and strips.dtype == torch.int32
    assert dense.dtype == torch.int32 and torch.equal(dense, strips)
    assert not strips[len(pairs):].any()
    np.testing.assert_array_equal(
        dense.numpy()[:len(pairs)],
        native.sw_scores_native(pairs, SWConfig(**cfg)))


def test_tiles_of_128_in_input_order():
    """More than one tile: 130 pairs, scores in input order."""
    rng = np.random.default_rng(1)
    pairs = [SWPair(sx=_dna(rng, int(rng.integers(1, 70))),
                    sy=_dna(rng, int(rng.integers(1, 90))))
             for _ in range(130)]
    got = torch_long.sw_scores_long(pairs, device="cpu", strip_w=32)
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs))
    assert torch_long.sw_scores_long([], device="cpu").shape == (0,)


def test_cpu_tensors_do_not_count_as_launches():
    before = trace.counter("launches.sw_long")
    torch_long.sw_scores_long(_seam_pairs()[:2], device="cpu", strip_w=64)
    assert trace.counter("launches.sw_long") == before


def _tile(strip_w=64):
    b = torch_long.pack_sw_long(_seam_pairs()[:3], strip_w)
    return b, torch_long.tile_to_torch(b, "cpu")


@pytest.mark.parametrize("strip_w", [0, -8, 12, 100])
def test_wrapper_rejects_strip_width(strip_w):
    b, (sx, sy, nx, ny) = _tile()
    with pytest.raises(ValueError, match="strip_w"):
        torch_long.sw_forward_long(sx, sy, nx, ny, k_strips=b.n_strips,
                                   strip_w=strip_w, ny_max=b.ny_max)


@pytest.mark.parametrize("what", ["sx-rows", "sy-rows", "nx-shape",
                                  "k_strips", "ny-shape"])
def test_wrapper_rejects_shapes(what):
    b, (sx, sy, nx, ny) = _tile()
    kw = dict(k_strips=b.n_strips, strip_w=b.strip_w, ny_max=b.ny_max)
    if what == "sx-rows":
        sx = sx[:-8]
    elif what == "sy-rows":
        sy = sy[8:]
    elif what == "nx-shape":
        nx = nx[:64]
    elif what == "k_strips":
        kw["k_strips"] = b.n_strips + 1
    else:
        ny = ny.view(1, 128)
    with pytest.raises(ValueError, match="shapes"):
        torch_long.sw_forward_long(sx, sy, nx, ny, **kw)


def test_wrapper_needs_the_lengths_and_the_device():
    """nx, ny and the device have no default: a tile is never swept blind,
    and sw_scores_long never picks the CPU by itself."""
    b, (sx, sy, nx, ny) = _tile()
    with pytest.raises(TypeError):
        torch_long.sw_forward_long(sx, sy, k_strips=b.n_strips,
                                   strip_w=b.strip_w, ny_max=b.ny_max)
    with pytest.raises(TypeError, match="device"):
        torch_long.sw_scores_long(_seam_pairs()[:2])


@pytest.mark.parametrize("what", ["sx", "sy", "nx"])
def test_wrapper_rejects_dtypes(what):
    b, (sx, sy, nx, ny) = _tile()
    t = dict(sx=sx, sy=sy, nx=nx, ny=ny)
    t[what] = t[what].to(torch.int64)
    with pytest.raises(TypeError, match="dtypes"):
        torch_long.sw_forward_long(t["sx"], t["sy"], t["nx"], t["ny"],
                                   k_strips=b.n_strips, strip_w=b.strip_w,
                                   ny_max=b.ny_max)


def test_pack_rejects_pad_codes_and_tile_size():
    with pytest.raises(ValueError, match="reserved byte"):
        torch_long.pack_sw_long([SWPair(sx=b"AC\x01T", sy=b"ACGT")])
    with pytest.raises(ValueError, match="1 to 128"):
        torch_long.pack_sw_long([SWPair(sx=b"A", sy=b"A")] * 129)
    with pytest.raises(ValueError, match="1 to 128"):
        torch_long.pack_sw_long([])


def test_device_tensor_launches_or_raises(monkeypatch):
    """A tensor off the CPU never takes the plain version: with the build
    failing, the wrapper raises instead of returning scores."""
    def fail(*args, **kwargs):
        raise _build.BuildError("nvcc failed (simulated)")

    monkeypatch.setattr(_build, "load", fail)
    b, tensors = _tile()
    sx, sy, nx, ny = (t.to("meta") for t in tensors)
    with pytest.raises(_build.BuildError):
        torch_long.sw_forward_long(sx, sy, nx, ny, k_strips=b.n_strips,
                                   strip_w=b.strip_w, ny_max=b.ny_max)


def test_long_kernel_is_registered_with_the_build():
    import os

    assert "sw_long" in _build.KERNELS
    for name in _build.KERNELS:
        assert os.path.exists(os.path.join(_build.CSRC, name + ".cu"))


@pytest.mark.parametrize("n_rows,r", [(64, 4), (1024, 8), (4096, 16),
                                      (4104, 8), (50176, 4), (50176, 8),
                                      (50176, 16)])
def test_geometry_covers_the_rows_in_whole_warps(n_rows, r):
    """The kernel's sub-strips: threads in whole warps, at most 4,096 rows
    a sub-strip, as few sub-strips as cover the pack's rows, split evenly
    (no sub-strip a warp's rows short of another), and a halo of ny_max
    entries a lane."""
    g = torch_long.geometry(n_rows, 50176, r)
    assert g.threads % 32 == 0 and g.height == g.threads * r
    assert g.height <= torch_long.MAX_ROWS
    assert g.n_sub == -(-n_rows // torch_long.MAX_ROWS)
    assert g.n_sub * g.height >= n_rows > (g.n_sub - 1) * g.height
    assert g.n_sub * g.height - n_rows < 32 * r * g.n_sub
    assert g.halo_entries == 50176


@pytest.mark.parametrize("r", torch_long.ROWS_PER_THREAD)
def test_geometry_caps_the_sub_strip(r):
    """A tile one strip past MAX_ROWS takes two sub-strips of at most
    MAX_ROWS rows, and one of MAX_ROWS rows takes one (threads at most
    MAX_ROWS / R); the build makes R = 4, 8 and 16 and nothing else."""
    g = torch_long.geometry(torch_long.MAX_ROWS + 8, 512, r)
    assert g.height <= torch_long.MAX_ROWS and g.n_sub == 2
    g = torch_long.geometry(torch_long.MAX_ROWS, 512, r)
    assert (g.height, g.n_sub) == (torch_long.MAX_ROWS, 1)
    assert g.threads == torch_long.MAX_ROWS // r
    assert r in (4, 8, 16) and torch_long.LONG_R in torch_long.ROWS_PER_THREAD
    with pytest.raises(ValueError, match="n_rows"):
        torch_long.geometry(0, 512, r)


@pytest.mark.parametrize("r", [0, 2, 6, 32])
def test_wrapper_rejects_rows_per_thread(r):
    b, (sx, sy, nx, ny) = _tile()
    with pytest.raises(ValueError, match="rows_per_thread"):
        torch_long.sw_forward_long(sx, sy, nx, ny, k_strips=b.n_strips,
                                   strip_w=b.strip_w, ny_max=b.ny_max,
                                   _rows_per_thread=r)


def test_plain_takes_any_rows_per_thread_and_cap():
    """On the CPU R only picks the kernel's geometry (threads, and the
    sub-strips capped at MAX_ROWS): the plain strip sweep's scores are the
    same at each."""
    b, (sx, sy, nx, ny) = _tile()
    kw = dict(k_strips=b.n_strips, strip_w=b.strip_w, ny_max=b.ny_max)
    want = torch_long.sw_forward_long(sx, sy, nx, ny, **kw)
    for r in torch_long.ROWS_PER_THREAD:
        got = torch_long.sw_forward_long(sx, sy, nx, ny, **kw,
                                         _rows_per_thread=r)
        assert torch.equal(got, want)
