"""The CUDA kernel csrc/sw_tile.cu against its plain PyTorch version on the
card (int32 scores, tolerance exact). Needs a CUDA device and nvcc; skips
without them. This file imports no jax, so on a machine without jax it
runs as `python -m pytest --noconftest tests/test_torch_kernel.py`."""

import numpy as np
import pytest
import torch

from genomax import native
from genomax.config import SWConfig
from genomax.io.formats import SWPair
from genomax.pack.bucketing import pack_sw_pairs, unpack_scores

from genomax_torch.kernels import _build, sw
from genomax_torch.kernels.wavefront import sw_forward_tiles
from genomax_torch.pack import sw_bucket_to_torch

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
    before = sw.launches
    results = []
    for b in buckets:
        sx, sy, nd = sw_bucket_to_torch(b, device)
        got = sw.sw_forward(sx, sy, nd, cfg)
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == torch.int32
        want = sw_forward_tiles(sx, sy, nd, cfg)
        assert torch.equal(got, want)
        results.append(got.cpu().numpy())
    assert sw.launches - before == len(buckets)
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
