"""The port's plain Smith-Waterman wavefront (genomax_torch.kernels) held
against the JAX package on the same packed buckets: the lax twin
(genomax.kernels.wavefront.sw_forward_dense) and the resident Pallas
kernel in interpret mode (sw_pallas.sw_forward_pallas). int32 scores,
tolerance exact; the native golden model (the full-matrix oracle where it
does not load) checks all three."""

import numpy as np
import pytest
import torch

from genomax import native
from genomax.config import SWConfig
from genomax.engine.executor import flatten_tiles
from genomax.io.formats import SWPair
from genomax.kernels import oracle
from genomax.kernels.sw_pallas import sw_forward_pallas
from genomax.kernels.wavefront import sw_forward_dense as lax_sw_forward_dense
from genomax.pack.bucketing import pack_sw_pairs, unpack_scores

from genomax_torch.kernels import sw as torch_sw
from genomax_torch.kernels.wavefront import sw_forward_dense
from _torch_cpu import one_torch_thread  # noqa: F401

# Diagonals per traced loop body of the JAX functions: a short body keeps
# their CPU compile (and Pallas interpret) time low; scores do not depend
# on it.
_UNROLL = 4


def _random_pairs(rng, n, lo, hi, alphabet=b"ATGC", newline=True):
    # the fuzz shapes of tests/test_wavefront.py
    out = []
    for _ in range(n):
        a = rng.choice(list(alphabet), size=int(rng.integers(lo, hi)))
        b = rng.choice(list(alphabet), size=int(rng.integers(lo, hi)))
        a, b = a.astype(np.uint8).tobytes(), b.astype(np.uint8).tobytes()
        if newline:
            a, b = a + b"\n", b + b"\n"
        if len(a) > len(b):
            a, b = b, a
        out.append(SWPair(sx=a, sy=b))
    return out


def _tandem_pairs():
    """y holds a second (and third) copy of x about NXs rows later: the
    wrap-around adversaries of tests/test_wavefront.py."""
    rng = np.random.default_rng(42)
    abc = np.frombuffer(b"ATGC", np.uint8)
    out = []
    for xlen, gap in [(100, 104), (100, 60), (100, 160), (37, 40),
                      (250, 256), (250, 1000)]:
        x = rng.choice(abc, xlen).tobytes()
        junk = rng.choice(abc, gap).tobytes()
        out.append(SWPair(sx=x, sy=x + junk + x))
        out.append(SWPair(sx=x, sy=x + junk + x + junk + x))
    return out


def _scoring_cfgs():
    # the scoring domain of test_sw_random_scoring_configs_vs_oracle
    rng = np.random.default_rng(0)
    cfgs = [SWConfig(match=2, mismatch=-3, gap_open=0, gap_extend=-1)]
    for _ in range(3):
        cfgs.append(SWConfig(
            match=int(rng.integers(1, 6)),
            mismatch=-int(rng.integers(1, 6)),
            gap_open=-int(rng.integers(0, 8)),
            gap_extend=-int(rng.integers(1, 5)),
        ))
    return cfgs


def _cases():
    cases = [
        ("random", _random_pairs(np.random.default_rng(7), 24, 1, 40),
         SWConfig()),
        ("ragged", _random_pairs(np.random.default_rng(8), 10, 1, 30)
         + _random_pairs(np.random.default_rng(8), 6, 120, 180), SWConfig()),
        ("empty_single", [SWPair(sx=b"", sy=b""), SWPair(sx=b"A", sy=b"A"),
                          SWPair(sx=b"A", sy=b"T")], SWConfig()),
        ("tandem", _tandem_pairs(), SWConfig()),
    ]
    rng = np.random.default_rng(1)
    for k, cfg in enumerate(_scoring_cfgs()):
        cases.append((f"scoring{k}", _random_pairs(rng, 6, 1, 35), cfg))
    return cases


def _torch_plain(b, cfg):
    return torch_sw.sw_forward(torch.from_numpy(b.sx), torch.from_numpy(b.sy),
                               torch.from_numpy(b.ndiag_tile), cfg).numpy()


def _lax(b, cfg):
    nt = b.sx.shape[0]
    got = lax_sw_forward_dense(flatten_tiles(b.sx), flatten_tiles(b.sy),
                               None, None, n_diags=b.max_diags, cfg=cfg,
                               unroll=_UNROLL)
    return np.asarray(got).reshape(nt, -1)


@pytest.mark.parametrize("name,pairs,cfg", _cases(),
                         ids=[c[0] for c in _cases()])
def test_plain_vs_lax_vs_pallas_interpret(name, pairs, cfg):
    buckets = pack_sw_pairs(pairs)
    results = []
    for b in buckets:
        got = _torch_plain(b, cfg)
        assert got.dtype == np.int32 and got.shape == (b.sx.shape[0], 128)
        np.testing.assert_array_equal(got, _lax(b, cfg), err_msg=name)
        pallas = np.asarray(sw_forward_pallas(b.sx, b.sy, b.ndiag_tile,
                                              cfg=cfg, unroll=_UNROLL,
                                              interpret=True))
        np.testing.assert_array_equal(got, pallas, err_msg=name)
        results.append(got)
    np.testing.assert_array_equal(
        unpack_scores(buckets, results, len(pairs)),
        native.sw_scores_native(pairs, cfg), err_msg=name)


def test_plain_widens_int8_tiles():
    """int8 code tiles in, as packed: without the widening KILL = 2**28
    would wrap to 0 and scores past 127 would overflow."""
    rng = np.random.default_rng(3)
    abc = np.frombuffer(b"ATGC", np.uint8)
    pairs = [SWPair(sx=rng.choice(abc, 150).tobytes() + b"\n",
                    sy=rng.choice(abc, 170).tobytes() + b"\n")
             for _ in range(6)]
    pairs.append(SWPair(sx=b"A" * 160, sy=b"A" * 160))  # score 160 > 127
    (b,) = pack_sw_pairs(pairs)
    assert b.sx.dtype == np.int8 and b.sy.dtype == np.int8
    got = sw_forward_dense(torch.from_numpy(b.sx[0]),
                           torch.from_numpy(b.sy[0]), int(b.ndiag_tile[0]))
    lax = np.asarray(lax_sw_forward_dense(b.sx[0], b.sy[0].astype(np.int32),
                                          None, None,
                                          int(b.ndiag_tile[0])))
    np.testing.assert_array_equal(got.numpy(), lax)
    out = np.zeros(len(pairs), np.int32)
    out[b.perm] = got.numpy()[: b.n_valid]
    np.testing.assert_array_equal(out, oracle.sw_scores_pairs(pairs))


def test_plain_long_stream_bucket_vs_lax():
    """A bucket with NDs > 6144 rows (the JAX engine's streamed-kernel
    threshold), held against the lax twin and the native model."""
    rng = np.random.default_rng(5)
    abc = np.frombuffer(b"ATGC", np.uint8)
    x = rng.choice(abc, 30).tobytes()
    pairs = [SWPair(sx=x, sy=rng.choice(abc, 3000).tobytes() + x
                    + rng.choice(abc, 3200).tobytes()),
             SWPair(sx=rng.choice(abc, 25).tobytes(),
                    sy=rng.choice(abc, 6300).tobytes())]
    (b,) = pack_sw_pairs(pairs)
    assert b.sy.shape[1] > 6144
    got = _torch_plain(b, SWConfig())
    np.testing.assert_array_equal(got, _lax(b, SWConfig()))
    np.testing.assert_array_equal(
        unpack_scores([b], [got], len(pairs)),
        native.sw_scores_native(pairs))
    assert got.reshape(-1)[list(b.perm).index(0)] >= 30


def test_plain_rejects_sweep_past_stream_window():
    (b,) = pack_sw_pairs([SWPair(sx=b"ACGT", sy=b"ACGT")])
    anchor = b.sy.shape[1] - b.sx.shape[1]
    with pytest.raises(ValueError, match="stream window"):
        sw_forward_dense(torch.from_numpy(b.sx[0]),
                         torch.from_numpy(b.sy[0]), anchor + 1)
