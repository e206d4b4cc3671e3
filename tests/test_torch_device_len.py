"""max_device_len past 1,024 on the CPU (plain versions): at L = 2,048 the
port's engine against the JAX engine at the same L (its lax backend) and
the native models, SW with strips on and off and PairHMM reads of
520-1,000bp on the lane tile (the kernel's block form past 512 rows); the
packs of buckets past 1,024 SW rows and 512 PairHMM rows against the JAX
packs bit for bit; the stream and a two-rank gloo ShardedEngine at L =
2,048 against Engine.sw_scores; and both command lines with
--max-device-len 2048 and with --chunk 0. SW scores exact; PairHMM within
1e-4 in log10 of the fp64 model and of the JAX engine."""

import dataclasses
import os

import numpy as np
import pytest

import genomax
from genomax import native as jax_native
from genomax.cli.main import main as jax_main
from genomax.config import EngineConfig as JaxEngineConfig
from genomax.io import formats as jax_formats
from genomax.pack import bucketing as jax_bucketing

from _phmm_cases import tall_phmm_batches, tall_sw_pairs
from _torch_cpu import one_torch_thread  # noqa: F401
from genomax_torch.cli.main import main
from genomax_torch.config import EngineConfig
from genomax_torch.engine.executor import Engine, _jobs
from genomax_torch.io import formats
from genomax_torch.io.generator import generate_pairhmm_batch
from genomax_torch.kernels import pairhmm
from genomax_torch.kernels.sw_strips import maybe_prep_strips
from genomax_torch.pack import bucketing
from test_torch_dist import _rows, _run_ranks

L = 2048


def _sw_pairs():
    """Short pairs in two buckets (64 and 136 rows), pairs of 1,030, 1,100
    and 1,300bp planted in y with one mismatch (buckets of 1,032 and 1,304
    rows, past the default max_device_len) and one of 2,100bp that L =
    2,048 still offloads."""
    rng = np.random.default_rng(3)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for lo, hi, k in ((30, 60, 12), (100, 130, 4)):
        for _ in range(k):
            n = int(rng.integers(lo, hi))
            pairs.append(formats.SWPair(
                sx=rng.choice(abc, n).tobytes(),
                sy=rng.choice(abc, n + int(rng.integers(0, 9))).tobytes()))
    for n in (1030, 1100, 1300, 2100):
        x = rng.choice(abc, n)
        y = rng.choice(abc, n + 60)
        y[30: 30 + n] = x
        y[30 + n // 2] = ord("A") if x[n // 2] != ord("A") else ord("C")
        pairs.append(formats.SWPair(sx=x.tobytes(), sy=y.tobytes()))
    return pairs


def _jax_pairs(pairs):
    return [jax_formats.SWPair(sx=p.sx, sy=p.sy) for p in pairs]


def _jax_batches(batches):
    return [jax_formats.PairHMMBatch(
        reads=[jax_formats.PairHMMRead(**dataclasses.asdict(r))
               for r in b.reads], haplotypes=list(b.haplotypes))
        for b in batches]


@pytest.fixture(scope="module")
def sw_case():
    """The pairs, the JAX engine's scores and stats at L, the native
    model's scores."""
    pairs = _sw_pairs()
    jax_eng = genomax.Engine(JaxEngineConfig(backend="lax", max_device_len=L))
    want = jax_eng.sw_scores(_jax_pairs(pairs))
    np.testing.assert_array_equal(
        want, jax_native.sw_scores_native(_jax_pairs(pairs)))
    return pairs, want, jax_eng.last_stats


@pytest.mark.parametrize("strips", [True, False], ids=["strips", "tile"])
def test_sw_at_2048_matches_jax_engine(sw_case, strips):
    """The 1,032- and 1,304-row buckets stay on the device at L = 2,048: on
    strips (sw_strips on) or on the lane tile's block form (off); the
    2,100bp pair is the only offloaded one. Scores, offloads, buckets and
    cells equal the JAX engine's."""
    pairs, want, jax_stats = sw_case
    eng = Engine(EngineConfig(max_device_len=L, sw_strips=strips),
                 device="cpu")
    np.testing.assert_array_equal(eng.sw_scores(pairs), want)
    for key in ("n_jobs", "offloaded_jobs", "buckets", "dp_cells"):
        assert getattr(eng.last_stats, key) == getattr(jax_stats, key), key
    assert eng.last_stats.offloaded_jobs == 1
    tall = [b for b in bucketing.pack_sw_pairs(
        pairs, job_mask=~eng._sw_offload_mask(pairs)) if b.sx.shape[1] > 1024]
    assert [b.sx.shape[1] for b in tall] == [1032, 1304]
    assert all((maybe_prep_strips(eng.cfg, b) is not None) == strips
               for b in tall)


@pytest.mark.parametrize("height", [2048, 4096])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "job_mask"])
def test_pack_sw_pairs_equal_past_1024_rows(height, masked):
    """The port's pack of buckets of 2,048 and 4,096 rows (and the short
    bucket beside them) is the JAX pack's, field for field."""
    pairs = tall_sw_pairs(5, height, n_pairs=24) + _sw_pairs()[:6]
    mask = None
    if masked:
        mask = np.random.default_rng(1).random(len(pairs)) < 0.7
    ours = bucketing.pack_sw_pairs(pairs, job_mask=mask)
    theirs = jax_bucketing.pack_sw_pairs(_jax_pairs(pairs), job_mask=mask)
    assert max(b.sx.shape[1] for b in ours) == height
    _assert_packs_equal(ours, theirs)


def test_pack_pairhmm_equal_past_512_rows():
    """The engine's PairHMM pack (byte qualities, factored, bitmask codes)
    of buckets of 736-2,048 rows is the JAX pack's, field for field."""
    batches = tall_phmm_batches(3, n_reads=12)
    kw = dict(byte_quals=True, factored=True, bitmask_codes=True)
    ours, n = bucketing.pack_pairhmm_batches(batches, **kw)
    theirs, m = jax_bucketing.pack_pairhmm_batches(_jax_batches(batches),
                                                   **kw)
    assert n == m and max(b.nxs for b in ours) == 2048
    _assert_packs_equal(ours, theirs)


def _assert_packs_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for f in dataclasses.fields(b):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if hasattr(vb, "materialize"):
                va, vb = va.materialize(), vb.materialize()
            if isinstance(vb, np.ndarray):
                assert va.dtype == vb.dtype, f.name
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
            else:
                assert va == vb, f.name


def _phmm_batches():
    """Reads of 520bp and 1,000bp from haplotype variants (buckets of 528
    and 1,008 rows), all on the lane tile at L = 2,048, where the default L sends
    them to the long-read kernel."""
    return [generate_pairhmm_batch(6, 2, read_len=1000, hap_len=1100, seed=4,
                                   from_haps=True),
            generate_pairhmm_batch(3, 2, read_len=520, hap_len=700, seed=5,
                                   from_haps=True)]


def test_pairhmm_at_2048_matches_jax_engine_and_golden():
    batches = _phmm_batches()
    eng = Engine(EngineConfig(max_device_len=L), device="cpu")
    got = eng.pairhmm(batches)
    jb = _jax_batches(batches)
    jax_eng = genomax.Engine(JaxEngineConfig(backend="lax", max_device_len=L))
    np.testing.assert_allclose(got, jax_eng.pairhmm(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, jax_native.pairhmm_native(jb), rtol=0,
                               atol=1e-4)
    for key in ("n_jobs", "offloaded_jobs", "fallback_jobs", "buckets",
                "dp_cells"):
        assert (getattr(eng.last_stats, key)
                == getattr(jax_eng.last_stats, key)), key
    assert eng.last_stats.offloaded_jobs == 0
    buckets, _ = eng._phmm_pack(batches)
    assert sorted(b.nxs for b in buckets) == [528, 1008]
    assert all(pairhmm.tile_geometry(b.nxs).block for b in buckets)
    # the default L = 1,024 sends every read past 510bp to the long-read
    # kernel
    assert Engine(device="cpu")._phmm_offload_mask(_jobs(batches)).all()


def test_stream_and_two_rank_sharded_engine_at_2048(sw_case, tmp_path):
    pairs, want, _ = sw_case
    eng = Engine(EngineConfig(max_device_len=L), device="cpu")
    np.testing.assert_array_equal(eng.sw_scores_stream(pairs, 7), want)
    assert eng.last_stats.offloaded_jobs == 1
    r0, r1 = _run_ranks(tmp_path, 2, "sw", {
        "sw": _rows(pairs), "configs": [{"max_device_len": L}]})
    assert r0 == r1
    np.testing.assert_array_equal(np.asarray(r0["sw0"], np.int32), want)
    assert r0["sw0_stats"]["offloaded_jobs"] == 1


def _scores(text):
    return [ln for ln in text.splitlines() if ln.startswith("Score: ")]


def test_cli_max_device_len_2048_matches_jax_cli(tmp_path, capsys):
    """rc 0 at 2,048 and 4,096 where the cap once returned 2, the JAX
    command line's scores; past 4,096 rc 2 naming the lane tile."""
    pairs = _sw_pairs()[10:19]
    path = tmp_path / "in.txt"
    formats.write_sw_input(str(path), [s for p in pairs
                                       for s in (p.sx, p.sy)])
    assert jax_main(["sw", str(path), "--backend", "lax",
                     "--max-device-len", "2048"]) == 0
    want = _scores(capsys.readouterr().out)
    assert len(want) == len(pairs)
    for n in ("2048", "4096"):
        assert main(["sw", str(path), "--device", "cpu",
                     "--max-device-len", n, "--stats"]) == 0
        out = capsys.readouterr()
        assert _scores(out.out) == want
        assert '"offloaded_jobs": 0' in out.err
    assert main(["sw", str(path), "--device", "cpu",
                 "--max-device-len", "4104"]) == 2
    assert "16 warps" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["sw", "pairhmm"])
def test_cli_chunk_zero_is_unchunked_as_in_genomax(tmp_path, capsys,
                                                   golden_dir, cmd):
    """--chunk 0 is the unchunked run in both command lines."""
    if cmd == "sw":
        path = os.path.join(golden_dir, "sw_small.in")
        assert jax_main(["sw", path, "--backend", "lax", "--chunk", "0"]) == 0
        want = _scores(capsys.readouterr().out)
        assert main(["sw", path, "--device", "cpu", "--chunk", "0"]) == 0
        assert _scores(capsys.readouterr().out) == want and len(want) == 32
        return
    path = os.path.join(golden_dir, "test.in")
    ours, theirs = tmp_path / "ours.out", tmp_path / "theirs.out"
    assert jax_main(["pairhmm", path, str(theirs), "--backend", "lax",
                     "--chunk", "0"]) == 0
    assert main(["pairhmm", path, str(ours), "--device", "cpu",
                 "--chunk", "0"]) == 0
    np.testing.assert_allclose(np.loadtxt(ours, ndmin=1),
                               np.loadtxt(theirs, ndmin=1), rtol=0, atol=1e-4)
