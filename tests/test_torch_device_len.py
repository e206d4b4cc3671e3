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
    """rc 0 at 2,048 through 16,384, where a cap once returned 2 past
    1,024 and then past 4,096, and the JAX command line's scores."""
    pairs = _sw_pairs()[10:19]
    path = tmp_path / "in.txt"
    formats.write_sw_input(str(path), [s for p in pairs
                                       for s in (p.sx, p.sy)])
    assert jax_main(["sw", str(path), "--backend", "lax",
                     "--max-device-len", "2048"]) == 0
    want = _scores(capsys.readouterr().out)
    assert len(want) == len(pairs)
    for n in ("2048", "4096", "4104", "8192", "16384"):
        assert main(["sw", str(path), "--device", "cpu",
                     "--max-device-len", n, "--stats"]) == 0
        out = capsys.readouterr()
        assert _scores(out.out) == want
        assert '"offloaded_jobs": 0' in out.err


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


@pytest.mark.parametrize("cmd,name,n", [("sw", "sw_small.in", "8192"),
                                        ("pairhmm", "10s.in", "8192"),
                                        ("pairhmm", "10s.in", "16384")])
def test_cli_past_the_tallest_block_matches_jax_cli(tmp_path, capsys,
                                                    golden_dir, cmd, name,
                                                    n):
    """`--max-device-len` 8,192 (the SW lane tile's tallest bucket, once
    past the cap) and 16,384 (the PairHMM tile's, 16,384 // 2 rows): rc 0
    and what the genomax command line prints at the same L, SW scores
    exact, PairHMM within 1e-4."""
    path = os.path.join(golden_dir, name)
    if cmd == "sw":
        assert jax_main(["sw", path, "--backend", "lax",
                         "--max-device-len", n]) == 0
        want = _scores(capsys.readouterr().out)
        assert main(["sw", path, "--device", "cpu",
                     "--max-device-len", n]) == 0
        assert _scores(capsys.readouterr().out) == want and len(want) == 32
        return
    ours, theirs = tmp_path / "ours.out", tmp_path / "theirs.out"
    assert jax_main(["pairhmm", path, str(theirs), "--backend", "lax",
                     "--max-device-len", n]) == 0
    assert main(["pairhmm", path, str(ours), "--device", "cpu",
                 "--max-device-len", n]) == 0
    got, want = np.loadtxt(ours, ndmin=1), np.loadtxt(theirs, ndmin=1)
    assert got.shape == want.shape == (3550,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# Routing past the lane tile's tallest bucket, with that bucket cut to two
# warps at R = 2 (129 rows; the engine's routing constant 128) so that it
# runs at a hundred rows on the CPU: x of 20-60bp (64 rows), 100-126bp
# (rows the lane tile holds) and 127-134bp (past it) in one ladder level
# of 136 rows, which strips decline (strips_min_nxs 144), and 150-180bp
# (152-184 rows), which strips take.
_TALLEST = 128


def _routing_pairs():
    rng = np.random.default_rng(20)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for lo, hi, k in ((20, 60, 6), (100, 126, 6), (127, 134, 5),
                      (150, 180, 7)):
        for _ in range(k):
            n = int(rng.integers(lo, hi + 1))
            x = rng.choice(abc, n)
            y = rng.choice(abc, n + int(rng.integers(0, 40)))
            y[5: 5 + n // 2] = x[: n // 2]
            pairs.append(formats.SWPair(sx=x.tobytes(), sy=y.tobytes()))
    return pairs


@pytest.fixture
def tallest_two_warps(monkeypatch):
    """The lane tile's tallest block cut to two warps at R = 2, and spies on
    the routes: the rows of every bucket the lane tile and strips get (the
    lane tile's geometry must hold each), the pairs sw_long and
    pairhmm_long get, the rows of every PairHMM lane-tile bucket."""
    from genomax_torch.engine import executor
    from genomax_torch.kernels import sw

    monkeypatch.setattr(sw, "MAX_WARPS", 2)
    monkeypatch.setattr(sw, "ROWS_PER_THREAD", (2,))
    assert sw.max_rows() // 8 * 8 == _TALLEST
    monkeypatch.setattr(executor, "MAX_KERNEL_ROWS", _TALLEST)
    monkeypatch.setattr(executor, "MAX_PHMM_ROWS", 64)
    log = {"tile": [], "strips": [], "sw_long": [], "phmm_tile": [],
           "pairhmm_long": []}

    def spy(name, record):
        fn = getattr(executor, name)

        def call(*a, **k):
            log[record].append(_spy_rows(record, a))
            return fn(*a, **k)

        monkeypatch.setattr(executor, name, call)

    spy("sw_forward", "tile")
    spy("sw_forward_strips", "strips")
    spy("sw_scores_long", "sw_long")
    spy("pairhmm_forward", "phmm_tile")
    spy("pairhmm_long", "pairhmm_long")
    return log


def _spy_rows(route, args):
    from genomax_torch.kernels import sw

    if route in ("sw_long", "pairhmm_long"):
        return len(args[0])
    if route == "tile":
        sw.tile_geometry(args[0].shape[1])  # raises past the tallest block
    return args[0].shape[1]


@pytest.mark.parametrize("route", ["strips", "tile", "smem"])
def test_sw_routing_past_the_tallest_block(tallest_two_warps, monkeypatch,
                                           route):
    """Pairs past the lane tile's tallest bucket take strips where strips
    take their bucket (cfg.sw_strips, strips_min_nxs rows, a y inside the
    shared-memory limit), else sw_long; the lane tile never gets a bucket
    past it. Scores == the JAX engine at the same L, exact; the stream
    routes alike."""
    from genomax_torch.kernels import sw_strips

    log = tallest_two_warps
    pairs = _routing_pairs()
    lx = np.array([len(p.sx) for p in pairs])
    if route == "smem":  # one pair's ring past the limit in the 184 rows
        big = max(len(p.sy) for p in pairs if len(p.sx) >= 150) + 1
        monkeypatch.setattr(sw_strips, "MAX_SMEM_BYTES",
                            sw_strips.smem_bytes(big) - 1)
    tall = lx + 2 > _TALLEST
    want_long = tall & ((lx < 140) if route == "strips" else True)
    eng = Engine(EngineConfig(sw_strips=route != "tile"), device="cpu")
    off = eng._sw_offload_mask(pairs)
    np.testing.assert_array_equal(off, want_long)
    jax_eng = genomax.Engine(JaxEngineConfig(backend="lax"))
    want = jax_eng.sw_scores(_jax_pairs(pairs))
    # the stream's chunks of 11 pairs are packed, and so routed, apart
    n_chunked = sum(int(m.sum()) for m in (
        eng._sw_offload_mask(pairs[i: i + 11])
        for i in range(0, len(pairs), 11))
        if m is not None)
    for run, n_long in ((lambda: eng.sw_scores(pairs), int(want_long.sum())),
                        (lambda: eng.sw_scores_stream(pairs, 11), n_chunked)):
        for v in log.values():
            v.clear()
        np.testing.assert_array_equal(run(), want)
        assert eng.last_stats.offloaded_jobs == n_long
        assert sum(log["sw_long"]) == n_long
        assert all(rows <= _TALLEST for rows in log["tile"])
        assert log["tile"]
        # strips get a bucket past the tallest where sw_long did not take
        # every pair past it
        assert (max(log["strips"], default=0) > _TALLEST) == (
            n_long < int(tall.sum()))
    assert (n_chunked < int(tall.sum())) == (route != "tile")


def test_pairhmm_routing_past_the_tallest_block(tallest_two_warps):
    """PairHMM reads past the lane tile's tallest bucket (cut to 64 rows:
    reads past 62bp) take pairhmm_long; the lane tile gets the rest.
    Values within 1e-4 of the JAX engine at the same L and of the fp64
    model; the stream routes alike."""
    log = tallest_two_warps
    batches = [generate_pairhmm_batch(4, 2, read_len=50, hap_len=90,
                                      seed=21, from_haps=True),
               generate_pairhmm_batch(3, 2, read_len=100, hap_len=140,
                                      seed=22, from_haps=True)]
    eng = Engine(device="cpu")
    off = eng._phmm_offload_mask(_jobs(batches))
    np.testing.assert_array_equal(off, [False] * 8 + [True] * 6)
    jb = _jax_batches(batches)
    want = genomax.Engine(JaxEngineConfig(backend="lax")).pairhmm(jb)
    for run in (lambda: eng.pairhmm(batches),
                lambda: eng.pairhmm_stream(batches, 1)):
        for v in log.values():
            v.clear()
        got = run()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, jax_native.pairhmm_native(jb),
                                   rtol=0, atol=1e-4)
        assert sum(log["pairhmm_long"]) == 6
        assert log["phmm_tile"] and max(log["phmm_tile"]) <= 64
