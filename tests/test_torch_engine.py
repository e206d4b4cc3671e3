"""genomax_torch.Engine on the CPU: the vendored goldens, agreement with the
JAX engine in the same configuration (resident Pallas kernel in interpret
mode, strips and rotor off; the strips route is tests/test_torch_sw_strips.py),
the native offload, and the refusals: knobs not ported yet, a CUDA device
on a host without one, and a failed kernel build. Scores are int32;
tolerance exact."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import genomax
from genomax import native
from genomax.config import EngineConfig as JaxEngineConfig
from genomax.config import SWConfig
from genomax_torch.engine.executor import EngineError
from genomax.io.formats import SWPair
from genomax.kernels import oracle

from genomax_torch.config import EngineConfig
from genomax_torch.engine import executor
from genomax_torch.engine.executor import Engine
from genomax_torch.kernels import _build
from genomax_torch.pack.nibble import stream_bytes
from _torch_cpu import one_torch_thread  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _golden_scores(path):
    with open(path) as f:
        return np.array([int(line.split()[1]) for line in f], np.int32)


@pytest.mark.parametrize("name", ["sw_small", "sw_medium", "sw_quirks"])
def test_engine_matches_golden(golden_dir, name):
    eng = Engine(device="cpu")
    got = eng.sw_scores_file(os.path.join(golden_dir, name + ".in"))
    np.testing.assert_array_equal(
        got, _golden_scores(os.path.join(golden_dir, name + ".golden.out")))
    assert eng.last_stats.n_jobs == len(got) and eng.last_stats.buckets >= 1


def _ragged_pairs(seed):
    """Lengths 0-150 with the trailing '\\n', an empty pair and a tandem
    repeat, across several sublane buckets."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = [SWPair(sx=b"", sy=b""), SWPair(sx=b"\n", sy=b"A\n")]
    for lo, hi, n in ((1, 40, 20), (60, 90, 6), (120, 150, 4)):
        for _ in range(n):
            a = rng.choice(abc, int(rng.integers(lo, hi))).tobytes() + b"\n"
            b = rng.choice(abc, int(rng.integers(lo, hi))).tobytes() + b"\n"
            pairs.append(SWPair(sx=min(a, b, key=len), sy=max(a, b, key=len)))
    x = rng.choice(abc, 70).tobytes()
    pairs.append(SWPair(sx=x, sy=x + rng.choice(abc, 80).tobytes() + x))
    return pairs


@pytest.mark.parametrize("cfg", [
    SWConfig(), SWConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)],
    ids=["default", "m2x3o5e2"])
def test_engine_matches_jax_engine_resident_kernel(cfg):
    pairs = _ragged_pairs(11)
    jax_eng = genomax.Engine(
        JaxEngineConfig(backend="pallas", sw_strips=False, sw_rotor=False,
                        unroll=4),
        sw_cfg=cfg, interpret=True)
    eng = Engine(EngineConfig(sw_strips=False, sw_rotor=False), sw_cfg=cfg,
                 device="cpu")
    got = eng.sw_scores(pairs)
    np.testing.assert_array_equal(got, jax_eng.sw_scores(pairs))
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs, cfg))
    assert eng.last_stats.buckets == jax_eng.last_stats.buckets
    assert eng.last_stats.dp_cells == jax_eng.last_stats.dp_cells


def _mixed_pairs(seed):
    """Short pairs, pairs whose x passes max_device_len = 128, and one whose
    diagonals pass max_device_diags = 450, interleaved."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)

    def dna(n):
        return rng.choice(abc, n).tobytes()

    x = dna(200)
    return [SWPair(sx=dna(20) + b"\n", sy=dna(40) + b"\n"),
            SWPair(sx=x, sy=dna(50) + x + dna(30)),       # 480 > 450: native
            SWPair(sx=dna(90), sy=dna(300)),              # lane tile
            SWPair(sx=dna(150), sy=dna(260)),             # long-pair kernel
            SWPair(sx=b"", sy=b""),
            SWPair(sx=x[:140], sy=x[:140] + b"\n")]       # long-pair kernel


_MIXED = dict(max_device_len=128, max_device_diags=450)


def test_engine_offloads_long_x_to_native(monkeypatch):
    """len(sx) + 2 > max_device_len leaves the lane-tile kernel: for the
    long-pair kernel on the engine's device while len(sx) + len(sy) <=
    max_device_diags, and only past that for the native model."""
    pairs = _mixed_pairs(2)
    to_native, to_long = [], []
    real_native, real_long = native.sw_scores_native, executor.sw_scores_long
    monkeypatch.setattr(
        executor.native, "sw_scores_native",
        lambda ps, cfg=None: to_native.append(len(ps)) or real_native(ps, cfg))
    monkeypatch.setattr(
        executor, "sw_scores_long",
        lambda ps, cfg, device: to_long.append(
            (len(ps), str(device))) or real_long(ps, cfg, device=device))
    eng = Engine(EngineConfig(**_MIXED), device="cpu")
    got = eng.sw_scores(pairs)
    np.testing.assert_array_equal(got, real_native(pairs))
    assert got[1] == 200 and got[5] == 140
    assert to_long == [(2, "cpu")] and to_native == [1]
    assert eng.last_stats.offloaded_jobs == 3
    assert eng.last_stats.n_jobs == 6 and eng.last_stats.buckets == 2


@pytest.mark.parametrize("cfg", [
    SWConfig(), SWConfig(match=3, mismatch=-1, gap_open=0, gap_extend=-2)],
    ids=["default", "m3x1o0e2"])
def test_engine_mixed_list_matches_jax_engine_long_pairs(cfg):
    """Short, long and oversized pairs in one call: the same scores, in
    input order, and the same offload count as the JAX engine, whose Pallas
    backend (interpret mode) sends the long pairs to its sw_long."""
    pairs = _mixed_pairs(5)
    jax_eng = genomax.Engine(
        JaxEngineConfig(backend="pallas", sw_strips=False, sw_rotor=False,
                        unroll=4, **_MIXED),
        sw_cfg=cfg, interpret=True)
    eng = Engine(EngineConfig(sw_strips=False, sw_rotor=False, **_MIXED),
                 sw_cfg=cfg, device="cpu")
    got = eng.sw_scores(pairs)
    np.testing.assert_array_equal(got, jax_eng.sw_scores(pairs))
    np.testing.assert_array_equal(got, oracle.sw_scores_pairs(pairs, cfg))
    assert (eng.last_stats.offloaded_jobs
            == jax_eng.last_stats.offloaded_jobs == 3)
    assert eng.last_stats.buckets == jax_eng.last_stats.buckets
    assert eng.last_stats.dp_cells == jax_eng.last_stats.dp_cells


def test_long_kernel_failure_raises_engine_error_not_native(monkeypatch):
    """The JAX engine reroutes a failed sw_long to the native model; the
    port raises, and the native model is not called for those pairs."""
    def fail(*args, **kwargs):
        raise RuntimeError("device fault (simulated)")

    called = []
    monkeypatch.setattr(executor, "sw_scores_long", fail)
    monkeypatch.setattr(executor.native, "sw_scores_native",
                        lambda *a, **k: called.append(a))
    eng = Engine(EngineConfig(**_MIXED), device="cpu")
    with pytest.raises(EngineError, match="sw_long") as err:
        eng.sw_scores(_mixed_pairs(2))
    assert err.value.stage == "sw_long"
    assert isinstance(err.value.cause, RuntimeError)
    assert called == []


def test_long_kernel_build_failure_raises_not_cpu_scores(monkeypatch):
    """On a device that is not the CPU the long-pair wrapper launches its
    kernel or raises: a build failure reaches the caller as EngineError."""
    def fail(*args, **kwargs):
        raise _build.BuildError("nvcc failed (simulated)")

    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    eng = Engine(EngineConfig(**_MIXED), device="cuda")
    eng.device = torch.device("meta")  # stand-in for a card on this host
    rng = np.random.default_rng(0)
    x = rng.choice(np.frombuffer(b"ACGT", np.uint8), 150).tobytes()
    with pytest.raises(EngineError, match="sw_long") as err:
        eng.sw_scores([SWPair(sx=x, sy=x)])
    assert isinstance(err.value.cause, _build.BuildError)


def test_cli_sw_file_with_long_pairs_reaches_long_kernel(tmp_path):
    """The slice as a whole: `python -m genomax_torch sw` on a file whose
    pairs pass max_device_len scores them through the long-pair path."""
    from genomax_torch.io.formats import parse_sw_file, write_sw_input

    rng = np.random.default_rng(3)
    abc = np.frombuffer(b"ACGT", np.uint8)
    long_x = rng.choice(abc, 1100).tobytes()
    seqs = [b"ACGTACGT", b"TTACGTACGTTT", long_x,
            long_x[:500] + b"GG" + long_x[500:],
            rng.choice(abc, 1030).tobytes(), rng.choice(abc, 1040).tobytes()]
    path = tmp_path / "long.in"
    write_sw_input(str(path), seqs)
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.set_num_threads(1);"
         "from genomax_torch.kernels import sw_long, wavefront;"
         "from genomax_torch.cli.main import main;"
         "calls = [];"
         "plain = sw_long.sw_long_forward;"
         "sw_long.sw_long_forward = lambda *a: calls.append(1) or plain(*a);"
         "rc = main(['sw', sys.argv[1], '--device', 'cpu', '--stats']);"
         "print('long tiles', len(calls)); sys.exit(rc)", str(path)],
        capture_output=True, text=True, cwd=_REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-400:]
    got = [int(line.split()[1]) for line in r.stdout.splitlines()
           if line.startswith("Score: ")]
    want = native.sw_scores_native(parse_sw_file(str(path)))
    assert got == list(want) and got[1] > 1000
    assert "long tiles 1" in r.stdout
    assert '"offloaded_jobs": 2' in r.stderr


@pytest.mark.parametrize("knob,value", [("sw_rotor", True), ("sw_stack", 4)])
def test_jax_engine_routers_construct(knob, value):
    """Every single-device SW router of the JAX engine has its knob here
    and constructs with the JAX sizes: sw_rotor (which raised
    NotImplementedError until the rotor kernel landed) and sw_stack."""
    cfg = EngineConfig(**{knob: value})
    assert getattr(cfg, knob) == value
    assert cfg.rotor_max_period == 136 and cfg.rotor_max_slots >= 1
    assert cfg.stack_max_nxs == 96


@pytest.mark.parametrize("bad", [
    dict(rotor_max_period=0), dict(rotor_max_period=100),
    dict(rotor_max_period=168), dict(rotor_max_slots=0)],
    ids=["period-0", "period-not-x8", "period-past-160", "slots-0"])
def test_rotor_sizes_out_of_range_raise(bad):
    with pytest.raises(ValueError, match=next(iter(bad))):
        EngineConfig(**bad)


def _stacked_window(rows):
    from genomax_torch.kernels import sw_stacked

    return sw_stacked.geometry(2, rows // 2)


def _conveyor_window(rows):
    from genomax_torch.kernels import sw_conveyor

    return sw_conveyor.geometry(rows, 1)


@pytest.mark.parametrize("make,rows,raises", [
    (lambda n: EngineConfig(max_device_len=n), 2048, None),
    (lambda n: EngineConfig(max_device_len=n), 4096, None),
    (lambda n: EngineConfig(max_device_len=n), 4104, None),
    (lambda n: EngineConfig(max_device_len=n), 8192, None),
    (lambda n: EngineConfig(max_device_len=n), 16384, None),
    (lambda n: EngineConfig(max_device_len=n), 65536, None),
    (lambda n: EngineConfig(max_device_len=n), 7, "at least 8"),
    (lambda n: EngineConfig(sw_stack=2, stack_max_nxs=n // 2), 1032, "1024"),
    (_stacked_window, 1032, "1024"),
    (_conveyor_window, 1032, "1024"),
    (_conveyor_window, 1024, None)],
    ids=["L2048", "L4096", "L4104", "L8192", "L16384", "L65536", "L7",
         "stack-rows", "stacked-geometry", "conveyor-window",
         "conveyor-1024"])
def test_max_device_len_cap_and_window_limits(make, rows, raises):
    """max_device_len takes any value of 8 or more, as the JAX config does
    (past the lane tiles' tallest buckets the engine routes, with the same
    scores), and raises below 8; the stacked kernel's rows a stack and the
    conveyor's window keep their own 1,024 rows."""
    if raises is None:
        make(rows)
    else:
        with pytest.raises(ValueError, match=raises):
            make(rows)


@pytest.mark.parametrize("strips,x_len,y_len,off", [
    (True, 8190, 100, False), (False, 8190, 100, False),
    (True, 8190, 30000, False), (True, 8191, 100, False),
    (False, 8191, 100, True), (True, 8191, 30000, True),
    (True, 12000, 9000, False), (False, 12000, 9000, True)],
    ids=["tile", "tile-nostrips", "tile-long-y", "strips", "nostrips",
         "strips-smem", "strips-12k", "nostrips-12k"])
def test_sw_offload_mask_past_the_tallest_bucket(strips, x_len, y_len, off):
    """At max_device_len 16,384: x up to 8,190 bases (8,192 rows, the lane
    tile's tallest bucket) stays in the bucket path whatever its y; past
    it a pair stays only where strips take its bucket (on, and a y whose
    seam ring fits a block's shared memory), else it takes sw_long."""
    eng = Engine(EngineConfig(max_device_len=16384, sw_strips=strips),
                 device="cpu")
    pairs = [SWPair(sx=b"A" * 20, sy=b"C" * 20),
             SWPair(sx=b"A" * x_len, sy=b"C" * y_len)]
    m = eng._sw_offload_mask(pairs)
    assert (m is not None and bool(m[1])) == off
    assert m is None or not m[0]


@pytest.mark.parametrize("L,read_len,off", [
    (4096, 2046, False), (4096, 2047, True), (16384, 8190, False),
    (16384, 8191, True), (65536, 8191, True)])
def test_phmm_offload_mask_past_the_tallest_bucket(L, read_len, off):
    """Reads under max_device_len // 2 stay on the lane tile, as in the JAX
    engine, up to its tallest bucket of 8,192 rows (8,190 bases); longer
    ones take pairhmm_long at any L."""
    from genomax_torch.io.formats import PairHMMBatch, PairHMMRead

    q = b"I" * read_len
    batch = PairHMMBatch(reads=[PairHMMRead(bases=b"A" * read_len, base_q=q,
                                            ins_q=q, del_q=q, gcp_q=q)],
                         haplotypes=[b"C" * 100])
    m = Engine(EngineConfig(max_device_len=L),
               device="cpu")._phmm_offload_mask(executor._jobs([batch]))
    assert (m is not None and bool(m[0])) == off


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(device="cuda")


def test_kernel_build_failure_raises_not_cpu_scores(monkeypatch):
    """A build failure on the device path surfaces as EngineError: the
    wrapper never drops to the plain version for a tensor off the CPU."""

    def fail(*args, **kwargs):
        raise _build.BuildError("nvcc failed (simulated)")

    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    eng = Engine(device="cuda")
    # Stand-in for device tensors on a host without a card.
    monkeypatch.setattr(
        executor, "sw_bucket_to_torch",
        lambda b, device: tuple(
            torch.from_numpy(a).to("meta")
            for a in (b.sx, stream_bytes(b.sy), b.ndiag_tile)))
    monkeypatch.setattr(
        executor, "sw_rotor_to_torch",
        lambda prep, device: tuple(torch.from_numpy(a).to("meta") for a in
                                   prep[0]))
    with pytest.raises(EngineError) as err:
        eng.sw_scores([SWPair(sx=b"ACGT", sy=b"ACGT")])
    assert isinstance(err.value.cause, _build.BuildError)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build("sw_tile")
    assert not os.listdir(tmp_path)
