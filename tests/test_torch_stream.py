"""genomax_torch's streaming pipeline (engine/stream.py) on the CPU: streamed
results equal the one-shot engine's and the JAX package's stream (SW
exactly, PairHMM within 1e-6 of one-shot and 1e-5 of the JAX stream), with
the offload, the native model and the fp64 fallback handled per chunk,
RunStats summed over the chunks, the chunk guard, empty workloads, and
the thread rule: the pack in the worker, every bucket run on the caller's
thread."""

import threading

import numpy as np
import pytest

from genomax.config import EngineConfig as JaxEngineConfig
from genomax.engine.executor import Engine as JaxEngine
from genomax.kernels import oracle
from genomax_torch.config import EngineConfig
from genomax_torch.engine import executor, stream
from genomax_torch.engine.executor import Engine, EngineError
from genomax_torch.io.formats import SWPair
from genomax_torch.io.generator import generate_pairhmm_batch
from genomax_torch.pack import pack_sw_pairs
from _torch_cpu import one_torch_thread  # noqa: F401

ABC = np.frombuffer(b"ATGC", np.uint8)


def _sw_pairs(n=90, seed=44, big_at=40):
    """tests/test_stream.py's pairs: 5-60bp, x no longer than y, and one
    1,100bp x 1,200bp pair at ``big_at`` that leaves the lane-tile kernels
    for the long-pair kernel (inside a middle chunk at a chunk of 32)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        a = rng.choice(ABC, int(rng.integers(5, 60))).tobytes()
        b = rng.choice(ABC, int(rng.integers(5, 60))).tobytes()
        if len(a) > len(b):
            a, b = b, a
        pairs.append(SWPair(sx=a, sy=b))
    if big_at is not None:
        pairs[big_at] = SWPair(sx=rng.choice(ABC, 1100).tobytes(),
                               sy=rng.choice(ABC, 1200).tobytes())
    return pairs


@pytest.fixture(scope="module")
def sw_case():
    pairs = _sw_pairs()
    eng = Engine(device="cpu")
    want = eng.sw_scores(pairs)
    return pairs, want, eng.last_stats


@pytest.fixture(scope="module")
def jax_sw_stream(sw_case):
    pairs = sw_case[0]
    jeng = JaxEngine(JaxEngineConfig(backend="lax"))
    return jeng.sw_scores_stream(pairs, chunk_pairs=32), jeng.last_stats


def _chunks(n, size):
    return [(s, min(s + size, n)) for s in range(0, n, size)]


@pytest.mark.parametrize("chunk", [1, 7, 32, 89, 90, 65536])
def test_sw_stream_equals_oneshot(sw_case, chunk):
    """Every chunk size, dividing the 90 pairs or not, gives the one-shot
    scores and the one-shot counts; buckets are summed over the chunks."""
    pairs, want, one = sw_case
    eng = Engine(device="cpu")
    got = eng.sw_scores_stream(pairs, chunk_pairs=chunk)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    st = eng.last_stats
    for key in ("n_jobs", "offloaded_jobs", "fallback_jobs", "dp_cells"):
        assert getattr(st, key) == getattr(one, key), key
    assert st.offloaded_jobs == 1
    n_buckets = 0
    for s, e in _chunks(len(pairs), chunk):
        keep = np.array([len(p.sx) + 2 <= 1024 for p in pairs[s:e]])
        n_buckets += len(pack_sw_pairs(pairs[s:e], job_mask=keep))
    assert st.buckets == n_buckets


def test_sw_stream_equals_jax_stream_and_oracle(sw_case, jax_sw_stream):
    pairs, want, _ = sw_case
    eng = Engine(device="cpu")
    got = eng.sw_scores_stream(pairs, chunk_pairs=32)
    jax_got, jax_stats = jax_sw_stream
    np.testing.assert_array_equal(got, jax_got)
    np.testing.assert_array_equal(got, oracle.sw_scores_pairs(pairs))
    for key in ("n_jobs", "offloaded_jobs", "buckets", "dp_cells"):
        assert getattr(eng.last_stats, key) == getattr(jax_stats, key), key


def _phmm_batches():
    """Five GATK-shaped batches, with one of random reads against random
    haplotypes (every job far below -45 log10: the fp64 fallback) as the
    third, so that at a chunk of 2 only the middle chunk falls back and is
    promoted to float64."""
    batches = [generate_pairhmm_batch(3, 2, read_len=30 + i, hap_len=50,
                                      seed=i, from_haps=True)
               for i in range(5)]
    batches[2] = generate_pairhmm_batch(2, 2, read_len=60, hap_len=80,
                                        seed=12)
    return batches


@pytest.fixture(scope="module")
def phmm_case():
    batches = _phmm_batches()
    eng = Engine(device="cpu")
    want = eng.pairhmm(batches)
    return batches, want, eng.last_stats


@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 64])
def test_pairhmm_stream_equals_oneshot(phmm_case, chunk):
    batches, want, one = phmm_case
    assert one.fallback_jobs == 4 and want.dtype == np.float64
    eng = Engine(device="cpu")
    got = eng.pairhmm_stream(batches, chunk_batches=chunk)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for key in ("n_jobs", "offloaded_jobs", "fallback_jobs", "dp_cells"):
        assert getattr(eng.last_stats, key) == getattr(one, key), key
    assert eng.last_stats.buckets == -(-len(batches) // chunk)


def test_pairhmm_stream_equals_jax_stream(phmm_case):
    batches, _, _ = phmm_case
    eng = Engine(device="cpu")
    got = eng.pairhmm_stream(batches, chunk_batches=2)
    jeng = JaxEngine(JaxEngineConfig(backend="lax"))
    want = jeng.pairhmm_stream(batches, chunk_batches=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for key in ("n_jobs", "fallback_jobs", "buckets", "dp_cells"):
        assert getattr(eng.last_stats, key) == getattr(jeng.last_stats,
                                                       key), key


def test_pairhmm_stream_offloads_per_chunk():
    """At max_device_diags 120 (PairHMM takes half), jobs past 60 diagonals
    leave the lane-tile kernel: those up to 120 for the long-read kernel,
    the rest for the native model, which promotes its chunk to float64."""
    batches = [generate_pairhmm_batch(2, 2, read_len=20, hap_len=30, seed=1,
                                      from_haps=True),
               generate_pairhmm_batch(2, 1, read_len=30, hap_len=50, seed=2,
                                      from_haps=True),
               generate_pairhmm_batch(1, 2, read_len=40, hap_len=90, seed=3,
                                      from_haps=True),
               generate_pairhmm_batch(2, 2, read_len=15, hap_len=25, seed=4,
                                      from_haps=True)]
    cfg = EngineConfig(max_device_diags=120)
    eng = Engine(cfg, device="cpu")
    want = eng.pairhmm(batches)
    one = eng.last_stats
    assert one.offloaded_jobs == 4 and want.dtype == np.float64
    got = eng.pairhmm_stream(batches, chunk_batches=1)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for key in ("n_jobs", "offloaded_jobs", "fallback_jobs"):
        assert getattr(eng.last_stats, key) == getattr(one, key), key


@pytest.mark.parametrize("bad", [0, -5])
def test_stream_rejects_nonpositive_chunk(bad):
    eng = Engine(device="cpu")
    with pytest.raises(ValueError, match="chunk_pairs must be >= 1"):
        eng.sw_scores_stream([SWPair(sx=b"ACG\n", sy=b"ACGT\n")], bad)
    with pytest.raises(ValueError, match="chunk_batches must be >= 1"):
        eng.pairhmm_stream([], bad)


def test_stream_empty_workloads():
    eng = Engine(device="cpu")
    got = eng.sw_scores_stream([])
    assert got.dtype == np.int32 and got.shape == (0,)
    assert eng.last_stats.n_jobs == 0 and eng.last_stats.buckets == 0
    got = eng.pairhmm_stream([])
    assert got.dtype == np.float32 and got.shape == (0,)
    assert eng.last_stats.n_jobs == 0 and eng.last_stats.buckets == 0


def _record_threads(monkeypatch, names):
    """Wrap each (owner, attribute) so that calls record their thread."""
    seen = {n: [] for _, n in names}
    for owner, name in names:
        fn = getattr(owner, name)

        def wrapped(*a, _fn=fn, _n=name, **kw):
            seen[_n].append(threading.get_ident())
            return _fn(*a, **kw)

        monkeypatch.setattr(owner, name, wrapped)
    return seen


def test_sw_stream_thread_rule(monkeypatch):
    """The pack runs in the worker, every bucket run (and so every torch
    call and launch) on the caller's thread."""
    seen = _record_threads(monkeypatch, [(stream, "pack_sw_pairs"),
                                         (Engine, "_sw_bucket"),
                                         (Engine, "_sw_offload_post")])
    pairs = _sw_pairs(40, big_at=None)
    eng = Engine(device="cpu")
    eng.sw_scores_stream(pairs, chunk_pairs=10)
    me = threading.get_ident()
    assert len(seen["pack_sw_pairs"]) == 4
    assert me not in seen["pack_sw_pairs"]
    assert seen["_sw_bucket"] and set(seen["_sw_bucket"]) == {me}
    assert set(seen["_sw_offload_post"]) == {me}


def test_pairhmm_stream_thread_rule(monkeypatch):
    seen = _record_threads(monkeypatch, [(executor, "pack_pairhmm_batches"),
                                         (Engine, "_phmm_bucket"),
                                         (Engine, "_phmm_fallback")])
    batches = [generate_pairhmm_batch(2, 2, read_len=12, hap_len=16, seed=i)
               for i in range(3)]
    eng = Engine(device="cpu")
    eng.pairhmm_stream(batches, chunk_batches=1)
    me = threading.get_ident()
    assert len(seen["pack_pairhmm_batches"]) == 3
    assert me not in seen["pack_pairhmm_batches"]
    assert len(seen["_phmm_bucket"]) == 3 and set(seen["_phmm_bucket"]) == {me}
    assert set(seen["_phmm_fallback"]) == {me}


def test_stream_worker_exception_propagates(monkeypatch):
    def fail(*a, **kw):
        raise MemoryError("pack failed (simulated)")

    monkeypatch.setattr(stream, "pack_sw_pairs", fail)
    with pytest.raises(MemoryError, match="simulated"):
        Engine(device="cpu").sw_scores_stream(_sw_pairs(20, big_at=None), 8)


@pytest.mark.parametrize("kind", ["sw", "pairhmm"])
def test_stream_bucket_failure_raises_engine_error(monkeypatch, kind):
    """A bucket that fails twice raises EngineError under the stream's
    stage name; nothing falls back."""
    def fail(*a, **kw):
        raise RuntimeError("device fault (simulated)")

    eng = Engine(device="cpu")
    if kind == "sw":
        monkeypatch.setattr(executor, "sw_bucket_to_torch", fail)
        call = lambda: eng.sw_scores_stream(_sw_pairs(20, big_at=None), 8)
    else:
        monkeypatch.setattr(executor, "phmm_bucket_to_torch", fail)
        call = lambda: eng.pairhmm_stream(  # noqa: E731
            [generate_pairhmm_batch(1, 1, 10, 12, seed=0)], 1)
    with pytest.raises(EngineError) as e:
        call()
    assert e.value.stage == f"{kind}-stream"
    assert "device fault (simulated)" in str(e.value)


def test_stream_long_kernel_failure_raises(monkeypatch):
    """A failing long-pair kernel inside a chunk raises EngineError; the
    pair is not rerouted to the native model."""
    def fail(*a, **kw):
        raise RuntimeError("long kernel fault (simulated)")

    monkeypatch.setattr(executor, "sw_scores_long", fail)
    with pytest.raises(EngineError) as e:
        Engine(device="cpu").sw_scores_stream(_sw_pairs(), 32)
    assert e.value.stage == "sw_long"
