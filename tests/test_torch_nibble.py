"""The port's SW transfer ladder (genomax_torch.pack.nibble, StreamBand) on
the CPU: every function of genomax.pack.nibble, StreamBand,
pack_sw_pairs(stream_band=...) and pad_tiles_to on a band bucket held
against the JAX package bit for bit; tile_slice of a band bucket; the
rotor and stacked preps on band buckets; and the CPU Engine, its stream,
the sweep's pack and a two-rank gloo ShardedEngine, which ship the band,
equal to the oracle on the strips, rotor, stacked and tile routes. Codes
and scores are integers; tolerance exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomax.io.formats import SWPair as JaxSWPair
from genomax.kernels import oracle
from genomax.kernels import sw_rotor as jax_rotor
from genomax.pack import bucketing as jax_bucketing
from genomax.pack import nibble as jax_nibble

from _torch_cpu import one_torch_thread  # noqa: F401
from test_torch_dist import _rows, _run_ranks
from genomax_torch import native
from genomax_torch.bench import sweep
from genomax_torch.config import EngineConfig
from genomax_torch.dist import sharded
from genomax_torch.dist.engine import ShardedEngine
from genomax_torch.dist.mesh import make_mesh
from genomax_torch.engine import stream
from genomax_torch.engine.executor import Engine
from genomax_torch.io.formats import SWPair
from genomax_torch.kernels import sw_rotor, sw_stacked
from genomax_torch.pack import bucketing, nibble, tensors

ABC = np.frombuffer(b"ACGT", np.uint8)


def _tiles(rng, nt, r, alphabet):
    """tests/test_nibble.py's tiles: codes of ``alphabet`` with the pad
    codes in the first and last rows."""
    a = rng.choice(alphabet, size=(nt, r, 128)).astype(np.int8)
    a[:, 0] = 1
    a[:, -1] = 0
    return a


def _dna(rng, n):
    return rng.choice(ABC, n).tobytes()


def _ragged(seed, n=150):
    """Ragged pairs of 3-90bp x 3-200bp, x no longer than y, every third
    with the trailing '\\n': more than one tile a bucket."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        a, b = _dna(rng, int(rng.integers(3, 90))), _dna(
            rng, int(rng.integers(3, 200)))
        if len(a) > len(b):
            a, b = b, a
        if i % 3 == 0:
            a, b = a + b"\n", b + b"\n"
        pairs.append(SWPair(sx=a, sy=b))
    return pairs


def _jax(pairs):
    return [JaxSWPair(sx=p.sx, sy=p.sy) for p in pairs]


def _same_bucket(ours, theirs):
    """An SW bucket of the port equal to the JAX one, field by field, a
    StreamBand's band, lo and nds included."""
    assert type(ours.sy).__name__ == type(theirs.sy).__name__
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(b, jax_bucketing.StreamBand):
            np.testing.assert_array_equal(a.band, b.band)
            assert (a.lo, a.nds, a.shape, a.dtype) == (b.lo, b.nds, b.shape,
                                                       b.dtype)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


# -- genomax.pack.nibble, function by function ------------------------------

@pytest.mark.parametrize("n_symbols", [4, 14, 15])
@pytest.mark.parametrize("newline", [False, True], ids=["", "newline"])
def test_build_code_lut_equal(n_symbols, newline):
    rng = np.random.default_rng(n_symbols)
    alphabet = np.arange(65, 65 + n_symbols - newline, dtype=np.uint8)
    if newline:
        alphabet = np.append(alphabet, np.uint8(ord("\n")))
    a = _tiles(rng, 2, 16, alphabet)
    b = _tiles(rng, 3, 24, alphabet[::2])
    ours, theirs = nibble.build_code_lut(a, b), jax_nibble.build_code_lut(a, b)
    if n_symbols > nibble.MAX_SYMBOLS:
        assert ours is None and theirs is None
        return
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == np.uint8 and ours[0] == 0 and ours[1] == 1
    assert sorted(ours[alphabet]) == list(range(2, 2 + n_symbols))
    if newline:
        assert ours[ord("\n")] >= 2


@pytest.mark.parametrize("rows", [8, 13])
def test_nibble_pack_equal(rows):
    rng = np.random.default_rng(rows)
    arr = _tiles(rng, 3, rows, np.frombuffer(b"ACGTN\n", np.uint8))
    lut = nibble.build_code_lut(arr)
    ours = nibble.nibble_pack(arr, lut)
    np.testing.assert_array_equal(ours, jax_nibble.nibble_pack(arr, lut))
    assert ours.shape == (3, -(-rows // 2), 128) and ours.dtype == np.uint8


def test_nibble_pack_4bit_equal_and_guarded():
    rng = np.random.default_rng(3)
    arr = rng.choice(np.array([0, 1, 2, 4, 8, 15], np.int8), (2, 7, 128))
    np.testing.assert_array_equal(nibble.nibble_pack_4bit(arr),
                                  jax_nibble.nibble_pack_4bit(arr))
    arr[1, 3, 5] = 16
    for fn in (nibble.nibble_pack_4bit, jax_nibble.nibble_pack_4bit):
        with pytest.raises(ValueError, match="> 15"):
            fn(arr)


@pytest.mark.parametrize("rows", [8, 13, 1])
def test_expand_nibbles_equal(rows):
    rng = np.random.default_rng(rows + 20)
    arr = _tiles(rng, 3, rows, np.frombuffer(b"ACGT\n", np.uint8))
    lut = nibble.build_code_lut(arr)
    packed = nibble.nibble_pack(arr, lut)
    ours = nibble.expand_nibbles(torch.from_numpy(packed), rows)
    theirs = np.asarray(jax_nibble.expand_nibbles(jnp.asarray(packed), rows))
    assert ours.dtype == torch.int8 and ours.is_contiguous()
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(ours.numpy(),
                                  lut[arr.view(np.uint8)].astype(np.int8))


def test_make_shipper_forms():
    """lut: remap and expand; none: the placement itself."""
    def put(a):
        return torch.from_numpy(a)

    assert nibble.make_shipper(put) is put
    rng = np.random.default_rng(5)
    arr = _tiles(rng, 2, 9, np.frombuffer(b"ACGT", np.uint8))
    lut = nibble.build_code_lut(arr)
    got = nibble.make_shipper(put, lut=lut)(arr)
    np.testing.assert_array_equal(got.numpy(), lut[arr.view(np.uint8)])


# -- StreamBand and the pack ------------------------------------------------

@pytest.mark.parametrize("band", ["all", "predicate"])
@pytest.mark.parametrize("masked", [False, True], ids=["", "masked"])
def test_pack_sw_pairs_stream_band_equal(band, masked):
    pairs = _ragged(17, n=220)
    pairs += [SWPair(sx=_dna(np.random.default_rng(i), 130),
                     sy=_dna(np.random.default_rng(i + 9), 150))
              for i in range(3)]
    mask = None
    if masked:
        mask = np.random.default_rng(4).random(len(pairs)) < 0.7
    flag = True if band == "all" else (lambda nxs: nxs > 96)
    ours = bucketing.pack_sw_pairs(pairs, job_mask=mask, stream_band=flag)
    theirs = jax_bucketing.pack_sw_pairs(_jax(pairs), job_mask=mask,
                                         stream_band=flag)
    full = bucketing.pack_sw_pairs(pairs, job_mask=mask)
    assert len(ours) == len(theirs) == len(full) >= 2
    kinds = set()
    for o, t, f in zip(ours, theirs, full):
        _same_bucket(o, t)
        banded = isinstance(o.sy, bucketing.StreamBand)
        kinds.add(banded)
        assert banded == (band == "all" or o.sx.shape[1] > 96)
        if banded:
            assert 0 < o.sy.lo and o.sy.band.shape[1] < f.sy.shape[1]
            assert o.sy.nds == f.sy.shape[1] and o.sy.shape == f.sy.shape
            np.testing.assert_array_equal(o.sy.materialize(), f.sy)
        else:
            np.testing.assert_array_equal(o.sy, f.sy)
        for name in ("sx", "nx", "ny", "ndiag_tile", "perm"):
            np.testing.assert_array_equal(getattr(o, name), getattr(f, name))
    assert kinds == ({True} if band == "all" else {True, False})


@pytest.mark.parametrize("multiple", [2, 3, 4])
def test_pad_tiles_to_band_bucket_equal(multiple):
    pairs = _ragged(23, n=300)
    for o, t in zip(bucketing.pack_sw_pairs(pairs, stream_band=True),
                    jax_bucketing.pack_sw_pairs(_jax(pairs),
                                                stream_band=True)):
        po = bucketing.pad_tiles_to(o, multiple)
        _same_bucket(po, jax_bucketing.pad_tiles_to(t, multiple))
        assert po.ndiag_tile.shape[0] % multiple == 0
        assert po.sy.band.shape[0] == po.ndiag_tile.shape[0]
        np.testing.assert_array_equal(
            po.sy.materialize(),
            bucketing.pad_tiles_to(dataclasses.replace(
                o, sy=o.sy.materialize()), multiple).sy)


@pytest.mark.parametrize("shipper", ["raw", "nibble"])
def test_ship_stream_equals_the_full_pack(shipper):
    """A band rebuilt on the device (raw, or nibble-packed through one
    table of the bucket's codes) == the full host buffer through the same
    placement, == the JAX ship_stream's."""
    pairs = _ragged(31, n=200)
    for bb, bf in zip(bucketing.pack_sw_pairs(pairs, stream_band=True),
                      bucketing.pack_sw_pairs(pairs)):
        def put(a):
            return torch.from_numpy(a)

        lut = nibble.build_code_lut(bb.sx, nibble.stream_bytes(bb.sy))
        assert lut is not None
        ship = put if shipper == "raw" else nibble.make_shipper(put, lut=lut)
        jship = (jnp.asarray if shipper == "raw" else
                 jax_nibble.make_shipper(jnp.asarray, lut=lut))
        got = nibble.ship_stream(ship, bb.sy)
        assert got.dtype == torch.int8 and got.shape == bf.sy.shape
        np.testing.assert_array_equal(got.numpy(), ship(bf.sy).numpy())
        want = bf.sy if shipper == "raw" else lut[bf.sy.view(np.uint8)]
        np.testing.assert_array_equal(got.numpy(), want.view(np.int8))
        jb = jax_bucketing.StreamBand(band=bb.sy.band, lo=bb.sy.lo,
                                      nds=bb.sy.nds)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_nibble.ship_stream(jship, jb)))
        # a full buffer passes through ship unchanged
        np.testing.assert_array_equal(
            nibble.ship_stream(ship, bf.sy).numpy(), got.numpy())


def test_stream_bytes():
    (b,) = bucketing.pack_sw_pairs([SWPair(sx=b"ACGT", sy=b"ACGTT")],
                                   stream_band=True)
    assert nibble.stream_bytes(b.sy) is b.sy.band
    assert nibble.stream_bytes(b.sy.band) is b.sy.band


@pytest.mark.parametrize("size", [2, 4])
def test_tile_slice_slices_a_band_by_rank(size):
    """Each rank's run holds its own tiles' streams (the parent handed
    every rank the whole band: rank r scored its tiles against rank 0's
    streams)."""
    rng = np.random.default_rng(size)
    pairs = [SWPair(sx=_dna(rng, int(rng.integers(5, 40))),
                    sy=_dna(rng, int(rng.integers(5, 60))))
             for _ in range(700)]
    (b,) = bucketing.pack_sw_pairs(pairs, stream_band=True)
    b = bucketing.pad_tiles_to(b, size)
    runs = [sharded.tile_slice(b, r, size) for r in range(size)]
    n = b.ndiag_tile.shape[0] // size
    for r, p in enumerate(runs):
        assert isinstance(p.sy, bucketing.StreamBand)
        assert (p.sy.lo, p.sy.nds) == (b.sy.lo, b.sy.nds)
        assert p.sy.band.shape[0] == p.sx.shape[0] == n
        np.testing.assert_array_equal(p.sy.band,
                                      b.sy.band[r * n: (r + 1) * n])
        np.testing.assert_array_equal(
            p.sy.materialize(), b.sy.materialize()[r * n: (r + 1) * n])
    assert not np.array_equal(runs[0].sy.band, runs[1].sy.band)
    np.testing.assert_array_equal(
        np.concatenate([p.sy.band for p in runs]), b.sy.band)


def test_tile_slice_refuses_an_unknown_field():
    (b,) = bucketing.pack_sw_pairs([SWPair(sx=b"ACGT", sy=b"ACGT")])
    with pytest.raises(TypeError, match="sy"):
        sharded.tile_slice(dataclasses.replace(b, sy=[b.sy]), 0, 1)


# -- the preps on band buckets ----------------------------------------------

def test_prep_bucket_rotor_on_band_buckets_equal():
    rng = np.random.default_rng(41)
    pairs = [SWPair(sx=_dna(rng, int(rng.integers(3, 90))),
                    sy=_dna(rng, int(rng.integers(3, 125))))
             for _ in range(400)]
    rotors = 0
    for bb, bf, jb in zip(bucketing.pack_sw_pairs(pairs, stream_band=True),
                          bucketing.pack_sw_pairs(pairs),
                          jax_bucketing.pack_sw_pairs(_jax(pairs),
                                                      stream_band=True)):
        maxlen = max(int(bf.nx.max()), int(bf.ny.max())) - 1
        T = -(-(maxlen + 1) // 8) * 8
        if T > 136:
            continue
        for slots in (2, 4):
            ours = sw_rotor.prep_bucket_rotor(bb, T, slots)
            full = sw_rotor.prep_bucket_rotor(bf, T, slots)
            theirs = jax_rotor.prep_bucket_rotor(jb, T, slots)
            for a, f, t in zip(ours[0], full[0], theirs[0]):
                np.testing.assert_array_equal(a, f)
                np.testing.assert_array_equal(a, t)
            assert ours[1] == full[1]
            rotors += 1
    assert rotors >= 2


def test_prep_bucket_stacked_on_band_buckets_equal():
    from _phmm_cases import stacked_sw_pairs

    (bb,) = bucketing.pack_sw_pairs(stacked_sw_pairs(6, 30, n_pairs=300),
                                    stream_band=True)
    (bf,) = bucketing.pack_sw_pairs(stacked_sw_pairs(6, 30, n_pairs=300))
    assert isinstance(bb.sy, bucketing.StreamBand)
    for stack in (2, 3, 4):
        ours, full = (sw_stacked.prep_bucket_stacked(b, stack)
                      for b in (bb, bf))
        assert ours[1] == full[1]
        for a, f in zip(ours[0], full[0]):
            np.testing.assert_array_equal(a, f)
    # the band bucket itself is untouched
    assert isinstance(bb.sy, bucketing.StreamBand)


@pytest.mark.parametrize("helper", ["bucket", "strips"])
def test_tensors_helpers_rebuild_the_band(helper):
    """sw_bucket_to_torch and sw_strips_to_torch of a band bucket == of the
    full bucket."""
    from genomax_torch.kernels import sw_strips

    rng = np.random.default_rng(8)
    pairs = [SWPair(sx=_dna(rng, int(rng.integers(140, 160))),
                    sy=_dna(rng, int(rng.integers(140, 200))))
             for _ in range(20)]
    (bb,), (bf,) = (bucketing.pack_sw_pairs(pairs, stream_band=s)
                    for s in (True, False))
    if helper == "bucket":
        fn, args = tensors.sw_bucket_to_torch, lambda b: (b,)
    else:
        fn, args = tensors.sw_strips_to_torch, lambda b: (
            sw_strips.prep_bucket_strips(b), b)
    got, want = fn(*args(bb), "cpu"), fn(*args(bf), "cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# -- the engine, the stream, the sweep and the mesh --------------------------

def _route_pairs():
    """Buckets that the default router sends to the rotor (140 pairs of
    20-60bp, y no longer than the bucket's 64 rows, which sw_stack=4
    stacks), the lane tile (x 100bp against y 300bp: a period past 136)
    and strips (x 142-160bp, 152 rows or more), with the '\\n' quirk on
    some."""
    rng = np.random.default_rng(61)
    pairs = [SWPair(sx=_dna(rng, 60), sy=_dna(rng, 60))]
    for i in range(139):
        a, b = (_dna(rng, int(rng.integers(20, 61))) for _ in range(2))
        a, b = min(a, b, key=len), max(a, b, key=len)
        pairs.append(SWPair(sx=a + b"\n", sy=b + b"\n") if i % 4 == 0 and
                     len(b) < 60 else SWPair(sx=a, sy=b))
    pairs += [SWPair(sx=_dna(rng, 100) + b"\n", sy=_dna(rng, 300) + b"\n")
              for _ in range(6)]
    pairs += [SWPair(sx=_dna(rng, int(rng.integers(142, 161))),
                     sy=_dna(rng, int(rng.integers(130, 170))))
              for _ in range(6)]
    return pairs


def _wide_pairs():
    """An 18-symbol alphabet, too wide for the nibble codes: the bucket
    travels raw."""
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ABCDEFGHIJKLMNOPQR", np.uint8)
    return [SWPair(sx=rng.choice(alpha, 70).tobytes(),
                   sy=rng.choice(alpha, 75).tobytes()) for _ in range(9)]


@pytest.fixture(scope="module")
def route_case():
    pairs = _route_pairs()
    want = oracle.sw_scores_pairs(_jax(pairs))
    np.testing.assert_array_equal(want, native.sw_scores_native(pairs))
    return pairs, want


def _spy(monkeypatch, routes):
    """Record each bucket's route (Engine._sw_prep) and whether its stream
    came as a band."""
    prep = Engine._sw_prep

    def spied_prep(self, b):
        route, launch = prep(self, b)
        routes.append((route, isinstance(b.sy, bucketing.StreamBand)))
        return route, launch

    monkeypatch.setattr(Engine, "_sw_prep", spied_prep)


@pytest.mark.parametrize("stack", [0, 4], ids=["", "sw_stack4"])
def test_engine_band_equals_the_oracle(monkeypatch, route_case, stack):
    pairs, want = route_case
    routes = []
    _spy(monkeypatch, routes)
    eng = Engine(EngineConfig(sw_stack=stack), device="cpu")
    np.testing.assert_array_equal(eng.sw_scores(pairs), want)
    short = "stacked" if stack else "rotor"
    assert sorted(r for r, _ in routes) == sorted([short, "tile", "strips"])
    # the band travels where the gate keeps it: past stack_max_nxs under
    # sw_stack >= 2, everywhere otherwise
    assert dict(routes) == {short: not stack, "tile": True, "strips": True}


def test_engine_band_wide_alphabet(monkeypatch):
    """An 18-symbol alphabet (past the nibble codes) through the band."""
    pairs = _wide_pairs() + _route_pairs()[:20]
    routes = []
    _spy(monkeypatch, routes)
    got = Engine(EngineConfig(), device="cpu").sw_scores(pairs)
    np.testing.assert_array_equal(got, oracle.sw_scores_pairs(_jax(pairs)))
    assert len(routes) == 2 and all(band for _, band in routes)


@pytest.mark.parametrize("stack", [0, 4], ids=["", "sw_stack4"])
def test_stream_packs_through_the_gate(monkeypatch, route_case, stack):
    pairs, want = route_case
    flags, pack = [], stream.pack_sw_pairs

    def spied(chunk, job_mask=None, stream_band=False):
        flags.append(stream_band)
        return pack(chunk, job_mask=job_mask, stream_band=stream_band)

    monkeypatch.setattr(stream, "pack_sw_pairs", spied)
    eng = Engine(EngineConfig(sw_stack=stack), device="cpu")
    np.testing.assert_array_equal(eng.sw_scores_stream(pairs, 64), want)
    assert len(flags) == 3
    if stack:
        assert all(callable(f) and not f(96) and f(97) for f in flags)
    else:
        assert flags == [True] * 3


def test_sweep_packs_through_the_gate(monkeypatch, route_case):
    pairs, want = route_case
    flags, pack = [], sweep.pack_sw_pairs

    def spied(p, job_mask=None, stream_band=False):
        flags.append(stream_band)
        return pack(p, job_mask=job_mask, stream_band=stream_band)

    monkeypatch.setattr(sweep, "pack_sw_pairs", spied)
    for stack in (0, 4):
        eng = Engine(EngineConfig(sw_stack=stack), device="cpu")
        runs = sweep.sw_launches(eng, pairs)
        buckets = bucketing.pack_sw_pairs(pairs)
        got = bucketing.unpack_scores(
            buckets, [launch().numpy() for _, launch in runs], len(pairs))
        np.testing.assert_array_equal(got, want)
    assert flags[0] is True
    assert callable(flags[1]) and not flags[1](96) and flags[1](97)


def test_stream_band_gate():
    def gate(**kw):
        return Engine(EngineConfig(**kw), device="cpu")._stream_band()

    assert gate() is True
    stacked = gate(sw_stack=2)
    assert not stacked(96) and stacked(104)


def test_one_rank_sharded_engine_with_the_band_equals_engine(route_case):
    pairs, want = route_case
    dist = ShardedEngine(make_mesh(device="cpu"), EngineConfig())
    np.testing.assert_array_equal(dist.sw_scores(pairs), want)


def test_two_rank_sharded_engine_band(tmp_path, route_case):
    """Two gloo ranks of ShardedEngine (tests/_torch_dist_worker.py) with
    the band, and with it under sw_stack=4: both ranks == one rank == the
    oracle."""
    pairs, want = route_case
    configs = [{}, dict(sw_stack=4)]
    r0, r1 = _run_ranks(tmp_path, 2, "sw", {"sw": _rows(pairs),
                                             "configs": configs})
    assert r0 == r1
    for i, kw in enumerate(configs):
        np.testing.assert_array_equal(np.asarray(r0[f"sw{i}"], np.int32),
                                      want, err_msg=str(kw))
        assert r0[f"sw{i}_stats"]["n_jobs"] == len(pairs)
