"""The port's own host layer (configs, formats, generator, native golden
model, packs, stats) against the JAX package's, which it was copied from:
the same inputs give the same values, bit for bit. Inputs come from numpy
seeds; nothing here runs a kernel."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from genomax import layout as jax_layout
from genomax import native as jax_native
from genomax.config import EngineConfig as JaxEngineConfig
from genomax.config import PairHMMConfig as JaxPairHMMConfig
from genomax.config import SWConfig as JaxSWConfig
from genomax.engine import executor as jax_executor
from genomax.io import formats as jax_formats
from genomax.io import generator as jax_generator
from genomax.io.phred import phred_to_error_prob as jax_phred
from genomax.pack import bucketing as jax_bucketing

from genomax_torch import layout, native
from genomax_torch.config import EngineConfig, PairHMMConfig, SWConfig
from genomax_torch.engine import executor
from genomax_torch.io import formats, generator
from genomax_torch.io.phred import phred_to_error_prob
from genomax_torch.pack import bucketing

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SW_FILES = sorted(glob.glob(os.path.join(GOLDEN, "sw_*.in")))
PHMM_FILES = [os.path.join(GOLDEN, n) for n in ("test.in", "10s.in")]


def _same_fields(a, b):
    """Two dataclass instances of different classes with equal fields."""
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        assert da[k] == db[k], k


# -- layout and configs ----------------------------------------------------

@pytest.mark.parametrize("name", ["LANES", "SUB_Q", "MAX_UNROLL",
                                  "STREAM_CHUNK", "PAD_X", "PAD_STREAM"])
def test_layout_constants_equal(name):
    assert getattr(layout, name) == getattr(jax_layout, name)


# Fields of the port's configs that the JAX package's lack, each with its
# default: SWConfig.matrix, a substitution matrix (None scores by match and
# mismatch, as the JAX package does), last so that positional use holds.
_PORT_ONLY = {SWConfig: {"matrix": None}, PairHMMConfig: {}}


@pytest.mark.parametrize("cls,jax_cls", [(SWConfig, JaxSWConfig),
                                         (PairHMMConfig, JaxPairHMMConfig)],
                         ids=["sw", "pairhmm"])
def test_config_defaults_equal(cls, jax_cls):
    """The JAX fields, in the JAX order and with the JAX defaults, then the
    port's own fields with theirs."""
    ours, extra = dataclasses.asdict(cls()), _PORT_ONLY[cls]
    theirs = dataclasses.asdict(jax_cls())
    assert {k: ours.pop(k) for k in extra} == extra
    assert ours == theirs
    assert ([f.name for f in dataclasses.fields(cls)]
            == [f.name for f in dataclasses.fields(jax_cls)] + list(extra))


def test_engine_config_stack_knobs_equal():
    """sw_stack and stack_max_nxs carry the JAX names and defaults, and the
    SW routing knobs come in the JAX order: strips, stack, rotor."""
    ours, theirs = EngineConfig(), JaxEngineConfig()
    for name in ("sw_stack", "stack_max_nxs"):
        assert getattr(ours, name) == getattr(theirs, name), name
    routing = ["sw_strips", "strips_min_nxs", "sw_stack", "stack_max_nxs",
               "sw_rotor", "rotor_max_period", "rotor_max_slots"]
    for cls in (EngineConfig, JaxEngineConfig):
        names = [f.name for f in dataclasses.fields(cls)]
        i = names.index("sw_strips")
        assert names[i: i + len(routing)] == routing, cls


# Fields of genomax.config.EngineConfig that the port leaves out, each with
# its reason.
_NOT_PORTED = {
    # the TPU's own surface
    "backend": "the port has one backend per device, chosen by the "
               "torch.device the engine takes",
    "stream_vmem_rows": "a TPU VMEM budget; the CUDA lane tile takes any "
                        "stream length",
    # the transfer flags the port dropped: every SW stream ships as its
    # band, every PairHMM bucket factored
    "stream_band_transfer": "always on in the port",
    "nibble_transfer": "the SW nibble rung runs on no path, and PairHMM "
                       "ships factored, where no tile travels four-bit",
    "factored_transfer": "always on in the port: the same scores, and the "
                         "unfactored route was 2.1-5.7x slower on the H100 "
                         "(PERF.md, unfactored_cost.py)",
}
# Fields whose port default was measured on the H100 (genomax_torch/config.py
# says where), not taken from the JAX package's TPU measurement.
_MEASURED_ON_H100 = {
    "strips_min_nxs": "strips start past the rotor's 136 rows",
    "rotor_max_slots": "four slots, the fastest on 25,000 x 64bp",
}


def test_engine_config_covers_every_jax_knob():
    """Every field of the JAX EngineConfig is a field of the port's with the
    same default, or stands on one of the two lists above with its reason:
    a knob the JAX package grows reaches the port or this list."""
    ours = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxEngineConfig)}
    assert set(_NOT_PORTED) <= set(theirs) and not set(_NOT_PORTED) & set(ours)
    assert set(_MEASURED_ON_H100) <= set(theirs) & set(ours)
    for name, default in theirs.items():
        if name in _NOT_PORTED:
            continue
        assert name in ours, f"EngineConfig.{name} is not ported"
        if name in _MEASURED_ON_H100:
            assert ours[name] != default, f"{name}: the JAX default again"
        else:
            assert ours[name] == default, name


@pytest.mark.parametrize("kw", [
    dict(match=0), dict(mismatch=0), dict(gap_open=1), dict(gap_extend=0),
    dict(match=2, mismatch=-3, gap_open=0, gap_extend=-2)],
    ids=["match0", "mismatch0", "open1", "extend0", "valid"])
def test_sw_config_validate_equal(kw):
    ours, theirs = SWConfig(**kw), JaxSWConfig(**kw)
    try:
        theirs.validate()
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            ours.validate()
        assert str(err.value) == str(e)
    else:
        assert ours.validate() is ours


@pytest.mark.parametrize("gatk", [False, True])
def test_pairhmm_config_mm_div_equal(gatk):
    assert (PairHMMConfig(gatk_emission=gatk).mm_div
            == JaxPairHMMConfig(gatk_emission=gatk).mm_div)


# -- formats, phred, generator ---------------------------------------------

@pytest.mark.parametrize("path", SW_FILES, ids=os.path.basename)
def test_parse_sw_file_equal(path):
    ours, theirs = formats.parse_sw_file(path), jax_formats.parse_sw_file(path)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        _same_fields(a, b)


@pytest.mark.parametrize("path", PHMM_FILES, ids=os.path.basename)
def test_parse_pairhmm_file_equal(path):
    ours = formats.parse_pairhmm_file(path)
    theirs = jax_formats.parse_pairhmm_file(path)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        _same_fields(a, b)


@pytest.mark.parametrize("text", [b"", b"x\nACGT\n", b"-2\nAC\nGT\n"],
                         ids=["empty", "no-count", "negative"])
def test_parse_sw_file_rejections_equal(tmp_path, text):
    path = tmp_path / "bad.in"
    path.write_bytes(text)
    with pytest.raises(ValueError) as theirs:
        jax_formats.parse_sw_file(str(path))
    with pytest.raises(ValueError) as ours:
        formats.parse_sw_file(str(path))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("text", [b"x y\n", b"1 1\nACGT IIII IIII\nACGT\n",
                                  b"2 1\nAC II II II II\n"],
                         ids=["header", "fields", "short"])
def test_parse_pairhmm_file_rejections_equal(tmp_path, text):
    path = tmp_path / "bad.in"
    path.write_bytes(text)
    with pytest.raises(ValueError) as theirs:
        jax_formats.parse_pairhmm_file(str(path))
    with pytest.raises(ValueError) as ours:
        formats.parse_pairhmm_file(str(path))
    assert str(ours.value) == str(theirs.value)


def test_write_sw_input_round_trip_equal(tmp_path):
    seqs = generator.generate_sw_sequences(5, 3, 40, seed=4)
    assert seqs == jax_generator.generate_sw_sequences(5, 3, 40, seed=4)
    a, b = tmp_path / "a.in", tmp_path / "b.in"
    formats.write_sw_input(str(a), seqs)
    jax_formats.write_sw_input(str(b), seqs)
    assert a.read_bytes() == b.read_bytes()
    # the trailing '\n' is part of every parsed sequence
    assert all(p.sx.endswith(b"\n") and p.sy.endswith(b"\n")
               for p in formats.parse_sw_file(str(a)))


def test_format_pairhmm_values_equal(tmp_path):
    v = np.random.default_rng(0).normal(-20, 30, 50)
    assert (formats.format_pairhmm_values(v)
            == jax_formats.format_pairhmm_values(v))
    formats.write_pairhmm_output(str(tmp_path / "o"), v)
    assert (tmp_path / "o").read_text() == jax_formats.format_pairhmm_values(v)


@pytest.mark.parametrize("offset", [33.0, 64.0])
def test_phred_table_equal(offset):
    q = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(phred_to_error_prob(q, offset),
                                  jax_phred(q, offset))


@pytest.mark.parametrize("seed", [0, 9])
def test_random_dna_equal(seed):
    a = generator.random_dna(np.random.default_rng(seed), 333)
    b = jax_generator.random_dna(np.random.default_rng(seed), 333)
    assert a == b and len(a) == 333


@pytest.mark.parametrize("from_haps", [False, True])
def test_generate_pairhmm_batch_equal(from_haps):
    kw = dict(num_reads=7, num_haps=3, read_len=40, hap_len=61, seed=5,
              from_haps=from_haps)
    ours = generator.generate_pairhmm_batch(**kw)
    theirs = jax_generator.generate_pairhmm_batch(**kw)
    assert ours.haplotypes == theirs.haplotypes
    assert len(ours.reads) == len(theirs.reads) == 7
    for a, b in zip(ours.reads, theirs.reads):
        _same_fields(a, b)


# -- packs -------------------------------------------------------------------

def _ragged_sw_pairs(seed, cls):
    """Lengths 0-700 over several bucket levels, the empty pair, the lone
    '\\n', N runs."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGTN", np.uint8)
    pairs = [cls(sx=b"", sy=b""), cls(sx=b"\n", sy=b"ACGT\n"),
             cls(sx=b"NNNN\n", sy=b"ANNNNNNT\n")]
    for lo, hi, n in ((1, 60, 140), (60, 200, 30), (300, 700, 9)):
        for _ in range(n):
            a = rng.choice(abc, int(rng.integers(lo, hi))).tobytes() + b"\n"
            b = rng.choice(abc, int(rng.integers(lo, hi))).tobytes() + b"\n"
            pairs.append(cls(sx=min(a, b, key=len), sy=max(a, b, key=len)))
    return pairs


def _assert_packs_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)]
        for name in fa:
            va, vb = getattr(a, name), getattr(b, name)
            if isinstance(vb, np.ndarray):
                assert va.dtype == vb.dtype and va.shape == vb.shape, name
                np.testing.assert_array_equal(va, vb, err_msg=name)
            else:
                assert va == vb, name


@pytest.mark.parametrize("masked", [False, True], ids=["all", "job_mask"])
def test_pack_sw_pairs_equal(masked):
    ours_in = _ragged_sw_pairs(3, formats.SWPair)
    theirs_in = _ragged_sw_pairs(3, jax_formats.SWPair)
    mask = None
    if masked:
        mask = np.random.default_rng(1).random(len(ours_in)) < 0.7
    ours = bucketing.pack_sw_pairs(ours_in, job_mask=mask)
    theirs = jax_bucketing.pack_sw_pairs(theirs_in, job_mask=mask)
    assert len(ours) >= 3  # several bucket levels
    _assert_packs_equal(ours, theirs)


def _ragged_batches(seed, mod):
    """Three ragged batches with N runs; the same bytes whichever module's
    dataclasses carry them."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGTN", np.uint8)

    def qual(n):
        return (rng.integers(2, 60, n) + 33).astype(np.uint8).tobytes()

    out = []
    for n_reads, n_haps in ((5, 3), (1, 1), (9, 2)):
        reads = []
        for _ in range(n_reads):
            n = int(rng.integers(1, 120))
            reads.append(mod.PairHMMRead(
                bases=rng.choice(abc, n).tobytes(), base_q=qual(n),
                ins_q=qual(n), del_q=qual(n), gcp_q=qual(n)))
        haps = [rng.choice(abc, int(rng.integers(1, 200))).tobytes()
                for _ in range(n_haps)]
        out.append(mod.PairHMMBatch(reads=reads, haplotypes=haps))
    return out


@pytest.mark.parametrize("kw", [
    dict(byte_quals=True, factored=True, bitmask_codes=True),
    dict(byte_quals=True, bitmask_codes=True),
    dict(byte_quals=True),
    dict()], ids=["factored-bitmask", "bytes-bitmask", "bytes", "floats"])
def test_pack_pairhmm_batches_equal(kw):
    ours, n = bucketing.pack_pairhmm_batches(_ragged_batches(8, formats), **kw)
    theirs, m = jax_bucketing.pack_pairhmm_batches(
        _ragged_batches(8, jax_formats), **kw)
    assert n == m == 5 * 3 + 1 + 9 * 2
    _assert_packs_equal(ours, theirs)


def test_pack_pairhmm_batches_job_mask_and_raw_codes_equal():
    """A job mask, and an alphabet outside ACGTN that keeps raw codes."""
    def batches(mod):
        b = _ragged_batches(2, mod)
        b[0].haplotypes[0] = b"ACGTXACGT"
        return b

    mask = np.random.default_rng(3).random(34) < 0.6
    kw = dict(job_mask=mask, byte_quals=True, factored=True,
              bitmask_codes=True)
    ours, _ = bucketing.pack_pairhmm_batches(batches(formats), **kw)
    theirs, _ = jax_bucketing.pack_pairhmm_batches(batches(jax_formats), **kw)
    assert not all(b.bitmask_codes for b in ours)
    _assert_packs_equal(ours, theirs)


_PHMM_FORMS = {
    "factored-bitmask": dict(byte_quals=True, factored=True,
                             bitmask_codes=True),
    "factored": dict(factored=True),
    "bytes-bitmask": dict(byte_quals=True, bitmask_codes=True),
    "bytes": dict(byte_quals=True),
    "floats": dict()}


def _phmm_case(case, mod):
    """(batches, job_mask) of one pack case, the same bytes whichever
    module's dataclasses carry them."""
    batches = _ragged_batches(4, mod)
    rlen = np.concatenate([np.repeat([len(rd.bases) for rd in b.reads],
                                     len(b.haplotypes)) for b in batches])
    if case == "mask-empties-one-thins-another":
        # no job of the 64-row level; about half of each other level
        keep = np.random.default_rng(5).random(len(rlen)) < 0.5
        return batches, keep & (rlen + 2 > 64)
    if case == "empty-batches":
        read = batches[0].reads[0]
        batches.insert(1, mod.PairHMMBatch(reads=[], haplotypes=[b"ACGT"]))
        batches.insert(3, mod.PairHMMBatch(reads=[read], haplotypes=[]))
        batches.append(mod.PairHMMBatch(reads=[], haplotypes=[]))
    elif case == "zero-length-read":
        batches[1].reads.insert(0, mod.PairHMMRead(b"", b"", b"", b"", b""))
    elif case == "raw-codes-beside-bitmask":
        # an X in one read past the 64-row level; the haplotypes, which
        # every level shares, stay ACGTN
        rd = next(rd for b in batches for rd in b.reads
                  if len(rd.bases) + 2 > 64)
        rd.bases = b"X" + rd.bases[1:]
    elif case == "10s":
        batches = mod.parse_pairhmm_file(os.path.join(
            os.path.dirname(GOLDEN), os.pardir, "gxbench", "data", "10s.in"))
    return batches, None


@pytest.mark.parametrize("form", list(_PHMM_FORMS))
@pytest.mark.parametrize("case", [
    "mask-empties-one-thins-another", "empty-batches", "zero-length-read",
    "raw-codes-beside-bitmask", "10s"])
def test_pack_pairhmm_batches_cases_equal(case, form):
    """Every array of every bucket, perm, the gather indices and the code
    flag, against the JAX package's pack, on the edges of the array-wise
    flatten, bucketing and unique-row fill."""
    kw = _PHMM_FORMS[form]
    ours_in, mask = _phmm_case(case, formats)
    theirs_in, _ = _phmm_case(case, jax_formats)
    ours, n = bucketing.pack_pairhmm_batches(ours_in, job_mask=mask, **kw)
    theirs, m = jax_bucketing.pack_pairhmm_batches(theirs_in, job_mask=mask,
                                                   **kw)
    assert n == m
    _assert_packs_equal(ours, theirs)
    if case == "mask-empties-one-thins-another":
        full, _ = bucketing.pack_pairhmm_batches(ours_in, **kw)
        assert len(ours) == len(full) - 1 and full[0].nxs <= 64
        assert 0 < sum(b.n_valid for b in ours) < sum(b.n_valid
                                                      for b in full[1:])
    if case == "raw-codes-beside-bitmask" and "bitmask_codes" in kw:
        assert {b.bitmask_codes for b in ours} == {True, False}
    if case == "10s":
        assert n == 3550 and len(ours) >= 3


def _batches_with_bad_reads(kind, mod):
    """Good ragged batches with two bad reads of one kind in the middle,
    the first of them in batch 1; the kinds' messages tell the two
    apart."""
    batches = _ragged_batches(6, mod)

    def bad(b, i, **kw):
        batches[b].reads[i] = dataclasses.replace(batches[b].reads[i], **kw)

    def reads(b, i):
        return batches[b].reads[i]

    if kind == "short-qual":
        # one byte short, then one too many: the joined field's length is
        # right, only the reads' own lengths are not
        bad(1, 0, ins_q=reads(1, 0).ins_q[:-1])
        bad(2, 4, ins_q=reads(2, 4).ins_q + b"I")
    elif kind == "low-qual":
        bad(1, 0, del_q=b" " + reads(1, 0).del_q[1:])
        bad(2, 4, base_q=b"\xc8" + reads(2, 4).base_q[1:])
    elif kind == "pad-code-haplotype":
        batches[1].haplotypes[0] = b"AC\x01GT"
        batches[2].haplotypes[1] = b"AC\x00GT"
    elif kind == "low-qual-after-pad-code-read":
        # the quality checks come first, whatever batch holds the pad code
        bad(0, 2, bases=b"\x01" + reads(0, 2).bases[1:])
        bad(2, 4, base_q=b"!" + reads(2, 4).base_q[1:])
    return batches


@pytest.mark.parametrize("form", ["factored-bitmask", "floats"])
@pytest.mark.parametrize("kind", ["short-qual", "low-qual",
                                  "pad-code-haplotype",
                                  "low-qual-after-pad-code-read"])
def test_bad_read_in_the_middle_rejection_equal(kind, form):
    kw = _PHMM_FORMS[form]
    with pytest.raises(ValueError) as theirs:
        jax_bucketing.pack_pairhmm_batches(
            _batches_with_bad_reads(kind, jax_formats), **kw)
    with pytest.raises(ValueError) as ours:
        bucketing.pack_pairhmm_batches(
            _batches_with_bad_reads(kind, formats), **kw)
    assert str(ours.value) == str(theirs.value)


def test_unpack_scores_equal():
    pairs = _ragged_sw_pairs(6, formats.SWPair)
    buckets = bucketing.pack_sw_pairs(pairs)
    rng = np.random.default_rng(0)
    results = [rng.integers(0, 99, (b.sx.shape[0], 128)).astype(np.int32)
               for b in buckets]
    ours = bucketing.unpack_scores(buckets, results, len(pairs))
    theirs = jax_bucketing.unpack_scores(buckets, results, len(pairs))
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype


def _packs_to_pad(kind):
    """(the port's buckets, the JAX package's) of one kind: SW, or PairHMM
    factored (gather indices past the unique rows), with raw quality bytes
    or with fp32 planes."""
    if kind == "sw":
        return (bucketing.pack_sw_pairs(_ragged_sw_pairs(4, formats.SWPair)),
                jax_bucketing.pack_sw_pairs(_ragged_sw_pairs(
                    4, jax_formats.SWPair)))
    kw = {"pairhmm-factored": dict(byte_quals=True, factored=True,
                                   bitmask_codes=True),
          "pairhmm-bytes": dict(byte_quals=True, bitmask_codes=True)}.get(
              kind, {})
    return (bucketing.pack_pairhmm_batches(_ragged_batches(8, formats),
                                           **kw)[0],
            jax_bucketing.pack_pairhmm_batches(
                _ragged_batches(8, jax_formats), **kw)[0])


@pytest.mark.parametrize("multiple", [1, 3, 8])
@pytest.mark.parametrize("kind", ["sw", "pairhmm-factored", "pairhmm-bytes",
                                  "pairhmm-floats"])
def test_pad_tiles_to_equal(kind, multiple):
    ours, theirs = _packs_to_pad(kind)
    padded = [bucketing.pad_tiles_to(b, multiple) for b in ours]
    _assert_packs_equal(padded,
                        [jax_bucketing.pad_tiles_to(b, multiple)
                         for b in theirs])
    for b, p in zip(ours, padded):
        assert p.ndiag_tile.shape[0] % multiple == 0
        assert p.n_valid == b.n_valid and p.perm is b.perm
    assert multiple == 1 or any(p is not b for b, p in zip(ours, padded))


@pytest.mark.parametrize("x", [0, 1, 63, 64, 65, 136, 137, 515, 768, 769,
                               5000])
def test_bucket_ladder_equal(x):
    assert bucketing._level(x) == jax_bucketing._level(x)
    assert bucketing._quantize_tiles(x * 37) == jax_bucketing._quantize_tiles(
        x * 37)
    assert bucketing._round_up(x, 8) == jax_bucketing._round_up(x, 8)


@pytest.mark.parametrize("bad", [b"AC\x00GT", b"AC\x01GT"], ids=["0", "1"])
def test_pad_code_rejection_equal(bad):
    with pytest.raises(ValueError) as theirs:
        jax_bucketing.pack_sw_pairs([jax_formats.SWPair(sx=b"ACGT", sy=bad)])
    with pytest.raises(ValueError) as ours:
        bucketing.pack_sw_pairs([formats.SWPair(sx=b"ACGT", sy=bad)])
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("read_kw", [
    dict(bases=b"ACGT", base_q=b"III", ins_q=b"IIII", del_q=b"IIII",
         gcp_q=b"IIII"),
    dict(bases=b"ACGT", base_q=b"II I", ins_q=b"IIII", del_q=b"IIII",
         gcp_q=b"IIII"),
    dict(bases=b"AC\x01T", base_q=b"IIII", ins_q=b"IIII", del_q=b"IIII",
         gcp_q=b"IIII")], ids=["short-qual", "low-qual", "pad-code"])
def test_bad_read_rejection_equal(read_kw):
    def batch(mod):
        return [mod.PairHMMBatch(reads=[mod.PairHMMRead(**read_kw)],
                                 haplotypes=[b"ACGTACGT"])]

    with pytest.raises(ValueError) as theirs:
        jax_bucketing.pack_pairhmm_batches(batch(jax_formats))
    with pytest.raises(ValueError) as ours:
        bucketing.pack_pairhmm_batches(batch(formats))
    assert str(ours.value) == str(theirs.value)
    if b"\x01" not in read_kw["bases"]:  # the native model checks quals
        with pytest.raises(ValueError):
            native.pairhmm_native(batch(formats))


# -- native golden model -----------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(), dict(match=2, mismatch=-3, gap_open=-5, gap_extend=-2),
    dict(match=3, mismatch=-1, gap_open=0, gap_extend=-2)],
    ids=["default", "m2x3o5e2", "m3x1o0e2"])
def test_native_sw_scores_equal(cfg):
    ours = native.sw_scores_native(_ragged_sw_pairs(4, formats.SWPair),
                                   SWConfig(**cfg))
    theirs = jax_native.sw_scores_native(
        _ragged_sw_pairs(4, jax_formats.SWPair), JaxSWConfig(**cfg))
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype and ours.max() > 0


@pytest.mark.parametrize("gatk", [False, True])
def test_native_pairhmm_equal(gatk):
    ours = native.pairhmm_native(_ragged_batches(8, formats),
                                 gatk_emission=gatk)
    theirs = jax_native.pairhmm_native(_ragged_batches(8, jax_formats),
                                       gatk_emission=gatk)
    np.testing.assert_array_equal(ours, theirs)
    assert np.isfinite(ours).all()


def test_native_pairhmm_matches_golden():
    v = native.pairhmm_native(formats.parse_pairhmm_file(PHMM_FILES[1]))
    want = np.loadtxt(os.path.join(GOLDEN, "10s.golden.out"))
    assert np.abs(v - want).max() < 1e-6  # the golden is %f-rounded


def _factored_rows_plain(reads, haps, u_r, u_h, nxs, nds, anchor, code):
    """rchar_u, qb_u, hap_u of a factored pack, built row by row in numpy."""
    rchar = np.full((len(u_r) + 1, nxs), code[layout.PAD_X], np.int8)
    qb = np.zeros((len(u_r) + 1, 4, nxs), np.int8)
    hap = np.full((len(u_h) + 1, nds), code[layout.PAD_STREAM], np.int8)
    for k, r in enumerate(u_r):
        bases, *quals = reads[r]
        rchar[k, 1: len(bases) + 1] = code[np.frombuffer(bases, np.uint8)]
        for p, q in enumerate(quals):
            qb[k, p, 1: len(q) + 1] = np.frombuffer(q, np.int8)
    for k, h in enumerate(u_h):
        row = code[np.frombuffer(haps[h], np.uint8)[::-1]]
        hap[k, anchor - len(row): anchor] = row
    return rchar, qb, hap


@pytest.mark.parametrize("codes", ["raw", "bitmask"])
@pytest.mark.parametrize("anchor", ["smallest", "largest"])
def test_native_factored_fill_matches_plain(anchor, codes):
    """gx_pack_phmm_fill_factored against a numpy build of the unique rows:
    ragged reads (the empty one among them), haplotypes of many lengths,
    rows taken out of order and some left out, the stream anchor at the
    longest haplotype and at the last row."""
    rng = np.random.default_rng(11)
    abc = np.frombuffer(b"ACGTN", np.uint8)
    reads = [tuple(rng.choice(abc, n).tobytes() if f == 0 else
                   (rng.integers(2, 60, n) + 33).astype(np.uint8).tobytes()
                   for f in range(5))
             for n in [0, 1, 7, 64, 150, 151, 33, 90]]
    haps = [rng.choice(abc, int(n)).tobytes() for n in (1, 299, 300, 17, 64)]
    (rd_data, rd_off), *quals = (
        native._concat_with_offsets([r[f] for r in reads]) for f in range(5))
    hp_data, hp_off = native._concat_with_offsets(haps)
    u_r = np.array([6, 0, 2, 4, 5, 1], np.int64)
    u_h = np.array([2, 0, 4, 3], np.int64)
    nxs = bucketing.bucket_rows(151)
    nds = 300 + (0 if anchor == "smallest" else 37)
    at = 300 if anchor == "smallest" else nds
    code = {"raw": bucketing._RAW_CODES, "bitmask": bucketing._BM_LUT}[codes]
    rchar, qb, hap = _factored_rows_plain(reads, haps, u_r, u_h, nxs, nds, at,
                                          code)
    got = (np.full(rchar.shape, code[layout.PAD_X], np.int8),
           np.zeros(qb.shape, np.int8),
           np.full(hap.shape, code[layout.PAD_STREAM], np.int8))
    native.load().gx_pack_phmm_fill_factored(
        rd_data, rd_off, *(q for q, _ in quals), hp_data, hp_off, u_r,
        len(u_r), u_h, len(u_h), nxs, nds, at, code, *got)
    for name, want, have in zip(("rchar_u", "qb_u", "hap_u"),
                                (rchar, qb, hap), got):
        np.testing.assert_array_equal(have, want, err_msg=name)
    # the longest haplotype reaches row 0 at the smallest anchor alone
    assert (hap[:, 0] == code[layout.PAD_STREAM]).all() != (at == 300)


@pytest.mark.parametrize("bad", [None, 0, 3])
def test_native_rows_ok(bad):
    """gx_rows_ok flags the rows whose every byte has a match-bitmask code:
    all but a row with an X (the empty row too)."""
    rows = [b"ACGT", b"", b"NNACG", b"TTTT", b"GA"]
    if bad is not None:
        rows[bad] = rows[bad][:1] + b"X" + rows[bad][2:]
    data, off = native._concat_with_offsets(rows)
    got = bucketing._rows_with_codes(native.load(), data, off)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, [k != bad for k in range(5)])


@pytest.mark.parametrize("items", [
    [], [b""], [b"", b""], [b"ACGT", b"", b"A\n", b"NN"],
    [np.frombuffer(b"ACG", np.uint8), b"TT"]],
    ids=["none", "one-empty", "all-empty", "ragged", "array-item"])
def test_concat_with_offsets_equal(items):
    ours = native._concat_with_offsets(items)
    theirs = jax_native._concat_with_offsets(items)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bucket_levels_equal():
    """Each length's level is the JAX package's _level of it plus 2, in
    the lengths' order, repeats and the empty list included."""
    lengths = np.concatenate([np.arange(0, 5000), [100000, 3, 3, 8191]])
    np.random.default_rng(2).shuffle(lengths)
    got = bucketing.bucket_levels(lengths)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, [jax_bucketing._level(int(n) + 2) for n in lengths])
    assert bucketing.bucket_levels(np.zeros(0, np.int64)).shape == (0,)


def test_native_builds_into_the_ports_build_dir():
    path = native.build()
    pkg = os.path.dirname(os.path.abspath(native.__file__))
    assert os.path.dirname(path) == os.path.join(os.path.dirname(pkg),
                                                 "_build")
    assert os.path.exists(path)
    assert not glob.glob(os.path.join(pkg, "*.so"))  # never beside the source
    assert native.load() is native.load()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "SRC", str(tmp_path / "broken.cpp"))
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(native.NativeBuildError, match="broken.cpp"):
        native.build()
    assert not glob.glob(str(tmp_path / "*.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeBuildError, match="cannot run"):
        native.build()


# -- engine stats --------------------------------------------------------------

def test_run_stats_equal():
    kw = dict(n_jobs=7, dp_cells=1234, padded_cells=5000, pack_s=0.25,
              exec_s=0.5, buckets=2, fallback_jobs=1, offloaded_jobs=3)
    ours, theirs = executor.RunStats(**kw), jax_executor.RunStats(**kw)
    assert ours.as_dict() == theirs.as_dict()
    assert list(ours.as_dict()) == list(theirs.as_dict())
    _same_fields(executor.RunStats(), jax_executor.RunStats())


def test_bucket_stats_equal():
    sw = bucketing.pack_sw_pairs(_ragged_sw_pairs(3, formats.SWPair))
    ph, _ = bucketing.pack_pairhmm_batches(_ragged_batches(8, formats),
                                           byte_quals=True, factored=True)
    ours, theirs = executor.RunStats(), jax_executor.RunStats()
    executor.sw_bucket_stats(ours, sw)
    executor.phmm_bucket_stats(ours, ph)
    jax_executor.sw_bucket_stats(theirs, sw)
    jax_executor.phmm_bucket_stats(theirs, ph)
    assert (ours.dp_cells, ours.padded_cells) == (theirs.dp_cells,
                                                  theirs.padded_cells)
    assert ours.dp_cells > 0


def test_engine_error_names_stage_and_bucket():
    ours = executor.EngineError("sw", 3, (2, 8, 128), RuntimeError("boom"))
    theirs = jax_executor.EngineError("sw", 3, (2, 8, 128),
                                      RuntimeError("boom"))
    assert str(ours) == str(theirs)
    assert (ours.stage, ours.bucket) == ("sw", 3)
    assert isinstance(ours.cause, RuntimeError)
