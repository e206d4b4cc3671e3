"""The port's PairHMM quality expansion (genomax_torch.kernels.expand)
against the JAX package's (pairhmm_pallas.expand_byte_quals and
expand_factored): bit-exact on every table, the factored gather included,
and the refusal of a phred offset below 1."""

import numpy as np
import pytest
import torch

from genomax.io.generator import generate_pairhmm_batch
from genomax.kernels import pairhmm_pallas
from genomax.pack.bucketing import pack_pairhmm_batches

from genomax_torch.kernels import expand
from genomax_torch.pack import phmm_bucket_to_torch
from _torch_cpu import one_torch_thread  # noqa: F401


def _weird(seed):
    """An 'X' byte: the bitmask translation declines, raw bytes ship."""
    b = generate_pairhmm_batch(3, 2, read_len=14, hap_len=18, seed=seed)
    b.reads[0].bases = b"AX" + b.reads[0].bases[2:]
    b.haplotypes[0] = b"XA" + b.haplotypes[0][2:]
    return b


def _batches():
    return [generate_pairhmm_batch(5, 3, read_len=21, hap_len=33, seed=3),
            _weird(4)]


@pytest.mark.parametrize("offset", [33.0, 64.0])
def test_expand_byte_quals_bit_exact(offset):
    batch = generate_pairhmm_batch(9, 2, read_len=41, hap_len=60, seed=3)
    if offset != 33.0:  # phred+64 bytes for the same qualities
        for rd in batch.reads:
            for f in ("base_q", "ins_q", "del_q", "gcp_q"):
                setattr(rd, f, bytes(c + 31 for c in getattr(rd, f)))
    (b, *_), _ = pack_pairhmm_batches([batch], offset, byte_quals=True)
    got = expand.expand_byte_quals(torch.from_numpy(b.qb), offset)
    want = pairhmm_pallas.expand_byte_quals(b.qb, offset)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pad = b.qb[:, 0] == 0
    for g in got:
        assert (g.numpy()[pad] == 0.0).all()


@pytest.mark.parametrize("which", [0, 1], ids=["acgtn", "weird"])
def test_expand_factored_bit_exact(which):
    batch = _batches()[which]
    (fb, *_), _ = pack_pairhmm_batches([batch], factored=True,
                                       bitmask_codes=True)
    assert fb.bitmask_codes == (which == 0)
    args = (fb.rchar_u, fb.qb_u, fb.hap_u, fb.ridx, fb.hidx)
    got = expand.expand_factored(*(torch.from_numpy(a) for a in args))
    want = pairhmm_pallas.expand_factored(*args)
    assert got[0].dtype == torch.int8 and got[-1].dtype == torch.int8
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("which", [0, 1], ids=["acgtn", "weird"])
def test_bucket_to_torch_same_tiles_for_every_pack_form(which):
    """The factored pack the engine ships expands to the ten kernel inputs
    that the byte-quals and fp32 packs of the same batch carry (the fp32
    pack's mmv/gapm sum in fp64 on the host: within 1 ulp). Other packs
    are refused."""
    batch = _batches()[which]
    fb, qb, fp = (pack_pairhmm_batches([batch], bitmask_codes=True, **kw)[0][0]
                  for kw in ({"factored": True}, {"byte_quals": True}, {}))
    got = phmm_bucket_to_torch(fb, torch.device("cpu"))
    assert len(got) == 10 and all(t.is_contiguous() for t in got)
    quals = expand.expand_byte_quals(torch.from_numpy(qb.qb))
    ref = (torch.from_numpy(qb.rchar), *quals, torch.from_numpy(qb.hap),
           torch.from_numpy(qb.meta), torch.from_numpy(qb.ndiag_tile))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    planes = (fp.qr, fp.mmv, fp.gapm, fp.qi, fp.qd, fp.qg)
    for k, a in enumerate(planes, start=1):
        if k in (2, 3):
            np.testing.assert_allclose(got[k].numpy(), a, rtol=2e-7)
        else:
            np.testing.assert_array_equal(got[k].numpy(), a)
    for b in (qb, fp):
        with pytest.raises(ValueError, match="factored"):
            phmm_bucket_to_torch(b, torch.device("cpu"))


def test_phred_offset_below_one_raises():
    qb = torch.zeros((1, 4, 8, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="phred_offset"):
        expand.expand_byte_quals(qb, 0.5)
