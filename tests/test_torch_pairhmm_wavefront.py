"""The port's plain PairHMM wavefront (genomax_torch.kernels.wavefront)
held against the JAX package on the same packed buckets: the lax twin
(genomax.kernels.wavefront.phmm_forward_dense) and the Pallas kernel in
interpret mode (pairhmm_pallas.pairhmm_forward_pallas), both within
atol 1e-5 in log10 (the same fp32 formulation; the largest difference
seen was 3.8e-6, two fp32 ulps of the log10 value), and the fp64 oracle within the JAX tests' tolerances
(2e-4; 5e-3 for the deep-decay pair the fp32 path carries without the
fallback)."""

import numpy as np
import pytest
import torch

from genomax.config import PairHMMConfig
from genomax.engine.executor import flatten_tiles
from genomax.io.formats import PairHMMBatch, PairHMMRead
from genomax.io.generator import generate_pairhmm_batch
from genomax.kernels import oracle
from genomax.kernels.pairhmm_pallas import pairhmm_forward_pallas
from genomax.kernels.wavefront import phmm_forward_dense as lax_phmm_dense
from genomax.pack.bucketing import pack_pairhmm_batches, unpack_scores

from genomax_torch.kernels import pairhmm as torch_pairhmm
from genomax_torch.kernels.wavefront import phmm_forward_dense
from _torch_cpu import one_torch_thread  # noqa: F401

ATOL_JAX = 1e-5


def _with(batch, reads=None, haps=None):
    """``batch`` with some read bases and haplotypes replaced."""
    for k, bases in (reads or {}).items():
        batch.reads[k].bases = bases
    for k, hap in (haps or {}).items():
        batch.haplotypes[k] = hap
    return batch


def _n_run_batch():
    """'N' runs in the haplotypes beside a second read-similar region: the
    PairHMM counterpart of the SW tandem-repeat wrap (test_wavefront.py)."""
    rng = np.random.default_rng(9)
    abc = np.frombuffer(b"ACGT", np.uint8)
    bases = rng.choice(abc, 120).tobytes()
    q = bytes([40] * 120)
    rd = PairHMMRead(bases=bases, base_q=q, ins_q=q, del_q=q, gcp_q=q)
    return PairHMMBatch(reads=[rd], haplotypes=[
        rng.choice(abc, 60).tobytes() + b"N" * 200 + bases + b"N" * 100,
        b"N" * 500, bases + b"N" * 130 + bases])


def _cases():
    """(id, batches, PairHMMConfig, rescale_period, bitmask codes asked of
    the pack, oracle atol). The engine packs bitmask codes; the byte
    cases keep the raw codes and their 'N' rule. Period 32 is the
    default; shorter periods keep the JAX compiles short."""
    gatk = PairHMMConfig(gatk_emission=True)
    n_mixed = [_with(generate_pairhmm_batch(2, 2, read_len=16, hap_len=20,
                                            seed=30),
                     reads={0: b"NN" + b"ACGTACGTACGTAC"},
                     haps={0: b"NA" + b"C" * 18})]
    return [
        ("random", [generate_pairhmm_batch(3, 2, read_len=25, hap_len=33,
                                           seed=3)], PairHMMConfig(), 8, True,
         2e-4),
        ("n_read", [_with(generate_pairhmm_batch(1, 1, read_len=12,
                                                 hap_len=16, seed=5),
                          reads={0: b"N" * 12})], PairHMMConfig(), 8, True,
         2e-4),
        ("n_mixed", n_mixed, PairHMMConfig(), 8, True, 2e-4),
        ("n_mixed_bytes", n_mixed, PairHMMConfig(), 8, False, 2e-4),
        ("multi_batch", [generate_pairhmm_batch(2, 2, read_len=11, hap_len=14,
                                                seed=11),
                         generate_pairhmm_batch(1, 3, read_len=17, hap_len=9,
                                                seed=12)],
         PairHMMConfig(), 4, True, 2e-4),
        ("deep_decay", [_with(generate_pairhmm_batch(1, 1, read_len=60,
                                                     hap_len=70, seed=21),
                              reads={0: b"A" * 60}, haps={0: b"C" * 70})],
         PairHMMConfig(), 32, True, 5e-3),
        ("n_run_wrap", [_n_run_batch()], PairHMMConfig(), 8, True, 2e-4),
        ("n_run_wrap_bytes", [_n_run_batch()], PairHMMConfig(), 8, False,
         2e-4),
        ("gatk_mm_div3", [generate_pairhmm_batch(2, 2, read_len=21,
                                                 hap_len=27, seed=15)],
         gatk, 16, True, 2e-4),
        ("raw_codes", [_with(generate_pairhmm_batch(2, 2, read_len=14,
                                                    hap_len=18, seed=22),
                             reads={0: b"AX" + b"CGTACGTACGTA"},
                             haps={0: b"XA" + b"GGTACCATGCATGCAT"})],
         PairHMMConfig(), 8, True, 2e-4),
        ("multi_tile", [generate_pairhmm_batch(30, 5, read_len=9, hap_len=12,
                                               seed=4, from_haps=True)],
         PairHMMConfig(), 4, True, 2e-4),
    ]


def _want(batches, cfg):
    return np.concatenate([oracle.pairhmm_batch_log10(b, cfg)
                           for b in batches])


def _plain(b, period, mm_div):
    args = [torch.from_numpy(a) for a in
            (b.rchar, b.qr, b.mmv, b.gapm, b.qi, b.qd, b.qg, b.hap, b.meta,
             b.ndiag_tile)]
    return torch_pairhmm.pairhmm_forward(
        *args, rescale_period=period, mm_div=mm_div,
        bitmask=b.bitmask_codes).numpy()


def _lax(b, period, mm_div):
    n_diags = -(-b.max_diags // period) * period
    got = lax_phmm_dense(
        *(flatten_tiles(a) for a in (b.rchar, b.qr, b.mmv, b.gapm, b.qi,
                                     b.qd, b.qg, b.hap)),
        np.asarray(b.rl), np.asarray(b.hl), n_diags=n_diags,
        rescale_period=period, mm_div=mm_div, bitmask=b.bitmask_codes)
    return np.asarray(got).reshape(b.rchar.shape[0], -1)


@pytest.mark.parametrize("name,batches,cfg,period,bitmask,atol", _cases(),
                         ids=[c[0] for c in _cases()])
def test_plain_vs_lax_vs_pallas_interpret(name, batches, cfg, period, bitmask,
                                          atol):
    buckets, n = pack_pairhmm_batches(batches, bitmask_codes=bitmask)
    assert all(b.bitmask_codes == (bitmask and name != "raw_codes")
               for b in buckets)
    results = []
    for b in buckets:
        got = _plain(b, period, cfg.mm_div)
        assert got.dtype == np.float32 and got.shape == (b.rchar.shape[0], 128)
        valid = b.rl > 0
        lax = _lax(b, period, cfg.mm_div)
        pallas = np.asarray(pairhmm_forward_pallas(
            b.rchar, b.qr, b.mmv, b.gapm, b.qi, b.qd, b.qg, b.hap, b.meta,
            b.ndiag_tile, rescale_period=period, interpret=True,
            mm_div=cfg.mm_div, bitmask=b.bitmask_codes))
        for ref in (lax, pallas):
            np.testing.assert_allclose(got.reshape(-1)[valid],
                                       ref.reshape(-1)[valid], rtol=0,
                                       atol=ATOL_JAX, err_msg=name)
        results.append(got)
    if name == "multi_tile":
        assert buckets[0].rchar.shape[0] >= 2
    np.testing.assert_allclose(unpack_scores(buckets, results, n, np.float32),
                               _want(batches, cfg), rtol=0, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("period", [1, 4, 32])
def test_deep_decay_any_rescale_period(period):
    """The all-mismatch pair decays far past the 2**40 trigger, so its
    answer rests on the rescale; any period the packs allow gives it."""
    batch = _with(generate_pairhmm_batch(1, 1, read_len=48, hap_len=56,
                                         seed=13),
                  reads={0: b"A" * 48}, haps={0: b"C" * 56})
    want = oracle.pairhmm_batch_log10(batch)
    assert want[0] < -30
    (b,), _ = pack_pairhmm_batches([batch], bitmask_codes=True)
    got = _plain(b, period, 1.0).reshape(-1)[: b.n_valid]
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_plain_rejects_sweep_past_stream_window():
    (b,), _ = pack_pairhmm_batches([generate_pairhmm_batch(1, 1, 5, 6)])
    t = [torch.from_numpy(a[0]) for a in (b.rchar, b.qr, b.mmv, b.gapm, b.qi,
                                          b.qd, b.qg, b.hap)]
    anchor = b.hap.shape[1] - b.rchar.shape[1]
    rl, hl = torch.from_numpy(b.meta[0, 0]), torch.from_numpy(b.meta[0, 1])
    with pytest.raises(ValueError, match="stream window"):
        phmm_forward_dense(*t, rl, hl, anchor + 2, rescale_period=1)
