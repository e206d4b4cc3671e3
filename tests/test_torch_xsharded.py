"""The port's cross-device SW wavefront (genomax_torch.dist.xsharded, the
plain version of csrc/sw_xstrip.cu) against the JAX package's
(genomax.dist.xsharded, its Pallas block in interpret mode on a CPU mesh)
and the numpy oracle: the pack array for array, one strip block on seeded
states (all eight outputs exact), the K-strip ring at K = 2 and 8 on the
cases of tests/test_xsharded.py, and the slab bounds of every block."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomax.config import SWConfig as JaxSWConfig
from genomax.dist import xsharded as jxs
from genomax.dist.mesh import make_mesh as jax_make_mesh
from genomax.io.formats import SWPair as JaxSWPair
from genomax.kernels import oracle

from _phmm_cases import xshard_cases, xstrip_inputs
from _torch_cpu import one_torch_thread  # noqa: F401
from genomax_torch.config import SWConfig
from genomax_torch.dist import xsharded
from genomax_torch.dist.mesh import make_mesh
from genomax_torch.io.formats import SWPair
from genomax_torch.kernels.wavefront import sw_xstrip_block

CASES = {name: (pairs, unroll) for name, pairs, unroll in xshard_cases()}
CFGS = [dict(), dict(match=2, mismatch=-3, gap_open=-5, gap_extend=-2),
        dict(match=3, mismatch=-1, gap_open=0, gap_extend=-2)]


def _jax_pairs(pairs):
    return [JaxSWPair(sx=p.sx, sy=p.sy) for p in pairs]


def _pack(pairs, K, unroll):
    return xsharded.pack_sw_xsharded(pairs, K, unroll=unroll)


@pytest.mark.parametrize("unroll", [1, 2, 4, 16, 64])
@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_pack_equals_jax(K, unroll):
    pairs = CASES["ragged"][0] + CASES["tiny"][0] + CASES["tandem"][0]
    ours = _pack(pairs, K, unroll)
    theirs = jxs.pack_sw_xsharded(_jax_pairs(pairs), K, unroll=unroll)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_pack_rejects_bad_tiles():
    with pytest.raises(ValueError, match="tile"):
        _pack([], 2, 4)
    with pytest.raises(ValueError, match="tile"):
        _pack([SWPair(sx=b"A", sy=b"A")] * 129, 2, 4)
    with pytest.raises(ValueError, match="positive"):
        _pack([SWPair(sx=b"A", sy=b"A")], 2, 0)


@pytest.mark.parametrize("w,U,ci", [(24, 1, 0), (24, 8, 1), (24, 16, 2),
                                    (40, 1, 1), (40, 8, 2), (40, 16, 0)])
def test_strip_block_equals_pallas_block(w, U, ci):
    sxb, slab, hD, hQ, state = xstrip_inputs(100 + w + U, w, U)
    want_state, want_bD, want_bQ = jxs._strip_block_pallas(
        jnp.asarray(sxb.astype(np.int32)), jnp.asarray(slab.astype(np.int32)),
        jnp.asarray(hD), jnp.asarray(hQ), tuple(map(jnp.asarray, state)),
        w=w, U=U, cfg=JaxSWConfig(**CFGS[ci]), interpret=True)
    want = [np.asarray(a) for a in (*want_state, want_bD, want_bQ)]
    t = torch.from_numpy
    args = (t(sxb), t(slab), t(hD), t(hQ), tuple(map(t, state)))
    plain = sw_xstrip_block(*args, w=w, U=U, cfg=SWConfig(**CFGS[ci]))
    wrapped = xsharded.strip_block(*args, w=w, U=U, cfg=SWConfig(**CFGS[ci]))
    for got in (plain, wrapped):
        outs = [*got[0], got[1], got[2]]
        assert len(outs) == 8
        for i, (g, e) in enumerate(zip(outs, want)):
            assert g.dtype == torch.int32, i
            np.testing.assert_array_equal(g.numpy(), e, err_msg=str(i))


@pytest.mark.parametrize("U", [1, 3])
def test_strip_block_in_place_equals_new(U):
    """out=state updates the state in place; at U = 1 the new D2s is the
    old D1s itself, which the copy must not lose."""
    w = 16
    sxb, slab, hD, hQ, state = (torch.from_numpy(a) if not isinstance(a, tuple)
                                else tuple(map(torch.from_numpy, a))
                                for a in xstrip_inputs(7, w, U))
    want = sw_xstrip_block(sxb, slab, hD, hQ, state, w=w, U=U)
    st = tuple(s.t().contiguous().t() for s in state)
    got = xsharded.strip_block(sxb, slab, hD, hQ, st, w=w, U=U, out=st)
    assert all(a is b for a, b in zip(got[0], st))
    for g, e in zip((*st, got[1], got[2]), (*want[0], want[1], want[2])):
        assert torch.equal(g, e)


def test_strip_block_rejects_bad_inputs():
    sxb, slab, hD, hQ, state = (torch.from_numpy(a) if not isinstance(a, tuple)
                                else tuple(map(torch.from_numpy, a))
                                for a in xstrip_inputs(1, 16, 4))
    with pytest.raises(TypeError, match="dtypes"):
        xsharded.strip_block(sxb.int(), slab, hD, hQ, state, w=16, U=4)
    with pytest.raises(ValueError, match="shapes"):
        xsharded.strip_block(sxb, slab[1:], hD, hQ, state, w=16, U=4)
    with pytest.raises(ValueError, match="six"):
        xsharded.strip_block(sxb, slab, hD, hQ, state[:5], w=16, U=4)
    with pytest.raises(ValueError, match="U="):
        xsharded.strip_block(sxb, slab, hD, hQ, state, w=16, U=0)


def _jax_forward(pairs, K, unroll):
    mesh = jax_make_mesh(K, devices=jax.devices("cpu")[:K])
    b = jxs.pack_sw_xsharded(_jax_pairs(pairs), K, unroll=unroll)
    got = jxs.sw_forward_xsharded(
        jnp.asarray(b.sx), jnp.asarray(b.sy), mesh=mesh, strip_w=b.strip_w,
        n_diags=b.n_diags, unroll=b.unroll, anchor=b.anchor, interpret=True)
    return np.asarray(got)


def _ring(pairs, K, unroll):
    pk = _pack(pairs, K, unroll)
    got = xsharded.sw_forward_xsharded_ring(
        torch.from_numpy(pk.sx), torch.from_numpy(pk.sy), n_strips=K,
        strip_w=pk.strip_w, n_diags=pk.n_diags, unroll=unroll,
        anchor=pk.anchor)
    return got.numpy()


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("K", [2, 8])
def test_ring_equals_jax_mesh_and_oracle(K, name):
    if len(jax.devices("cpu")) < K:
        pytest.skip(f"needs {K} virtual CPU devices (see conftest XLA_FLAGS)")
    pairs, unroll = CASES[name]
    got = _ring(pairs, K, unroll)
    np.testing.assert_array_equal(got, _jax_forward(pairs, K, unroll))
    np.testing.assert_array_equal(got[: len(pairs)],
                                  oracle.sw_scores_pairs(_jax_pairs(pairs)))
    assert not got[len(pairs):].any()


def test_ring_hands_over_the_previous_blocks_halo():
    """A ring fed the left strip's halo of the same block, one block early,
    scores the tandem repeat wrong: the hand-off's timing is what the
    equality above holds."""
    pairs, unroll = CASES["tandem"]
    K = 4
    pk = _pack(pairs, K, unroll)
    w, U = pk.strip_w, unroll
    sx, sy = torch.from_numpy(pk.sx), torch.from_numpy(pk.sy)
    zero = torch.zeros((U, 128), dtype=torch.int32)
    states = [xsharded.new_state(w, "cpu") for _ in range(K)]
    for b in range(xsharded.n_blocks(pk.n_diags, U, K)):
        halo = (zero, zero)
        for k in range(K):
            s = xsharded.slab_start(pk.anchor, k, b, strip_w=w, unroll=U,
                                    ndt=sy.shape[0])
            states[k], bD, bQ = sw_xstrip_block(
                sx[k * w: (k + 1) * w], sy[s: s + w + U], *halo, states[k],
                w=w, U=U)
            halo = (bD, bQ)
    early = int(torch.stack([st[5].amax(0) for st in states]).amax(0)[0])
    want = int(oracle.sw_scores_pairs(_jax_pairs(pairs))[0])
    assert int(_ring(pairs, K, unroll)[0]) == want
    assert early != want


def test_forward_on_a_one_rank_mesh_equals_oracle():
    mesh = make_mesh(1, device="cpu")
    for name in ("identical_disjoint", "tandem", "unroll2"):
        pairs, unroll = CASES[name]
        got = xsharded.sw_scores_xsharded(pairs, mesh=mesh, unroll=unroll)
        np.testing.assert_array_equal(
            got, oracle.sw_scores_pairs(_jax_pairs(pairs)), err_msg=name)


@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_slab_bounds_hold_on_every_block(K):
    """Every (block, rank) slab of every case lies in the stream, with at
    least 2U+1 rows before it and U after it, so no start is ever clamped;
    a stream one row short, or an anchor off by a strip, raises."""
    for name, (pairs, U) in CASES.items():
        pk = _pack(pairs, K, U)
        w, ndt = pk.strip_w, pk.sy.shape[0]
        nb = xsharded.n_blocks(pk.n_diags, U, K)
        for b in range(nb):
            for k in range(K):
                s = xsharded.slab_start(pk.anchor, k, b, strip_w=w, unroll=U,
                                        ndt=ndt)
                assert 2 * U + 1 <= s <= ndt - w - U, (name, b, k)
        with pytest.raises(ValueError, match="outside"):
            xsharded.slab_start(pk.anchor, K - 1, 0, strip_w=w, unroll=U,
                                ndt=ndt - 1 - (ndt - pk.anchor
                                               - (K - 1) * (w + U) - w))
        with pytest.raises(ValueError, match="outside"):
            xsharded.slab_start(pk.anchor - pk.n_diags - (K + 2) * U, 0,
                                nb - 1, strip_w=w, unroll=U, ndt=ndt)


def test_forward_requires_the_anchor():
    pk = _pack(CASES["tiny"][0], 1, 8)
    with pytest.raises(ValueError, match="anchor"):
        xsharded.sw_forward_xsharded(
            torch.from_numpy(pk.sx), torch.from_numpy(pk.sy),
            mesh=make_mesh(device="cpu"), strip_w=pk.strip_w,
            n_diags=pk.n_diags, unroll=8)
