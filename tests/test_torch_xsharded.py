"""The port's cross-device SW wavefront (genomax_torch.dist.xsharded, the
plain version of csrc/sw_xstrip.cu) against the JAX package's
(genomax.dist.xsharded, its Pallas block in interpret mode on a CPU mesh)
and the numpy oracle: the pack array for array, one strip block on seeded
states (all eight outputs exact), the K-strip ring at K = 2 and 8 on the
cases of tests/test_xsharded.py, and the slab bounds of every block."""

import dataclasses
import functools

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


def _jax_forward(pairs, K, unroll, cfg=None):
    mesh = jax_make_mesh(K, devices=jax.devices("cpu")[:K])
    b = jxs.pack_sw_xsharded(_jax_pairs(pairs), K, unroll=unroll)
    got = jxs.sw_forward_xsharded(
        jnp.asarray(b.sx), jnp.asarray(b.sy), mesh=mesh, strip_w=b.strip_w,
        n_diags=b.n_diags, unroll=b.unroll, anchor=b.anchor,
        cfg=JaxSWConfig(**(cfg or {})), interpret=True)
    return np.asarray(got)


def _ring(pairs, K, unroll, cfg=None, windowed=False):
    pk = _pack(pairs, K, unroll)
    got = xsharded.sw_forward_xsharded_ring(
        torch.from_numpy(pk.sx), torch.from_numpy(pk.sy), n_strips=K,
        strip_w=pk.strip_w, n_diags=pk.n_diags, unroll=unroll,
        anchor=pk.anchor, cfg=SWConfig(**(cfg or {})),
        ly_max=xsharded.tile_ly_max(pk) if windowed else None)
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
            n_diags=pk.n_diags, unroll=8, ly_max=xsharded.tile_ly_max(pk))


def _state(w, offset=0, lane_major=True):
    """Six (w, 128) int32 arrays, lane-major (strides (1, w)) or
    contiguous, each starting `offset` ints into its storage."""
    def one():
        if not lane_major:
            return torch.zeros(offset + w * 128, dtype=torch.int32)[
                offset:].view(w, 128)
        return torch.zeros(offset + w * 128, dtype=torch.int32)[
            offset:].view(128, w).t()
    return tuple(one() for _ in range(6))


@pytest.mark.parametrize("w,offset,lane_major,U,want", [
    (24, 0, True, 32, (True, True)),
    (1032, 0, True, 64, (True, True)),
    (25, 0, True, 32, (False, False)),   # lane stride not whole int4
    (26, 0, True, 32, (False, False)),
    (24, 1, True, 32, (False, False)),   # arrays not 16-byte aligned
    (24, 4, True, 32, (True, True)),
    (24, 0, False, 32, (False, False)),  # contiguous: one int at a time
    (8000, 0, True, 8192, (True, False)),  # no room for the prefetch
])
def test_kernel_moves_follow_the_state_layout(w, offset, lane_major, U,
                                              want):
    """The kernel's int4 moves need lane-major state at a lane stride of
    whole int4 and 16-byte aligned arrays, and its prefetch needs shared
    memory beside the block's 5U ints; otherwise the same kernel moves one
    int at a time (a lane-major w = 25 is inside strip_block's contract)."""
    st = _state(w, offset, lane_major)
    (srow, slane), = {a.stride() for a in st}
    r = xsharded.XSTRIP_R
    threads = xsharded._threads(w, r)
    assert xsharded._moves([a.data_ptr() for a in st], srow, slane, threads,
                           r, U) == want


def test_block_length_cap_fits_shared_memory():
    """MAX_UNROLL's 5 ints a step and 6 a warp fit the block's shared
    memory at the most threads any R launches; strip_block takes U up to
    MAX_UNROLL and rejects one more."""
    warps = xsharded.MAX_ROWS // min(xsharded.ROWS_PER_THREAD) // 32
    assert 4 * (5 * xsharded.MAX_UNROLL + 6 * warps) <= xsharded.SMEM_BYTES
    assert xsharded.MAX_UNROLL == 8192
    w, U = 8, xsharded.MAX_UNROLL + 1
    sxb, slab, hD, hQ, state = (torch.from_numpy(a) if not isinstance(a, tuple)
                                else tuple(map(torch.from_numpy, a))
                                for a in xstrip_inputs(3, w, U))
    with pytest.raises(ValueError, match="U="):
        xsharded.strip_block(sxb, slab, hD, hQ, state, w=w, U=U)


@pytest.mark.parametrize("ci", range(len(CFGS)))
@pytest.mark.parametrize("K", [1, 2, 4])
def test_windowed_forward_and_ring_equal_jax_and_oracle(K, ci):
    """Every block windowed to its live rows (``live_rows``): the ring, and
    on one rank the forward itself, give the JAX package's forward and the
    oracle on every case of tests/test_xsharded.py."""
    if len(jax.devices("cpu")) < K:
        pytest.skip(f"needs {K} virtual CPU devices (see conftest XLA_FLAGS)")
    cfg = CFGS[ci]
    mesh = make_mesh(1, device="cpu")
    for name, (pairs, unroll) in CASES.items():
        got = _ring(pairs, K, unroll, cfg, windowed=True)
        np.testing.assert_array_equal(got, _jax_forward(pairs, K, unroll,
                                                        cfg), err_msg=name)
        np.testing.assert_array_equal(
            got[: len(pairs)],
            oracle.sw_scores_pairs(_jax_pairs(pairs), JaxSWConfig(**cfg)),
            err_msg=name)
        if K == 1:
            pk = _pack(pairs, 1, unroll)
            fwd = xsharded.sw_forward_xsharded(
                torch.from_numpy(pk.sx), torch.from_numpy(pk.sy), mesh=mesh,
                strip_w=pk.strip_w, n_diags=pk.n_diags, unroll=unroll,
                anchor=pk.anchor, ly_max=xsharded.tile_ly_max(pk),
                cfg=SWConfig(**cfg))
            np.testing.assert_array_equal(fwd.numpy(), got, err_msg=name)


@pytest.mark.parametrize("ci", range(len(CFGS)))
@pytest.mark.parametrize("K", [1, 2, 4])
def test_full_block_keeps_rows_past_the_window_zero(K, ci):
    """The exactness of the skip, on the reference's own function: in the
    full ring of JAX blocks (``_strip_block_pallas``, interpret mode), at
    every (k, b), the rows at and past ``live_rows``'s upper edge hold
    zeros in all six state arrays, and the strip's halo is zero when the
    edge lies inside the strip. A window is never wider than the strip,
    and at the last block every strip's window is done or nearly."""
    cfg = CFGS[ci]
    for name, (pairs, U) in CASES.items():
        if name not in ("ragged", "identical_disjoint", "tandem", "unroll4"):
            continue
        pk = _pack(pairs, K, U)
        w, ly_max = pk.strip_w, xsharded.tile_ly_max(pk)
        sx, sy = pk.sx.astype(np.int32), pk.sy.astype(np.int32)
        zero = np.zeros((U, 128), np.int32)
        block = jax.jit(functools.partial(
            jxs._strip_block_pallas, w=w, U=U, cfg=JaxSWConfig(**cfg),
            interpret=True))
        states = [tuple(np.zeros((w, 128), np.int32) for _ in range(6))
                  for _ in range(K)]
        halos = [(zero, zero)] * K
        for b in range(xsharded.n_blocks(pk.n_diags, U, K)):
            new = []
            for k in range(K):
                s = xsharded.slab_start(pk.anchor, k, b, strip_w=w, unroll=U,
                                        ndt=sy.shape[0])
                hD, hQ = halos[k - 1] if k else (zero, zero)
                st, bD, bQ = block(sx[k * w: (k + 1) * w],
                                   sy[s: s + w + U], hD, hQ, states[k])
                states[k] = tuple(np.asarray(a) for a in st)
                lo, hi = xsharded.live_rows(k, b, strip_w=w, unroll=U,
                                            ly_max=ly_max)
                assert 0 <= lo <= w and 0 <= hi <= w, (name, k, b)
                for a in states[k]:
                    assert not a[hi:].any(), (name, k, b, hi)
                if hi < w:
                    assert not np.asarray(bD).any()
                    assert not np.asarray(bQ).any()
                new.append((np.asarray(bD), np.asarray(bQ)))
            halos = new


@pytest.mark.parametrize("rows", [(0, 40), (0, 1), (0, 23), (9, 40),
                                  (13, 31), (39, 40), (20, 20)])
@pytest.mark.parametrize("U", [1, 8])
def test_strip_block_window_leaves_the_rest_untouched(U, rows):
    """strip_block(rows=(g_lo, g_hi)) on the CPU: the rows outside the
    window are bit for bit the input, with ``out`` or without; the window
    is the plain block on the slice (zeros above g_lo > 0), its halo that
    block's when g_hi = w and zeros otherwise; where g_lo is 0 the window's
    rows (and at g_hi = w the halo) equal the full block's; an empty
    window returns the state and a zero halo."""
    w = 40
    sxb, slab, hD, hQ, state = (torch.from_numpy(a) if not isinstance(a, tuple)
                                else tuple(map(torch.from_numpy, a))
                                for a in xstrip_inputs(70 + U, w, U))
    g_lo, g_hi = rows
    full = sw_xstrip_block(sxb, slab, hD, hQ, state, w=w, U=U)
    sl = slice(g_lo, g_hi)
    top = (hD, hQ) if g_lo == 0 else (torch.zeros_like(hD),) * 2
    part = (sw_xstrip_block(sxb[sl], slab[g_lo: g_hi + U], *top,
                            tuple(a[sl] for a in state), w=g_hi - g_lo, U=U)
            if g_lo < g_hi else None)
    got = xsharded.strip_block(sxb, slab, hD, hQ, state, w=w, U=U, rows=rows)
    io = tuple(a.t().contiguous().t() for a in state)
    inplace = xsharded.strip_block(sxb, slab, hD, hQ, io, w=w, U=U,
                                   rows=rows, out=io)
    assert all(a is b for a, b in zip(inplace[0], io))
    for res in (got, inplace):
        for i, (a, s0, f) in enumerate(zip(res[0], state, full[0])):
            assert torch.equal(a[:g_lo], s0[:g_lo])
            assert torch.equal(a[g_hi:], s0[g_hi:])
            if part is not None:
                assert torch.equal(a[sl], part[0][i])
            if g_lo == 0:
                assert torch.equal(a[:g_hi], f[:g_hi])
        for j, h in enumerate(res[1:]):
            if g_hi == w and part is not None:
                assert torch.equal(h, part[1 + j])
                if g_lo == 0:
                    assert torch.equal(h, full[1 + j])
            else:
                assert not h.any()


def test_live_rows_edges():
    """The window of block b on rank k: [(b-k)U - ly_max - k*w, (b-k+1)U -
    k*w) clamped to the strip; empty before the fill and after the drain."""
    kw = dict(strip_w=100, unroll=8, ly_max=30)
    assert xsharded.live_rows(0, 0, **kw) == (0, 8)
    assert xsharded.live_rows(0, 5, **kw) == (10, 48)
    assert xsharded.live_rows(0, 20, **kw) == (100, 100)
    assert xsharded.live_rows(1, 12, **kw) == (0, 0)
    assert xsharded.live_rows(1, 14, **kw) == (0, 12)
    assert xsharded.live_rows(1, 20, **kw) == (22, 60)
    assert xsharded.live_rows(2, 0, **kw) == (0, 0)
