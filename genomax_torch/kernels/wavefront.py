"""Plain PyTorch wavefronts: the torch twin of ``genomax/kernels/wavefront.py``
(Smith-Waterman and the PairHMM forward).

They are the plain references of the CUDA kernels ``csrc/sw_tile.cu`` and
``csrc/pairhmm_tile.cu`` (and, further down, of the strip kernels
``csrc/sw_long.cu``, ``csrc/sw_strips.cu`` and ``csrc/pairhmm_long.cu``,
of the short-pair kernels ``csrc/sw_rotor.cu``, ``csrc/sw_stacked.cu``
and ``csrc/sw_conveyor.cu``, and of the cross-device strip kernel
``csrc/sw_xstrip.cu``): the CPU paths of the wrappers in
``kernels.sw``, ``kernels.pairhmm``, ``kernels.sw_long``,
``kernels.sw_strips``, ``kernels.sw_rotor``, ``kernels.sw_stacked``,
``kernels.sw_conveyor``, ``kernels.pairhmm_long`` and ``dist.xsharded``
run them, the tests hold them against the JAX package, and
``chip_smoke.py`` holds the kernels against them on the card. They keep
the JAX formulation as it is, so the two can be read side by side:

  * the ``(NXs, L)`` layout: x position on axis 0, one pair per column;
  * the reversed diagonal stream, anchored at A = NDs - NXs: the window of
    diagonal d is rows [A-d, A-d+NXs), and its row s holds sy[d-1-s];
  * the mask-free recurrence: pads (x 1, stream 0) mismatch everything,
    so cells outside a pair's matrix decay and never feed a real cell
    (under ``SWConfig.matrix`` a cell scores the code table's entry of its
    x and y codes, gathered, and a pad's entries are at most 0, which
    gives the same decay: ``genomax_torch/scoring.py``);
  * the -KILL pins on the boundary rows, which make the circular
    ``torch.roll`` of the carried diagonals act as the first-column
    boundary (D = 0, Q = 0 at row 0);
  * PairHMM in fp32 with the 2**120 initial constant, a per-pair 2**80
    rescale when the live window's peak falls below 2**40, checked once
    per block of ``rescale_period`` diagonals, and a likelihood
    accumulator that carries its own exponent (the JAX docstrings of
    ``phmm_step`` and ``phmm_rescale`` hold the proofs).
"""

from __future__ import annotations

import torch

from genomax_torch import scoring
from genomax_torch.config import SWConfig
from genomax_torch.layout import PAD_STREAM, PAD_X

# Boundary-row kill constant, as in genomax/kernels/wavefront.py: it
# dominates any real score chain and keeps every int32 add from wrapping.
KILL = 1 << 28

# PairHMM fp32 scaling scheme (genomax/kernels/wavefront.py:100-105).
PHMM_INIT_LOG2 = 120  # initial constant = 2**120
PHMM_RESCALE_TRIGGER = 2.0**40
PHMM_RESCALE_FACTOR = 2.0**80
PHMM_RESCALE_LOG10 = 80 * 0.30102999566398120  # log10(2**80)
PHMM_INIT_LOG10 = 120 * 0.30102999566398120
_N_CODE = ord("N")
_N_BITMASK = 15  # 'N' in the pack's match-bitmask codes


def sub_table(cfg: SWConfig, device) -> torch.Tensor | None:
    """The code table of ``cfg.matrix`` (``scoring.code_table``) as a flat
    int32 tensor on ``device``, entry STRIDE * x + y; None under equality
    scoring."""
    name = scoring.matrix_of(cfg)
    if name is None:
        return None
    return torch.from_numpy(scoring.code_table(name).copy()).to(device)


def sw_make_consts(sxb: torch.Tensor, cfg: SWConfig,
                   region_h: int | None = None):
    """Loop-invariant (NXs, L) vectors (genomax wavefront.sw_make_consts):
    match/mismatch and gap-open+extend carry -KILL at the bottom row,
    gap-extend for Q's carry at row 0. ``region_h``: the pin period of
    stacked tiles, whose rows q*region_h take the row-0 pin and rows
    q*region_h - 1 the bottom-row pins (default: one region, NXs rows)."""
    h = sxb.shape[0] if region_h is None else region_h
    rows = torch.arange(sxb.shape[0], device=sxb.device).unsqueeze(1) % h
    row0, rowl = rows == 0, rows == h - 1

    def vec(mask, value):
        v = torch.full_like(sxb, value)
        return v.masked_fill_(mask.expand_as(v), -KILL)

    return (vec(rowl, cfg.match), vec(rowl, cfg.mismatch),
            vec(row0, cfg.gap_extend), vec(rowl, cfg.gap_open + cfg.gap_extend))


def sw_forward_dense(sx: torch.Tensor, sy_rev: torch.Tensor, n_diags: int,
                     cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """SW scores of the pairs packed in the columns of ``sx``.

    sx: (NXs, L) sublane-fixed codes (row p holds x[p-1], pads 1);
    sy_rev: (NDs, L) reversed diagonal stream; n_diags: diagonals swept
    (any count from the pairs' largest nx+ny-1 up to NDs-NXs).
    Returns (L,) int32 scores.
    """
    # Widen first: the state and the -KILL constants take the input dtype,
    # and int8 would wrap KILL to 0 and scores at 127.
    sx = sx.to(torch.int32)
    sy_rev = sy_rev.to(torch.int32)
    nxs = sx.shape[0]
    anchor = sy_rev.shape[0] - nxs
    if not 0 <= n_diags <= anchor:
        raise ValueError(f"n_diags={n_diags} outside the stream window "
                         f"(anchor {anchor})")
    return sw_sweep(sx, lambda d: sy_rev[anchor - d: anchor - d + nxs],
                    n_diags, cfg).amax(dim=0)


def sw_sweep(sx: torch.Tensor, window, n_diags: int, cfg: SWConfig,
             region_h: int | None = None) -> torch.Tensor:
    """The carried-diagonal sweep of genomax wavefront.sw_step over the
    int32 (NXs, L) frame ``sx``: diagonals 0 .. n_diags-1, ``window(d)``
    the (NXs, L) stream window of diagonal d, the boundary pins of
    ``sw_make_consts`` (``region_h`` for stacked tiles). Returns the
    running max of D, (NXs, L)."""
    subm, subx, gev, ogev = sw_make_consts(sx, cfg, region_h)
    tab = sub_table(cfg, sx.device)
    if tab is not None:  # the bottom-row pins of subm, on the gathered entry
        kill, xoff = subm == -KILL, sx * scoring.STRIDE
    z = torch.zeros_like(sx)
    p1, d1, d1s, q1s, d2s, mx = z, z, z, z, z, z
    for d in range(n_diags):
        syw = window(d)
        pn = torch.maximum(d1, p1 + cfg.gap_extend)
        qn = torch.maximum(d1s, q1s + gev)
        if tab is None:
            sub = torch.where(syw == sx, subm, subx)
        else:
            sub = torch.where(kill, -KILL, tab[xoff + syw])
        dn = torch.maximum(torch.maximum(pn, qn) + ogev,
                           torch.clamp_min(d2s + sub, 0))
        mx = torch.maximum(mx, dn)
        p1, d1, d1s, q1s, d2s = (pn, dn, torch.roll(dn, 1, 0),
                                 torch.roll(qn, 1, 0), d1s)
    return mx


def sw_forward_tiles(sx: torch.Tensor, sy: torch.Tensor,
                     ndiag_tile: torch.Tensor,
                     cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """The same on a packed bucket: sx (NT, NXs, 128), sy (NT, NDs, 128),
    ndiag_tile (NT,) -> (NT, 128) int32, the contract of
    ``genomax.kernels.sw_pallas.sw_forward_pallas``. All tiles sweep the
    bucket's largest diagonal count, which the pad decay makes harmless."""
    nt, nxs, lanes = sx.shape
    if nt == 0:
        return torch.zeros((0, lanes), dtype=torch.int32, device=sx.device)
    flat_x = sx.permute(1, 0, 2).reshape(nxs, nt * lanes)
    flat_y = sy.permute(1, 0, 2).reshape(sy.shape[1], nt * lanes)
    scores = sw_forward_dense(flat_x, flat_y, int(ndiag_tile.max()), cfg)
    return scores.reshape(nt, lanes)


def sw_stacked_forward_tiles(sx: torch.Tensor, sy: torch.Tensor,
                             ndt: torch.Tensor, *, stack: int, h: int,
                             cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """Plain version of the stacked SW kernel (``csrc/sw_stacked.cu``):
    stacked tiles of ``kernels.sw_stacked.prep_bucket_stacked`` ->
    (NT*stack, 128) int32, row t*stack + q the scores of region q of
    stacked tile t (bucket tile t*stack + q).

    sx: (NT, stack*h, 128), region q's rows [q*h, (q+1)*h) the codes of one
    bucket tile; sy: (NT, a0 + stack*h, 128), region q's stream at rows
    [a0 + (q-1)*h, a0 + q*h), y_q[k] at row a0 + q*h - 1 - k; ndt: (NT,)
    the largest diagonal count of the stack. The JAX formulation
    (genomax/kernels/sw_stacked.py ``_kernel``): every region sweeps in
    phase in one (stack*h, L) frame; the window of diagonal d is rows
    [a0 - d, a0 - d + stack*h), whose row q*h + s holds y_q[d-1-s] while
    0 <= d-1-s < h and a neighbour's bases otherwise, so those rows are
    masked to PAD_STREAM (the ghost-read mask); the -KILL pins of every
    region's first and last row make the circular roll the first-column
    boundary of each region. All tiles sweep the largest ndt.
    """
    nt, nxs, lanes = sx.shape
    if nt == 0:
        return torch.zeros((0, lanes), dtype=torch.int32, device=sx.device)
    a0 = sy.shape[1] - nxs
    nd = int(ndt.max())
    if not (nxs == stack * h and h <= a0 and nd <= a0):
        raise ValueError(f"stacked tiles of {nxs} rows, stream of "
                         f"{sy.shape[1]} rows and {nd} diagonals do not "
                         f"hold {stack} regions of h={h} rows")
    x = sx.to(torch.int32).permute(1, 0, 2).reshape(nxs, nt * lanes)
    y = sy.to(torch.int32).permute(1, 0, 2).reshape(sy.shape[1], nt * lanes)
    smod = torch.arange(nxs, device=sx.device).unsqueeze(1) % h

    def window(d):
        k = (d - 1) - smod  # the stream index row q*h + s reads
        return torch.where((k >= 0) & (k < h), y[a0 - d: a0 - d + nxs],
                           PAD_STREAM)

    mx = sw_sweep(x, window, nd, cfg, region_h=h)
    best = mx.view(stack, h, nt, lanes).amax(dim=1)  # (stack, NT, L)
    return best.permute(1, 0, 2).reshape(nt * stack, lanes)


def sw_long_forward(sx: torch.Tensor, sy: torch.Tensor, nx: torch.Tensor,
                    ny: torch.Tensor, k_strips: int, strip_w: int,
                    anchor: int, cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """Plain version of the long-pair SW kernel (``csrc/sw_long.cu``): one
    packed tile of ``kernels.sw_long.pack_sw_long`` -> (128,) int32 scores.

    sx: (K*W, L) codes, row p holding x[p-1]; sy: (NDt, L) reversed stream
    with y[j-1] at row anchor - j; nx, ny: (L,) matrix dimensions len + 1.

    It sweeps as the kernel does, so that it tests the strip seam and not
    only the score: the K strips of W rows one after another, strip k over
    the diagonals [kW + 1, max over the pairs of min(kW + W - 1, len x) +
    len y], its last live one (not the longest x's row plus the longest y,
    which may be two pairs' and pass the anchor); the strip's last row writes its D and Q of diagonal d to
    halo row d, and the next strip's first row takes the row above from
    halo row d - 1 (and keeps d - 2 as its diagonal neighbour). One halo
    serves every strip: a strip reads row d, for the next diagonal, before
    it writes its own row d. A cell is live iff 1 <= p <= len x and
    1 <= j <= len y; every other cell is D = 0, P = Q = -KILL, written out
    rather than left to pad decay.
    """
    w, all_lanes = strip_w, sx.shape[1]
    dev = sx.device
    out = torch.zeros(all_lanes, dtype=torch.int32, device=dev)
    # A tile fills its lanes from 0; the lanes past the last pair with a
    # cell (the pack's empty lanes) score 0 and are left out of the sweep.
    used = ((nx > 1) & (ny > 1)).nonzero()
    if not len(used):
        return out
    lanes = int(used.max()) + 1
    sx = sx[:, :lanes].to(torch.int32)
    sy = sy[:, :lanes].to(torch.int32)
    lx = (nx[:lanes].to(torch.int32) - 1).view(1, lanes)
    ly = (ny[:lanes].to(torch.int32) - 1).view(1, lanes)
    lx_max, ly_max = int(lx.max()), int(ly.max())
    oge, ge = cfg.gap_open + cfg.gap_extend, cfg.gap_extend
    tab = sub_table(cfg, dev)
    best = torch.zeros((w, lanes), dtype=torch.int32, device=dev)
    nh = k_strips * w + ly_max + 1
    halo_d = torch.zeros((nh, lanes), dtype=torch.int32, device=dev)
    halo_q = torch.full((nh, lanes), -KILL, dtype=torch.int32, device=dev)
    rows = torch.arange(w, dtype=torch.int32, device=dev).view(w, 1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    neg = torch.full((), -KILL, dtype=torch.int32, device=dev)
    for k in range(k_strips):
        row0 = k * w
        if row0 > lx_max:
            break
        p = rows + row0
        xs = sx[row0: row0 + w]
        # Row p is live on the diagonals p + 1 .. p + len y (none where it
        # lies outside 1 .. len x).
        d_lo = p + 1
        d_hi = torch.where((p >= 1) & (p <= lx), p + ly, 0)
        # State of diagonal kW: all boundary. Row 0 of d1e and q1e is the
        # row above the strip, rows 1.. the strip's own rows.
        d1e = torch.zeros((w + 1, lanes), dtype=torch.int32, device=dev)
        q1e = torch.full((w + 1, lanes), -KILL, dtype=torch.int32, device=dev)
        p1 = q1e[1:].clone()
        up2 = d1e[1:].clone()
        if k:
            d1e[0], q1e[0] = halo_d[row0], halo_q[row0]
        for d in range(row0 + 1, int(d_hi.max()) + 1):
            up_d, up_q, d1 = d1e[:-1], q1e[:-1], d1e[1:]
            live = (d_lo <= d) & (d_hi >= d)
            yw = sy[anchor - d + row0: anchor - d + row0 + w]
            pn = torch.maximum(d1 + oge, p1 + ge)
            qn = torch.maximum(up_d + oge, up_q + ge)
            if tab is None:
                sub = torch.where(yw == xs, cfg.match, cfg.mismatch)
            else:
                sub = tab[xs * scoring.STRIDE + yw]
            dn = torch.maximum(torch.maximum(pn, qn),
                               torch.clamp_min(up2 + sub, 0))
            dn = torch.where(live, dn, zero)
            pn = torch.where(live, pn, neg)
            qn = torch.where(live, qn, neg)
            best = torch.maximum(best, dn)
            nd1e, nq1e = torch.empty_like(d1e), torch.empty_like(q1e)
            nd1e[1:], nq1e[1:] = dn, qn
            if k:  # the seam: read row d before this strip overwrites it
                nd1e[0], nq1e[0] = halo_d[d], halo_q[d]
            else:
                nd1e[0], nq1e[0] = zero, neg
            halo_d[d], halo_q[d] = dn[-1], qn[-1]
            up2, p1, d1e, q1e = up_d, pn, nd1e, nq1e
    out[:lanes] = best.amax(dim=0)
    return out


def sw_strips_forward_tiles(sx: torch.Tensor, sy: torch.Tensor,
                            nx: torch.Tensor, ny: torch.Tensor, *,
                            k_strips: int, strip_w: int, anchor: int,
                            cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """Plain version of the strip-mined SW kernel (``csrc/sw_strips.cu``):
    a packed bucket swept in K strips of W rows -> (NT, 128) int32 scores.

    sx: (NT, K*W, 128) codes (``kernels.sw_strips.prep_bucket_strips``:
    the bucket's sx re-padded to K*W rows); sy: (NT, NDs, 128), the
    bucket's stream untouched; nx, ny: (NT*128,) matrix dimensions len + 1
    of each slot (``SWPacked.nx/ny``); anchor: NDs - NXs of the bucket
    before the re-pad, so that y[j-1] sits at stream row anchor - j.

    The bucket flattened to (K*W, NT*128) columns has the layout of one
    long-pair tile, so this is ``sw_long_forward`` over all its columns.
    Every stream read stays in [0, NDs) while W <= NXs: the pack's anchor
    is at least max(nx + ny - 1) + 32, and each strip stops at its last
    live diagonal, at most max(nx + ny - 2).
    """
    nt, kw, lanes = sx.shape
    if nt == 0:
        return torch.zeros((0, lanes), dtype=torch.int32, device=sx.device)
    flat_x = sx.permute(1, 0, 2).reshape(kw, nt * lanes)
    flat_y = sy.permute(1, 0, 2).reshape(sy.shape[1], nt * lanes)
    scores = sw_long_forward(flat_x, flat_y, nx, ny, k_strips, strip_w,
                             anchor, cfg)
    return scores.reshape(nt, lanes)


def sw_rotor_forward_tiles(xrev: torch.Tensor, ybuf: torch.Tensor, *,
                           period: int, n_slots: int, anchor: int,
                           unroll: int,
                           cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """Plain version of the rotor SW kernel (``csrc/sw_rotor.cu``): rotor
    tiles of ``kernels.sw_rotor.prep_bucket_rotor`` -> (NT_r * P8, 128)
    int32, P8 = round_up(P, 8), row q of a tile's block the score of queue
    slot q; rows P..P8-1 are 0.

    xrev: (NT_r, NB, 128), xrev[A - (qT + r)] = x_q[r-1] (pads 1); ybuf:
    (NT_r, NY, 128), ybuf[qT + p] = y_q[p] (pads 0). The JAX formulation
    (genomax/kernels/sw_rotor.py ``_kernel``) on a (T, NT_r*128) frame:
    frame row p always computes matrix column p + 1, so pair q's cell
    (r, c) falls on step d = qT + r + c; the -KILL pins of row T-1 make the
    circular roll the left boundary; the moving wrap row p* = (d-1) mod T
    is the r = 0 slot between two pairs of a queue, where the y code of
    that row is refreshed from ybuf[d-1], D and Q are forced to 0 (no
    chain leaks from pair q-1's pad rows) and the column's running max
    moves to ``harv``, whose column maxes give slot m-2's score at each
    period boundary m. The steps run in blocks of ``unroll``, and a
    harvest falls at a block start only if unroll divides T (the caller
    checks it; the JAX kernel silently scores 0 otherwise).
    """
    nt, _, lanes = xrev.shape
    T, P, A = period, n_slots, anchor
    p8 = -(-P // 8) * 8
    out = torch.zeros((nt, p8, lanes), dtype=torch.int32, device=xrev.device)
    if nt == 0:
        return out.reshape(0, lanes)
    cols = nt * lanes
    xf = xrev.to(torch.int32).permute(1, 0, 2).reshape(-1, cols)
    yf = ybuf.to(torch.int32).permute(1, 0, 2).reshape(-1, cols)
    ge, og_e = cfg.gap_extend, cfg.gap_open + cfg.gap_extend
    ii = torch.arange(T, device=xrev.device).unsqueeze(1)
    z = torch.zeros((T, cols), dtype=torch.int32, device=xrev.device)

    def pinned(value):  # value everywhere, -KILL at row T-1
        return torch.where(ii == T - 1, -KILL, z + value)

    subm, subx = pinned(cfg.match), pinned(cfg.mismatch)
    ogev, gevP, kT1 = pinned(og_e), pinned(ge), pinned(0)
    tab = sub_table(cfg, xrev.device)
    syb = z.clone()
    P1 = D1 = D2 = Dv = Qv = mx = harv = z
    for blk in range((P + 1) * T // unroll + 1):
        d0 = blk * unroll + 1
        m = (d0 - 1) // T
        if m * T == d0 - 1 and 2 <= m < P + 2:
            out[:, m - 2] = harv.amax(dim=0).view(nt, lanes)
        for d in range(d0, d0 + unroll):
            pstar = (d - 1) % T
            wrap = ii == pstar
            syb[pstar] = yf[d - 1]
            xw = xf[A - d + 1: A - d + 1 + T]
            Pn = torch.maximum(D1 + kT1, P1 + gevP)
            Qn = torch.where(wrap, 0, torch.maximum(Dv, Qv + ge))
            if tab is None:
                sub = torch.where(xw == syb, subm, subx)
            else:
                sub = torch.where(ii == T - 1, -KILL,
                                  tab[xw * scoring.STRIDE + syb])
            Dn = torch.maximum(torch.maximum(Pn, Qn) + ogev,
                               torch.clamp_min(D2 + sub, 0))
            Dn = torch.where(wrap, 0, Dn)
            harv = torch.where(wrap, mx, harv)
            mx = torch.maximum(torch.where(wrap, 0, mx), Dn)
            P1, D1, D2, Dv, Qv = (torch.roll(Pn, 1, 0), torch.roll(Dn, 1, 0),
                                  D1, Dn, Qn)
    return out.reshape(nt * p8, lanes)


def sw_conveyor_forward_tiles(sched: torch.Tensor, sy: torch.Tensor, *,
                              nxs: int, n_slots: int, period: int, a0: int,
                              unroll: int,
                              cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """Plain version of the conveyor SW kernel (``csrc/sw_conveyor.cu``):
    tiles of ``kernels.sw_conveyor.pack_sw_conveyor`` -> (NT * P8, 128)
    int32, P8 = round_up(P, 8), row q of a tile's block the score of queue
    slot q; rows P..P8-1 are 0.

    sched: (NT, SR, 128), row d the x code that the switching row
    r* = (d-1) mod T adopts at step d (pads 1); sy: (NT, NB, 128), the
    shared stream, row a0 - m holding the code of coordinate m (pads 0).
    The JAX formulation (genomax/kernels/sw_conveyor.py ``_kernel``) on an
    (nxs, NT*128) frame: row r of pair q computes column j at step
    d = qT + r + j; the -KILL pins of rows 0 and nxs-1 (``sw_make_consts``)
    make the circular roll's wrap inert; at each step the switching row
    collects its running max into ``done``, takes its x code from sched,
    and restarts P, the diagonal D and its max at the pair's boundary
    (zero). At each period boundary d = qT, before that step's collect,
    ``done`` holds pair q-2's row maxima: its column max is slot q-2's
    score, and ``done`` restarts. The steps run to (P+1)T + unroll, the
    JAX kernel's last block.
    """
    nt, _, lanes = sched.shape
    T, P = period, n_slots
    p8 = -(-P // 8) * 8
    out = torch.zeros((nt, p8, lanes), dtype=torch.int32, device=sched.device)
    if nt == 0:
        return out.reshape(0, lanes)
    cols = nt * lanes
    sf = sched.to(torch.int32).permute(1, 0, 2).reshape(-1, cols)
    yf = sy.to(torch.int32).permute(1, 0, 2).reshape(-1, cols)
    x = torch.full((nxs, cols), PAD_X, dtype=torch.int32, device=sched.device)
    subm, subx, gev, ogev = sw_make_consts(x, cfg)

    def zeros():
        return torch.zeros_like(x)

    P1, D1, D1s, Q1s, D2s, mx, done = (zeros() for _ in range(7))
    for d in range((P + 1) * T + unroll):
        if d % T == 0:
            if 2 <= d // T < P + 2:
                out[:, d // T - 2] = done.amax(dim=0).view(nt, lanes)
            done = zeros()
        r = (d - 1) % T  # the switching row; none when r >= nxs
        syw = yf[a0 - d: a0 - d + nxs]
        if r < nxs:
            done[r] = mx[r]
            x[r] = sf[d]
        Pn = torch.maximum(D1, P1 + cfg.gap_extend)
        Qn = torch.maximum(D1s, Q1s + gev)
        sub = torch.where(syw == x, subm, subx)
        diag = D2s + sub
        if r < nxs:  # the pair's boundary: P' = 0, D(r-1, 0) = 0, max = 0
            Pn[r] = 0
            diag[r] = sub[r]
            mx[r] = 0
        Dn = torch.maximum(torch.maximum(Pn, Qn) + ogev,
                           torch.clamp_min(diag, 0))
        mx = torch.maximum(mx, Dn)
        P1, D1, D1s, Q1s, D2s = (Pn, Dn, torch.roll(Dn, 1, 0),
                                 torch.roll(Qn, 1, 0), D1s)
    return out.reshape(nt * p8, lanes)


def sw_long_forward_dense(sx: torch.Tensor, sy: torch.Tensor, n_diags: int,
                          ny_max: int, anchor: int,
                          cfg: SWConfig = SWConfig()) -> torch.Tensor:
    """The same tile in one full-height sweep, without strips: all K*W rows
    at once over the tile's n_diags = max(len x + len y) + 1 diagonals
    (``SWLongPacked.n_diags``), by ``sw_forward_dense``. It takes a K-th of
    the strip sweep's steps, so it is the plain version that a 50kbp tile
    can be held against; it knows nothing of seams or lengths (the pad
    codes let the cells past a pair's matrix decay).

    sx, sy, anchor as in ``sw_long_forward``; the codes of every y lie in
    the stream's rows [anchor - ny_max, anchor).
    """
    kw, lanes = sx.shape
    stream = torch.zeros((n_diags + kw, lanes), dtype=sy.dtype,
                         device=sy.device)
    n = min(ny_max, n_diags)
    stream[n_diags - n: n_diags] = sy[anchor - n: anchor]
    return sw_forward_dense(sx, stream, n_diags, cfg)


def sw_xstrip_block(sxb: torch.Tensor, slab: torch.Tensor, hD: torch.Tensor,
                    hQ: torch.Tensor, state, *, w: int, U: int,
                    cfg: SWConfig = SWConfig()):
    """Plain version of the cross-device strip kernel
    (``csrc/sw_xstrip.cu``): one skewed block of U diagonals of one strip
    of w rows, the step loop of genomax/dist/xsharded.py
    ``_strip_block_pallas``.

    sxb: (w, L) x codes of the strip; slab: (w+U, L) stream rows, the
    window of in-block step tt being slab[U-tt : U-tt+w); hD, hQ: (U, L)
    the left neighbour's last-row D and Q of each step (zeros on the first
    strip); state: (P1, D1, D1s, Q1s, D2s, mx), six (w, L) int32. Returns
    (state', bD, bQ): the state after the U steps and this strip's
    last-row Dn and Qn of each step, (U, L) int32. There are no boundary
    pins: row 0 takes the halo row where the roll would wrap the last row
    round.
    """
    sxb = sxb.to(torch.int32)
    slab = slab.to(torch.int32)
    ge, oge = cfg.gap_extend, cfg.gap_open + cfg.gap_extend
    match, mismatch = (torch.tensor(v, dtype=torch.int32, device=sxb.device)
                       for v in (cfg.match, cfg.mismatch))
    P1, D1, D1s, Q1s, D2s, mx = state
    bD = torch.empty((U, sxb.shape[1]), dtype=torch.int32, device=sxb.device)
    bQ = torch.empty_like(bD)
    for tt in range(U):
        syw = slab[U - tt: U - tt + w]
        Pn = torch.maximum(D1, P1 + ge)
        Qn = torch.maximum(D1s, Q1s + ge)
        sub = torch.where(syw == sxb, match, mismatch)
        Dn = torch.maximum(torch.maximum(Pn, Qn) + oge,
                           torch.clamp_min(D2s + sub, 0))
        mx = torch.maximum(mx, Dn)
        bD[tt], bQ[tt] = Dn[w - 1], Qn[w - 1]
        D1sn, Q1sn = torch.roll(Dn, 1, 0), torch.roll(Qn, 1, 0)
        D1sn[0], Q1sn[0] = hD[tt], hQ[tt]
        P1, D1, D1s, Q1s, D2s = Pn, Dn, D1sn, Q1sn, D1s
    return (P1, D1, D1s, Q1s, D2s, mx), bD, bQ


# ---------------------------------------------------------------------------
# PairHMM forward
# ---------------------------------------------------------------------------


def phmm_make_consts(rchar, qr, mmv, gapm, qi, qd, qg, rl, hl,
                     mm_div: float = 1.0, bitmask: bool = False) -> dict:
    """Loop-invariant (NXs, L) values (genomax wavefront.phmm_make_consts),
    with its three folds: pm = 0 at row 0 and at rows past the read (every
    M/X/Y product chain is then exactly zero outside the live matrix);
    the read-'N' wildcard folded into qr; qg = 1 at row 0, so the row-0 Y
    boundary constant persists from its initial state. rl, hl: (1, L)."""
    nxs, lanes = qr.shape
    ii = torch.arange(nxs, device=qr.device, dtype=torch.int32).unsqueeze(1)
    ii = ii.expand(nxs, lanes)
    row0 = ii == 0
    y0 = (2.0**PHMM_INIT_LOG2) / hl.clamp_min(1).to(torch.float32)
    dead = row0 | (ii > rl)
    rn = rchar == (_N_BITMASK if bitmask else _N_CODE)
    return dict(
        rchar=rchar, bitmask=bitmask,
        pm=torch.where(dead, 0.0, 1.0 - qr),
        qr=torch.where(dead, 0.0,
                       torch.where(rn, 1.0 - qr, qr * (1.0 / mm_div))),
        mmv=mmv, gapm=gapm, qi=qi, qd=qd,
        qg=torch.where(row0, 1.0, qg),
        rlmask=ii == rl,
        y0row=torch.where(row0, y0, 0.0),
        rl=rl, hl=hl, rlhl=rl + hl, ii=ii,
    )


def phmm_make_state(z, y0row):
    """(M1, Y1, M1s, X1s, Y1s, M2s, X2s, Y2s, acc, accb, cmul, acc_log)
    (genomax wavefront.phmm_make_state): *1s are roll-by-one copies of
    the previous diagonal, *2s of the one before it; Y1 starts at the
    row-0 boundary constant. z: (NXs, L) f32 zeros."""
    zc = z[0:1]
    return (z, z + y0row, z, z, z, z, z, z, z, z, zc + 1.0, zc)


def _roll1(x):
    return torch.roll(x, 1, 0)


def phmm_step(hw, d: int, state, c: dict):
    """Anti-diagonal d of M/X/Y (genomax wavefront.phmm_step). hw: the
    stream window of diagonal d, whose row i holds H[d-1-i] for the cell
    (i, j = d-i). Raw (Mn+Xn) contributions of rows still inside the
    pair's live diagonals collect in accb; only the read_len row is read
    later, through the rlmask select."""
    M1, Y1, M1s, X1s, Y1s, M2s, X2s, Y2s, acc, accb, cmul, acc_log = state
    if c["bitmask"]:
        match = (c["rchar"] & hw) != 0
    else:
        match = (c["rchar"] == hw) | (hw == _N_CODE)
    p = torch.where(match, c["pm"], c["qr"])
    Mn = p * (c["mmv"] * M2s + c["gapm"] * (X2s + Y2s))
    Xn = M1s * c["qi"] + X1s * c["qg"]
    Yn = M1 * c["qd"] + Y1 * c["qg"]
    accb = accb + torch.where(d <= c["rlhl"], Mn + Xn, 0.0)
    return (Mn, Yn, _roll1(Mn), _roll1(Xn), _roll1(Yn), M1s, X1s, Y1s,
            acc, accb, cmul, acc_log)


def phmm_rescale(state, d: int, c: dict):
    """Per-pair exponent rescale after the block ending at diagonal d
    (genomax wavefront.phmm_rescale): fold accb into acc, take the peak of
    the live window over the last diagonals with the JAX masks v0/v1/v2
    (written for this rolled layout), multiply every carry by 2**80 where
    it fell below 2**40, and let the accumulator follow the scale while it
    is small and freeze it after."""
    M1, Y1, M1s, X1s, Y1s, M2s, X2s, Y2s, acc, accb, cmul, acc_log = state
    acc = acc + accb * cmul
    # Literal zeros: off-rl rows of accb may hold +inf, and inf - inf = NaN.
    accb = torch.zeros_like(accb)
    ii, rl, hl = c["ii"], c["rl"], c["hl"]
    jv = d - ii
    v0 = (ii <= rl) & (jv >= 0) & (jv <= hl)
    jv1 = (d - 1) - (ii - 1)
    v1 = (ii >= 1) & (ii - 1 <= rl) & (jv1 >= 0) & (jv1 <= hl)
    jv2 = (d - 2) - (ii - 1)
    v2 = (ii >= 1) & (ii - 1 <= rl) & (jv2 >= 0) & (jv2 <= hl)
    live = torch.where(v0, torch.maximum(M1, Y1), 0.0)
    live = torch.maximum(live, torch.where(
        v1, torch.maximum(torch.maximum(M1s, X1s), Y1s), 0.0))
    live = torch.maximum(live, torch.where(
        v2, torch.maximum(torch.maximum(M2s, X2s), Y2s), 0.0))
    peak = live.amax(dim=0, keepdim=True)
    alive = d <= rl + hl + 1
    need = alive & (peak > 0.0) & (peak < PHMM_RESCALE_TRIGGER)
    f = torch.where(need, PHMM_RESCALE_FACTOR, 1.0)
    # Only the rl row is the real accumulator: mask before reducing.
    asum = torch.where(c["rlmask"], acc, 0.0).amax(dim=0, keepdim=True)
    follow = need & (asum < PHMM_RESCALE_TRIGGER)
    return (M1 * f, Y1 * f, M1s * f, X1s * f, Y1s * f, M2s * f, X2s * f,
            Y2s * f,
            acc * torch.where(follow, PHMM_RESCALE_FACTOR, 1.0),
            accb,
            cmul * torch.where(need & ~follow, 1.0 / PHMM_RESCALE_FACTOR, 1.0),
            acc_log - torch.where(follow, PHMM_RESCALE_LOG10, 0.0))


def phmm_finalize(state, c: dict):
    """log10 of the read_len row's accumulator minus the 2**120 constant,
    the exponent shifts folded back in; (L,) f32."""
    acc, acc_log = state[8], state[11]
    total = torch.where(c["rlmask"], acc, 0.0).sum(dim=0, keepdim=True)
    return (torch.log10(total) + acc_log - PHMM_INIT_LOG10)[0]


def phmm_forward_dense(rchar, qr, mmv, gapm, qi, qd, qg, hap_rev, rl, hl,
                       n_diags: int, rescale_period: int = 32,
                       mm_div: float = 1.0, bitmask: bool = False):
    """PairHMM forward over the pairs packed in the columns (genomax
    wavefront.phmm_forward_dense).

    rchar: (NXs, L) int codes; the six quality planes: (NXs, L) f32 with
    row i holding base i-1; hap_rev: (NDs, L) reversed diagonal stream;
    rl, hl: (L,) true lengths; n_diags: diagonals to sweep, run in
    ceil(n_diags / rescale_period) blocks of rescale_period steps with the
    rescale after every block, the last included. Returns (L,) f32 log10
    likelihoods relative to the reference constant.
    """
    nxs, lanes = qr.shape
    anchor = hap_rev.shape[0] - nxs
    n_blocks = -(-n_diags // rescale_period)
    if n_diags < 0 or n_blocks * rescale_period > anchor + 1:
        raise ValueError(f"n_diags={n_diags} rounded up to rescale_period="
                         f"{rescale_period} runs past the stream window "
                         f"(anchor {anchor})")
    c = phmm_make_consts(rchar, qr, mmv, gapm, qi, qd, qg,
                         rl.reshape(1, lanes), hl.reshape(1, lanes),
                         mm_div, bitmask)
    state = phmm_make_state(torch.zeros_like(qr), c["y0row"])
    for blk in range(n_blocks):
        base = blk * rescale_period
        for d in range(base, base + rescale_period):
            hw = hap_rev[anchor - d: anchor - d + nxs]
            state = phmm_step(hw, d, state, c)
        state = phmm_rescale(state, base + rescale_period - 1, c)
    return phmm_finalize(state, c)


def phmm_forward_tiles(rchar, qr, mmv, gapm, qi, qd, qg, hap, meta,
                       ndiag_tile, rescale_period: int = 32,
                       mm_div: float = 1.0,
                       bitmask: bool = False) -> torch.Tensor:
    """The same on a packed bucket, with the contract of
    ``genomax.kernels.pairhmm_pallas.pairhmm_forward_pallas``: rchar
    (NT, NXs, 128), six f32 planes (NT, NXs, 128), hap (NT, NDs, 128)
    reversed stream, meta (NT, 8, 128) int32 (row 0 read_len, row 1
    hap_len), ndiag_tile (NT,) -> (NT, 128) f32. All tiles sweep the
    bucket's largest diagonal count: past its own last diagonal a pair
    neither accumulates nor rescales, so the extra blocks change nothing."""
    nt, nxs, lanes = rchar.shape
    if nt == 0:
        return torch.zeros((0, lanes), dtype=torch.float32,
                           device=rchar.device)

    def flat(x):
        if x.dtype == torch.int8:
            x = x.to(torch.int32)
        return x.permute(1, 0, 2).reshape(x.shape[1], nt * lanes)

    out = phmm_forward_dense(
        flat(rchar), flat(qr), flat(mmv), flat(gapm), flat(qi), flat(qd),
        flat(qg), flat(hap), meta[:, 0, :].reshape(-1),
        meta[:, 1, :].reshape(-1), int(ndiag_tile.max()), rescale_period,
        mm_div, bitmask)
    return out.reshape(nt, lanes)


# ---------------------------------------------------------------------------
# PairHMM forward for long reads: read-axis strips with a halo
# ---------------------------------------------------------------------------

# Diagonals per stream and halo chunk of the long-read kernel; a strip's
# sweep starts at a multiple of it (genomax.kernels.sw_long.CHUNK).
LONG_CHUNK = 256
# Ceiling of the carried values of the long-read kernel: cells past a
# haplotype's end keep being fed from the row-0 Y constant, and repeated
# rescales would push them to inf (genomax pairhmm_long._kernel).
_LONG_CAP = 2.0**126


def phmm_long_halo_rows(k_strips: int, strip_w: int,
                        sweep_chunks: int) -> int:
    """Rows of each halo buffer: every diagonal any strip sweeps."""
    n = (k_strips - 1) * strip_w + (sweep_chunks + 1) * LONG_CHUNK
    return -(-n // LONG_CHUNK) * LONG_CHUNK


def phmm_long_forward(rchar, qual, hap, meta, k_strips: int, strip_w: int,
                      anchor: int, sweep_chunks: int, unroll: int = 16,
                      mm_div: float = 1.0) -> torch.Tensor:
    """Long-read PairHMM over one tile of 128 jobs (genomax
    pairhmm_long._kernel), in the same ``(W, L)`` layout and order.

    The read axis runs in ``k_strips`` strips of ``strip_w`` rows, one
    after another; strip k sweeps the ``sweep_chunks * LONG_CHUNK``
    diagonals from ``(k*W // LONG_CHUNK) * LONG_CHUNK``. M, X and Y of a
    strip's last row, and its rescale count, pass to the next strip's row
    0 through four halo rows per diagonal. Each strip rescales in its own
    2**80 frame; the reader adopts the writer's count at its start, never
    runs deeper than its writer, and converts every injected value down
    by 2**(80 * (cnt_reader - cnt_writer)), clipped at 2**-240. The
    accumulator carries its own count (the JAX docstring holds the
    argument).

    rchar: (K*W, 128) int8 raw codes, row i holding base i-1 (pads 1);
    qual: (6*K*W, 128) fp32, the planes qr, mmv, gapm, qi, qd, qg stacked;
    hap: (NDt, 128) int8 reversed stream, H[j] at row anchor-1-j (pads 0);
    meta: (8, 128) int32, row 0 read_len, row 1 hap_len. Returns (128,)
    fp32 log10 relative to the reference's constant; lanes with read_len 0
    give -inf."""
    w, lanes = strip_w, rchar.shape[1]
    kw = k_strips * w
    dev = qual.device
    rchar = rchar.to(torch.int32)
    hap = hap.to(torch.int32)
    halo = torch.zeros((4, phmm_long_halo_rows(k_strips, w, sweep_chunks),
                        lanes), dtype=torch.float32, device=dev)
    z = torch.zeros((w, lanes), dtype=torch.float32, device=dev)
    rl, hl = meta[0:1], meta[1:2]
    rlhl = rl + hl
    iil = torch.arange(w, device=dev, dtype=torch.int32).unsqueeze(1)
    row0 = iil == 0
    y0 = (2.0**PHMM_INIT_LOG2) / hl.clamp_min(1).to(torch.float32)
    acc, acc_cnt = z, z[0:1]
    for k in range(k_strips):
        rows = slice(k * w, (k + 1) * w)
        code = rchar[rows]
        qr, mmv, gapm, qi, qd, qg = (qual[j * kw:(j + 1) * kw][rows]
                                     for j in range(6))
        ii = iil + k * w
        dead = (ii == 0) | (ii > rl)
        pm = torch.where(dead, 0.0, 1.0 - qr)
        qr = torch.where(dead, 0.0, torch.where(code == _N_CODE, 1.0 - qr,
                                                qr * (1.0 / mm_div)))
        qg = torch.where(ii == 0, 1.0, qg)
        rlmask = ii == rl
        is0 = k == 0
        # Frame snap: the writer's count at this strip's first live
        # diagonal; the accumulator snaps too while it is empty.
        cnt = z[0:1] if is0 else halo[3, k * w:k * w + 1].clone()
        acc_cnt = torch.where(acc.amax(dim=0, keepdim=True) > 0.0, acc_cnt,
                              cnt)
        da = torch.clamp(cnt - acc_cnt, 0.0, 3.0)
        half = torch.exp2(-40.0 * da)
        cmul = torch.where(da < 3.0, half * half, 0.0)
        M1, Y1 = z, z + torch.where(ii == 0, y0, 0.0)
        M1s = X1s = Y1s = M2s = X2s = Y2s = accb = z
        d0 = (k * w) // LONG_CHUNK * LONG_CHUNK
        for base in range(d0, d0 + sweep_chunks * LONG_CHUNK, unroll):
            # The writer's rows of this block, read before this strip
            # overwrites them, in the reader's frame.
            hin = halo[:, base:base + unroll].clone()
            g = torch.exp2(40.0 * torch.clamp(cnt - hin[3], -3.0, 1.0))
            if is0:
                g = torch.zeros_like(g)
            hMb, hXb, hYb = ((hin[j] * g) * g for j in range(3))
            for tt in range(unroll):
                d = base + tt
                hw = hap[anchor + k * w - d:anchor + k * w - d + w]
                match = (code == hw) | (hw == _N_CODE)
                p = torch.where(match, pm, qr)
                Mn = p * (mmv * M2s + gapm * (X2s + Y2s))
                Xn = M1s * qi + X1s * qg
                Yn = M1 * qd + Y1 * qg
                accb = accb + torch.where(rlmask & (d <= rlhl), Mn + Xn, 0.0)
                halo[0, d] = Mn[w - 1]
                halo[1, d] = Xn[w - 1]
                halo[2, d] = Yn[w - 1]
                M2s, X2s, Y2s = M1s, X1s, Y1s
                M1s = torch.where(row0, hMb[tt:tt + 1], _roll1(Mn))
                X1s = torch.where(row0, hXb[tt:tt + 1], _roll1(Xn))
                Y1s = torch.where(row0, hYb[tt:tt + 1], _roll1(Yn))
                M1, Y1 = Mn, Yn
            halo[3, base:base + unroll] = cnt
            acc = acc + accb * cmul
            accb = torch.zeros_like(accb)
            # The peak of the live window with the JAX masks, global rows.
            d = base + unroll - 1
            jv = d - ii
            v0 = (ii <= rl) & (jv >= 0) & (jv <= hl)
            jv1 = (d - 1) - (ii - 1)
            v1 = (ii >= 1) & (ii - 1 <= rl) & (jv1 >= 0) & (jv1 <= hl)
            jv2 = (d - 2) - (ii - 1)
            v2 = (ii >= 1) & (ii - 1 <= rl) & (jv2 >= 0) & (jv2 <= hl)
            live = torch.where(v0, torch.maximum(M1, Y1), 0.0)
            live = torch.maximum(live, torch.where(
                v1, torch.maximum(torch.maximum(M1s, X1s), Y1s), 0.0))
            live = torch.maximum(live, torch.where(
                v2, torch.maximum(torch.maximum(M2s, X2s), Y2s), 0.0))
            peak = live.amax(dim=0, keepdim=True)
            # A reader never runs deeper than its writer (strip 0 is the
            # frame of reference and rescales freely).
            lead_ok = (cnt < hin[3, unroll - 1:unroll]) | is0
            need = ((d <= rlhl + 1) & (peak > 0.0)
                    & (peak < PHMM_RESCALE_TRIGGER) & lead_ok)
            f = torch.where(need, PHMM_RESCALE_FACTOR, 1.0)
            follow = need & (acc.amax(dim=0, keepdim=True)
                             < PHMM_RESCALE_TRIGGER)
            M1, Y1, M1s, X1s, Y1s, M2s, X2s, Y2s = (
                torch.clamp_max(v * f, _LONG_CAP)
                for v in (M1, Y1, M1s, X1s, Y1s, M2s, X2s, Y2s))
            acc = acc * torch.where(follow, PHMM_RESCALE_FACTOR, 1.0)
            cmul = cmul * torch.where(need & ~follow,
                                      1.0 / PHMM_RESCALE_FACTOR, 1.0)
            cnt = cnt + torch.where(need, 1.0, 0.0)
            acc_cnt = acc_cnt + torch.where(follow, 1.0, 0.0)
    total = acc.sum(dim=0, keepdim=True)
    return (torch.log10(total) - acc_cnt * PHMM_RESCALE_LOG10
            - PHMM_INIT_LOG10)[0]
