"""B3's backward on tensor cores (`csrc/conv_axis_bwd_tc.cu`): the tile
plans of `conv_axis_dw` and `conv_axis_dx` for bfloat16, and their route.

The kernels run only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).  Here each plan is walked with torch the way the kernel
walks it: the same staged rows (parity classes, zero fill), the same
16 x 16 MMA operands gathered row by row from them, the same warp tiles,
slots and stores, on integer-valued inputs so that every float sum is
exact and the walk must equal `conv_axis_dw_plain` / `conv_axis_dx_plain`
bit for bit.  One case is also held against JAX's gradient of its XLA
one-axis conv (`jax.vjp`), the function the JAX package trains through."""
import itertools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_tpu.ops import functional as JF

torch.set_num_threads(2)

SMEM = 232448                  # shared memory one H100 block may use
MAX_PARTIALS = 1 << 24         # floats of dw scratch


def _view(shape, axis):
    """(a, l, b) of a channels-last (N, D, H, W, C) shape along `axis`."""
    return (math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:4]))


def _ints(rng, shape):
    return torch.from_numpy(rng.integers(-3, 4, size=shape).astype(
        np.float32))


def _dw_plan(xshape, co, k, s, p, axis):
    a, l, b = _view(xshape, axis)
    lo = (l + 2 * p - k) // s + 1
    return K.conv_axis_dw_tc_plan(a, l, lo, b, xshape[4], co, k, s, p)


def _dx_plan(gshape, ci, length, k, s, p, axis):
    a, lo, b = _view(gshape, axis)
    return K.conv_axis_dx_tc_plan(a, length, lo, b, ci, gshape[4], k, s, p)


def _kernel_view(t, P, length):
    """t (N, D, H, W, C) as the kernel reads it under plan P: (a, length,
    b, C), or with the plan's swap (1, length, a, C) of the (a, length, 1,
    C) view."""
    if P.swap:
        return t.reshape(P.b, length, 1, t.shape[-1]).permute(2, 1, 0, 3)
    return t.reshape(P.a, length, P.b, t.shape[-1])


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------


def walk_dw(x, g, P, bias):
    """conv_axis_dw_tc.cu's two passes over x (a, l, B, Ci) and g (a, lo,
    B, Co): per block the staged slab and g tile of each row tile, the
    m16 x k16 operands of each warp's k-steps, its stores into its slot,
    then the slots summed in order.  Returns (dw, db or None)."""
    slots = torch.full((P.slots, P.nout), float("nan"), dtype=torch.float64)
    written = torch.zeros((P.slots, P.nout), dtype=torch.int64)
    cg8 = max(1, P.cit // 8)
    mg_total = P.k if P.ci1 else P.k * cg8
    assert P.wm * P.fm >= P.mt and P.wn * P.fn * 8 == P.cot
    assert P.wm * P.wn * P.wk == 8 and (P.jn * P.bt) % 16 == 0
    for chunk, mtile, ntile in itertools.product(
            range(P.chunks), range(P.mtiles), range(P.ntiles)):
        ci0, co0 = mtile * P.cit, ntile * P.cot
        acc = {}
        for tile in range(chunk * P.tpc, min(P.tiles, (chunk + 1) * P.tpc)):
            bi, rem = tile % P.btiles, tile // P.btiles
            jt, a = rem % P.jtiles, rem // P.jtiles
            j0, b0 = jt * P.jn, bi * P.bt
            lbase = j0 * P.s - P.p
            # the staged x slab: row (class, idx[, bb]), l = lbase + idx s +
            # class, zero outside x
            if P.ci1:
                xs = torch.zeros((P.s * P.nlc, P.xpitch), dtype=torch.float64)
                for r in range(P.s * P.nlc):
                    cls, q = r // P.nlc, (r % P.nlc) * P.s + r // P.nlc
                    lv = lbase + q
                    if q < P.nl and 0 <= lv < P.l:
                        seg = x[a, lv, b0:b0 + P.bt, 0]
                        xs[r, :len(seg)] = seg.double()
            else:
                xs = torch.zeros((P.s * P.nlc * P.bt, P.cit),
                                 dtype=torch.float64)
                for r in range(xs.shape[0]):
                    bb, ri = r % P.bt, r // P.bt
                    cls = ri // P.nlc
                    q = (ri % P.nlc) * P.s + cls
                    lv = lbase + q
                    if q < P.nl and 0 <= lv < P.l and b0 + bb < P.b:
                        seg = x[a, lv, b0 + bb, ci0:ci0 + P.cit]
                        xs[r, :len(seg)] = seg.double()
            gs = torch.zeros((P.jn * P.bt, P.cot), dtype=torch.float64)
            for r in range(gs.shape[0]):
                jj, bb = divmod(r, P.bt)
                if j0 + jj < P.lo and b0 + bb < P.b:
                    seg = g[a, j0 + jj, b0 + bb, co0:co0 + P.cot]
                    gs[r, :len(seg)] = seg.double()
            for step in range(P.jn * P.bt // 16):
                kg = step % P.wk
                kk0 = step * 16
                bmat = gs[kk0:kk0 + 16]
                for wmi in range(P.wm):
                    for f in range(P.fm):
                        m16 = wmi * P.fm + f
                        if m16 >= P.mt:
                            break
                        amat = torch.zeros((16, 16), dtype=torch.float64)
                        for m, kidx in itertools.product(range(16), range(16)):
                            r = kk0 + kidx
                            jj, bb = divmod(r, P.bt)
                            if P.ci1:
                                t = m16 * 16 + m
                                if t >= P.k:
                                    continue
                                q = jj * P.s + t
                                row = (q % P.s) * P.nlc + q // P.s
                                amat[m, kidx] = xs[row, bb]
                            else:
                                mg = 2 * m16 + m // 8
                                if mg >= mg_total:
                                    mg = 0
                                t, cgi = divmod(mg, cg8)
                                q = jj * P.s + t
                                row = ((q % P.s) * P.nlc + q // P.s) * P.bt + bb
                                amat[m, kidx] = xs[row, cgi * 8 + m % 8]
                        key = (kg, m16)
                        acc[key] = acc.get(key, 0) + amat @ bmat
                if bias:
                    key = (kg, "db")
                    acc[key] = acc.get(key, 0) + bmat.sum(0)
        # the stores: each warp writes its tiles' live entries in its slot
        for kg in range(P.wk):
            slot = chunk * P.wk + kg
            for wmi, wni in itertools.product(range(P.wm), range(P.wn)):
                cols = range(wni * P.fn * 8, (wni + 1) * P.fn * 8)
                for f in range(P.fm):
                    m16 = wmi * P.fm + f
                    if m16 >= P.mt:
                        break
                    tile = acc.get((kg, m16), torch.zeros(16, P.cot,
                                                          dtype=torch.float64))
                    for m in range(16):
                        mm = m16 * 16 + m
                        if P.ci1:
                            t, ci = mm, 0
                            if t >= P.k:
                                continue
                        else:
                            mg = mm // 8
                            if mg >= mg_total:
                                continue
                            t = mg // cg8
                            ci = ci0 + (mg % cg8) * 8 + mm % 8
                            if ci >= P.ci:
                                continue
                        for n in cols:
                            co = co0 + n
                            if co < P.co:
                                e = (t * P.ci + ci) * P.co + co
                                slots[slot, e] = tile[m, n]
                                written[slot, e] += 1
                if bias and mtile == 0 and wmi == 0:
                    db = acc.get((kg, "db"), torch.zeros(P.cot,
                                                         dtype=torch.float64))
                    for n in cols:
                        if co0 + n < P.co:
                            e = P.k * P.ci * P.co + co0 + n
                            slots[slot, e] = db[n]
                            written[slot, e] += 1
    nw = P.k * P.ci * P.co
    n = P.nout if bias else nw
    assert bool((written[:, :n] == 1).all()), "an entry written != once"
    total = slots[0, :n].clone()
    for c in range(1, P.slots):
        total += slots[c, :n]
    dw = total[:nw].reshape(P.k, P.ci, P.co).float()
    return dw, (total[nw:].float() if bias else None)


def walk_dx(g, w, P):
    """conv_axis_dx_tc.cu over g (a, lo, B, Co) and w (k, Ci, Co): per
    block and tile, the staged g rows and weights of each co-chunk, the
    m16 x k16 operands of each warp's class taps, and the stores, each
    output once.  Returns dx (a, l, B, Ci) in float32."""
    dx = torch.full((P.a, P.l, P.b, P.ci), float("nan"), dtype=torch.float64)
    written = torch.zeros(dx.shape, dtype=torch.int64)
    classes = K.conv_axis_dx_classes(P.k, P.s, P.p)
    rows_c = P.u * P.bt
    S = P.cok // 8
    assert P.wm * P.wn == 8 and P.wn * P.fn * 8 == P.cit
    assert P.wm * P.fm >= P.mt and rows_c % 16 == 0 and P.in_ == P.s * P.u
    for blk, ctile in itertools.product(range(P.blocks), range(P.ctiles)):
        ci0 = ctile * P.cit
        for tile in range(blk * P.tpb, min(P.tiles, (blk + 1) * P.tpb)):
            bi, rem = tile % P.btiles, tile // P.btiles
            it, a = rem % P.itiles, rem // P.itiles
            i0, b0 = it * P.in_, bi * P.bt
            acc = torch.zeros((P.mt * 16, P.cit), dtype=torch.float64)
            for cs in range(P.kst):
                co0 = cs * P.cok
                gs = torch.zeros((P.ng * P.bt, P.cok), dtype=torch.float64)
                for r in range(gs.shape[0]):
                    jr, bb = divmod(r, P.bt)
                    j = i0 // P.s + P.jb + jr
                    if 0 <= j < P.lo and b0 + bb < P.b:
                        seg = g[a, j, b0 + bb, co0:co0 + P.cok]
                        gs[r, :len(seg)] = seg.double()
                ws = torch.zeros((P.k * P.cit, P.cok), dtype=torch.float64)
                for r in range(ws.shape[0]):
                    t, cl = divmod(r, P.cit)
                    if ci0 + cl < P.ci:
                        seg = w[t, ci0 + cl, co0:co0 + P.cok]
                        ws[r, :len(seg)] = seg.double()
                nq = min(S, (P.co - co0 + 7) // 8)
                for wmi, wni in itertools.product(range(P.wm), range(P.wn)):
                    for f in range(P.fm):
                        m16 = wmi * P.fm + f
                        if m16 >= P.mt:
                            break
                        c = m16 * 16 // rows_c
                        tc, cp, nv = classes[c]
                        nk8 = nv * nq
                        for ks in range((nk8 + 1) // 2):
                            amat = torch.zeros((16, 16), dtype=torch.float64)
                            bmat = torch.zeros((16, P.fn * 8),
                                               dtype=torch.float64)
                            for half in range(2):
                                k8 = 2 * ks + half
                                if k8 >= nk8:
                                    continue   # the zero row
                                v, cc = divmod(k8, nq)
                                t = tc + P.s * v
                                for m in range(16):
                                    mr = m16 * 16 + m - c * rows_c
                                    u, bb = divmod(mr, P.bt)
                                    row = (u + cp - v - P.jb) * P.bt + bb
                                    assert 0 <= row < P.ng * P.bt
                                    amat[m, half * 8:half * 8 + 8] = gs[
                                        row, cc * 8:cc * 8 + 8]
                                for n in range(P.fn * 8):
                                    wrow = (t * P.cit + wni * P.fn * 8 + n)
                                    bmat[half * 8:half * 8 + 8, n] = ws[
                                        wrow, cc * 8:cc * 8 + 8]
                            cols = slice(wni * P.fn * 8, (wni + 1) * P.fn * 8)
                            acc[m16 * 16:m16 * 16 + 16, cols] += amat @ bmat
            for m in range(P.mt * 16):
                c, r = divmod(m, rows_c)
                u, bb = divmod(r, P.bt)
                i, b = i0 + c + P.s * u, b0 + bb
                if i >= P.l or b >= P.b:
                    continue
                n = min(P.cit, P.ci - ci0)
                dx[a, i, b, ci0:ci0 + n] = acc[m, :n]
                written[a, i, b, ci0:ci0 + n] += 1
    assert bool((written == 1).all()), "an output written != once"
    return dx.float()


# ---------------------------------------------------------------------------
# the walks at ragged shapes
# ---------------------------------------------------------------------------

# (N, D, H, W) small and ragged; Ci in {1, 8}; Co not a tile multiple
RAGGED = [(ci, co, k, s, p, axis)
          for ci, co in ((1, 12), (8, 3), (8, 20))
          for k, s, p in ((3, 1, 1), (6, 2, 2), (2, 2, 0), (3, 1, 0))
          for axis in (1, 2, 3)]


def _ragged_case(ci, co, k, s, p, axis, seed):
    rng = np.random.default_rng(seed)
    shape = [1, 7, 6, 9]
    if ci == 8 and co == 20:
        shape[0] = 2
    x = _ints(rng, (*shape, ci))
    lo = (shape[axis] + 2 * p - k) // s + 1
    gshape = list(shape)
    gshape[axis] = lo
    g = _ints(rng, (*gshape, co))
    w = _ints(rng, (k, ci, co))
    return x, g, w


@pytest.mark.parametrize("ci, co, k, s, p, axis", RAGGED)
def test_dw_plan_walk_equals_plain(ci, co, k, s, p, axis):
    x, g, _ = _ragged_case(ci, co, k, s, p, axis, seed=axis + 10 * k)
    P = _dw_plan(tuple(x.shape), co, k, s, p, axis)
    ref_w, ref_b = K.conv_axis_dw_plain(x, g, k=k, axis=axis, stride=s,
                                        pad=p, bias=True)
    got_w, got_b = walk_dw(_kernel_view(x, P, P.l),
                           _kernel_view(g, P, P.lo), P, bias=True)
    assert torch.equal(got_w, ref_w)
    assert torch.equal(got_b, ref_b)


@pytest.mark.parametrize("ci, co, k, s, p, axis", RAGGED)
def test_dx_plan_walk_equals_plain(ci, co, k, s, p, axis):
    x, g, w = _ragged_case(ci, co, k, s, p, axis, seed=7 + axis + 10 * k)
    length = x.shape[axis]
    P = _dx_plan(tuple(g.shape), ci, length, k, s, p, axis)
    ref = K.conv_axis_dx_plain(g, w, length=length, axis=axis, stride=s,
                               pad=p)
    got = walk_dx(_kernel_view(g, P, P.lo), w, P)
    assert torch.equal(_kernel_view(ref, P, length), got)


@pytest.mark.parametrize("which, blocks", [("dw", 12), ("dx", 4)])
def test_walks_split_the_work_across_chunks_and_tiles(which, blocks,
                                                      monkeypatch):
    """The ragged cases fit one chunk or block: shrink the block target so
    the walks cross chunks (dw slots summed in order), tiles per block and
    several M, N and K tiles (Ci 72, Co 136: cit 64 x 2, cot 64 x 3, cok
    128 x 2)."""
    monkeypatch.setattr(K, "_TC_BLOCKS", blocks)
    monkeypatch.setattr(K, "_TC_DW_BLOCKS", blocks)
    monkeypatch.setattr(K, "_TC_STAGE_BYTES", 4096)
    rng = np.random.default_rng(5)
    x = _ints(rng, (1, 33, 3, 4, 72))
    g = _ints(rng, (1, 33, 3, 4, 136))
    w = _ints(rng, (3, 72, 136))
    if which == "dw":
        P = _dw_plan(tuple(x.shape), 136, 3, 1, 1, 1)
        assert P.chunks > 1 and P.tpc > 1 and P.mtiles == 2
        assert P.ntiles == 3
        ref_w, ref_b = K.conv_axis_dw_plain(x, g, k=3, axis=1, stride=1,
                                            pad=1)
        got_w, got_b = walk_dw(_kernel_view(x, P, P.l),
                               _kernel_view(g, P, P.lo), P, True)
        assert torch.equal(got_w, ref_w) and torch.equal(got_b, ref_b)
    else:
        P = _dx_plan(tuple(g.shape), 72, 33, 3, 1, 1, 1)
        assert P.blocks > 1 and P.tpb > 1 and P.ctiles == 2 and P.kst == 2
        ref = K.conv_axis_dx_plain(g, w, length=33, axis=1, stride=1, pad=1)
        got = walk_dx(_kernel_view(g, P, P.lo), w, P)
        assert torch.equal(_kernel_view(ref, P, 33), got)


def test_walks_match_jax_vjp():
    """The walks' dw, db and dx against `jax.vjp` of the JAX package's XLA
    one-axis conv (float32, "highest"), at a stride-2 H stage."""
    rng = np.random.default_rng(3)
    k, s, p, axis, ci, co = 6, 2, 2, 2, 8, 12
    x = rng.normal(size=(1, 5, 10, 4, ci)).astype(np.float32)
    w = (rng.normal(size=(k, ci, co)) / np.sqrt(k * ci)).astype(np.float32)
    b = rng.normal(size=co).astype(np.float32)
    shape, stride, pad = [1, 1, 1], [1, 1, 1], [0, 0, 0]
    shape[axis - 1], stride[axis - 1], pad[axis - 1] = k, s, p

    def f(xx, ww, bb):
        return JF.conv3d(xx, ww.reshape(*shape, ci, co), bb,
                         stride=tuple(stride), padding=tuple(pad))

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    g = rng.normal(size=y.shape).astype(np.float32)
    jdx, jdw, jdb = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    xt, gt, wt = (torch.from_numpy(v) for v in (x, g, w))
    P = _dw_plan(x.shape, co, k, s, p, axis)
    dw, db = walk_dw(_kernel_view(xt, P, P.l), _kernel_view(gt, P, P.lo), P,
                     True)
    Q = _dx_plan(g.shape, ci, x.shape[axis], k, s, p, axis)
    dx = walk_dx(_kernel_view(gt, Q, Q.lo), wt, Q)
    jdx = _kernel_view(torch.tensor(jdx), Q, x.shape[axis]).numpy()
    for got, ref in ((dw, jdw), (db, jdb), (dx, jdx)):
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the plans at the real sites
# ---------------------------------------------------------------------------

# (x shape, axis, k, s, p, Co) of every B3 backward site: the fader
# alternation at batch 35 (e0, e1, e2, the heads) and `examples/
# train_ae.py`'s AE at batch 3 (its stages at 192^3 .. 6^3, the
# decoder's 512-wide stage, the 16 -> 1 output, the 2^3/s2 disc)
FADER_SITES = [
    ((35, 192, 192, 192, 1), 1, 6, 2, 2, 8),
    ((35, 96, 192, 192, 8), 2, 6, 2, 2, 8),
    ((35, 96, 96, 192, 8), 3, 6, 2, 2, 8),
    ((35, 48, 48, 48, 8), 1, 6, 2, 2, 16),
    ((35, 24, 48, 48, 16), 2, 6, 2, 2, 16),
    ((35, 24, 24, 48, 16), 3, 6, 2, 2, 16),
    ((35, 12, 12, 12, 16), 1, 6, 2, 2, 32),
    ((35, 6, 12, 12, 32), 2, 6, 2, 2, 32),
    ((35, 6, 6, 12, 32), 3, 6, 2, 2, 32),
    ((35, 3, 3, 3, 32), 1, 3, 1, 0, 64),
    ((35, 1, 3, 3, 64), 2, 3, 1, 0, 64),
    ((35, 1, 1, 3, 64), 3, 3, 1, 0, 64),
]
AE_SITES = [((3, n, n, n, ci), axis, 3, 1, 1, co)
            for n, c_in, c_out in ((192, 1, 16), (96, 16, 32), (48, 32, 64),
                                   (24, 64, 128), (12, 128, 256),
                                   (6, 256, 512))
            for axis, ci, co in ((1, c_in, c_out), (2, c_out, c_out),
                                 (3, c_out, c_out))] + [
    ((3, 6, 6, 6, 512), 1, 3, 1, 1, 256),
    ((3, 192, 192, 192, 16), 3, 3, 1, 1, 1),
    ((3, 3, 3, 3, 512), 1, 2, 2, 0, 1024),
    ((3, 1, 3, 3, 1024), 2, 2, 2, 0, 1024),
]
SITES = FADER_SITES + AE_SITES


def _out_shape(xshape, axis, k, s, p, co):
    out = list(xshape)
    out[axis] = (xshape[axis] + 2 * p - k) // s + 1
    out[4] = co
    return tuple(out)


@pytest.mark.parametrize("site", SITES, ids=lambda s: f"{s[0]}-{s[1]}")
def test_dw_plan_at_real_sites(site):
    xshape, axis, k, s, p, co = site
    P = _dw_plan(xshape, co, k, s, p, axis)
    assert P.smem <= SMEM and 2 <= P.stages <= 5
    assert P.tiles < 2 ** 31 and P.mtiles <= 65535 and P.ntiles <= 65535
    assert P.slots * P.nout <= MAX_PARTIALS
    assert P.wm * P.wn * P.wk == 8 and P.wm * P.fm >= P.mt
    assert P.wn * P.fn * 8 == P.cot and P.fn in (1, 2, 4)
    assert P.fm in ((1,) if P.ci1 else (1, 2, 3, 4))
    assert (P.jn * P.bt) % 16 == 0 and P.chunks * P.tpc >= P.tiles
    assert (P.chunks - 1) * P.tpc < P.tiles       # no empty chunk
    assert P.ci1 == (xshape[4] == 1)
    # the halo costs at most a quarter more x rows than the j range needs,
    # unless one tile spans the whole range or b tiles are down to 16
    assert (4 * (P.nl - P.jn * P.s) <= P.jn * P.s or P.jtiles == 1
            or P.bt <= 16)
    # enough blocks to fill the card where the rows allow it
    assert (P.chunks * P.mtiles * P.ntiles >= 132
            or P.chunks == P.tiles or P.slots * 2 * P.nout > MAX_PARTIALS)


@pytest.mark.parametrize("site", SITES, ids=lambda s: f"{s[0]}-{s[1]}")
def test_dx_plan_at_real_sites(site):
    xshape, axis, k, s, p, co = site
    gshape = _out_shape(xshape, axis, k, s, p, co)
    P = _dx_plan(gshape, xshape[4], xshape[axis], k, s, p, axis)
    assert P.smem <= SMEM and 2 <= P.stages <= 5
    assert P.tiles * P.kst < 2 ** 31 and P.ctiles <= 65535
    assert P.in_ < 32768
    assert P.wm * P.wn == 8 and P.wm * P.fm >= P.mt
    assert P.fm in (1, 2, 4, 8) and P.fn in (1, 2, 4) and P.fm * P.fn <= 8
    assert P.wn * P.fn * 8 == P.cit and P.kst * P.cok >= co
    assert (P.u * P.bt) % 16 == 0 and P.blocks * P.tpb >= P.tiles
    assert (P.blocks - 1) * P.tpb < P.tiles
    # at the encoder's strided stages a warp's m16 tiles share one class
    # (the kernel's faster path)
    assert (site not in FADER_SITES or P.s == 1
            or (P.u * P.bt // 16) % P.fm == 0)
    # every class's g rows lie in the staged window
    for tc, cp, nv in K.conv_axis_dx_classes(k, s, p):
        if nv:
            assert cp - (nv - 1) - P.jb >= 0
            assert cp + P.u - 1 - P.jb < P.ng


def test_e0_plans():
    """e0's sites, the fader's widest: Ci = 1 stages x as rows of b (one
    m16 tile of the 6 taps), the Co = 8 stages take one n8 tile, and the
    8 warps split the k-steps."""
    d = _dw_plan((35, 192, 192, 192, 1), 8, 6, 2, 2, 1)
    assert (d.ci1, d.mt, d.cot, d.wk, d.fm, d.fn) == (1, 1, 8, 8, 1, 1)
    h = _dw_plan((35, 96, 192, 192, 8), 8, 6, 2, 2, 2)
    assert (h.ci1, h.mt, h.wk, h.fm, h.fn) == (0, 3, 8, 3, 1)
    x = _dx_plan((35, 96, 96, 192, 8), 8, 192, 6, 2, 2, 2)
    assert (x.cit, x.cok, x.kst, x.wm, x.fn) == (8, 8, 1, 8, 1)


@pytest.mark.parametrize("dtype, w_dtype, route", [
    (torch.bfloat16, None, "tc"), (torch.bfloat16, torch.bfloat16, "tc"),
    (torch.bfloat16, torch.float32, "cuda_core"),
    (torch.float32, None, "cuda_core"),
    (torch.float32, torch.float32, "cuda_core")])
def test_route(dtype, w_dtype, route):
    assert K._axis_bwd_route(dtype, w_dtype) == route


def test_counters_reset():
    K.conv_axis_dw.tc_launches = K.conv_axis_dx.tc_launches = 3
    K.reset_launch_counts()
    assert K.conv_axis_dw.tc_launches == K.conv_axis_dx.tc_launches == 0
