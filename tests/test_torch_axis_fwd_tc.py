"""B3's one-axis conv on tensor cores (`csrc/conv_axis_tc.cu`): the tile
plan of `conv_axis` for bfloat16 x and w, and its route.

The kernel runs only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).  Here the plan is walked with torch the way the kernel
walks it: the same staged rows (parity classes, zero fill, the Ci = 1
rows of b), the same 16 x 16 MMA operands gathered from them and from
the staged weights, the same K chunks, N tiles and stores, on
integer-valued inputs so that every float sum is exact and the walk must
equal `conv_axis_plain` bit for bit.  One case is also held against the
JAX package's Pallas `conv_one_axis` in interpret mode."""
import itertools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_tpu.ops import pallas_kernels as JK
from test_torch_axis_bwd_tc import AE_SITES, FADER_SITES, _kernel_view, \
    _view

torch.set_num_threads(2)

SMEM = 232448                  # shared memory one H100 block may use


def _ints(rng, shape):
    return torch.from_numpy(rng.integers(-3, 4, size=shape).astype(
        np.float64))


def _plan(xshape, co, k, s, p, axis):
    a, l, b = _view(xshape, axis)
    lo = (l + 2 * p - k) // s + 1
    return K.conv_axis_tc_plan(a, l, lo, b, xshape[4], co, k, s, p)


def _tapoff(t, P):
    """The staged row (class, idx) of tap t at j = 0."""
    return (t % P.s) * P.nlc + t // P.s


def walk_dense(x, w, bias, P):
    """The Co = 1 path of conv_axis_tc.cu: thread (a, j, b group: 8
    consecutive b with Ci = 1, one cell otherwise) sums, tap by tap, its
    cells' Ci products, each output once."""
    assert P.co == 1 and not P.tma and not P.bulk
    out = torch.full((P.a, P.lo, P.b, 1), float("nan"), dtype=torch.float64)
    written = torch.zeros(out.shape, dtype=torch.int64)
    cells = 8 if P.ci1 and not P.swap else 1
    bgroups = -(-P.b // cells)
    for g in range(P.a * P.lo * bgroups):
        rem, b0 = divmod(g, bgroups)
        a, j = divmod(rem, P.lo)
        b0 *= cells
        nb = min(cells, P.b - b0)
        acc = torch.zeros(nb, dtype=torch.float64) + (
            0 if bias is None else bias[0])
        for t in range(P.k):
            lv = j * P.s + t - P.p
            if 0 <= lv < P.l:
                acc += x[a, lv, b0:b0 + nb] @ w[t, :, 0]
        out[a, j, b0:b0 + nb, 0] = acc
        written[a, j, b0:b0 + nb, 0] += 1
    assert bool((written == 1).all()), "an output written != once"
    return out.float()


def walk_fwd(x, w, bias, P):
    """conv_axis_tc.cu over x (a, l, B, Ci) and w (k, Ci, Co), float64:
    per block and N tile, each tile's staged slab and weights of every K
    chunk, the m16 x k16 operands of each warp's steps, and the stores,
    each output once (Co = 1: `walk_dense`).  Returns out (a, lo, B, Co)
    in float32."""
    if P.dense:
        return walk_dense(x, w, bias, P)
    out = torch.full((P.a, P.lo, P.b, P.co), float("nan"),
                     dtype=torch.float64)
    written = torch.zeros(out.shape, dtype=torch.int64)
    S = max(1, P.cik // 8)
    mrows = P.jn * P.bt
    assert P.wm * P.wn == 8 and P.wn * P.fn * 8 == P.cot
    assert P.wm * P.fm * 16 >= mrows and mrows % 16 == 0
    assert P.kst * P.cik >= P.ci and P.nl == (P.jn - 1) * P.s + P.k
    m_all = torch.arange(mrows)
    jj_all, bb_all = m_all // P.bt, m_all % P.bt
    for blk, ntile in itertools.product(range(P.blocks), range(P.ntiles)):
        co0 = ntile * P.cot
        for tile in range(blk * P.tpb, min(P.tiles, (blk + 1) * P.tpb)):
            bi, rem = tile % P.btiles, tile // P.btiles
            jt, a = rem % P.jtiles, rem // P.jtiles
            j0, b0 = jt * P.jn, bi * P.bt
            lbase = j0 * P.s - P.p
            acc = torch.zeros((mrows, P.cot), dtype=torch.float64)
            for cs in range(P.kst):
                ci0 = cs * P.cik
                # the slab: row (class, idx[, bb]) holds l = lbase + idx s +
                # class, zero outside x
                rows = P.s * P.nlc
                xs = torch.zeros((rows, P.xpitch) if P.ci1
                                 else (rows * P.bt, P.cik),
                                 dtype=torch.float64)
                for r in range(rows):
                    cls, q = r // P.nlc, (r % P.nlc) * P.s + r // P.nlc
                    lv = lbase + q
                    if not (q < P.nl and 0 <= lv < P.l):
                        continue
                    seg = x[a, lv, b0:b0 + P.bt, ci0:ci0 + P.cik]
                    if P.ci1:
                        xs[r, :seg.shape[0]] = seg[:, 0]
                    else:
                        xs[r * P.bt:r * P.bt + seg.shape[0],
                           :seg.shape[1]] = seg
                # the weights: rows (t, ci - ci0) of cot channels
                ws = torch.zeros((P.k * P.cik, P.cot), dtype=torch.float64)
                for r in range(P.k * P.cik):
                    t, cl = divmod(r, P.cik)
                    if ci0 + cl < P.ci:
                        seg = w[t, ci0 + cl, co0:co0 + P.cot]
                        ws[r, :seg.shape[0]] = seg
                if P.ci1:
                    # one k16 step: K row t is tap t (zero past k); A[m, t]
                    # = column bb of slab row jj + tapoff(t)
                    steps = [[(t, 0) if t < P.k else None for t in range(16)]]
                else:
                    nq = min(S, -(-(P.ci - ci0) // 8))
                    groups = [divmod(g, nq) for g in range(P.k * nq)]
                    groups += [None] * (len(groups) % 2)
                    steps = [[grp for grp in groups[i:i + 2]]
                             for i in range(0, len(groups), 2)]
                for step in steps:
                    amat = torch.zeros((mrows, 16), dtype=torch.float64)
                    bmat = torch.zeros((16, P.cot), dtype=torch.float64)
                    for kk, g in enumerate(step):
                        if g is None:
                            continue          # the zero row
                        t, c = g
                        if P.ci1:
                            amat[:, kk] = xs[jj_all + _tapoff(t, P), bb_all]
                            bmat[kk] = ws[t]
                        else:
                            rows_a = m_all + _tapoff(t, P) * P.bt
                            amat[:, kk * 8:kk * 8 + 8] = xs[
                                rows_a, c * 8:c * 8 + 8]
                            bmat[kk * 8:kk * 8 + 8] = ws[
                                t * P.cik + c * 8:t * P.cik + c * 8 + 8]
                    # each warp's m16 x n8 tiles
                    for wmi, wni in itertools.product(range(P.wm),
                                                      range(P.wn)):
                        cols = slice(wni * P.fn * 8, (wni + 1) * P.fn * 8)
                        for f in range(P.fm):
                            m16 = wmi * P.fm + f
                            if m16 >= P.mt:
                                break
                            rs = slice(m16 * 16, m16 * 16 + 16)
                            acc[rs, cols] += amat[rs] @ bmat[:, cols]
            # the stores, bias added
            n = min(P.cot, P.co - co0)
            bv = (torch.zeros(n, dtype=torch.float64) if bias is None
                  else bias[co0:co0 + n])
            for m in range(mrows):
                j, b = j0 + int(jj_all[m]), b0 + int(bb_all[m])
                if j < P.lo and b < P.b:
                    out[a, j, b, co0:co0 + n] = acc[m, :n] + bv
                    written[a, j, b, co0:co0 + n] += 1
    assert bool((written == 1).all()), "an output written != once"
    return out.float()


def _check_walk(x, w, bias, k, s, p, axis):
    P = _plan(tuple(x.shape), w.shape[2], k, s, p, axis)
    ref = K.conv_axis_plain(x.float(), w.float(),
                            None if bias is None else bias.float(),
                            axis=axis, stride=s, pad=p)
    got = walk_fwd(_kernel_view(x, P, P.l), w, bias, P)
    assert torch.equal(_kernel_view(ref, P, P.lo), got)
    return P


# ---------------------------------------------------------------------------
# the walk at ragged shapes
# ---------------------------------------------------------------------------

# Ci, Co in {1, 8, 20}; (k, s, p): the AE's k3/s1/p1, the encoder's
# k6/s2/p2, the disc's k2/s2/p0, a k3/s2/p1 with an odd halo, every axis
RAGGED = [(ci, co, k, s, p, axis)
          for ci, co in itertools.product((1, 8, 20), (1, 8, 20))
          for k, s, p in ((3, 1, 1), (6, 2, 2), (2, 2, 0), (3, 2, 1))
          for axis in (1, 2, 3)]


@pytest.mark.parametrize("ci, co, k, s, p, axis", RAGGED)
def test_fwd_plan_walk_equals_plain(ci, co, k, s, p, axis):
    rng = np.random.default_rng(axis + 10 * k + 100 * ci + 1000 * co)
    shape = (2 if ci == 20 else 1, 7, 6, 9)
    x = _ints(rng, (*shape, ci))
    w = _ints(rng, (k, ci, co))
    bias = _ints(rng, (co,)) if (ci + co + axis) % 2 else None
    P = _check_walk(x, w, bias, k, s, p, axis)
    assert P.ci1 == (ci == 1) and P.dense == (co == 1)


def test_fwd_walk_splits_k_chunks_n_tiles_and_blocks(monkeypatch):
    """The ragged cases fit one K chunk, N tile and block: shrink the
    block target, the M tile, the K chunk and the N tile so the walk
    crosses K chunks (weights through the ring), N tiles, j tiles and
    tiles per block (Ci 72 in chunks of 16, Co 40 in tiles of 16), with a
    stride-2 halo."""
    monkeypatch.setattr(K, "_TC_BLOCKS", 6)
    monkeypatch.setattr(K, "_FWD_MROWS", 48)
    monkeypatch.setattr(K, "_FWD_CIK", 16)
    monkeypatch.setattr(K, "_FWD_COT", 16)
    rng = np.random.default_rng(5)
    x = _ints(rng, (1, 33, 3, 4, 72))
    w = _ints(rng, (6, 72, 40))
    bias = _ints(rng, (40,))
    P = _check_walk(x, w, bias, 6, 2, 2, 1)
    assert P.kst == 5 and P.ntiles == 3 and P.jtiles > 1
    assert P.tpb > 1 and P.blocks > 1


def test_fwd_walk_swaps_the_last_axis():
    """Along W (b = 1) a tile takes bt consecutive a, each a row of l."""
    rng = np.random.default_rng(6)
    x = _ints(rng, (2, 3, 5, 11, 8))
    w = _ints(rng, (3, 8, 8))
    P = _check_walk(x, w, None, 3, 1, 1, 3)
    assert P.swap == 1 and P.a == 1 and P.b == 30


def test_fwd_walk_matches_jax_conv_one_axis():
    """The walk against the JAX package's Pallas `conv_one_axis`
    (interpret mode, float32, "highest"), at the encoder's stride-2 H
    stage with its bias."""
    rng = np.random.default_rng(3)
    k, s, p, axis, ci, co = 6, 2, 2, 2, 8, 12
    x = rng.normal(size=(1, 5, 10, 4, ci)).astype(np.float32)
    w = (rng.normal(size=(k, ci, co)) / np.sqrt(k * ci)).astype(np.float32)
    b = rng.normal(size=co).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JK.conv_one_axis(
            jnp.asarray(x), jnp.asarray(w), axis, stride=s, pad=p,
            bias=jnp.asarray(b), interpret=True))
    P = _plan(x.shape, co, k, s, p, axis)
    got = walk_fwd(_kernel_view(torch.from_numpy(x).double(), P, P.l),
                   torch.from_numpy(w).double(), torch.from_numpy(b).double(),
                   P)
    ref = _kernel_view(torch.from_numpy(ref), P, P.lo).numpy()
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the plans at the real sites
# ---------------------------------------------------------------------------

# the one-axis convs that the fader alternation and the AE step launch:
# the backward sites of tests/test_torch_axis_bwd_tc.py as forward calls
SITES = FADER_SITES + AE_SITES


@pytest.mark.parametrize("site", SITES, ids=lambda s: f"{s[0]}-{s[1]}")
def test_fwd_plan_at_real_sites(site):
    xshape, axis, k, s, p, co = site
    P = _plan(xshape, co, k, s, p, axis)
    assert P.smem <= SMEM and 2 <= P.stages <= 5
    assert P.smem == K._fwd_smem(
        K._fwd_x_bytes(P.jn, P.bt, k, s, P.cik, P.xpitch),
        2 * k * P.cik * P.cot, P.kst, P.stages, 2 * P.jn * P.bt * P.cot, k,
        P.tma)
    assert P.tiles * P.kst < 2 ** 31 and P.ntiles <= 65535
    assert P.wm * P.wn == 8 and P.wm * P.fm * 16 >= P.jn * P.bt
    assert P.fm in (1, 2, 4, 8) and P.fn in (1, 2, 4) and P.fm * P.fn <= 8
    assert P.wn * P.fn * 8 == P.cot and (P.jn * P.bt) % 16 == 0
    assert P.ci1 == (xshape[4] == 1) and not (P.ci1 and P.swap)
    # every output exactly once: the tiles cover j, b and Co, each block
    # takes tiles, no block is empty
    assert P.jtiles * P.jn >= P.lo > (P.jtiles - 1) * P.jn
    assert P.btiles * P.bt >= P.b > (P.btiles - 1) * P.bt
    assert P.ntiles * P.cot >= co > (P.ntiles - 1) * P.cot
    assert P.kst * P.cik >= xshape[4]
    assert P.blocks * P.tpb >= P.tiles > (P.blocks - 1) * P.tpb
    # TMA boxes: at most 256 a dimension, 16-byte strides, class boxes at
    # their swizzle span; bulk stores: whole unswapped rows of all Co
    if P.tma:
        assert P.nlc * s <= 256 and P.bt <= 256 and P.xpitch <= 256
        assert (P.b % 8 == 0) if P.ci1 else (
            xshape[4] % 8 == 0 and P.bt % 8 == 0)
    if P.bulk:
        assert not P.swap and (co == P.cot <= 16 or co == 1 and (
            P.bt % 8 == P.b % 8 == 0))


@pytest.mark.parametrize("site", FADER_SITES[:2], ids=["e0-D", "e0-H"])
def test_e0_plans(site):
    """e0's recomputes, the fader's widest: Ci = 1 stages dense rows of b,
    Ci = 8 one 8-channel K group a tap; Co = 8 is one n8 tile; the grid
    is at least two waves of the H100's 132 SMs."""
    xshape, axis, k, s, p, co = site
    P = _plan(xshape, co, k, s, p, axis)
    assert (P.cot, P.fn, P.wn, P.kst, P.ntiles) == (8, 1, 1, 1, 1)
    assert P.cik == (1 if xshape[4] == 1 else 8)
    assert P.blocks * P.ntiles >= 2 * 132
    assert P.xpitch % 64 != 0 if P.ci1 else P.xpitch == 0
    assert P.tma and P.bulk


@pytest.mark.parametrize("dtype, w_dtype, route", [
    (torch.bfloat16, torch.bfloat16, "tc"),
    (torch.bfloat16, torch.float32, "cuda_core"),
    (torch.float32, torch.bfloat16, "cuda_core"),
    (torch.float32, torch.float32, "cuda_core")])
def test_route(dtype, w_dtype, route):
    assert K._axis_fwd_route(dtype, w_dtype) == route


def test_counters_reset():
    K.conv_axis.launches = K.conv_axis.tc_launches = 3
    K.reset_launch_counts()
    assert K.conv_axis.launches == K.conv_axis.tc_launches == 0


def test_ci1_rows_keep_taps_off_one_bank():
    """Ci = 1 rows are never a multiple of 128 bytes apart."""
    for bt in (1, 8, 9, 16, 32, 48, 64):
        pitch = K._ci1_pitch(bt)
        assert pitch >= bt and pitch % 8 == 0 and (2 * pitch) % 128


# (name, batch, extent, channels (Cin, C, C, C), k, stride, pad) of the
# fader alternation's stacks (encoder blocks and heads, batch 35) and of
# the depth-6 AE step's (encoder, decoder, disc head; batch 3)
FADER_STACKS = [("e0", 35, 192, (1, 8, 8, 8), 6, 2, 2),
                ("e1", 35, 48, (8, 16, 16, 16), 6, 2, 2),
                ("e2", 35, 12, (16, 32, 32, 32), 6, 2, 2),
                ("head", 35, 3, (32, 64, 64, 64), 3, 1, 0)]
AE_STACKS = [(f"ae.{n}.{ci}", 3, n, (ci, co, co, co), 3, 1, 1)
             for n, ci, co in ((192, 1, 16), (96, 16, 32), (48, 32, 64),
                               (24, 64, 128), (12, 128, 256),
                               (6, 256, 512), (6, 512, 256),
                               (12, 256, 128), (24, 128, 64),
                               (48, 64, 32), (96, 32, 16), (192, 16, 1))] + [
    ("ae.disc", 3, 3, (512, 1024, 1024, 1024), 2, 2, 0)]


@pytest.mark.parametrize("stack", FADER_STACKS + AE_STACKS,
                         ids=lambda s: s[0])
def test_separable_route_at_fader_and_ae_stacks(stack):
    """bf16 stacks of 64 input channels and more, and those with one
    output channel, take three tensor-core `conv_axis` launches, the
    others (every fader stack) the fused kernel; float32 stays fused
    wherever its plan fits."""
    _, n, size, chans, k, s, p = stack
    plan = K.separable_plan(n, (size,) * 3, chans, (k,) * 3, (s,) * 3,
                            (p,) * 3, torch.bfloat16)
    want = "per_axis" if chans[0] >= 64 or chans[3] == 1 else "fused"
    assert K._separable_route(torch.bfloat16, plan) == want
    plan32 = K.separable_plan(n, (size,) * 3, chans, (k,) * 3, (s,) * 3,
                              (p,) * 3, torch.float32)
    assert K._separable_route(torch.float32, plan32) == (
        "fused" if plan32 is not None else "per_axis")
