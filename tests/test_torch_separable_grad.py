"""Port parity: B3's backward (`ops/cuda_kernels.py::SeparableConv3dFn`:
the fused forward, then `conv_axis` recomputes, `conv_axis_dw` and
`conv_axis_dx` axis by axis in reverse) against the JAX package.

`jax.vjp` cannot linearize a `pallas_call`, so the reference gradient is
`jax.vjp` of the XLA stack the JAX package trains the fader through: three
`ops.functional.conv3d` calls with (k,1,1)-, (1,k,1)- and (1,1,k)-shaped
weights, the convs of its `models/fader.py` layers; its forward is held
against the Pallas `separable_conv3d(interpret=True)` at the same inputs.
On the CPU the wrappers take their plain versions; the CUDA kernels run in
`tests/test_torch_cuda.py` and `chip_smoke.py`.

float32 on both sides, JAX at "highest" precision.  Tolerance: 1e-5 x
max|ref| per leaf, from summation order.  Also walked exactly here: the dx
kernel's tap mapping and the dw kernel's split plan, with integer-valued
data, so that every float sum is exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_tpu.ops import functional as JF
from mri_epilepsy_diagnosis_tpu.ops import pallas_kernels as JK

torch.set_num_threads(2)

REL_TOL = 1e-5
SPATIAL = (11, 10, 9)
C = 4


def _inputs(k, s, p, ci, with_bias, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *SPATIAL, ci)).astype(np.float32)
    ws = [(rng.normal(size=(k, cin, C)) / np.sqrt(k * cin)).astype(np.float32)
          for cin in (ci, C, C)]
    bs = [rng.normal(size=C).astype(np.float32) if with_bias else None
          for _ in range(3)]
    out = list(x.shape)
    for a in range(3):
        out[1 + a] = (out[1 + a] + 2 * p - k) // s + 1
    out[4] = C
    g = rng.normal(size=out).astype(np.float32)
    return x, ws, bs, g


def _jax_stack(x, wx, wy, wz, bx, by, bz, s, p):
    """The JAX package's XLA separable stack: each (k, Ci, Co) weight as a
    one-axis (kD, kH, kW, Ci, Co) conv3d weight."""
    y = x
    for a, (w, b) in enumerate(zip((wx, wy, wz), (bx, by, bz))):
        shape, stride, pad = [1, 1, 1], [1, 1, 1], [0, 0, 0]
        shape[a], stride[a], pad[a] = w.shape[0], s, p
        y = JF.conv3d(y, w.reshape(*shape, *w.shape[1:]), b,
                      stride=tuple(stride), padding=tuple(pad))
    return y


def _jax_grads(x, ws, bs, g, s, p):
    with jax.default_matmul_precision("highest"):
        args = [jnp.asarray(v) for v in (x, *ws)]
        if bs[0] is not None:
            args += [jnp.asarray(b) for b in bs]

            def f(x, wx, wy, wz, bx, by, bz):
                return _jax_stack(x, wx, wy, wz, bx, by, bz, s, p)
        else:
            def f(x, wx, wy, wz):
                return _jax_stack(x, wx, wy, wz, None, None, None, s, p)
        y, vjp = jax.vjp(f, *args)
        pallas = JK.separable_conv3d(
            *args[:4], stride=(s,) * 3, pad=(p,) * 3,
            biases=tuple(args[4:]) if bs[0] is not None else (None,) * 3,
            interpret=True)
        return np.asarray(y), np.asarray(pallas), [
            np.asarray(v) for v in vjp(jnp.asarray(g))]


def _torch_grads(fn, x, ws, bs, g):
    leaves = [torch.tensor(v, requires_grad=True) for v in (x, *ws)]
    biases = [None if b is None else torch.tensor(b, requires_grad=True)
              for b in bs]
    y = fn(leaves, biases)
    y.backward(torch.from_numpy(g))
    return y.detach(), [v.grad for v in leaves] + [
        b.grad for b in biases if b is not None]


def _fn(s, p):
    return lambda leaves, biases: K.SeparableConv3dFn.apply(
        *leaves, *biases, (s,) * 3, (p,) * 3)


def _assert_close(got, ref, what):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), (what, err,
                                                np.abs(ref).max())


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("ci", [1, 8])
@pytest.mark.parametrize("p", [0, 1, 2])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", [3, 6])
def test_separable_backward_matches_jax(k, s, p, ci, with_bias):
    x, ws, bs, g = _inputs(k, s, p, ci, with_bias, seed=k * 100 + s * 10 + p)
    ref_y, pallas_y, ref_grads = _jax_grads(x, ws, bs, g, s, p)
    _assert_close(pallas_y, ref_y, "pallas forward")
    y, grads = _torch_grads(_fn(s, p), x, ws, bs, g)
    _assert_close(y, ref_y, "forward")
    names = ["x", "wx", "wy", "wz", "bx", "by", "bz"]
    assert len(grads) == len(ref_grads)
    for name, got, ref in zip(names, grads, ref_grads):
        _assert_close(got, ref, name)


@pytest.mark.parametrize("k,s,p,ci", [(6, 2, 2, 1), (3, 1, 1, 8),
                                      (3, 1, 0, 8), (5, 1, 2, 8)])
def test_backward_matches_plain_autograd(k, s, p, ci):
    """The Function's backward equals autograd through the plain forward
    (`separable_conv3d_plain`), the version the card's kernels are held
    to."""
    x, ws, bs, g = _inputs(k, s, p, ci, True, seed=7 + k)

    def plain(leaves, biases):
        return K.separable_conv3d_plain(
            *leaves, stride=(s,) * 3, pad=(p,) * 3, biases=tuple(biases))

    y_ref, ref = _torch_grads(plain, x, ws, bs, g)
    y, got = _torch_grads(_fn(s, p), x, ws, bs, g)
    assert torch.equal(y, y_ref)
    for name, a, b in zip(["x", "wx", "wy", "wz", "bx", "by", "bz"], got,
                          ref):
        _assert_close(a.numpy(), b.numpy(), name)


@pytest.mark.parametrize("case,xg,wg,want", [
    # (recompute, dw, dx) calls, as the alternation's stacks make them.
    # The image (e0's input) and a latent under no_grad (the discriminator
    # in disc_step) take no gradient, but the weight gradients of the H
    # and D stages still need the cotangents of y2 and y1: two dx
    ("input_without_grad", False, (1, 1, 1), (2, 3, 2)),
    ("frozen_head", True, (0, 0, 0), (0, 0, 3)),   # the frozen disc
    ("all", True, (1, 1, 1), (2, 3, 3)),           # e1, e2, the classifier
    ("last_axis_only", False, (0, 0, 1), (2, 1, 0)),
])
def test_backward_prunes_by_needs_input_grad(monkeypatch, case, xg, wg,
                                             want):
    x, ws, bs, g = _inputs(6, 2, 2, 8, True, seed=3)
    calls = {"conv_axis": 0, "conv_axis_dw": 0, "conv_axis_dx": 0}
    for name in calls:
        fn = getattr(K, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(K, name, counted)
    xt = torch.tensor(x, requires_grad=xg)
    wt = [torch.tensor(w, requires_grad=bool(f)) for w, f in zip(ws, wg)]
    bt = [torch.tensor(b, requires_grad=bool(f)) for b, f in zip(bs, wg)]
    y = K.SeparableConv3dFn.apply(xt, *wt, *bt, (2,) * 3, (2,) * 3)
    y.backward(torch.from_numpy(g))
    assert (calls["conv_axis"], calls["conv_axis_dw"],
            calls["conv_axis_dx"]) == want, case
    assert (xt.grad is not None) == xg
    for t, f in zip(wt + bt, wg + wg):
        assert (t.grad is not None) == bool(f)


@pytest.mark.parametrize("length,k,s,p", [
    (192, 6, 2, 2), (13, 6, 2, 2), (12, 3, 1, 1), (3, 3, 1, 0), (7, 5, 1, 2),
    (10, 3, 2, 1), (9, 6, 2, 0), (11, 2, 2, 0), (8, 4, 3, 2)])
def test_dx_tap_walk_is_exact(length, k, s, p):
    """`conv_axis_dx_taps` (the kernel's loop) visits exactly the (t, j)
    with j * s + t - p == i, in rising t; evaluating dx through it with
    integer data equals the plain dx exactly."""
    lo = (length + 2 * p - k) // s + 1
    for i in range(length):
        brute = [(t, j) for t in range(k) for j in range(lo)
                 if j * s + t - p == i]
        assert K.conv_axis_dx_taps(i, lo, k, s, p) == brute
    rng = np.random.default_rng(length + k)
    g = rng.integers(-3, 4, size=(2, lo, 3, 4)).astype(np.float32)
    w = rng.integers(-3, 4, size=(k, 5, 4)).astype(np.float32)
    walked = np.zeros((2, length, 3, 5), np.float32)
    for i in range(length):
        for t, j in K.conv_axis_dx_taps(i, lo, k, s, p):
            walked[:, i] += g[:, j] @ w[t].T
    plain = K.conv_axis_dx_plain(torch.from_numpy(g[:, :, :, None]),
                                 torch.from_numpy(w), length=length, axis=1,
                                 stride=s, pad=p)[:, :, :, 0]
    np.testing.assert_array_equal(plain.numpy(), walked)


def _walk_dw_plan(x, g, k, s, p, plan):
    """The two passes of the dw kernel in numpy: each (chunk, tile, lane,
    output group) thread's row sums, the lanes summed in order, then the
    chunks in order.  Returns (dw, db, rows covered per (chunk, lane))."""
    a_n, length, b_n, ci = x.shape
    lo, co = g.shape[1], g.shape[3]
    rows = a_n * lo * b_n
    groups = co // plan.cot
    partials = np.zeros((plan.chunks, plan.nout))
    seen = np.zeros(rows, int)
    g_rows = g.reshape(rows, co)
    for chunk in range(plan.chunks):
        for lane in range(plan.lanes):
            r = np.arange(chunk * plan.rows_per_chunk + lane,
                          min(rows, (chunk + 1) * plan.rows_per_chunk),
                          plan.lanes)
            seen[r] += 1
            b, q = r % b_n, r // b_n
            j, a = q % lo, q // lo
            for tile in range(plan.tiles):
                for og_local in range(plan.og_block):
                    og = tile * plan.og_block + og_local
                    if og >= plan.og_total:
                        continue
                    cg, tci = og % groups, og // groups
                    ci_, t = tci % ci, tci // ci
                    sl = slice(cg * plan.cot, (cg + 1) * plan.cot)
                    l_ = j * s + t - p
                    ok = (l_ >= 0) & (l_ < length)
                    xv = np.where(ok, x[a, np.clip(l_, 0, length - 1), b,
                                        ci_], 0.0)
                    e = og * plan.cot
                    partials[chunk, e:e + plan.cot] += xv @ g_rows[r, sl]
                    if tci == 0:
                        e = k * ci * co + cg * plan.cot
                        partials[chunk, e:e + plan.cot] += g_rows[r, sl].sum(0)
    total = partials.sum(0)
    return (total[:k * ci * co].reshape(k, ci, co), total[k * ci * co:],
            seen)


@pytest.mark.parametrize("shape,k,s,p,co", [
    ((2, 13, 7, 1), 6, 2, 2, 8), ((3, 9, 5, 8), 3, 1, 1, 8),
    ((1, 3, 9, 32), 3, 1, 0, 64), ((2, 12, 3, 3), 5, 1, 2, 6),
    ((1, 5, 2, 2), 3, 2, 1, 3), ((4, 40, 30, 8), 6, 2, 2, 8)])
def test_dw_plan_walk_is_exact(shape, k, s, p, co):
    """Every row lands in exactly one (chunk, lane), every output group in
    one (tile, thread), the db groups in tile 0; a block holds at most 256
    threads; the two-pass sum equals the plain dw and db exactly for
    integer data."""
    a_n, length, b_n, ci = shape
    lo = (length + 2 * p - k) // s + 1
    rows = a_n * lo * b_n
    plan = K.conv_axis_dw_plan(rows, k, ci, co)
    assert plan.og_block * plan.lanes <= 256
    assert plan.tiles * plan.og_block >= plan.og_total > (
        plan.tiles - 1) * plan.og_block
    assert co // plan.cot <= plan.og_block          # db groups in tile 0
    assert plan.chunks * plan.rows_per_chunk >= rows > (
        plan.chunks - 1) * plan.rows_per_chunk
    assert plan.chunks == 1 or plan.chunks * plan.nout <= K._DW_MAX_PARTIALS
    rng = np.random.default_rng(rows)
    x = rng.integers(-3, 4, size=shape).astype(np.float64)
    g = rng.integers(-3, 4, size=(a_n, lo, b_n, co)).astype(np.float64)
    dw, db, seen = _walk_dw_plan(x, g, k, s, p, plan)
    assert (seen == 1).all()
    pdw, pdb = K.conv_axis_dw_plain(
        torch.tensor(x[:, :, :, None], dtype=torch.float32),
        torch.tensor(g[:, :, :, None], dtype=torch.float32), k=k, axis=1,
        stride=s, pad=p)
    np.testing.assert_array_equal(pdw.numpy(), dw)
    np.testing.assert_array_equal(pdb.numpy(), db)


def test_dw_plan_at_the_fader_sites():
    """The first encoder stage at batch 35 fills the card with one output
    tile; the discriminator head of the depth-6 AE (k 2, 512 -> 1024) with
    tiles, its partials held to the scratch limit."""
    e0 = K.conv_axis_dw_plan(35 * 96 * 192 * 192, 6, 1, 8)
    assert (e0.cot, e0.og_total, e0.tiles) == (8, 6, 1)
    assert e0.chunks == K._DW_BLOCKS
    disc = K.conv_axis_dw_plan(3 * 1 * 9, 2, 512, 1024)
    assert disc.tiles * disc.og_block >= 2 * 512 * 1024 // 8
    assert disc.chunks * disc.nout <= K._DW_MAX_PARTIALS


@pytest.mark.parametrize("case,match", [
    ("rank", "needs g"), ("length", "does not give"), ("channels",
                                                        "output channels"),
    ("device", "cpu or cuda")])
def test_dx_argument_checks(case, match):
    g = torch.zeros(1, 4, 5, 5, 3)
    w = torch.zeros(3, 2, 3)
    kw = dict(length=6, axis=1, stride=1, pad=0)
    if case == "rank":
        g = g[0]
    elif case == "length":
        kw["length"] = 7
    elif case == "channels":
        w = torch.zeros(3, 2, 4)
    else:
        g, w = g.to("meta"), w.to("meta")
    with pytest.raises(ValueError, match=match):
        K.conv_axis_dx(g, w, **kw)


@pytest.mark.parametrize("case,match", [
    ("rank", "needs x and g"), ("shape", "is not the output"),
    ("device", "cpu or cuda")])
def test_dw_argument_checks(case, match):
    x = torch.zeros(1, 6, 5, 5, 2)
    g = torch.zeros(1, 4, 5, 5, 3)
    if case == "rank":
        x = x[0]
    elif case == "shape":
        g = torch.zeros(1, 4, 5, 4, 3)
    elif case == "device":
        x, g = x.to("meta"), g.to("meta")
    with pytest.raises(ValueError, match=match):
        K.conv_axis_dw(x, g, k=3, axis=1)
