"""Kernel B3 fused (`csrc/separable_conv3d.cu`): the port's
`separable_conv3d` against the JAX package's `separable_conv3d` (Pallas in
interpret mode, Precision.HIGHEST), and what its wrapper computes in
Python: the route of every served stack, the tile plan (coverage, halo,
shared memory), and the plan walked with torch the way the kernel walks
it, tile by tile through shared-memory intermediates.

The kernel itself runs only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).  The walk uses integer-valued float32 data, so every
product and sum is exact in any order: it must equal the plain version
bit for bit.  Against JAX: 1e-5 x max|ref| in float32."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.models import fader as TFd
from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_tpu.ops import pallas_kernels as JK

torch.set_num_threads(2)

# (x extents, Ci, C, k, stride, pad) of the four stacks of the served
# fader encoder and Classificator at 192^3 (the reference's kwargs)
SERVED = {"e0": ((192, 192, 192), 1, 8, 6, 2, 2),
          "e1": ((48, 48, 48), 8, 16, 6, 2, 2),
          "e2": ((12, 12, 12), 16, 32, 6, 2, 2),
          "clf": ((3, 3, 3), 32, 64, 3, 1, 0)}
# (k, stride, pad): the DownBlock, the UpBlocks and the conv head
GEOMETRIES = [(6, 2, 2), (3, 1, 1), (5, 1, 2), (3, 1, 0)]


def _plan(n, extents, ci, c, k, s, p, dtype):
    return K.separable_plan(n, extents, (ci, c, c, c), (k,) * 3, (s,) * 3,
                            (p,) * 3, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("site", list(SERVED))
def test_served_stacks_take_the_fused_route(site, dtype):
    extents, ci, c, k, s, p = SERVED[site]
    plan = _plan(8, extents, ci, c, k, s, p, dtype)
    assert K._separable_route(dtype, plan) == "fused"
    assert plan.smem <= K._SEP_SMEM_TARGET <= 232448
    for o, t, n_t, halo in zip(plan.out, plan.tile, plan.tiles, plan.halo):
        assert (n_t - 1) * t < o <= n_t * t          # covers, no idle tile
        assert halo == (t - 1) * s + k
    assert plan.grid == 8 * int(np.prod(plan.tiles))
    # tensor cores for the bf16 stages with Cin and Cout multiples of 8
    want = (tuple(cin % 8 == 0 for cin in (ci, c, c))
            if dtype == torch.bfloat16 else (False,) * 3)
    assert plan.mma == want


def test_e0_tile():
    """At e0 the whole 4 x 8 x 16 tile fits: 12 x 20 x 36 input cells,
    staged as rows of 48 two-byte cells (whole 16-byte copy units, room
    for a lead of up to 7 cells: 23 KB), 46 KB after D, and 18 KB after H
    over the input."""
    plan = _plan(8, (192,) * 3, 1, 8, 6, 2, 2, torch.bfloat16)
    assert plan.out == (96, 96, 96)
    assert plan.tile == (4, 8, 16) and plan.halo == (12, 20, 36)
    assert plan.off_y1 == 12 * 20 * 48 * 2
    assert plan.off_w - plan.off_y1 == 4 * 20 * 36 * 8 * 2


@pytest.mark.parametrize("dtype,ci,c,route", [
    (torch.bfloat16, 1, 8, "fused"), (torch.float32, 64, 64, "fused"),
    (torch.float32, 512, 512, "per_axis"), (torch.float16, 8, 8,
                                            "per_axis")])
def test_route_rule(dtype, ci, c, route):
    """Fused wherever a tile fits one block's shared memory (even 1x1x1
    at k = 6 needs 216 x 512 x 4 bytes of input for 512 f32 channels),
    and only for the dtypes the kernel takes."""
    plan = _plan(2, (20, 20, 20), ci, c, 6, 2, 2, dtype)
    assert K._separable_route(dtype, plan) == route


def test_route_does_not_depend_on_the_build(monkeypatch):
    """The route is a function of dtype and shape: with a build that
    fails it is the same, and the failure raises (no fallback)."""
    plan = _plan(8, (48,) * 3, 8, 16, 6, 2, 2, torch.bfloat16)
    before = K._separable_route(torch.bfloat16, plan)

    def broken():
        raise RuntimeError("nvcc failed")

    K.load.cache_clear()
    monkeypatch.setattr(K, "build", broken)
    try:
        assert K._separable_route(torch.bfloat16, plan) == before == "fused"
        with pytest.raises(RuntimeError, match="nvcc failed"):
            K.load()
    finally:
        K.load.cache_clear()


def _walk(x, ws, bs, ks, ss, ps, plan):
    """The fused kernel's computation in torch: per tile, the zero-filled
    input halo, the D stage into y1, zeroed outside the volume in H and W,
    the H stage into y2, zeroed outside it in W, the W stage, and the
    cells inside the output stored.  Also returns how often each output
    cell was stored."""
    n, dims = x.shape[0], x.shape[1:4]
    (td, th, tw), (ld, lh, lw) = plan.tile, plan.halo
    out = torch.zeros(n, *plan.out, ws[2].shape[2])
    stores = torch.zeros(n, *plan.out, dtype=torch.int64)
    m = max(plan.halo)
    xz = torch.nn.functional.pad(x, (0, 0) + (m, m) * 3)
    for b in range(n):
        for tz in range(plan.tiles[0]):
            for ty in range(plan.tiles[1]):
                for tx in range(plan.tiles[2]):
                    o0 = (tz * td, ty * th, tx * tw)
                    i0 = [o * s - p for o, s, p in zip(o0, ss, ps)]
                    v = xz[b:b + 1, m + i0[0]:m + i0[0] + ld,
                           m + i0[1]:m + i0[1] + lh,
                           m + i0[2]:m + i0[2] + lw]
                    for axis in range(3):
                        v = K.conv_axis_plain(v, ws[axis], bs[axis],
                                              axis=axis + 1,
                                              stride=ss[axis])
                        # cells outside the volume along the axes still
                        # to be convolved are the next stages' zero pad
                        for a in range(axis + 1, 3):
                            g = i0[a] + torch.arange(v.shape[1 + a])
                            keep = (g >= 0) & (g < dims[a])
                            shape = [1, 1, 1, 1, 1]
                            shape[1 + a] = -1
                            v = v * keep.view(shape)
                    e = [min(t, o - s0) for t, o, s0 in
                         zip(plan.tile, plan.out, o0)]
                    out[b, o0[0]:o0[0] + e[0], o0[1]:o0[1] + e[1],
                        o0[2]:o0[2] + e[2]] = v[0, :e[0], :e[1], :e[2]]
                    stores[b, o0[0]:o0[0] + e[0], o0[1]:o0[1] + e[1],
                           o0[2]:o0[2] + e[2]] += 1
    return out, stores


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ci,c", [(1, 8), (8, 16), (32, 32)])
@pytest.mark.parametrize("k,s,p", GEOMETRIES)
def test_plan_walk_equals_plain(k, s, p, ci, c, dtype):
    """Walking the plan (of the bf16 or f32 kernel: their tiles differ)
    covers every output cell once and reproduces the plain version
    exactly.  The extents give 5 x 9 x 17 output cells: ragged against
    every tile."""
    rng = np.random.default_rng(k * 100 + ci * 10 + c)
    extents = [(o - 1) * s + k - 2 * p for o in (5, 9, 17)]
    x = torch.from_numpy(rng.integers(-2, 3, (2, *extents, ci))).float()
    ws = [torch.from_numpy(rng.integers(-2, 3, (k, cin, c))).float()
          for cin in (ci, c, c)]
    bs = [torch.from_numpy(rng.integers(-2, 3, c)).float(), None,
          torch.from_numpy(rng.integers(-2, 3, c)).float()]
    plan = _plan(2, extents, ci, c, k, s, p, dtype)
    assert plan.out == (5, 9, 17)
    got, stores = _walk(x, ws, bs, (k,) * 3, (s,) * 3, (p,) * 3, plan)
    assert torch.equal(stores, torch.ones_like(stores))
    ref = K.separable_conv3d_plain(x, *ws, stride=(s,) * 3, pad=(p,) * 3,
                                   biases=tuple(bs))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("k,s,p", GEOMETRIES)
def test_separable_conv3d_matches_jax(k, s, p, with_bias):
    """The port's `separable_conv3d` (its plain version on the CPU) ==
    JAX's `separable_conv3d(interpret=True)`, Ci = 1 like the encoder's
    first stack."""
    rng = np.random.default_rng(k * 10 + s + with_bias)
    x = rng.normal(size=(1, 10, 8, 12, 1)).astype(np.float32)
    ws = [rng.normal(size=(k, ci, 8)).astype(np.float32) for ci in (1, 8, 8)]
    bs = ([rng.normal(size=(8,)).astype(np.float32) for _ in range(3)]
          if with_bias else [None] * 3)
    kw = dict(stride=(s,) * 3, pad=(p,) * 3)
    got = K.separable_conv3d(
        torch.from_numpy(x), *map(torch.from_numpy, ws), **kw,
        biases=tuple(None if b is None else torch.from_numpy(b) for b in bs))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JK.separable_conv3d(
            jnp.asarray(x), *map(jnp.asarray, ws), **kw,
            biases=tuple(None if b is None else jnp.asarray(b) for b in bs),
            interpret=True))
    assert tuple(got.shape) == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def test_fader_calls_separable_once_per_stack():
    """The encoder and the head reach B3 through one `separable_conv3d`
    call per stack, never through `conv_one_axis`."""
    torch.manual_seed(0)
    enc = TFd.make_encoder(dict(
        c_in=1, deapth=2, c_base=8, inc_size=2, down_block_kwargs=dict(
            conv_k=6, conv_pad=2, conv_s=2, maxpool_k=2, maxpool_s=2)),
        device="cpu").eval()
    calls = {"stack": 0, "axis": 0}
    stack, axis = K.separable_conv3d, K.conv_one_axis

    def rec_stack(*a, **kw):
        calls["stack"] += 1
        return stack(*a, **kw)

    def rec_axis(*a, **kw):
        calls["axis"] += 1
        return axis(*a, **kw)

    K.separable_conv3d, K.conv_one_axis = rec_stack, rec_axis
    try:
        with torch.no_grad():
            z, _ = enc(torch.zeros(1, 32, 32, 32, 1))
    finally:
        K.separable_conv3d, K.conv_one_axis = stack, axis
    assert z.shape == (1, 2, 2, 2, 16)
    assert calls == {"stack": 2, "axis": 0}


@pytest.mark.parametrize("case,match", [
    ("rank", "needs x"), ("chain", "channel chain"), ("short", "does not "
                                                       "take"),
    ("bias", "bias must"), ("device", "cpu or cuda")])
def test_separable_argument_checks(case, match):
    x = torch.zeros(1, 6, 6, 6, 2)
    ws = [torch.zeros(3, 2, 4), torch.zeros(3, 4, 4), torch.zeros(3, 4, 4)]
    kw = {}
    if case == "rank":
        x = x[0]
    elif case == "chain":
        ws[1] = torch.zeros(3, 5, 4)
    elif case == "short":
        ws[0] = torch.zeros(9, 2, 4)
    elif case == "bias":
        kw["biases"] = (torch.zeros(3), None, None)
    else:
        x, ws = x.to("meta"), [w.to("meta") for w in ws]
    with pytest.raises(ValueError, match=match):
        K.separable_conv3d(x, *ws, **kw)
