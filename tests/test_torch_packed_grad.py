"""Port parity: the gradients of the packed convs (`ops/packed.py::
Conv3Packed`, `Conv3PackedAs`) against `jax.vjp` of the JAX package's
`conv3_packed` / `conv3_packed_as` (its hand-rolled custom VJPs, f32 at
HIGHEST), and the pieces they are built from: the input gradient as B1 in
the other parity (`conv2_packed_dx`, here its plain version) and the
float32 weight gradient (`_dw_packed_qgroup`).

On the CPU every launch takes the kernel's plain version; the kernels'
own gradient checks are in `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_torch.ops import packed as TP
from mri_epilepsy_diagnosis_tpu.ops import packed as JP

torch.set_num_threads(2)

# f32 gradients: both sides sum the same products in another order
GRAD_TOL = 1e-5


def _close(got, ref, tol=GRAD_TOL):
    """max|got - ref| <= tol * max|ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.fixture(params=["sa", "as"])
def conv_case(request):
    """A packed conv of either parity with its JAX counterpart: input
    (2, 4|5, 5|6, 3|4, 24), weights (2,2,2,24,40), bias (5,), cotangent."""
    kind = request.param
    rng = np.random.default_rng(17 if kind == "sa" else 23)
    cells = (5, 6, 4) if kind == "sa" else (4, 5, 3)
    x = rng.normal(size=(2, *cells, 24)).astype(np.float32)
    wp = (rng.normal(size=(2, 2, 2, 24, 40)) / 12).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    jfn = JP.conv3_packed if kind == "sa" else JP.conv3_packed_as
    tfn = TP.conv3_packed if kind == "sa" else TP.conv3_packed_as
    out_cells = tuple(c - 1 if kind == "sa" else c + 1 for c in cells)
    g = rng.normal(size=(2, *out_cells, 40)).astype(np.float32)
    return kind, x, wp, bias, g, jfn, tfn


def test_packed_conv_grads_match_jax_vjp(conv_case):
    """dx, dw and the bias gradient of the port's autograd Function ==
    `jax.vjp` of the JAX function, and the forward too."""
    _, x, wp, bias, g, jfn, tfn = conv_case
    y_ref, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(wp),
                         jnp.asarray(bias))
    dx_ref, dw_ref, db_ref = vjp(jnp.asarray(g))
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, wp, bias))
    y = tfn(xt, wt, bt)
    y.backward(torch.from_numpy(g))
    _close(y.detach(), y_ref)
    _close(xt.grad, dx_ref)
    _close(wt.grad, dw_ref)
    _close(bt.grad, db_ref)
    assert wt.grad.dtype == bt.grad.dtype == torch.float32


def test_packed_conv_skips_dx_without_input_grad(conv_case):
    """The stem's case: an input that takes no gradient gets no dx launch,
    while the weights and bias still get theirs."""
    _, x, wp, bias, g, _, tfn = conv_case
    wt, bt = (torch.tensor(a, requires_grad=True) for a in (wp, bias))
    xt = torch.from_numpy(x)
    calls = []
    dx = K.conv2_packed_dx
    K.conv2_packed_dx = lambda *a, **kw: calls.append(1) or dx(*a, **kw)
    try:
        tfn(xt, wt, bt).backward(torch.from_numpy(g))
        assert not calls and wt.grad is not None and bt.grad is not None
        xt.requires_grad_(True)
        tfn(xt, wt, bt).backward(torch.from_numpy(g))
        assert len(calls) == 1
    finally:
        K.conv2_packed_dx = dx


def test_packed_conv_grads_with_non_contiguous_cotangent(conv_case):
    """grad_output may arrive as a strided view: the Function makes it
    contiguous before any launch."""
    _, x, wp, bias, g, _, tfn = conv_case
    g_t = torch.from_numpy(np.ascontiguousarray(np.swapaxes(g, 1, 3)))
    g_view = g_t.transpose(1, 3)
    assert not g_view.is_contiguous()
    grads = []
    for cot in (g_view, torch.from_numpy(g)):
        xt, wt = (torch.tensor(a, requires_grad=True) for a in (x, wp))
        tfn(xt, wt, torch.from_numpy(bias)).backward(cot)
        grads.append((xt.grad, wt.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("pad", [0, 1])
def test_conv2_packed_dx_is_the_input_gradient(pad):
    """B1 in the other parity with flipped, io-swapped weights is the
    gradient of `conv2_packed_plain` in its input (torch autograd)."""
    rng = np.random.default_rng(5 + pad)
    x = torch.tensor(rng.normal(size=(2, 4, 3, 5, 16)).astype(np.float32),
                     requires_grad=True)
    wp = torch.from_numpy(rng.normal(size=(2, 2, 2, 16, 24)).astype(
        np.float32))
    y = K.conv2_packed_plain(x, wp, pad=pad)
    g = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
    y.backward(g)
    got = K.conv2_packed_dx(g, wp, pad=pad)
    assert got.shape == x.shape
    _close(got, x.grad)
    torch.testing.assert_close(got, K.conv2_packed_dx_plain(g, wp, pad=pad),
                               rtol=0, atol=0)


def test_flipped_weights_layout():
    wp = torch.arange(2 * 2 * 2 * 3 * 4, dtype=torch.float32).reshape(
        2, 2, 2, 3, 4)
    wt = K.flipped_weights(wp)
    assert wt.shape == (2, 2, 2, 4, 3) and wt.is_contiguous()
    for qd, qh, qw in np.ndindex(2, 2, 2):
        assert torch.equal(wt[qd, qh, qw], wp[1 - qd, 1 - qh, 1 - qw].t())


@pytest.mark.parametrize("bad", [dict(pad=2), dict(wp=(2, 2, 8, 4)),
                                 dict(g=(2, 3, 3, 3, 12))])
def test_conv2_packed_dx_rejects_bad_arguments(bad):
    g = torch.zeros(bad.get("g", (2, 3, 3, 3, 8)))
    wp = torch.zeros(bad.get("wp", (2, 2, 2, 4, 8)))
    with pytest.raises(ValueError):
        K.conv2_packed_dx(g, wp, pad=bad.get("pad", 0))


def test_conv2_packed_dx_cpu_counts_nothing():
    g = torch.ones(1, 3, 3, 3, 8)
    wp = torch.ones(2, 2, 2, 4, 8)
    before = (K.conv2_packed.launches, K.conv2_packed_dx.launches,
              K.conv2_packed_dx.tc_launches)
    K.conv2_packed_dx(g, wp, pad=1)
    assert (K.conv2_packed.launches, K.conv2_packed_dx.launches,
            K.conv2_packed_dx.tc_launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_packed_qgroup_is_float32(dtype):
    """dw is float32 whatever the activations' dtype, equal to the f32
    einsum of the same (rounded) operands; JAX's `_dw_packed_qgroup` on
    f32 inputs agrees."""
    rng = np.random.default_rng(9)
    xpad = torch.from_numpy(rng.normal(size=(2, 5, 4, 6, 16)).astype(
        np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(2, 4, 3, 5, 8)).astype(
        np.float32)).to(dtype)
    got = TP._dw_packed_qgroup(xpad, g)
    assert got.dtype == torch.float32 and got.shape == (2, 2, 2, 16, 8)
    ref = torch.stack([torch.einsum(
        "ndhwi,ndhwo->io", xpad[:, qd:qd + 4, qh:qh + 3, qw:qw + 5].float(),
        g.float()) for qd, qh, qw in np.ndindex(2, 2, 2)]).reshape(
        2, 2, 2, 16, 8)
    _close(got, ref)
    if dtype == torch.float32:
        _close(got, JP._dw_packed_qgroup(jnp.asarray(xpad.numpy()),
                                         jnp.asarray(g.numpy())))


def test_packed_conv_weight_grad_dtype_follows_weights():
    """bf16 activations with float32 master weights: the forward runs in
    bf16, the weight and bias gradients come back in float32, the input
    gradient in bf16."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(1, 4, 4, 4, 16)).astype(np.float32)
                     ).to(torch.bfloat16).requires_grad_(True)
    w = torch.tensor((rng.normal(size=(2, 2, 2, 16, 16)) / 8).astype(
        np.float32), requires_grad=True)
    b = torch.zeros(2, requires_grad=True)
    y = TP.conv3_packed_as(x, w, b)
    assert y.dtype == torch.bfloat16
    y.float().square().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert w.grad.dtype == b.grad.dtype == torch.float32


def test_serving_forward_under_inference_mode_unchanged():
    """Under inference_mode the Functions are the plain forward: equal to
    `conv2_packed` itself."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, 4, 16)).astype(
        np.float32))
    w = torch.from_numpy(rng.normal(size=(2, 2, 2, 16, 8)).astype(
        np.float32))
    b = torch.from_numpy(rng.normal(size=(1,)).astype(np.float32))
    with torch.inference_mode():
        for fn, pad in ((TP.conv3_packed, 0), (TP.conv3_packed_as, 1)):
            got = fn(x, w, b)
            assert torch.equal(got, K.conv2_packed(
                x, w, TP.tile_channel_param(b), pad=pad))
