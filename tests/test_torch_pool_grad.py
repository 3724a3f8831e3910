"""Port parity: the gradients of the port's `ops/functional.py::maxpool3d`
and `maxpool2d` at tied maxima against `jax.grad` of the JAX package's
`maxpool3d` and `maxpool2d`, exactly.

The inputs are small integers, so that most windows hold several equal
maxima, and the cotangents are integers, so that every sum is exact in
float32.  The JAX package gives the full cotangent to every tied maximum
of a non-overlapping block (`_maxpool3d_blocks`), composes k=4, s=2 as a
k=2 block pool and a k=2, s=1 `reduce_window`, and gives the gradient of
a `reduce_window` to the first maximum of each window."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_epilepsy_diagnosis_torch.ops import functional as TF
from mri_epilepsy_diagnosis_tpu.ops import functional as JF

# (input shape, kernel, stride): blocks, k=4 s=2 (even and odd extents),
# ragged floor mode, and overlapping windows
POOL3D_CASES = {
    "blocks_k2": ((2, 4, 6, 8, 3), 2, None),
    "blocks_k3": ((1, 6, 3, 9, 2), 3, None),
    "k4_s2": ((2, 8, 8, 8, 2), 4, 2),
    "k4_s2_odd": ((1, 9, 10, 7, 2), 4, 2),
    "ragged_k2": ((1, 5, 7, 6, 2), 2, None),
    "ragged_k3": ((1, 7, 8, 9, 2), 3, None),
    "overlap_k3_s2": ((1, 7, 7, 7, 2), 3, 2),
}
POOL2D_CASES = {
    "k2": ((2, 6, 22, 4), 2, None, 0),
    "ragged_k2": ((1, 7, 9, 3), 2, None, 0),
    "k3_s2_pad1": ((1, 7, 9, 3), 3, 2, 1),
}


def _tied(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, size=shape).astype(np.float32)


def _port_vjp(fn, x, g):
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    y.backward(torch.tensor(g))
    return y.detach().numpy(), xt.grad.numpy()


def _jax_vjp(fn, x, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("case", list(POOL3D_CASES))
def test_maxpool3d_grad_matches_jax_at_ties(case):
    shape, k, s = POOL3D_CASES[case]
    x = _tied(shape, len(case))
    y_ref = np.asarray(JF.maxpool3d(jnp.asarray(x), k, s))
    g = np.random.default_rng(7).integers(
        -3, 4, size=y_ref.shape).astype(np.float32)
    y_ref, dx_ref = _jax_vjp(lambda v: JF.maxpool3d(v, k, s), x, g)
    y, dx = _port_vjp(lambda v: TF.maxpool3d(v, k, s), x, g)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(dx, dx_ref)


@pytest.mark.parametrize("case", list(POOL2D_CASES))
def test_maxpool2d_grad_matches_jax_at_ties(case):
    shape, k, s, p = POOL2D_CASES[case]
    x = _tied(shape, len(case))
    y_ref = np.asarray(JF.maxpool2d(jnp.asarray(x), k, s, p))
    g = np.random.default_rng(8).integers(
        -3, 4, size=y_ref.shape).astype(np.float32)
    y_ref, dx_ref = _jax_vjp(lambda v: JF.maxpool2d(v, k, s, p), x, g)
    y, dx = _port_vjp(lambda v: TF.maxpool2d(v, k, s, p), x, g)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(dx, dx_ref)


@pytest.mark.parametrize("shape,k,s,total", [((1, 4, 4, 4, 1), 2, None, 64),
                                             ((1, 8, 8, 8, 1), 4, 2, 216)])
def test_all_zero_input_gradient_sums(shape, k, s, total):
    """On an all-zero volume every element of a block is a maximum: at
    k=2 each of the 64 voxels takes its block's cotangent; at k=4, s=2 the
    27 outputs select the first inner block of each window, and each of
    those 27 blocks passes its cotangent to all 8 voxels (216, where
    torch's own `F.max_pool3d` gives 27)."""
    x = np.zeros(shape, np.float32)
    _, dx = _port_vjp(lambda v: TF.maxpool3d(v, k, s).sum(), x,
                      np.float32(1.0))
    assert dx.sum() == total
    _, dx_ref = _jax_vjp(lambda v: JF.maxpool3d(v, k, s).sum(), x,
                         np.float32(1.0))
    np.testing.assert_array_equal(dx, dx_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_pool_keeps_dtype_and_forward(dtype):
    """The block pool's forward is the reshape-and-max it was, and its
    gradient keeps the input's dtype."""
    x = torch.randn(2, 4, 6, 8, 3, generator=torch.Generator().manual_seed(0)
                    ).to(dtype).requires_grad_(True)
    y = TF.maxpool3d(x, 2)
    ref = x.detach().reshape(2, 2, 2, 3, 2, 4, 2, 3).amax(dim=(2, 4, 6))
    assert torch.equal(y.detach(), ref)
    y.sum().backward()
    assert x.grad.dtype == dtype
    assert x.grad.sum().item() == y.numel()


POOL3D_PADDED = {"k2s2p1": ((2, 5, 6, 7, 3), 2, 2, 1),
                 "k3s2p1": ((1, 7, 6, 5, 2), 3, 2, 1),
                 "k3s1p1": ((1, 5, 4, 6, 2), 3, 1, 1),
                 "k4s2p2": ((1, 6, 7, 5, 2), 4, 2, 2)}


@pytest.mark.parametrize("case", list(POOL3D_PADDED))
def test_maxpool3d_padding_matches_jax_at_ties(case):
    """`maxpool3d(..., padding)`: values and `jax.grad` of JAX's
    `maxpool3d` (a -inf-padded `reduce_window`) on tied integer inputs,
    exactly; the gradient goes to the first maximum of each window."""
    shape, k, s, p = POOL3D_PADDED[case]
    x = _tied(shape, len(case))
    y_ref = np.asarray(JF.maxpool3d(jnp.asarray(x), k, s, p))
    g = np.random.default_rng(9).integers(
        -3, 4, size=y_ref.shape).astype(np.float32)
    y_ref, dx_ref = _jax_vjp(lambda v: JF.maxpool3d(v, k, s, p), x, g)
    y, dx = _port_vjp(lambda v: TF.maxpool3d(v, k, s, p), x, g)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(dx, dx_ref)


@pytest.mark.parametrize("case", list(POOL3D_PADDED))
def test_maxpool3d_padding_keeps_integer_dtypes(case):
    """An integer pool pads with the dtype's minimum, as `reduce_window`
    does, and stays in its dtype (int8: the quantized path's packed
    activations); its values are JAX's float pool's.  JAX's own int8
    padded pool refuses its int32 init value, hence the float
    reference."""
    shape, k, s, p = POOL3D_PADDED[case]
    x = np.random.default_rng(10).integers(-128, 128,
                                           size=shape).astype(np.int8)
    got = TF.maxpool3d(torch.from_numpy(x), k, s, p)
    ref = np.asarray(JF.maxpool3d(jnp.asarray(x.astype(np.float32)), k, s,
                                  p))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int8))
