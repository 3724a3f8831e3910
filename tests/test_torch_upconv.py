"""Port parity: the composed decoder up branch of int8 serving
(`ops/packed.py`: `pack_upconv_weights`, `edge_pad_cells`,
`upconv_packed`, `upconv_fix_faces`) and the gradients of the explicit up
branch that training runs, against the JAX package on the CPU.

The same numpy inputs and weights go through both packages.  f32, JAX at
"highest" precision (this JAX build contracts float32 at bf16-level
precision by default, and `pack_upconv_weights`' einsum names none).
Tolerance: 1e-5 x max|ref| (float32 summation order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.ops import packed as TP
from mri_epilepsy_diagnosis_tpu.ops import packed as JP

torch.set_num_threads(2)

TOL = 1e-5                       # x max|ref|


def _close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), err


def _fine_kernel(rng, ci, co):
    """A fine kernel in JAX's (3, 3, 3, Ci, Co) layout and the port's
    (Co, Ci, 3, 3, 3)."""
    wj = rng.normal(size=(3, 3, 3, ci, co)).astype(np.float32)
    return wj, torch.from_numpy(np.ascontiguousarray(wj.transpose(4, 3, 0,
                                                                  1, 2)))


@pytest.fixture(scope="module")
def branch():
    """An up branch at 3 x 4 x 3 coarse cells (non-cubic), Ci 4, Co 3,
    with JAX's composed kernel, output and face-fixed output."""
    rng = np.random.default_rng(0)
    wj, wt = _fine_kernel(rng, 4, 3)
    x = rng.normal(size=(2, 3, 4, 3, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        wk = np.asarray(JP.pack_upconv_weights(jnp.asarray(wj)))
        y = np.asarray(JP.upconv_packed(jnp.asarray(x), jnp.asarray(wk)))
        fixed = np.asarray(JP.upconv_fix_faces(jnp.asarray(y), jnp.asarray(x),
                                               jnp.asarray(wj)))
    return wj, wt, x, wk, y, fixed


@pytest.mark.parametrize("ci,co", [(1, 2), (4, 3), (8, 16)])
def test_pack_upconv_weights_matches_jax(ci, co):
    wj, wt = _fine_kernel(np.random.default_rng(ci), ci, co)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JP.pack_upconv_weights(jnp.asarray(wj)))
    got = TP.pack_upconv_weights(wt)
    assert tuple(got.shape) == (5, 5, 5, 8 * ci, 8 * co)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("shape", [(2, 3, 4, 2, 16), (1, 2, 2, 2, 8)])
def test_edge_pad_cells_matches_jax(dtype, shape):
    """Any dtype, exactly: int8 goes through the pad and the plane writes
    unchanged (the int8 path edge-pads in int8)."""
    rng = np.random.default_rng(1)
    x = (rng.integers(-127, 128, size=shape) if dtype == np.int8
         else rng.normal(size=shape)).astype(dtype)
    got = TP.edge_pad_cells(torch.from_numpy(x))
    ref = np.asarray(JP.edge_pad_cells(jnp.asarray(x)))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_upconv_packed_matches_jax(branch):
    """The lhs-dilated conv as one transposed convolution == JAX's
    `lax.conv_general_dilated` form."""
    _, _, x, wk, y, _ = branch
    got = TP.upconv_packed(torch.from_numpy(x), torch.from_numpy(wk))
    _close(got.numpy(), y)


def test_upconv_fix_faces_matches_jax(branch):
    _, wt, x, _, y, fixed = branch
    got = TP.upconv_fix_faces(torch.from_numpy(y.copy()), torch.from_numpy(x),
                              wt)
    _close(got.numpy(), fixed)


def test_upconv_fix_faces_dequantizes_int8_planes(branch):
    """The int8 form: the boundary planes of int8 x are dequantized after
    slicing (`dequant_scale`), as JAX's int8 path runs it."""
    wj, wt, x, _, y, _ = branch
    x8 = np.random.default_rng(2).integers(-127, 128, size=x.shape).astype(
        np.int8)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JP.upconv_fix_faces(
            jnp.asarray(y), jnp.asarray(x8), jnp.asarray(wj),
            dequant_scale=jnp.float32(1.0)))
    got = TP.upconv_fix_faces(torch.from_numpy(y.copy()),
                              torch.from_numpy(x8), wt, dequant_scale=1.0)
    _close(got.numpy(), ref)


def test_composed_branch_equals_explicit_beneath_the_pads(branch):
    """Composed + face fixes == `upsample2_packed` + the aligned->shifted
    conv on every voxel that the decoder keeps (the shifted pads are
    zeroed after the block's activation either way)."""
    _, wt, x, wk, _, _ = branch
    xt = torch.from_numpy(x)
    composed = TP.upconv_fix_faces(TP.upconv_packed(xt, torch.from_numpy(wk)),
                                   xt, wt)
    explicit = TP.conv3_packed_as(TP.upsample2_packed(xt),
                                  TP.pack_weights2_as(wt))
    _close(TP.zero_shifted_pads(composed).numpy(),
           TP.zero_shifted_pads(explicit).numpy())


def test_explicit_up_branch_gradients_match_jax(branch):
    """dx and dw of the up branch the decoder trains,
    `conv3_packed_as(upsample2_packed(x), pack_weights2_as(w))`, against
    `jax.grad` of JAX's explicit form."""
    wj, wt, x, _, _, _ = branch
    xt = torch.from_numpy(x).requires_grad_()
    wtt = wt.clone().requires_grad_()
    y = TP.conv3_packed_as(TP.upsample2_packed(xt), TP.pack_weights2_as(wtt))
    g = np.random.default_rng(3).normal(size=tuple(y.shape)).astype(
        np.float32)

    def jloss(xx, ww):
        return jnp.sum(JP.conv3_packed_as(JP.upsample2_packed(xx),
                                          JP.pack_weights2_as(ww)) * g)

    with jax.default_matmul_precision("highest"):
        gx, gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(wj))
    (y * torch.from_numpy(g)).sum().backward()
    _close(xt.grad.numpy(), gx)
    _close(wtt.grad.numpy(), np.asarray(gw).transpose(4, 3, 0, 1, 2))
