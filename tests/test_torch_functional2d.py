"""Port parity: the 2-D ops of `ops/functional.py` that PatchModel runs
(`conv2d`, `dense`) against the JAX package's, channels-last, with the
port's weights in torch's layouts ((O, I / groups, kH, kW), (out, in))
and JAX's in its own ((kH, kW, I / groups, O), (in, out)).  float32, JAX
at "highest" precision; tolerance 1e-5 x max|ref| (summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_epilepsy_diagnosis_torch.ops import functional as TF
from mri_epilepsy_diagnosis_tpu.ops import functional as JF

# (N, H, W, Ci, Co, k, stride, padding, dilation, groups)
CONV2D_CASES = [(2, 16, 32, 2, 16, 3, 1, 0, 1, 1),
                (1, 9, 11, 4, 6, 3, 2, 1, 1, 1),
                (2, 12, 10, 4, 8, 3, 1, 2, 2, 2),
                (1, 7, 8, 3, 5, 1, 1, 0, 1, 1)]


@pytest.mark.parametrize("case", CONV2D_CASES)
def test_conv2d_matches_jax(case):
    n, h, w, ci, co, k, s, p, d, g = case
    rng = np.random.default_rng(sum(case))
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    wt = rng.normal(size=(co, ci // g, k, k)).astype(np.float32)
    b = rng.normal(size=co).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JF.conv2d(jnp.asarray(x),
                                   jnp.asarray(wt.transpose(2, 3, 1, 0)),
                                   jnp.asarray(b), stride=s, padding=p,
                                   dilation=d, groups=g))
    got = TF.conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                    torch.from_numpy(b), stride=s, padding=p, dilation=d,
                    groups=g).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_matches_jax(bias, dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 3, 64)).astype(np.float32)
    wt = rng.normal(size=(7, 64)).astype(np.float32)
    b = rng.normal(size=7).astype(np.float32) if bias else None
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JF.dense(jnp.asarray(x, jdt), jnp.asarray(wt.T),
                                  None if b is None else jnp.asarray(b)),
                         np.float32)
    got = TF.dense(torch.from_numpy(x).to(dtype), torch.from_numpy(wt),
                   None if b is None else torch.from_numpy(b))
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())
