"""Port parity: the functional ops of the segmentation model zoo
(`ops/functional.py`: `conv3d`, `conv3d_transpose`, `avgpool3d`,
`instance_norm`, `group_norm`) against the JAX package's, on the CPU.

The same numpy inputs go through both packages in float32, JAX at
`Precision.HIGHEST` (its f32 policy); every output is held to 1e-5 x
max(1, max|ref|).  Weights are made in JAX's channels-last layouts and
transposed for the port as the weight bridge transposes them."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.ops import functional as TF
from mri_epilepsy_diagnosis_tpu.ops import functional as JF

torch.set_num_threads(2)

TOL = 1e-5


def _close(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got.detach().numpy().astype(np.float64) - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), err


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _torch_w(w):
    """JAX (kD, kH, kW, a, b) -> torch (b, a, kD, kH, kW)."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


@pytest.mark.parametrize("k,stride,padding,dilation,groups,bias", [
    (3, 1, 1, 1, 1, True), (3, 2, 1, 1, 1, False), (1, 2, 0, 1, 1, False),
    (3, 1, 2, 2, 1, True), (3, 1, 3, 3, 1, False), (3, 1, 1, 1, 2, True),
    (2, 2, 0, 1, 4, False), ((1, 3, 3), (1, 2, 1), (0, 1, 1), 1, 1, True)])
def test_conv3d_matches_jax(k, stride, padding, dilation, groups, bias):
    rng = np.random.default_rng(0)
    kk = k if isinstance(k, tuple) else (k,) * 3
    x = _rand(rng, 2, 9, 8, 10, 8)
    w = _rand(rng, *kk, 8 // groups, 4) / np.sqrt(8 * np.prod(kk))
    b = _rand(rng, 4) if bias else None
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups)
    ref = JF.conv3d(jnp.asarray(x), jnp.asarray(w),
                    None if b is None else jnp.asarray(b), **kw)
    got = TF.conv3d(torch.from_numpy(x), _torch_w(w),
                    None if b is None else torch.from_numpy(b), **kw)
    _close(got, ref)


@pytest.mark.parametrize("k,stride,padding,output_padding,dilation", [
    (4, 2, 0, 0, 1), (3, 2, 1, 1, 1), (2, 2, 0, 0, 1), (3, 1, 1, 0, 1),
    (3, 2, 1, 0, 2), ((4, 2, 3), (2, 1, 2), (1, 0, 1), (1, 0, 0), 1)])
def test_conv3d_transpose_matches_jax(k, stride, padding, output_padding,
                                      dilation):
    rng = np.random.default_rng(1)
    kk = k if isinstance(k, tuple) else (k,) * 3
    x = _rand(rng, 2, 5, 4, 6, 6)
    w = _rand(rng, *kk, 3, 6) / np.sqrt(6 * np.prod(kk))   # (k, O, I)
    b = _rand(rng, 3)
    kw = dict(stride=stride, padding=padding, output_padding=output_padding,
              dilation=dilation)
    ref = JF.conv3d_transpose(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), **kw)
    got = TF.conv3d_transpose(torch.from_numpy(x), _torch_w(w),
                              torch.from_numpy(b), **kw)
    _close(got, ref)


@pytest.mark.parametrize("kernel,stride", [(2, None), (3, 2), ((2, 1, 3), 1),
                                           (3, (1, 2, 3))])
def test_avgpool3d_matches_jax(kernel, stride):
    x = _rand(np.random.default_rng(2), 2, 9, 8, 7, 3)
    ref = JF.avgpool3d(jnp.asarray(x), kernel, stride)
    _close(TF.avgpool3d(torch.from_numpy(x), kernel, stride), ref)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("shape", [(2, 6, 5, 4, 3), (1, 8, 8, 8, 16),
                                   (3, 5, 7, 2)])
def test_instance_norm_matches_jax(shape, affine):
    rng = np.random.default_rng(3)
    x = 3.0 + 2.0 * _rand(rng, *shape)
    g = b = None
    if affine:
        g, b = 0.5 + rng.random(shape[-1], np.float32), _rand(rng, shape[-1])
    ref = JF.instance_norm(jnp.asarray(x), None if g is None else
                           jnp.asarray(g), None if b is None else
                           jnp.asarray(b))
    got = TF.instance_norm(torch.from_numpy(x),
                           None if g is None else torch.from_numpy(g),
                           None if b is None else torch.from_numpy(b))
    _close(got, ref)


@pytest.mark.parametrize("groups,channels", [(4, 8), (4, 16), (2, 6), (1, 5),
                                             (3, 3)])
def test_group_norm_matches_jax(groups, channels):
    rng = np.random.default_rng(4)
    x = 1.0 + _rand(rng, 2, 6, 5, 4, channels)
    g = 0.5 + rng.random(channels, np.float32)
    b = _rand(rng, channels)
    ref = JF.group_norm(jnp.asarray(x), groups, jnp.asarray(g),
                        jnp.asarray(b))
    got = TF.group_norm(torch.from_numpy(x), groups, torch.from_numpy(g),
                        torch.from_numpy(b))
    _close(got, ref)


def test_group_norm_grouping_is_torchs():
    """Channel c lies in group c // (C / groups), as in `nn.GroupNorm`,
    and no affine leaves the normalized values."""
    x = torch.randn(2, 4, 3, 5, 8, generator=torch.Generator().manual_seed(5))
    ref = torch.nn.functional.group_norm(x.permute(0, 4, 1, 2, 3), 4)
    got = TF.group_norm(x, 4)
    torch.testing.assert_close(got, ref.permute(0, 2, 3, 4, 1), rtol=1e-5,
                               atol=1e-5)
