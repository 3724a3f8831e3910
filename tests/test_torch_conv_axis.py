"""Port parity: kernel B3's wrapper `conv_axis` and its callers
`conv_one_axis` / `separable_conv3d` against the JAX package's Pallas
`conv_one_axis` / `separable_conv3d`, which run here in interpret mode.

On the CPU the wrapper takes its plain version; the CUDA kernel itself
runs only on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).  The
JAX side runs under `jax.default_matmul_precision("highest")`: this JAX
build contracts float32 at bf16-level precision by default, even on the
CPU.  Tolerance: 1e-5 x max|ref| in float32, from summation order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_tpu.ops import pallas_kernels as JK

torch.set_num_threads(2)

# (k, stride, pad): the fader DownBlock, the UpBlock at scale 2 and 4
# (train_AE.ipynb cell 8), and the Classificator head
GEOMETRIES = [(6, 2, 2), (3, 1, 1), (5, 1, 2), (3, 1, 0)]


def _assert_close(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def _jax_one_axis(x, w, axis, stride, pad, bias):
    with jax.default_matmul_precision("highest"):
        return JK.conv_one_axis(
            jnp.asarray(x), jnp.asarray(w), axis, stride=stride, pad=pad,
            bias=None if bias is None else jnp.asarray(bias), interpret=True)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("k,stride,pad", GEOMETRIES)
@pytest.mark.parametrize("axis", [1, 2, 3])
def test_conv_one_axis_matches_jax(axis, k, stride, pad, with_bias):
    rng = np.random.default_rng(10 * axis + k)
    x = rng.normal(size=(2, 12, 10, 14, 4)).astype(np.float32)
    w = rng.normal(size=(k, 4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32) if with_bias else None
    got = K.conv_one_axis(torch.from_numpy(x), torch.from_numpy(w), axis,
                          stride=stride, pad=pad,
                          bias=None if b is None else torch.from_numpy(b))
    _assert_close(got, _jax_one_axis(x, w, axis, stride, pad, b))


@pytest.mark.parametrize("ci,co", [(1, 8), (8, 1), (3, 5)])
@pytest.mark.parametrize("axis", [1, 3])
def test_conv_axis_channel_widths_match_jax(axis, ci, co):
    """The encoder stem (Ci = 1), the AE's last UpBlock (Co = 1), and
    widths that are no multiple of 4 (the kernel's scalar paths)."""
    rng = np.random.default_rng(ci * co + axis)
    x = rng.normal(size=(1, 11, 9, 10, ci)).astype(np.float32)
    w = rng.normal(size=(6, ci, co)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    got = K.conv_axis(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), axis=axis, stride=2, pad=2)
    _assert_close(got, _jax_one_axis(x, w, axis, 2, 2, b))


@pytest.mark.parametrize("with_bias", [False, True])
def test_separable_conv3d_matches_jax(with_bias):
    """The fader DownBlock stack: k=6, stride 2, pad 2 on every axis."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 12, 20, 1)).astype(np.float32)
    ws = [rng.normal(size=(6, ci, 8)).astype(np.float32) for ci in (1, 8, 8)]
    bs = ([rng.normal(size=(8,)).astype(np.float32) for _ in range(3)]
          if with_bias else [None] * 3)
    got = K.separable_conv3d(
        torch.from_numpy(x), *map(torch.from_numpy, ws), stride=(2, 2, 2),
        pad=(2, 2, 2),
        biases=tuple(None if b is None else torch.from_numpy(b) for b in bs))
    with jax.default_matmul_precision("highest"):
        ref = JK.separable_conv3d(
            jnp.asarray(x), *map(jnp.asarray, ws), stride=(2, 2, 2),
            pad=(2, 2, 2),
            biases=tuple(None if b is None else jnp.asarray(b) for b in bs),
            interpret=True)
    _assert_close(got, ref)


def test_conv_axis_plain_is_a_one_axis_conv3d():
    """The plain version equals torch's conv3d with the (Co, Ci, 1, k, 1)
    weight, the yardstick `chip_smoke.py` times beside the kernel."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 7, 9, 8, 3, generator=g)
    w = torch.randn(5, 3, 4, generator=g)
    b = torch.randn(4, generator=g)
    got = K.conv_axis_plain(x, w, b, axis=2, stride=2, pad=2)
    ref = torch.nn.functional.conv3d(
        x.permute(0, 4, 1, 2, 3), w.permute(2, 1, 0)[:, :, None, :, None], b,
        stride=(1, 2, 1), padding=(0, 2, 0)).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def test_conv_axis_keeps_bf16():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 6, 5, 4, 8, generator=g).to(torch.bfloat16)
    w = torch.randn(3, 8, 8, generator=g).to(torch.bfloat16)
    got = K.conv_axis(x, w, axis=1, stride=1, pad=1)
    ref = K.conv_axis_plain(x.float(), w.float(), axis=1, stride=1, pad=1)
    assert got.dtype == torch.bfloat16
    # one rounding of the float32 sum: half a bf16 step
    assert (got.float() - ref).abs().max() <= 2.0 ** -8 * ref.abs().max()


@pytest.mark.parametrize("case,match", [
    ("rank", "needs x"), ("axis", "axis must be"), ("channels", "input "
                                                    "channels"),
    ("short", "too short"), ("bias", "bias must"), ("stride", "stride")])
def test_conv_axis_argument_checks(case, match):
    x, w, kw = torch.zeros(1, 4, 4, 4, 2), torch.zeros(3, 2, 5), {"axis": 1}
    if case == "rank":
        x = x[0]
    elif case == "axis":
        kw["axis"] = 4
    elif case == "channels":
        w = torch.zeros(3, 3, 5)
    elif case == "short":
        w = torch.zeros(7, 2, 5)
    elif case == "bias":
        kw["bias"] = torch.zeros(4)
    else:
        kw["stride"] = 0
    with pytest.raises(ValueError, match=match):
        K.conv_axis(x, w, **kw)
