"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.  The
file imports neither JAX nor the JAX package, so it also runs on a
machine without them; there, skip tests/conftest.py, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_torch.ops import packed as TP


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pad,c8i,c8o", [(0, 8, 64), (1, 64, 128),
                                         (1, 256, 96), (0, 512, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2_packed_kernel_matches_plain(cuda_device, pad, c8i, c8o, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 7, 6, 9, c8i, generator=g, device=cuda_device).to(dtype)
    wp = (torch.randn(2, 2, 2, c8i, c8o, generator=g, device=cuda_device)
          / (8 * c8i) ** 0.5).to(dtype)
    bias = torch.randn(c8o, generator=g, device=cuda_device)
    before = K.conv2_packed.launches
    got = K.conv2_packed(x, wp, bias, pad=pad)
    torch.cuda.synchronize()
    assert K.conv2_packed.launches == before + 1
    ref = K.conv2_packed_plain(x, wp, bias, pad=pad)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("c8o", [64, 128, 256, 512])
@pytest.mark.parametrize("c8i", [64, 128, 512])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("shape", [(2, 7, 6, 9), (1, 2, 5, 17),
                                   (1, 13, 2, 2)])
def test_conv2_packed_tc_matches_plain(cuda_device, shape, pad, c8i, c8o):
    """The tensor-core route (bf16, 8Ci and 8Co multiples of 64) at
    extents that no box divides; at pad 0 the last two shapes give
    single-cell output axes."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(*shape, c8i, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    wp = (torch.randn(2, 2, 2, c8i, c8o, generator=g, device=cuda_device)
          / (8 * c8i) ** 0.5).to(torch.bfloat16)
    bias = torch.randn(c8o, generator=g, device=cuda_device)
    before = (K.conv2_packed.launches, K.conv2_packed.tc_launches)
    got = K.conv2_packed(x, wp, bias, pad=pad)
    torch.cuda.synchronize()
    assert (K.conv2_packed.launches, K.conv2_packed.tc_launches) == (
        before[0] + 1, before[1] + 1)
    ref = K.conv2_packed_plain(x, wp, bias, pad=pad)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -7 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c8i", [(torch.float32, 64),
                                       (torch.float32, 512),
                                       (torch.bfloat16, 8)])
def test_conv2_packed_cuda_core_route(cuda_device, dtype, c8i):
    """float32 and the 8Ci = 8 stem stay on the CUDA-core kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(1, 5, 4, 6, c8i, generator=g, device=cuda_device).to(dtype)
    wp = (torch.randn(2, 2, 2, c8i, 128, generator=g, device=cuda_device)
          / (8 * c8i) ** 0.5).to(dtype)
    before = (K.conv2_packed.launches, K.conv2_packed.tc_launches)
    got = K.conv2_packed(x, wp, pad=1)
    torch.cuda.synchronize()
    assert (K.conv2_packed.launches, K.conv2_packed.tc_launches) == (
        before[0] + 1, before[1])
    ref = K.conv2_packed_plain(x, wp, pad=1)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_act_zero_pads_kernel_matches_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    xs = torch.randn(2, 9, 5, 7, 64, generator=g,
                     device=cuda_device).to(dtype)
    scale, shift, alpha = (torch.rand(64, generator=g, device=cuda_device)
                           for _ in range(3))
    masks = TP.shifted_pad_mask_tensors(xs)
    got = K.bn_act_zero_pads(xs, scale, shift, alpha, masks)
    torch.cuda.synchronize()
    ref = K.bn_act_zero_pads_plain(xs, scale, shift, alpha, masks)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("axis,k,stride,pad,ci,co", [
    (1, 6, 2, 2, 1, 8), (2, 6, 2, 2, 8, 16), (3, 6, 2, 2, 16, 32),
    (1, 3, 1, 0, 32, 64), (3, 3, 1, 0, 64, 64), (2, 5, 1, 2, 8, 1),
    (3, 5, 1, 2, 1, 1), (1, 3, 1, 1, 3, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
def test_conv_axis_kernel_matches_plain(cuda_device, axis, k, stride, pad,
                                        ci, co, dtype, with_bias):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 9, 7, 11, ci, generator=g,
                    device=cuda_device).to(dtype)
    w = (torch.randn(k, ci, co, generator=g, device=cuda_device)
         / (k * ci) ** 0.5).to(dtype)
    bias = (torch.randn(co, generator=g, device=cuda_device) if with_bias
            else None)
    before = K.conv_axis.launches
    got = K.conv_axis(x, w, bias, axis=axis, stride=stride, pad=pad)
    torch.cuda.synchronize()
    assert K.conv_axis.launches == before + 1
    ref = K.conv_axis_plain(x, w, bias, axis=axis, stride=stride, pad=pad)
    assert got.shape == ref.shape and got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
def test_conv_axis_kernel_large_weights(cuda_device):
    """k=6, Ci=Co=64: 96 KB of weights, past the 48 KB static limit."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(1, 12, 6, 5, 64, generator=g, device=cuda_device)
    w = torch.randn(6, 64, 64, generator=g, device=cuda_device) / 20
    got = K.conv_axis(x, w, axis=1, stride=2, pad=2)
    torch.cuda.synchronize()
    ref = K.conv_axis_plain(x, w, axis=1, stride=2, pad=2)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item()
