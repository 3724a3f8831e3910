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


# B1 + B2 fused: (x extents at batch 1, 8Ci, 8Co, addend) of the five
# aligned->shifted sites of the served 192^3 UNet3D (out_channels_first_
# layer 8); the decoder's up launches add the skip launch's partial sum
FUSED_SITES = {"e0c1": ((96, 96, 96), 8, 64, False),
               "e1c1": ((48, 48, 48), 128, 128, False),
               "bc1": ((24, 24, 24), 256, 256, False),
               "d0c1.up": ((48, 48, 48), 512, 256, True),
               "d1c1.up": ((96, 96, 96), 256, 128, True)}


def _check_fused(dev, shape, c8i, c8o, addend, dtype, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*shape, c8i, generator=g, device=dev).to(dtype)
    wp = (torch.randn(2, 2, 2, c8i, c8o, generator=g, device=dev)
          / (8 * c8i) ** 0.5).to(dtype)
    scale = 0.5 + torch.rand(c8o, generator=g, device=dev)
    shift = torch.randn(c8o, generator=g, device=dev)
    alpha = torch.rand(c8o, generator=g, device=dev)
    out_shape = (shape[0], *(s + 1 for s in shape[1:]), c8o)
    add = (torch.randn(out_shape, generator=g, device=dev).to(dtype)
           if addend else None)
    tc = K._conv2_route(dtype, c8i, c8o) == "tc"
    before = (K.conv2_packed.launches, K.conv2_packed.tc_launches,
              K.conv2_packed_as_bn_act.launches,
              K.conv2_packed_as_bn_act.tc_launches)
    got = K.conv2_packed_as_bn_act(x, wp, scale, shift, alpha, addend=add)
    torch.cuda.synchronize()
    assert (K.conv2_packed.launches, K.conv2_packed.tc_launches,
            K.conv2_packed_as_bn_act.launches,
            K.conv2_packed_as_bn_act.tc_launches) == (
        before[0] + 1, before[1] + tc, before[2] + 1, before[3] + tc)
    ref = K.conv2_packed_as_bn_act_plain(x, wp, scale, shift, alpha, add)
    assert got.shape == ref.shape == out_shape and got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()
    # the pad voxels are exactly zero
    keep = [K.shifted_pad_keep(a, out_shape[1 + a], c8o, dev)
            for a in range(3)]
    pads = ~(keep[0][:, None, None] & keep[1][None, :, None]
             & keep[2][None, None, :])
    assert not got[:, pads].any()


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(FUSED_SITES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2_packed_as_bn_act_served_sites(cuda_device, site, dtype):
    extents, c8i, c8o, addend = FUSED_SITES[site]
    _check_fused(cuda_device, (1, *extents), c8i, c8o, addend, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("addend", [False, True])
@pytest.mark.parametrize("c8i,c8o", [(64, 64), (128, 256), (8, 64),
                                     (64, 128)])
@pytest.mark.parametrize("shape", [(2, 7, 6, 9), (1, 2, 5, 17),
                                   (1, 13, 2, 2), (1, 1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2_packed_as_bn_act_ragged(cuda_device, shape, c8i, c8o, addend,
                                       dtype):
    """Extents that no box divides, so the last cell of an axis lies
    anywhere in a tile, on both routes."""
    _check_fused(cuda_device, shape, c8i, c8o, addend, dtype, seed=4)


# B3 fused: (x extents at batch 1, Ci, C, k, stride, pad) of the four
# separable stacks of the served fader encoder and Classificator
SEP_SITES = {"e0": ((192, 192, 192), 1, 8, 6, 2, 2),
             "e1": ((48, 48, 48), 8, 16, 6, 2, 2),
             "e2": ((12, 12, 12), 16, 32, 6, 2, 2),
             "clf": ((3, 3, 3), 32, 64, 3, 1, 0)}
# bf16: each stage rounds its output to bf16; a one-step difference in an
# intermediate (two f32 sums in another order straddling a rounding
# boundary) passes through the later stages
SEP_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def _check_separable(dev, shape, ci, c, k, s, p, dtype, with_bias=True,
                     seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*shape, ci, generator=g, device=dev).to(dtype)
    ws = [(torch.randn(k, cin, c, generator=g, device=dev)
           / (k * cin) ** 0.5).to(dtype) for cin in (ci, c, c)]
    bs = tuple(torch.randn(c, generator=g, device=dev) if with_bias
               else None for _ in range(3))
    kw = dict(stride=(s,) * 3, pad=(p,) * 3, biases=bs)
    plan = K.separable_plan(shape[0], shape[1:4], (ci, c, c, c), (k,) * 3,
                            (s,) * 3, (p,) * 3, dtype)
    assert K._separable_route(dtype, plan) == "fused"
    before = (K.separable_conv3d.launches, K.conv_axis.launches)
    got = K.separable_conv3d(x, *ws, **kw)
    torch.cuda.synchronize()
    assert (K.separable_conv3d.launches, K.conv_axis.launches) == (
        before[0] + 1, before[1])
    ref = K.separable_conv3d_plain(x, *ws, **kw)
    assert got.shape == ref.shape and got.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= SEP_TOL[dtype] * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(SEP_SITES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_separable_conv3d_served_stacks(cuda_device, site, dtype):
    extents, ci, c, k, s, p = SEP_SITES[site]
    _check_separable(cuda_device, (1, *extents), ci, c, k, s, p, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 9, 7, 11), (1, 10, 6, 40)])
@pytest.mark.parametrize("ci,c", [(1, 8), (8, 16), (16, 8), (3, 5), (8, 1),
                                  (32, 64)])
@pytest.mark.parametrize("k,s,p", [(6, 2, 2), (3, 1, 1), (5, 1, 2),
                                   (3, 1, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_separable_conv3d_ragged(cuda_device, shape, ci, c, k, s, p, dtype):
    """Extents no tile divides; Ci = 1 and Cout = 1 (CUDA-core stages),
    widths that are no multiple of 8, and the tensor-core stages.  W = 11
    takes the element-wise and 4-byte input copies, W = 40 the 16-byte
    ones (with a lead of cells where a cell is narrower than 16 bytes)."""
    _check_separable(cuda_device, shape, ci, c, k, s, p, dtype,
                     with_bias=(ci + c) % 2 == 1, seed=6)


# B1 as input gradient: (x extents at batch 1, 8Ci, 8Co, forward pad) of
# the 11 dx sites of the 192^3 train step (every conv but the stem); the
# dx launch maps g (8Co) back to x (8Ci) in the other parity
DX_SITES = {"e0c2": ((97, 97, 97), 64, 128, 0),
            "e1c1": ((48, 48, 48), 128, 128, 1),
            "e1c2": ((49, 49, 49), 128, 256, 0),
            "bc1": ((24, 24, 24), 256, 256, 1),
            "bc2": ((25, 25, 25), 256, 512, 0),
            "d0c1.skip": ((48, 48, 48), 256, 256, 1),
            "d0c1.up": ((48, 48, 48), 512, 256, 1),
            "d0c2": ((49, 49, 49), 256, 256, 0),
            "d1c1.skip": ((96, 96, 96), 128, 128, 1),
            "d1c1.up": ((96, 96, 96), 256, 128, 1),
            "d1c2": ((97, 97, 97), 128, 128, 0)}


def _check_dx(dev, shape, c8i, c8o, pad, dtype, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    wp = (torch.randn(2, 2, 2, c8i, c8o, generator=g, device=dev)
          / (8 * c8o) ** 0.5).to(dtype)
    step = -1 if pad == 0 else 1
    gy = torch.randn(shape[0], *(s + step for s in shape[1:]), c8o,
                     generator=g, device=dev).to(dtype)
    tc = K._conv2_route(dtype, c8o, c8i) == "tc"
    before = (K.conv2_packed.launches, K.conv2_packed.tc_launches,
              K.conv2_packed_dx.launches, K.conv2_packed_dx.tc_launches)
    got = K.conv2_packed_dx(gy, wp, pad=pad)
    torch.cuda.synchronize()
    assert (K.conv2_packed.launches, K.conv2_packed.tc_launches,
            K.conv2_packed_dx.launches, K.conv2_packed_dx.tc_launches) == (
        before[0] + 1, before[1] + tc, before[2] + 1, before[3] + tc)
    ref = K.conv2_packed_dx_plain(gy, wp, pad=pad)
    assert got.shape == ref.shape == (*shape, c8i) and got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(DX_SITES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2_packed_dx_train_sites(cuda_device, site, dtype):
    extents, c8i, c8o, pad = DX_SITES[site]
    _check_dx(cuda_device, (1, *extents), c8i, c8o, pad, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c8i,c8o", [(64, 128), (128, 64), (8, 64),
                                     (256, 512)])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("shape", [(2, 7, 6, 9), (1, 3, 5, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2_packed_dx_ragged(cuda_device, shape, pad, c8i, c8o, dtype):
    """Extents that no box divides, both parities, both routes (8Ci = 8
    keeps the launch on CUDA cores in bf16)."""
    _check_dx(cuda_device, shape, c8i, c8o, pad, dtype, seed=8)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sa", "as"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_conv_function_backward_on_the_card(cuda_device, kind, dtype):
    """`Conv3Packed` / `Conv3PackedAs` on CUDA tensors: the forward and dx
    launch B1 (counted), dw is float32 (bf16 operands, float32 result where
    torch has it), and all three match the same Function run on the CPU
    (plain versions) from the same inputs."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    cells = (9, 8, 7) if kind == "sa" else (8, 7, 6)
    x = torch.randn(2, *cells, 64, generator=g, device=cuda_device)
    w = torch.randn(2, 2, 2, 64, 128, generator=g, device=cuda_device) / 23
    b = torch.randn(16, generator=g, device=cuda_device)
    fn = TP.conv3_packed if kind == "sa" else TP.conv3_packed_as
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        xs = x.detach().to(dev, dtype, copy=True).requires_grad_(True)
        ws, bs = (t.detach().to(dev, copy=True).requires_grad_(True)
                  for t in (w, b))
        before = (K.conv2_packed.launches, K.conv2_packed_dx.launches)
        y = fn(xs, ws, bs)
        y.float().sin().sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (K.conv2_packed.launches, K.conv2_packed_dx.launches) == (
                before[0] + 2, before[1] + 1)
        assert ws.grad.dtype == bs.grad.dtype == torch.float32
        grads.append([t.detach().float().cpu()
                      for t in (y, xs.grad, ws.grad, bs.grad)])
    # f32: summation order; bf16: one rounding step of y and dx, and dw
    # from bf16 operands that agree on both sides
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for got, ref in zip(*grads):
        err = (got - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item()


@pytest.mark.cuda
def test_dw_route_keeps_float32(cuda_device):
    route = TP.dw_gemm_route(torch.bfloat16, cuda_device)
    assert route in ("bf16_out_f32", "f32")
    g = torch.Generator(device=cuda_device).manual_seed(10)
    xpad = torch.randn(2, 9, 9, 9, 64, generator=g,
                       device=cuda_device).to(torch.bfloat16)
    gy = torch.randn(2, 8, 8, 8, 128, generator=g,
                     device=cuda_device).to(torch.bfloat16)
    got = TP._dw_packed_qgroup(xpad, gy)
    assert got.dtype == torch.float32
    ref = TP._dw_packed_qgroup(xpad.cpu(), gy.cpu())
    err = (got.cpu() - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_packed_train_step_on_the_card(cuda_device):
    """One bf16 packed train step at 32^3 through the kernels: 23 B1
    launches (11 of them dx), no B2, finite loss, float32 master weights;
    the served forward under inference_mode keeps its 12 launches."""
    from mri_epilepsy_diagnosis_torch.models import UNet3D
    from mri_epilepsy_diagnosis_torch.models.unet_packed import (
        fold_bn_inference, packed_unet_mask_v2)
    from mri_epilepsy_diagnosis_torch.train import (create_train_state,
                                                    packed_seg_train_step,
                                                    torch_adamw)

    torch.manual_seed(0)
    model = UNet3D(out_channels_first_layer=8, device=cuda_device)
    state = create_train_state(model, torch_adamw())
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(2, 32, 32, 32, 1, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    labels = (torch.rand(x.shape, generator=g, device=cuda_device) > 0.9
              ).to(torch.int16) * 1001
    K.reset_launch_counts()
    state, loss = packed_seg_train_step(state, x, labels)
    torch.cuda.synchronize()
    assert (K.conv2_packed.launches, K.conv2_packed.tc_launches,
            K.conv2_packed_dx.launches, K.conv2_packed_dx.tc_launches,
            K.conv2_packed_as_bn_act.launches,
            K.bn_act_zero_pads.launches) == (23, 22, 11, 11, 0, 0)
    assert torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    K.reset_launch_counts()
    with torch.inference_mode():
        packed_unet_mask_v2(fold_bn_inference(model.state_dict()), x)
    assert (K.conv2_packed.launches, K.conv2_packed.tc_launches,
            K.conv2_packed_dx.launches,
            K.conv2_packed_as_bn_act.launches) == (12, 11, 0, 5)


@pytest.fixture
def no_tf32():
    """f32 convolutions and matmuls in full f32, as the CPU's are."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _seg_case(dev, size, batch, seed):
    """A seeded UNet3D (out_channels_first_layer 8) and a batch of inputs
    with FreeSurfer-style labels (a cortical blob in each volume)."""
    from mri_epilepsy_diagnosis_torch.models import UNet3D

    torch.manual_seed(seed)
    model = UNet3D(out_channels_first_layer=8, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, size, size, size, 1, generator=g, device=dev)
    ax = torch.arange(size, device=dev, dtype=torch.float32) - size / 2
    r2 = ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None] ** 2
    inside = (r2 <= (size / 4) ** 2)[None, ..., None].expand_as(x)
    labels = torch.where(inside, 1002, 41).to(torch.int16)
    return model, x + inside, labels


@pytest.mark.cuda
def test_accum_full_micro_matches_flat_on_the_card(cuda_device, no_tf32):
    """`packed_seg_train_step_accum` with micro = batch against the flat
    packed step, f32 at 32^3 (the gate of `chip_smoke.py` phase 7a): loss
    1e-5 relative, each gradient leaf 2e-2 x its max plus 1e-6 x the
    largest gradient, running statistics 1e-5; then batch 4 in
    micro-batches of 2 in bf16 launches B1 23 times per micro-batch."""
    import copy

    from mri_epilepsy_diagnosis_torch.train import (create_train_state,
                                                    packed_seg_train_step,
                                                    packed_seg_train_step_accum,
                                                    torch_adamw)

    model, x, labels = _seg_case(cuda_device, 32, 2, 12)
    acc = create_train_state(copy.deepcopy(model), torch_adamw())
    acc, loss = packed_seg_train_step_accum(acc, x, labels, micro=2)
    flat = create_train_state(copy.deepcopy(model), torch_adamw())
    flat, flat_loss = packed_seg_train_step(flat, x, labels)
    assert abs(loss.item() - flat_loss.item()) <= 1e-5 * abs(flat_loss.item())
    grads = dict(flat.model.named_parameters())
    floor = 1e-6 * max(p.grad.abs().max().item() for p in grads.values())
    for k, p in acc.model.named_parameters():
        ref = grads[k].grad
        err = (p.grad - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item() + floor, k
    ref_buffers = dict(flat.model.named_buffers())
    for k, b in acc.model.named_buffers():
        if "running" in k:
            err = (b - ref_buffers[k]).abs().max().item()
            assert err <= 1e-5 * max(1.0, ref_buffers[k].abs().max().item())

    model, x, labels = _seg_case(cuda_device, 32, 4, 13)
    state = create_train_state(model, torch_adamw())
    K.reset_launch_counts()
    state, loss = packed_seg_train_step_accum(
        state, x.to(torch.bfloat16), labels, micro=2)
    torch.cuda.synchronize()
    assert (K.conv2_packed.launches, K.conv2_packed.tc_launches,
            K.conv2_packed_dx.launches,
            K.conv2_packed_as_bn_act.launches) == (46, 44, 22, 0)
    assert torch.isfinite(loss)


@pytest.mark.cuda
def test_validate_packed_masks_match_fine_on_the_card(cuda_device, no_tf32):
    """`validate_dsc_asd`'s two forwards in f32 at 32^3 (the gate of
    `chip_smoke.py` phase 7c): the packed masks (B1 with B2 fused, 12
    launches per batch, 5 fused) agree with the fine UNet3D's (cuDNN) at
    >= 0.999 of the voxels, with a non-trivial foreground; then the
    per-subject metrics of the packed route are finite."""
    from mri_epilepsy_diagnosis_torch.train import (TrainState, mask_forward,
                                                    torch_adamw,
                                                    validate_dsc_asd)

    model, x, labels = _seg_case(cuda_device, 32, 2, 14)
    state = TrainState(model, torch_adamw()(model.parameters()))
    with torch.no_grad():
        model.eval()
        logits = model(x)
        margin = (logits[..., 1] - logits[..., 0]).flatten()
        model.classifier.conv_layer.bias[1] -= torch.quantile(margin, 0.7)
    K.reset_launch_counts()
    packed = mask_forward(state, packed=True)(x)
    torch.cuda.synchronize()
    assert (K.conv2_packed.launches, K.conv2_packed.tc_launches,
            K.conv2_packed_as_bn_act.launches) == (12, 0, 5)
    fine = mask_forward(state, packed=False)(x)
    assert (packed == fine).float().mean().item() >= 0.999
    assert 0.1 < packed.float().mean().item() < 0.5
    metrics = validate_dsc_asd(state, [(x.cpu().numpy(),
                                        labels.cpu().numpy())], packed=True)
    assert all(len(m) == 2 for m in metrics)
    assert all(torch.isfinite(torch.tensor(m)).all() for m in metrics)


@pytest.mark.cuda
@pytest.mark.parametrize("angle", [0.0, 0.35])
def test_affine_resample_on_the_card_matches_cpu(cuda_device, angle):
    """`trilinear_sample` through `affine_resample` (a rotation, a scale
    and a shift with reads outside the volume) on the card against the
    CPU, whatever TF32 is set to: 1e-5 x max|ref|."""
    import math

    from mri_epilepsy_diagnosis_torch.transforms import spatial as TS

    g = torch.Generator().manual_seed(20)
    vol = torch.randn(40, 36, 44, generator=g)
    c, s = math.cos(angle), math.sin(angle)
    a = torch.eye(4, dtype=torch.float64)
    a[:3, :3] = 1.08 * torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                                    dtype=torch.float64)
    a[:3, 3] = torch.tensor([2.5, -1.25, 3.0], dtype=torch.float64)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = TS.affine_resample(vol.to(cuda_device), a, fill_value=-1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    ref = TS.affine_resample(vol, a, fill_value=-1.0)
    assert got.device.type == "cuda"
    assert (got.cpu() - ref).abs().max() <= 1e-5 * ref.abs().max()
    coords = torch.rand(3, 1000, generator=g) * 50 - 5
    got = TS.trilinear_sample(vol.to(cuda_device), coords.to(cuda_device))
    ref = TS.trilinear_sample(vol, coords)
    assert (got.cpu() - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_histogram_standardization_beyond_quantile_limit_on_the_card(
        cuda_device):
    """A 320 x 320 x 192 volume (19.7 M voxels, above `torch.quantile`'s
    2^24) standardizes on the card as on the CPU: 1e-5 x max|ref|."""
    import numpy as np

    from mri_epilepsy_diagnosis_torch.transforms import (
        histogram_standardization)

    g = torch.Generator().manual_seed(21)
    vol = torch.rand(320, 320, 192, generator=g) * 800
    lm = np.linspace(0, 100, 13)
    got = histogram_standardization(vol.to(cuda_device), lm)
    ref = histogram_standardization(vol, lm)
    assert got.shape == vol.shape and got.device.type == "cuda"
    assert (got.cpu() - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_random_noise_with_a_host_generator_on_the_card(cuda_device):
    """A CPU generator draws the scalar on the host and seeds a generator
    on the card for the field: the same seed, the same noisy volume."""
    from mri_epilepsy_diagnosis_torch.transforms import random_noise

    vol = torch.zeros(16, 16, 16, device=cuda_device)
    a = random_noise(torch.Generator().manual_seed(3), vol)
    b = random_noise(torch.Generator().manual_seed(3), vol)
    assert a.device.type == "cuda" and torch.equal(a, b)
    assert 0 < a.std().item() <= 0.25 * 1.2


@pytest.mark.cuda
def test_dropout_with_a_host_generator_draws_on_the_card(cuda_device):
    """A CPU generator seeds a generator on the card for the mask: no
    tensor crosses from the host, and the same seed gives the same mask."""
    from mri_epilepsy_diagnosis_torch.ops import functional as F

    x = torch.ones(64, 256, device=cuda_device)
    a = F.dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    b = F.dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    assert a.device.type == "cuda" and torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < (a == 0).float().mean().item() < 0.6


@pytest.mark.cuda
def test_sliding_window_on_the_card_matches_cpu(cuda_device, no_tf32):
    """`sliding_window_predict` over the packed UNet3D (B1 with B2 fused)
    on a 64^3 volume, patch 32, overlap 4, f32: the card against the CPU
    (plain versions), 1e-4 x max|ref|, in both modes; 12 B1 launches per
    model call, 5 with B2 fused."""
    from mri_epilepsy_diagnosis_torch.infer import sliding_window_predict
    from mri_epilepsy_diagnosis_torch.models import UNet3D
    from mri_epilepsy_diagnosis_torch.models.unet_packed import (
        fold_bn_inference, packed_unet_apply_v2)

    torch.manual_seed(22)
    model = UNet3D(out_channels_first_layer=8, device="cpu")
    params_cpu = fold_bn_inference(model.state_dict())
    params = {k: v.to(cuda_device) for k, v in params_cpu.items()}
    vol = torch.randn(64, 64, 64, 1, generator=torch.Generator().manual_seed(
        23))
    for mode in ("average", "crop"):
        K.reset_launch_counts()
        with torch.no_grad():
            got = sliding_window_predict(packed_unet_apply_v2, params,
                                         vol.to(cuda_device), 32, 4,
                                         batch_size=8, mode=mode)
            torch.cuda.synchronize()
            calls = -(-27 // 8)
            assert (K.conv2_packed.launches,
                    K.conv2_packed_as_bn_act.launches) == (12 * calls,
                                                           5 * calls)
            ref = sliding_window_predict(packed_unet_apply_v2, params_cpu,
                                         vol, 32, 4, batch_size=8,
                                         mode=mode)
        assert got.shape == ref.shape == (64, 64, 64, 2)
        assert (got.cpu() - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
def test_prefetcher_passes_card_tensors_through(cuda_device):
    """A batch already on the card (as `fader_collate` returns it) is not
    pinned or copied; its host parts are uploaded."""
    import numpy as np

    from mri_epilepsy_diagnosis_torch.data import DevicePrefetcher

    x = torch.randn(2, 8, 8, 8, 1, device=cuda_device)
    y = np.array([0, 1], np.int32)
    pf = DevicePrefetcher(iter([(x, y)]), device=cuda_device)
    sx, sy = pf.get()
    assert sx is x
    assert sy.device.type == "cuda" and sy.tolist() == [0, 1]
    assert pf.get() is None


# B3's backward: (axis, k, stride, pad, Ci, Co), the encoder's k=6/s=2/p=2
# stages, the heads' k=3/p=0, the AE's stride-1 k=3/p=1 and k=5/p=2, odd
# channel counts, and the discriminator's k=2/s=2 conv
B3_BWD_SITES = [(1, 6, 2, 2, 1, 8), (2, 6, 2, 2, 8, 8), (3, 6, 2, 2, 8, 16),
                (1, 3, 1, 0, 32, 64), (3, 3, 1, 0, 64, 64),
                (2, 3, 1, 1, 16, 16), (3, 5, 1, 2, 8, 1), (1, 3, 1, 1, 3, 6),
                (2, 2, 2, 0, 16, 32), (1, 6, 2, 1, 8, 8), (3, 3, 2, 0, 4, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("axis,k,stride,pad,ci,co", B3_BWD_SITES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_axis_dx_kernel_matches_plain(cuda_device, axis, k, stride, pad,
                                           ci, co, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    shape = [2, 9, 8, 11]
    length = shape[axis]
    lo = (length + 2 * pad - k) // stride + 1
    gshape = list(shape) + [co]
    gshape[axis] = lo
    gy = torch.randn(gshape, generator=g, device=cuda_device).to(dtype)
    w = (torch.randn(k, ci, co, generator=g, device=cuda_device)
         / (k * co) ** 0.5).to(dtype)
    before = K.conv_axis_dx.launches
    got = K.conv_axis_dx(gy, w, length=length, axis=axis, stride=stride,
                         pad=pad)
    torch.cuda.synchronize()
    assert K.conv_axis_dx.launches == before + 1
    ref = K.conv_axis_dx_plain(gy, w, length=length, axis=axis,
                               stride=stride, pad=pad)
    assert got.shape == ref.shape and got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("axis,k,stride,pad,ci,co", B3_BWD_SITES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_axis_dw_kernel_matches_plain(cuda_device, axis, k, stride, pad,
                                           ci, co, dtype):
    """dw and db (float32) within 2e-4 x max|ref|, as chip_smoke's dw
    gates; a second run repeats them bit for bit (no float atomics)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    shape = [2, 9, 8, 11]
    x = torch.randn(shape + [ci], generator=g, device=cuda_device).to(dtype)
    gshape = list(shape) + [co]
    gshape[axis] = (shape[axis] + 2 * pad - k) // stride + 1
    gy = torch.randn(gshape, generator=g, device=cuda_device).to(dtype)
    before = K.conv_axis_dw.launches
    dw, db = K.conv_axis_dw(x, gy, k=k, axis=axis, stride=stride, pad=pad)
    torch.cuda.synchronize()
    assert K.conv_axis_dw.launches == before + 1
    rdw, rdb = K.conv_axis_dw_plain(x, gy, k=k, axis=axis, stride=stride,
                                    pad=pad)
    assert dw.dtype == db.dtype == torch.float32
    for got, ref in ((dw, rdw), (db, rdb)):
        assert got.shape == ref.shape
        assert (got - ref).abs().max() <= 2e-4 * ref.abs().max()
    dw2, db2 = K.conv_axis_dw(x, gy, k=k, axis=axis, stride=stride, pad=pad)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    dw3, db3 = K.conv_axis_dw(x, gy, k=k, axis=axis, stride=stride, pad=pad,
                              bias=False)
    assert db3 is None and torch.equal(dw3, dw)


@pytest.mark.cuda
def test_conv_axis_bwd_many_chunks_and_tiles(cuda_device):
    """dw split over many row chunks (the first encoder stage's shape at
    batch 2, 48^3) and over many output tiles (Ci 256, Co 512); dx with
    weights past one block's shared memory (global-memory route)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(2, 48, 48, 48, 1, generator=g,
                    device=cuda_device).bfloat16()
    gy = torch.randn(2, 24, 48, 48, 8, generator=g,
                     device=cuda_device).bfloat16()
    plan = K.conv_axis_dw_plan(2 * 24 * 48 * 48, 6, 1, 8)
    assert plan.chunks > 100
    dw, db = K.conv_axis_dw(x, gy, k=6, axis=1, stride=2, pad=2)
    rdw, rdb = K.conv_axis_dw_plain(x, gy, k=6, axis=1, stride=2, pad=2)
    assert (dw - rdw).abs().max() <= 2e-4 * rdw.abs().max()
    assert (db - rdb).abs().max() <= 2e-4 * rdb.abs().max()
    x = torch.randn(3, 6, 6, 6, 256, generator=g, device=cuda_device)
    gy = torch.randn(3, 6, 6, 6, 512, generator=g, device=cuda_device)
    w = torch.randn(3, 256, 512, generator=g, device=cuda_device) / 40
    assert K.conv_axis_dw_plan(3 * 36 * 6, 3, 256, 512).tiles > 1
    dw, db = K.conv_axis_dw(x, gy, k=3, axis=3, stride=1, pad=1)
    rdw, rdb = K.conv_axis_dw_plain(x, gy, k=3, axis=3, stride=1, pad=1)
    assert (dw - rdw).abs().max() <= 2e-4 * rdw.abs().max()
    dx = K.conv_axis_dx(gy, w, length=6, axis=3, stride=1, pad=1)
    ref = K.conv_axis_dx_plain(gy, w, length=6, axis=3, stride=1, pad=1)
    assert (dx - ref).abs().max() <= 1e-5 * ref.abs().max()
    y = K.conv_axis(x, w, axis=3, stride=1, pad=1)
    ref = K.conv_axis_plain(x, w, axis=3, stride=1, pad=1)
    assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_separable_fn_on_the_card_matches_plain_autograd(cuda_device, dtype):
    """`SeparableConv3dFn` on the card (fused forward, recompute, dw, dx
    kernels) against autograd through the plain stack, at the first
    encoder stage's geometry; the launches it makes."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(2, 24, 20, 22, 1, generator=g,
                    device=cuda_device).to(dtype)
    ws = [(torch.randn(6, ci, 8, generator=g, device=cuda_device)
           / (6 * ci) ** 0.5).to(dtype) for ci in (1, 8, 8)]
    bs = [torch.randn(8, generator=g, device=cuda_device) for _ in range(3)]
    gy = torch.randn(2, 12, 10, 11, 8, generator=g,
                     device=cuda_device).to(dtype)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in ws + bs]
        fn(x, leaves).backward(gy)
        return [t.grad for t in leaves]

    K.reset_launch_counts()
    got = grads(lambda x, l: K.SeparableConv3dFn.apply(
        x, *l, (2, 2, 2), (2, 2, 2)))
    torch.cuda.synchronize()
    assert (K.separable_conv3d.launches, K.conv_axis.launches,
            K.conv_axis_dw.launches, K.conv_axis_dx.launches) == (1, 2, 3, 2)
    ref = grads(lambda x, l: K.separable_conv3d_plain(
        x, *l[:3], stride=(2, 2, 2), pad=(2, 2, 2), biases=tuple(l[3:])))
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        assert (a.float() - b.float()).abs().max() <= tol * b.float().abs(
        ).max()
