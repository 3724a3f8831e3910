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
    tc_before = K.conv_axis.tc_launches
    got = K.conv_axis(x, w, bias, axis=axis, stride=stride, pad=pad)
    torch.cuda.synchronize()
    assert K.conv_axis.launches == before + 1
    # bf16 takes the tensor-core kernel, float32 the CUDA-core one
    assert K.conv_axis.tc_launches == tc_before + (dtype == torch.bfloat16)
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
    # bf16 stacks with one output channel take three conv_axis launches
    fused = not (dtype == torch.bfloat16 and c == 1)
    assert K._separable_route(dtype, plan) == (
        "fused" if fused else "per_axis")
    before = (K.separable_conv3d.launches, K.conv_axis.launches)
    got = K.separable_conv3d(x, *ws, **kw)
    torch.cuda.synchronize()
    assert (K.separable_conv3d.launches, K.conv_axis.launches) == (
        before[0] + fused, before[1] + 3 * (not fused))
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


# dw's error bound against the float32 einsum of the same bf16 operands
# (`chip_smoke.py`'s DW_TOL): only the summation order differs
DW_TOL = 2e-4
# (N, Do, Ho, Wo) of g: odd, ragged extents, batch 1 and above
DW_SHAPES = ((2, 5, 7, 9), (1, 3, 4, 17), (3, 2, 9, 5), (1, 6, 3, 10))
DW_CASES = [(c8i, c8o, pad, DW_SHAPES[i % len(DW_SHAPES)])
            for i, (c8i, c8o, pad) in enumerate(
                (c8i, c8o, pad) for c8i in (8, 64, 384, 1024)
                for c8o in (64, 128, 256, 512, 1024) for pad in (0, 1))]
# channel counts that no tile divides, and a stride-2 conv's 8Co = Co
DW_CASES += [(24, 40, 1, (2, 4, 5, 6)), (136, 72, 0, (1, 7, 6, 11)),
             (512, 64, 0, (2, 6, 6, 6)), (1024, 128, 0, (3, 3, 3, 3))]


def _dw_operands(device, c8i, c8o, pad, shape, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    n, *cells = shape
    x_cells = [c + 1 - 2 * pad for c in cells]
    x = torch.randn(n, *x_cells, c8i, generator=gen,
                    device=device).to(torch.bfloat16)
    g = torch.randn(n, *cells, c8o, generator=gen,
                    device=device).to(torch.bfloat16)
    return x, g


@pytest.mark.cuda
@pytest.mark.parametrize("c8i,c8o,pad,shape", DW_CASES)
def test_dw_packed_kernel_matches_einsum(cuda_device, c8i, c8o, pad, shape):
    """The dw kernel against the float32 GEMMs of the same bf16 operands,
    with x unpadded (pad read from the extents): two launches a call."""
    x, g = _dw_operands(cuda_device, c8i, c8o, pad, shape, 11)
    before = (K.dw_packed.launches, K.dw_packed.fold_launches)
    got = K.dw_packed(x, g)
    torch.cuda.synchronize()
    assert (K.dw_packed.launches, K.dw_packed.fold_launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (2, 2, 2, c8i, c8o)
    ref = K.dw_packed_plain(x.float(), g.float())
    err = (got - ref).abs().max().item()
    assert err <= DW_TOL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("c8i,c8o,pad,shape", [
    (8, 64, 1, (2, 9, 9, 9)), (64, 128, 0, (2, 8, 8, 8)),
    (512, 256, 1, (2, 5, 5, 5))])
def test_dw_packed_is_reproducible_and_graph_safe(cuda_device, c8i, c8o,
                                                  pad, shape):
    """Two calls give the same bits (no atomics, a fixed fold order), and
    a CUDA graph's replay gives the eager call's bits."""
    x, g = _dw_operands(cuda_device, c8i, c8o, pad, shape, 12)
    first = K.dw_packed(x, g)
    second = K.dw_packed(x, g)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):
        K.dw_packed(x, g)     # the plan and the launch attributes, eagerly
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = K.dw_packed(x, g)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
def test_packed_train_step_on_the_card(cuda_device):
    """One bf16 packed train step at 32^3 through the kernels: 23 B1
    launches (11 of them dx), 12 dw kernels and their folds, no B2, finite
    loss, float32 master weights;
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
    assert (K.dw_packed.launches, K.dw_packed.fold_launches) == (12, 12)
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
    tc_before = K.conv_axis_dx.tc_launches
    got = K.conv_axis_dx(gy, w, length=length, axis=axis, stride=stride,
                         pad=pad)
    torch.cuda.synchronize()
    assert K.conv_axis_dx.launches == before + 1
    # bf16 takes the tensor-core kernel, float32 the CUDA-core one
    assert K.conv_axis_dx.tc_launches == tc_before + (dtype == torch.bfloat16)
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
    tc_before = K.conv_axis_dw.tc_launches
    dw, db = K.conv_axis_dw(x, gy, k=k, axis=axis, stride=stride, pad=pad)
    torch.cuda.synchronize()
    assert K.conv_axis_dw.launches == before + 1
    assert K.conv_axis_dw.tc_launches == tc_before + (dtype == torch.bfloat16)
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


# the tensor-core backward (bf16) at the CPU walks' ragged shapes (Ci in
# {1, 8}, Co no tile multiple, k/s/p of every kind, each axis), at e0's
# first stage (Ci = 1, Co = 8, batch 4) and at the AE's 512-wide H stage
TC_BWD_CASES = [((1, 7, 6, 9), ci, co, k, s, p, axis)
                for ci, co in ((1, 12), (8, 3), (8, 20))
                for k, s, p in ((3, 1, 1), (6, 2, 2), (2, 2, 0))
                for axis in (1, 2, 3)] + [
    ((4, 192, 192, 192), 1, 8, 6, 2, 2, 1),
    ((3, 6, 6, 6), 512, 512, 3, 1, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ci,co,k,s,p,axis", TC_BWD_CASES)
def test_axis_bwd_tensor_cores_match_plain(cuda_device, shape, ci, co, k, s,
                                           p, axis):
    """bf16 dw, db and dx through `conv_axis_bwd_tc.cu` against their
    plain versions (dw, db 2e-4 x max|ref|; dx 2^-7), counted in
    `.tc_launches`; two dw calls equal bit for bit; float32 inputs keep
    the CUDA-core kernels (no tensor-core launch)."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    shape = list(shape)
    x = torch.randn(shape + [ci], generator=g, device=cuda_device).bfloat16()
    gshape = shape + [co]
    gshape[axis] = (shape[axis] + 2 * p - k) // s + 1
    gy = torch.randn(gshape, generator=g, device=cuda_device).bfloat16()
    w = (torch.randn(k, ci, co, generator=g, device=cuda_device)
         / (k * co) ** 0.5).bfloat16()
    K.reset_launch_counts()
    dw, db = K.conv_axis_dw(x, gy, k=k, axis=axis, stride=s, pad=p)
    dw2, db2 = K.conv_axis_dw(x, gy, k=k, axis=axis, stride=s, pad=p)
    dx = K.conv_axis_dx(gy, w, length=shape[axis], axis=axis, stride=s,
                        pad=p)
    torch.cuda.synchronize()
    assert (K.conv_axis_dw.tc_launches, K.conv_axis_dx.tc_launches) == (2, 1)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    rdw, rdb = K.conv_axis_dw_plain(x, gy, k=k, axis=axis, stride=s, pad=p)
    for got, ref in ((dw, rdw), (db, rdb)):
        assert (got - ref).abs().max() <= 2e-4 * ref.abs().max()
    ref = K.conv_axis_dx_plain(gy, w, length=shape[axis], axis=axis,
                               stride=s, pad=p)
    assert dx.dtype == torch.bfloat16
    assert ((dx.float() - ref.float()).abs().max()
            <= 2.0 ** -7 * ref.float().abs().max())
    K.conv_axis_dw(x.float(), gy.float(), k=k, axis=axis, stride=s, pad=p)
    K.conv_axis_dx(gy.float(), w, length=shape[axis], axis=axis, stride=s,
                   pad=p)
    K.conv_axis_dx(gy, w.float(), length=shape[axis], axis=axis, stride=s,
                   pad=p)
    torch.cuda.synchronize()
    assert (K.conv_axis_dw.launches, K.conv_axis_dx.launches) == (3, 3)
    assert (K.conv_axis_dw.tc_launches, K.conv_axis_dx.tc_launches) == (2, 1)


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
    tc = 1 if dtype == torch.bfloat16 else 0
    assert (K.conv_axis_dw.tc_launches,
            K.conv_axis_dx.tc_launches) == (3 * tc, 2 * tc)
    # the recomputes of y1 and y2 take the tensor-core forward in bf16
    assert K.conv_axis.tc_launches == 2 * tc
    ref = grads(lambda x, l: K.separable_conv3d_plain(
        x, *l[:3], stride=(2, 2, 2), pad=(2, 2, 2), biases=tuple(l[3:])))
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        assert (a.float() - b.float()).abs().max() <= tol * b.float().abs(
        ).max()


# the tensor-core one-axis conv (bf16 x and w): the CPU walk's ragged
# shapes (Ci or Co 1, 8, 20; k/s/p of every kind; each axis: cp.async
# staging, 16-byte stores), shapes whose b extents are multiples of 8 (TMA
# staging; bulk stores at Co = 8, 16), then the recompute and per-axis
# sites of the fader (e0's D and H at batch 4) and of the depth-6 AE (a
# 192^3 16 -> 16 stage, the 16 -> 1 output, a 512-wide stage, the disc's
# 2 x 512 x 1024 along D and along W)
TC_FWD_CASES = [((1, 7, 6, 9), ci, co, k, s, p, axis)
                for ci, co in ((1, 8), (8, 20), (20, 1), (1, 1))
                for k, s, p in ((3, 1, 1), (6, 2, 2), (2, 2, 0))
                for axis in (1, 2, 3)] + [
    ((2, 9, 8, 16), ci, co, k, s, p, axis)
    for ci, co in ((1, 8), (8, 16), (16, 1), (32, 32))
    for k, s, p in ((3, 1, 1), (6, 2, 2))
    for axis in (1, 2, 3)] + [
    ((4, 192, 192, 192), 1, 8, 6, 2, 2, 1),
    ((4, 96, 192, 192), 8, 8, 6, 2, 2, 2),
    ((1, 192, 192, 192), 16, 16, 3, 1, 1, 2),
    ((1, 192, 192, 192), 16, 1, 3, 1, 1, 1),
    ((3, 6, 6, 6), 512, 512, 3, 1, 1, 2),
    ((3, 3, 3, 3), 512, 1024, 2, 2, 0, 1),
    ((3, 1, 1, 3), 1024, 1024, 2, 2, 0, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ci,co,k,s,p,axis", TC_FWD_CASES)
def test_axis_fwd_tensor_cores_match_plain(cuda_device, shape, ci, co, k, s,
                                           p, axis):
    """bf16 `conv_axis` through `conv_axis_tc.cu` against its plain version
    (2^-7 x max|ref|), the weights a (k, Ci, Co) view of torch's (Co, Ci,
    k) as the fader passes them, counted in `.tc_launches`; two calls
    equal bit for bit; float32 x or float32 w keep `conv_axis.cu`."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(list(shape) + [ci], generator=g,
                    device=cuda_device).bfloat16()
    w = (torch.randn(co, ci, k, generator=g, device=cuda_device)
         / (k * ci) ** 0.5).bfloat16().permute(2, 1, 0)
    bias = torch.randn(co, generator=g, device=cuda_device)
    kw = dict(axis=axis, stride=s, pad=p)
    K.reset_launch_counts()
    y = K.conv_axis(x, w, bias, **kw)
    y2 = K.conv_axis(x, w, bias, **kw)
    torch.cuda.synchronize()
    assert (K.conv_axis.launches, K.conv_axis.tc_launches) == (2, 2)
    assert torch.equal(y, y2)
    ref = K.conv_axis_plain(x, w, bias, **kw)
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert ((y.float() - ref.float()).abs().max()
            <= 2.0 ** -7 * ref.float().abs().max())
    K.conv_axis(x.float(), w, bias, **kw)
    K.conv_axis(x, w.float(), bias, **kw)
    torch.cuda.synchronize()
    assert (K.conv_axis.launches, K.conv_axis.tc_launches) == (4, 2)


@pytest.mark.cuda
def test_axis_fwd_tensor_cores_refuse_what_they_do_not_serve(cuda_device):
    """A bf16 call the tensor-core plan cannot serve (Ci = 1 with more than
    16 taps) raises: no fallback to the CUDA-core kernel."""
    x = torch.randn(1, 20, 4, 8, 1, device=cuda_device).bfloat16()
    w = torch.randn(17, 1, 8, device=cuda_device).bfloat16()
    K.reset_launch_counts()
    with pytest.raises(ValueError):
        K.conv_axis(x, w, axis=1)
    assert K.conv_axis.launches == 0


def _registration_pair(seed, shape=(48, 56, 40)):
    """A blob volume and the same volume under a small rigid motion."""
    import numpy as np

    from mri_epilepsy_diagnosis_torch.transforms import registration as TR

    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32)
                               for s in shape], indexing="ij"))
    vol = np.zeros(shape, np.float32)
    for _ in range(6):
        mu = rng.uniform(0.3, 0.7, 3) * np.array(shape)
        sd = rng.uniform(3.0, 6.0, 3)
        vol += np.exp(-np.square((g - mu[:, None, None, None])
                                 / sd[:, None, None, None]).sum(0))
    params = torch.tensor([2.0, -1.5, 1.0, 0.08, -0.06, 0.05]
                          + [0.0] * 6)
    moved = TR.apply_transform(vol, TR.params_to_affine(params, shape),
                               shape, device="cpu")
    return torch.from_numpy(vol), moved


@pytest.mark.cuda
def test_register_level_on_the_card_matches_cpu(cuda_device):
    """20 Adam steps of `_register_level` (the 12-parameter descent) on the
    card against the CPU: parameters 1e-4, loss 1e-5 at this size
    (chip_smoke.py's phase 10a holds 182 x 218 x 182 to 1e-3 and 1e-4:
    there Adam amplifies the two devices' float32 noise further)."""
    from mri_epilepsy_diagnosis_torch.transforms import registration as TR

    fixed, moving = _registration_pair(30)
    args = (torch.zeros(12), torch.ones(12), 20, 0.03)
    p_ref, loss_ref = TR._register_level(moving, fixed, *args)
    p, loss = TR._register_level(moving.to(cuda_device),
                                 fixed.to(cuda_device),
                                 *(a.to(cuda_device) for a in args[:2]),
                                 *args[2:])
    assert p.device.type == "cuda"
    assert (p.cpu() - p_ref).abs().max().item() <= 1e-4
    assert abs(loss.item() - loss_ref.item()) <= 1e-5


@pytest.mark.cuda
def test_bias_correction_on_the_card_matches_cpu(cuda_device):
    """`bias_field_correction` on the card (float64 normal equations; no
    TF32 matmul even when TF32 is on) against the CPU: 1e-4 x max|ref|."""
    from mri_epilepsy_diagnosis_torch.transforms import registration as TR

    vol, _ = _registration_pair(31)
    g = torch.meshgrid(*[torch.linspace(-1, 1, s) for s in vol.shape],
                       indexing="ij")
    corrupted = (vol + 0.1) * torch.exp(0.4 * g[0] - 0.2 * g[1] * g[2])
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got, bias = TR.bias_field_correction(corrupted.to(cuda_device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    ref, ref_bias = TR.bias_field_correction(corrupted)
    assert got.device.type == "cuda"
    assert (got.cpu() - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert (bias.cpu() - ref_bias).abs().max() <= 1e-4 * ref_bias.abs().max()


@pytest.mark.cuda
def test_patch_model_on_the_card_matches_cpu(cuda_device, no_tf32):
    """PatchModel's eval forward on 512 patches on the card against the CPU
    port with the same weights: 1e-4 x max|ref|; its default device is
    the card."""
    from mri_epilepsy_diagnosis_torch.models import PatchModel

    torch.manual_seed(32)
    cpu = PatchModel(device="cpu").eval()
    card = PatchModel().eval()
    assert next(card.parameters()).device.type == "cuda"
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(512, 16, 32, 2, generator=torch.Generator().manual_seed(
        33))
    with torch.no_grad():
        got = card(x.to(cuda_device))
        ref = cpu(x)
    assert (got.cpu() - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
def test_detection_entry_points_default_to_the_card(cuda_device):
    """Without `device`, registration takes an array to the card and the
    mask generator sends its patches there."""
    import numpy as np

    from mri_epilepsy_diagnosis_torch.infer import FCDMaskGenerator
    from mri_epilepsy_diagnosis_torch.transforms import registration as TR

    fixed, moving = _registration_pair(34, (24, 24, 24))
    aff, warped = TR.register_affine(moving.numpy(), fixed.numpy(),
                                     levels=(2, 1), iters=(5, 5),
                                     search=False)
    assert warped.device.type == "cuda" and aff.shape == (4, 4)
    seen = []

    def model(x):
        seen.append(x.device.type)
        return torch.zeros(x.shape[0], 2, device=x.device)

    gmpm = np.zeros((96, 96, 2), np.float32)
    gmpm[10:86, 20:76] = 1.0
    mask = FCDMaskGenerator(model, gmpm, batch_size=64).get_mask(
        np.random.default_rng(0).random((96, 96, 2)))
    assert seen and set(seen) == {"cuda"} and mask.shape == (96, 96, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride", [(2, None), (4, 2), (3, None)])
def test_maxpool3d_grad_on_the_card_matches_cpu(cuda_device, kernel, stride):
    """The max-pool gradients at tied maxima (block, composed k=4 s=2 and
    ragged cases) are the same on the card as on the CPU."""
    from mri_epilepsy_diagnosis_torch.ops import functional as F

    x = torch.randint(0, 3, (2, 8, 10, 9, 3),
                      generator=torch.Generator().manual_seed(35)).float()
    grads = []
    for dev in ("cpu", cuda_device):
        xd = x.to(dev).clone().requires_grad_(True)
        y = F.maxpool3d(xd, kernel, stride)
        y.backward(torch.arange(y.numel(), dtype=torch.float32).reshape(
            y.shape).to(dev) % 5)
        grads.append(xd.grad.cpu())
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride,padding", [(3, 2, 1), (2, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_maxpool3d_padding_on_the_card_matches_cpu(cuda_device, kernel,
                                                   stride, padding, dtype):
    """Padded pools (-inf, or the integer minimum, as JAX's
    `reduce_window`) give the CPU's values on the card."""
    from mri_epilepsy_diagnosis_torch.ops import functional as F

    x = torch.randint(-100, 100, (2, 7, 6, 9, 3),
                      generator=torch.Generator().manual_seed(36)).to(dtype)
    ref = F.maxpool3d(x, kernel, stride, padding)
    got = F.maxpool3d(x.to(cuda_device), kernel, stride, padding)
    assert got.dtype == dtype and torch.equal(got.cpu(), ref)


def _int8(shape, g, dev):
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("c8i,c8o", [(8, 64), (64, 128), (256, 256),
                                     (40, 24), (512, 512), (128, 192)])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("shape", [(2, 7, 6, 9), (1, 3, 2, 17)])
def test_conv2_packed_s8_raw_matches_plain(cuda_device, shape, pad, c8i, c8o):
    """K1's int32 sums equal the plain version's exactly, at extents that
    no 128-row tile divides: the wgmma route (8Ci, 8Co multiples of 64;
    64-byte K steps at 8Ci = 64, two N tiles at 8Co = 512, 8Co = 192 in
    three) and the mma.sync route (the 8Ci = 8 stem, 8Co below 64)."""
    g = torch.Generator(device=cuda_device).manual_seed(c8i + pad)
    x8 = _int8((*shape, c8i), g, cuda_device)
    w8 = _int8((2, 2, 2, c8i, c8o), g, cuda_device)
    wgmma = K._conv2_s8_route(c8i, c8o) == "wgmma"
    before = (K.conv2_packed_s8.launches, K.conv2_packed_s8.fused_launches,
              K.conv2_packed_s8.wgmma_launches)
    got = K.conv2_packed_s8(x8, w8, pad=pad)
    torch.cuda.synchronize()
    assert (K.conv2_packed_s8.launches, K.conv2_packed_s8.fused_launches,
            K.conv2_packed_s8.wgmma_launches) == (
        before[0] + 1, before[1], before[2] + wgmma)
    ref = K.conv2_packed_s8_plain(x8, w8, pad=pad)
    assert got.dtype == torch.int32 and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("addend", [False, True])
@pytest.mark.parametrize("c8i,c8o", [(8, 64), (128, 256), (16, 24),
                                     (64, 128), (256, 512)])
@pytest.mark.parametrize("pad", [0, 1])
def test_conv2_packed_s8_fused_matches_plain(cuda_device, pad, c8i, c8o,
                                             addend):
    """K1 with JAX's `_epilogue` fused: int8 equal to the plain version's
    float32 operations in the same order (rint ties to even, no FMA), one
    shared PReLU slope or one per channel, saturating values clipped, on
    both routes."""
    g = torch.Generator(device=cuda_device).manual_seed(7 + c8i)
    x8 = _int8((2, 5, 4, 7, c8i), g, cuda_device)
    w8 = _int8((2, 2, 2, c8i, c8o), g, cuda_device)
    dq = torch.rand(c8o, generator=g, device=cuda_device) * 1e-4
    b = torch.randn(c8o, generator=g, device=cuda_device)
    alpha = (torch.tensor([0.25], device=cuda_device) if c8o % 16
             else torch.rand(c8o, generator=g, device=cuda_device))
    rq = 10 + 50 * torch.rand(c8o, generator=g, device=cuda_device)
    step = 1 if pad else -1
    add = (torch.randn((2, 5 + step, 4 + step, 7 + step, c8o), generator=g,
                       device=cuda_device) if addend else None)
    kw = dict(pad=pad, dq=dq, bias=b, alpha=alpha, rq=rq, addend=add)
    got = K.conv2_packed_s8(x8, w8, **kw)
    torch.cuda.synchronize()
    ref = K.conv2_packed_s8_plain(
        x8, w8, pad=pad, dq=dq, bias=b, alpha=alpha.expand(c8o), rq=rq,
        addend=add)
    assert got.dtype == torch.int8 and torch.equal(got, ref)
    assert (ref.abs() == 127).any() and (ref != 0).float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("c8i,c8o", [(64, 64), (256, 128), (512, 256),
                                     (128, 192), (256, 512)])
@pytest.mark.parametrize("cells", [(3, 4, 2), (6, 6, 6), (1, 5, 3)])
def test_upconv_packed_s8_matches_plain(cuda_device, cells, c8i, c8o):
    """K2's 8 parity classes in one persistent wgmma launch: int32 equal
    to the plain version (and so to JAX's `upconv_int8`,
    tests/test_torch_quant.py), 64-byte K steps at 8Ci = 64, several N
    tiles at 8Co = 192 and 512."""
    from mri_epilepsy_diagnosis_torch.ops import packed as P

    g = torch.Generator(device=cuda_device).manual_seed(c8i)
    xe = P.edge_pad_cells(_int8((2, *cells, c8i), g, cuda_device))
    wk8 = _int8((5, 5, 5, c8i, c8o), g, cuda_device)
    before = K.upconv_packed_s8.launches
    got = K.upconv_packed_s8(xe, wk8)
    torch.cuda.synchronize()
    assert K.upconv_packed_s8.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, K.upconv_packed_s8_plain(xe, wk8))


# the 10 K1 sites of the served int8 UNet3D at 192^3, batch 1: (input
# cells, 8Ci, 8Co, pad, addend); the 2 K2 sites: (padded cells, 8Ci, 8Co)
S8_SERVED_K1 = {"e0c1": (96, 8, 64, 1, False),
                "e0c2": (97, 64, 128, 0, False),
                "e1c1": (48, 128, 128, 1, False),
                "e1c2": (49, 128, 256, 0, False),
                "bc1": (24, 256, 256, 1, False),
                "bc2": (25, 256, 512, 0, False),
                "d0c1": (48, 256, 256, 1, True),
                "d0c2": (49, 256, 256, 0, False),
                "d1c1": (96, 128, 128, 1, True),
                "d1c2": (97, 128, 128, 0, False)}
S8_SERVED_K2 = {"d0": (26, 512, 256), "d1": (50, 256, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(S8_SERVED_K1))
def test_conv2_packed_s8_served_site_matches_plain(cuda_device, site):
    """K1 at every served site's shape, 192^3, batch 1: raw int32 and the
    fused int8 epilogue (with the decoder's addend where it has one) equal
    to the plain version, on the route the site takes."""
    cells, c8i, c8o, pad, has_add = S8_SERVED_K1[site]
    g = torch.Generator(device=cuda_device).manual_seed(len(site) + c8o)
    x8 = _int8((1, cells, cells, cells, c8i), g, cuda_device)
    w8 = _int8((2, 2, 2, c8i, c8o), g, cuda_device)
    out = cells + (1 if pad else -1)
    kw = dict(dq=torch.rand(c8o, generator=g, device=cuda_device) * 2e-5,
              bias=torch.randn(c8o, generator=g, device=cuda_device),
              alpha=torch.rand(c8o, generator=g, device=cuda_device),
              rq=10 + 50 * torch.rand(c8o, generator=g, device=cuda_device),
              addend=(torch.randn((1, out, out, out, c8o), generator=g,
                                  device=cuda_device) if has_add else None))
    before = K.conv2_packed_s8.wgmma_launches
    raw = K.conv2_packed_s8(x8, w8, pad=pad)
    fused = K.conv2_packed_s8(x8, w8, pad=pad, **kw)
    torch.cuda.synchronize()
    wgmma = K._conv2_s8_route(c8i, c8o) == "wgmma"
    assert wgmma == (site != "e0c1")
    assert K.conv2_packed_s8.wgmma_launches == before + 2 * wgmma
    assert torch.equal(raw, K.conv2_packed_s8_plain(x8, w8, pad=pad))
    del raw
    assert torch.equal(fused, K.conv2_packed_s8_plain(x8, w8, pad=pad, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(S8_SERVED_K2))
def test_upconv_packed_s8_served_site_matches_plain(cuda_device, site):
    padded, c8i, c8o = S8_SERVED_K2[site]
    g = torch.Generator(device=cuda_device).manual_seed(c8i)
    xe = _int8((1, padded, padded, padded, c8i), g, cuda_device)
    wk8 = _int8((5, 5, 5, c8i, c8o), g, cuda_device)
    got = K.upconv_packed_s8(xe, wk8)
    torch.cuda.synchronize()
    assert torch.equal(got, K.upconv_packed_s8_plain(xe, wk8))


def _misaligned(t):
    """t's values in a tensor whose data starts 1 byte past 16-byte
    alignment (contiguous)."""
    flat = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.int8,
                       device=t.device)
    off = (16 - flat.data_ptr() % 16) % 16 + 1
    out = flat[off:off + t.numel() * t.element_size()].view(t.dtype)
    return out.view(t.shape).copy_(t)


@pytest.mark.cuda
def test_s8_wrappers_raise_on_strided_or_misaligned_inputs(cuda_device):
    """K1 and K2 take contiguous, 16-byte-aligned tensors and copy none:
    a strided or misaligned input, a K2 width the wgmma kernel does not
    serve, raise before any launch."""
    g = torch.Generator(device=cuda_device).manual_seed(40)
    x8 = _int8((1, 4, 5, 6, 128), g, cuda_device)
    w8 = _int8((2, 2, 2, 64, 64), g, cuda_device)
    before = (K.conv2_packed_s8.launches, K.upconv_packed_s8.launches)
    with pytest.raises(ValueError, match="contiguous"):
        K.conv2_packed_s8(x8[..., ::2], w8, pad=1)
    with pytest.raises(ValueError, match="aligned"):
        K.conv2_packed_s8(_misaligned(x8[..., :64].contiguous()), w8, pad=0)
    add = torch.zeros((1, 5, 7, 6, 64), device=cuda_device).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        K.conv2_packed_s8(x8[..., :64].contiguous(), w8, pad=1,
                          dq=torch.ones(64, device=cuda_device),
                          rq=torch.ones(64, device=cuda_device), addend=add)
    xe = _int8((1, 5, 5, 5, 64), g, cuda_device)
    wk8 = _int8((5, 5, 5, 64, 64), g, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        K.upconv_packed_s8(xe.transpose(1, 2), wk8)
    with pytest.raises(ValueError, match="aligned"):
        K.upconv_packed_s8(_misaligned(xe), wk8)
    with pytest.raises(ValueError, match="multiples"):
        K.upconv_packed_s8(xe[..., :24].contiguous(), wk8[..., :24, :])
    assert (K.conv2_packed_s8.launches,
            K.upconv_packed_s8.launches) == before


def _int8_unet(dev, size=32):
    """A seeded UNet3D (out_channels_first_layer 8), quantized on two
    volumes, and a batch of inputs."""
    from mri_epilepsy_diagnosis_torch.models import UNet3D
    from mri_epilepsy_diagnosis_torch.models import unet_packed_q as Q

    torch.manual_seed(37)
    model = UNet3D(out_channels_first_layer=8, device="cpu").eval()
    x = torch.randn((2, size, size, size, 1),
                    generator=torch.Generator().manual_seed(38))
    q = Q.quantize_inference(model.state_dict(), x)
    return q, x


@pytest.mark.cuda
def test_int8_unet_on_the_card_matches_cpu(cuda_device):
    """`packed_unet_mask_v2_int8` and its logits on the card (K1 10
    launches, all with the epilogue fused, K2 2, no B1) against the CPU's plain
    versions: int8 activations equal except where the float32 face fixes
    round differently, masks agreeing >= 0.999."""
    from mri_epilepsy_diagnosis_torch.models import unet_packed_q as Q

    q, x = _int8_unet("cpu")
    with torch.no_grad():
        ref = Q.packed_unet_apply_v2_int8(q, x)
        ref_mask = Q.packed_unet_mask_v2_int8(q, x)
    qd = {k: ({kk: None if vv is None else vv.to(cuda_device)
               for kk, vv in v.items()} if isinstance(v, dict)
              else v.to(cuda_device) if torch.is_tensor(v) else v)
          for k, v in q.items()}
    K.reset_launch_counts()
    with torch.no_grad():
        mask = Q.packed_unet_mask_v2_int8(qd, x.to(cuda_device))
    torch.cuda.synchronize()
    assert (K.conv2_packed_s8.launches, K.conv2_packed_s8.fused_launches,
            K.upconv_packed_s8.launches, K.conv2_packed.launches) == (
        10, 10, 2, 0)
    with torch.no_grad():
        got = Q.packed_unet_apply_v2_int8(qd, x.to(cuda_device)).cpu()
    assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()
    assert (mask.cpu() == ref_mask).float().mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["composed", "hybrid"])
def test_composed_up_branch_on_the_card_matches_cpu(cuda_device, no_tf32,
                                                    form):
    """The float composed up branch (one cuDNN transposed conv, the face
    fixes through 2-D cuDNN convs, TF32 off) and its gradients, card
    against CPU in f32: 1e-5 x max."""
    from mri_epilepsy_diagnosis_torch.ops import packed as P

    gen = torch.Generator().manual_seed(39)
    x = torch.randn((2, 6, 5, 6, 64), generator=gen)
    w = torch.randn((16, 8, 3, 3, 3), generator=gen)
    gy = torch.randn((2, 13, 11, 13, 128), generator=gen)
    out = []
    for dev in ("cpu", cuda_device):
        xd = x.detach().to(dev).requires_grad_()
        wd = w.detach().to(dev).requires_grad_()
        core = (P.upconv_core_hybrid(xd, wd) if form == "hybrid"
                else P.upconv_packed(xd, P.pack_upconv_weights(wd)))
        y = P.upconv_fix_faces(core, xd, wd)
        y.backward(gy.to(dev))
        out.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
    for a, b in zip(*out):
        assert (b - a).abs().max() <= 1e-5 * a.abs().max()


# the segmentation zoo at narrow widths (32^3, batch 2): name -> (class,
# constructor kwargs)
ZOO_SMALL = {
    "residual": ("ResidualUNet3D", dict(n_classes=2,
                                        n_channels=(1, 4, 8, 16, 32))),
    "residual_bayes": ("ResidualUNet3D", dict(n_classes=2,
                                              n_channels=(1, 4, 8, 16, 32),
                                              bayes=True)),
    "modified": ("Modified3DUNet", dict(in_channels=1, n_classes=2,
                                        base_n_filter=4)),
    "brats": ("BraTSUnet", dict(c=1, n=8, dropout=0.5, norm="gn",
                                num_classes=2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ZOO_SMALL))
def test_zoo_step_on_the_card_matches_cpu(cuda_device, no_tf32, name):
    """One f32 `seg_train_step` of each zoo model (cuDNN convs, TF32 off)
    on the card against the CPU, with the same host-drawn noise and
    masks (`chip_smoke.host_draws`), as phase 12a holds it: loss 1e-5 in
    f32; the step's gradients in f64 on both devices, 1e-10 x max|ref| per
    tensor (f32 rounding alone moves Modified3DUNet's by percents); the
    card's AdamW step on the CPU's f32 gradients gives the CPU's
    parameters within 1e-6 (`chip_smoke.adamw_step_on`); no kernel of the
    port launches."""
    import copy

    from chip_smoke import (ZOO_GRAD64_RTOL, ZOO_OPT_ATOL, adamw_step_on,
                            grads_of, host_draws)
    from mri_epilepsy_diagnosis_torch import models
    from mri_epilepsy_diagnosis_torch.train import seg as TS
    from mri_epilepsy_diagnosis_torch.train.optim import torch_adamw
    from mri_epilepsy_diagnosis_torch.train.state import create_train_state

    cls, kw = ZOO_SMALL[name]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = getattr(models, cls)(**kw, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 32, 32, 32, 1), generator=gen)
    y = (torch.rand((2, 32, 32, 32, 1), generator=gen) > 0.6).float()
    out = []
    K.reset_launch_counts()
    for dev in ("cpu", cuda_device):
        state = create_train_state(copy.deepcopy(model).to(dev),
                                   torch_adamw())
        with host_draws(2):
            state, loss = TS.seg_train_step(state, x.to(dev), y.to(dev))
        m64 = copy.deepcopy(model).to(dev, torch.float64).train()
        with host_draws(2):
            TS.seg_loss(m64, x.to(dev, torch.float64),
                        y.to(dev, torch.float64)).backward()
        out.append((loss.item(), grads_of(state.model), grads_of(m64),
                    {k: p.detach().cpu()
                     for k, p in state.model.named_parameters()}))
    torch.cuda.synchronize()
    assert sum(k.launches for k in K.KERNELS) == 0
    (l_cpu, g_cpu, g64_cpu, p_cpu), (l_gpu, _, g64_gpu, _) = out
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for k, ref in g64_cpu.items():
        assert ((g64_gpu[k] - ref).abs().max()
                <= ZOO_GRAD64_RTOL * ref.abs().max()), k
    on_card = adamw_step_on(model, g_cpu, cuda_device)
    for k, ref in p_cpu.items():
        assert (on_card[k] - ref).abs().max() <= ZOO_OPT_ATOL, k


# ---------------------------------------------------------------------------
# the packed encoders' kernel sites (VoxResNet's B1, the packed fader's B3)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 1])
def test_conv2_packed_tc_at_8ci_1024_over_3_cells(cuda_device, pad):
    """VoxResNet's last stage at 192^3: 8Ci = 8Co = 1024 over 3^3 cells
    (batch 10), forward and dx on the tensor cores."""
    g = torch.Generator(device=cuda_device).manual_seed(41)
    cells = 3 if pad else 4
    x = torch.randn(10, cells, cells, cells, 1024, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    wp = (torch.randn(2, 2, 2, 1024, 1024, generator=g, device=cuda_device)
          / 90.0).to(torch.bfloat16)
    before = K.conv2_packed.tc_launches
    got = K.conv2_packed(x, wp, pad=pad)
    gy = torch.randn(got.shape, generator=g,
                     device=cuda_device).to(torch.bfloat16)
    dx = K.conv2_packed_dx(gy, wp, pad=pad)
    torch.cuda.synchronize()
    assert K.conv2_packed.tc_launches == before + 2
    for out, ref in ((got, K.conv2_packed_plain(x, wp, pad=pad)),
                     (dx, K.conv2_packed_dx_plain(gy, wp, pad=pad))):
        assert out.shape == ref.shape
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 2.0 ** -7 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ci,co", [(torch.bfloat16, 32, 64),
                                         (torch.bfloat16, 64, 128),
                                         (torch.float32, 2, 4),
                                         (torch.float32, 4, 8)])
def test_downsample_and_pack4_stem_launches_match_plain(cuda_device, dtype,
                                                        ci, co):
    """`conv3s2_packed_aa`'s launch over the low-padded input and the pack4
    stem's aligned->shifted launch, each against `conv2_packed_plain`, and
    the downsample against the fine stride-2 conv (cuDNN, TF32 off)."""
    from mri_epilepsy_diagnosis_torch.ops import packed as P

    g = torch.Generator(device=cuda_device).manual_seed(ci + co)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    x = torch.randn(2, 12, 12, 12, 8 * ci, generator=g,
                    device=cuda_device).to(dtype)
    wk = (torch.randn(2, 2, 2, 8 * ci, co, generator=g, device=cuda_device)
          / (8 * ci) ** 0.5).to(dtype)
    xpad = torch.nn.functional.pad(x, (0, 0, 1, 0, 1, 0, 1, 0))
    before = K.conv2_packed.launches
    got = K.conv2_packed(xpad, wk, pad=0)
    vol = torch.randn(2, 24, 24, 24, 1, generator=g,
                      device=cuda_device).to(dtype)
    w1 = torch.randn(ci, 1, 3, 3, 3, generator=g, device=cuda_device)
    wp4 = P.pack_input_weights_s2_p4(w1).to(dtype)
    stem = K.conv2_packed(P.pack4(vol), wp4, pad=1)
    torch.cuda.synchronize()
    assert K.conv2_packed.launches == before + 2
    for out, ref in ((got, K.conv2_packed_plain(xpad, wk, pad=0)),
                     (stem, K.conv2_packed_plain(P.pack4(vol), wp4, pad=1))):
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item()
    if dtype == torch.float32:
        # the downsample and its gradients (dx a B1 launch; Co = 4 runs on
        # zero channels padded to 8) against the fine conv's
        w = torch.randn(co, ci, 3, 3, 3, generator=g, device=cuda_device,
                        requires_grad=True)
        fine = torch.randn(2, 16, 16, 16, ci, generator=g, device=cuda_device,
                           requires_grad=True)
        gy = torch.randn(2, 8, 8, 8, co, generator=g, device=cuda_device)
        with torch.backends.cudnn.flags(allow_tf32=False):
            ref = torch.nn.functional.conv3d(
                fine.permute(0, 4, 1, 2, 3), w, stride=2,
                padding=1).permute(0, 2, 3, 4, 1)
            ref_g = torch.autograd.grad(ref, (fine, w), gy)
        before = K.conv2_packed_dx.launches
        out = P.unpack2(P.conv3s2_packed_aa(P.pack2(fine),
                                            P.pack_weights2_s2(w)))
        got_g = torch.autograd.grad(out, (fine, w), gy)
        assert K.conv2_packed_dx.launches == before + 1
        for a, r in zip((out, *got_g), (ref, *ref_g)):
            assert (a - r).abs().max() <= 1e-5 * r.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cells,chans", [(48, (8, 64, 64, 64)),
                                         (12, (64, 128, 128, 128)),
                                         (6, (128, 256, 256, 256))],
                         ids=["e0", "e1", "e2"])
def test_packed_encoder_stacks_match_plain(cuda_device, dtype, cells,
                                           chans):
    """B3 at the packed fader encoder's stacks (Q = 4 cells, stride 2, pad
    1; e0 at half its 192^3 extent), through whatever route
    `_separable_route` gives, against `separable_conv3d_plain`."""
    g = torch.Generator(device=cuda_device).manual_seed(cells)
    x = torch.randn(2, cells, cells, cells, chans[0], generator=g,
                    device=cuda_device).to(dtype)
    ws = [(torch.randn(4, ci, co, generator=g, device=cuda_device)
           / (4 * ci) ** 0.5).to(dtype) for ci, co in zip(chans, chans[1:])]
    bs = tuple(torch.randn(co, generator=g, device=cuda_device)
               for co in chans[1:])
    kw = dict(stride=(2, 2, 2), pad=(1, 1, 1), biases=bs)
    before = K.separable_conv3d.launches + K.conv_axis.launches
    got = K.separable_conv3d(x, *ws, **kw)
    torch.cuda.synchronize()
    assert K.separable_conv3d.launches + K.conv_axis.launches > before
    ref = K.separable_conv3d_plain(x, *ws, **kw)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
def test_packed_voxresnet_bf16_step_on_the_card_matches_cpu(cuda_device):
    """One bf16 `voxresnet_class_step_packed` (32^3, 32 filters, 3 stages,
    batch 2, no dropout: a host generator seeds another mask on the card)
    on the card, every conv on B1's tensor cores (17 forward, 16 dx),
    against the same step on the CPU (plain versions): its loss,
    probabilities and gradients (all but the pre-BN biases, whose true
    gradient is 0, as one vector) differ from the CPU's by at most twice
    what bf16 itself moves them, the CPU's bf16 step against its f32 step
    (the last stage normalizes 16 values a channel, so that is
    percents)."""
    import copy

    from mri_epilepsy_diagnosis_torch.models import VoxResNet
    from mri_epilepsy_diagnosis_torch.models import voxresnet_packed as V
    from mri_epilepsy_diagnosis_torch.train import TrainState
    from mri_epilepsy_diagnosis_torch.train.optim import torch_adam

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = VoxResNet(input_shape=(32,) * 3, n_filters=32, n_blocks=3,
                          n_fc_units=16, device="cpu")
    x = torch.randn((2, 32, 32, 32, 1),
                    generator=torch.Generator().manual_seed(5))
    y = torch.tensor([0, 1])
    skip = ("model.conv3d_1.bias", "model.conv3d_2.bias")
    runs = []
    for dev, dtype in (("cpu", torch.float32), ("cpu", torch.bfloat16),
                       (cuda_device, torch.bfloat16)):
        m = copy.deepcopy(model).to(dev)
        state = TrainState(m, torch_adam(1e-5, weight_decay=0.01)(
            m.parameters()))
        K.reset_launch_counts()
        _, loss, probs = V.voxresnet_class_step_packed(
            state, x.to(dev, dtype), y.to(dev), None)
        grad = torch.cat([p.grad.float().cpu().flatten()
                          for n, p in m.named_parameters() if n not in skip])
        runs.append((float(loss), probs.cpu(), grad,
                     (K.conv2_packed.launches, K.conv2_packed.tc_launches,
                      K.conv2_packed_dx.launches)))
    (l32, p32, g32, _), (l16, p16, g16, _), (lc, pc, gc, counts) = runs
    assert counts == (33, 33, 16)

    def dist(a, b):
        return (abs(a[0] - b[0]), float((a[1] - b[1]).abs().max()),
                1 - float(torch.nn.functional.cosine_similarity(
                    a[2], b[2], dim=0)))

    bf16_own = dist((l16, p16, g16), (l32, p32, g32))
    card = dist((lc, pc, gc), (l16, p16, g16))
    for got, own in zip(card, bf16_own):
        assert got <= 2 * own + 1e-6, (card, bf16_own)


# ---------------------------------------------------------------------------
# distribution on the card: an NCCL group of one rank (one card: NCCL
# refuses two ranks on one device; ranks > 1 are tested on the CPU with
# gloo), and fault C3's gate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_mesh():
    """A (data, spatial) = (1, 1) mesh over an NCCL group of world size 1,
    torn down after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs on the card")
    import socket

    import torch.distributed as dist

    from mri_epilepsy_diagnosis_torch.core.mesh import (
        create_mesh, initialize_distributed)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")
    assert dist.get_backend() == "nccl"
    yield create_mesh(("data", "spatial"), (1, 1))
    dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_world_one_packed_step_matches_the_plain_step(nccl_mesh,
                                                           no_tf32):
    """The packed step under the NCCL mesh (BatchNorm and dice sums and
    the gradients all-reduced) against the same step without it, f32 at
    32^3 batch 2: loss 1e-5 relative, each gradient 1e-4 x its max plus
    1e-6 x the largest, the same B1 launches (23 per step)."""
    import copy

    from mri_epilepsy_diagnosis_torch.parallel import use_mesh
    from mri_epilepsy_diagnosis_torch.train import seg as TS
    from mri_epilepsy_diagnosis_torch.train.optim import torch_adamw
    from mri_epilepsy_diagnosis_torch.train.state import TrainState

    model, x, labels = _seg_case(nccl_mesh.device, 32, 2, 5)
    out = {}
    for name, mesh in (("plain", None), ("mesh", nccl_mesh)):
        m = copy.deepcopy(model)
        state = TrainState(m, torch_adamw()(m.parameters()))
        K.reset_launch_counts()
        with use_mesh(mesh):
            _, loss = TS.packed_seg_train_step(state, x, labels)
        torch.cuda.synchronize()
        out[name] = (loss.item(), {n: p.grad for n, p in
                                   m.named_parameters()},
                     K.conv2_packed.launches)
    (lp, gp, cp), (lm, gm, cm) = out["plain"], out["mesh"]
    assert cp == cm == 23
    assert abs(lm - lp) <= 1e-5 * abs(lp)
    largest = max(g.abs().max().item() for g in gp.values())
    for n, g in gp.items():
        err = (gm[n] - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item() + 1e-6 * largest, n


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["zeros", "edge"])
def test_halo_exchange_world_one_on_cuda(nccl_mesh, mode):
    """At one spatial rank both halos are the volume's faces, on CUDA
    tensors: zero planes or the boundary plane, gradients folded back."""
    from mri_epilepsy_diagnosis_torch.parallel import halo_exchange

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 5, 3, 4, 8, generator=g,
                    device="cuda").requires_grad_(True)
    h = halo_exchange(x, nccl_mesh.group("spatial"), 2, dim=1, mode=mode)
    idx = torch.arange(-2, 7, device="cuda")
    ref = (x[:, idx.clamp(0, 4)] if mode == "edge" else
           torch.nn.functional.pad(x, (0,) * 6 + (2, 2)))
    assert h.is_cuda and torch.equal(h, ref)
    cot = torch.randn(h.shape, generator=g, device="cuda")
    (gh,) = torch.autograd.grad(h, x, cot)
    (gr,) = torch.autograd.grad(ref, x, cot)
    torch.testing.assert_close(gh, gr)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unet3d", "residual_unet3d"])
def test_c3_f32_forwards_with_tf32_allowed_match_cpu(cuda_device, name):
    """Fault C3: with cuDNN allowed TF32 (torch's default; no `no_tf32`
    here), the float32 fine forwards of `ops/functional.py` run their
    convs in full float32 on the card: logits within 1e-4 x max|ref| of
    the CPU's."""
    import copy

    from mri_epilepsy_diagnosis_torch import models

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = (models.UNet3D(out_channels_first_layer=8, device="cpu")
                     if name == "unet3d" else models.ResidualUNet3D(
                         n_classes=2, n_channels=(1, 8, 16, 32, 64),
                         device="cpu")).eval()
        x = torch.randn(1, 32, 32, 32, 1,
                        generator=torch.Generator().manual_seed(1))
        with torch.inference_mode():
            ref = model(x)
            got = copy.deepcopy(model).to(cuda_device)(x.to(cuda_device))
        err = (got.cpu() - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item(), err
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
def test_step_timer_waits_for_the_card(cuda_device):
    """`StepTimer.stop(t)` synchronizes t's device before reading the
    clock: a step of queued matmuls times as long as its synchronized run,
    not as its enqueue."""
    from mri_epilepsy_diagnosis_torch.obs import StepTimer

    a = torch.randn(4096, 4096, device=cuda_device)

    def work():
        y = a
        for _ in range(20):
            y = a @ y / 64.0
        return y

    work()
    torch.cuda.synchronize()
    done = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    timer = StepTimer()
    timer.start()
    start.record()
    y = work()
    done.record()
    timer.stop(y)
    assert done.query()                      # the card had finished
    assert timer.times[0] * 1e3 >= 0.9 * start.elapsed_time(done)


@pytest.mark.cuda
def test_collect_latents_runs_fused_b3_and_matches_cpu(cuda_device):
    """`collect_latents` on the card: one fused separable launch per stack
    and batch (the encoder's DownBlock and each head's stack), no one-axis
    launch, and the CPU's latents within 1e-4 x max in float32."""
    import copy

    import numpy as np

    from mri_epilepsy_diagnosis_torch.models import fader as TFd
    from mri_epilepsy_diagnosis_torch.obs.analysis import collect_latents

    down = dict(conv_k=6, conv_pad=2, conv_s=2, maxpool_k=2, maxpool_s=2,
                batch_norm=True, act="l_relu")
    enc_kw = dict(c_in=1, deapth=2, c_base=8, inc_size=2,
                  down_block_kwargs=down)
    head = dict(c_in=16, c_out=32, conv_k=3, conv_s=1, conv_pad=0, l_in=32,
                l_out=16, batch_norm=True, act="relu", p_drop=0.5)
    torch.manual_seed(0)
    enc = TFd.make_encoder(enc_kw, device="cpu")
    clf = TFd.Classificator(n_class=2, device="cpu", **head)
    disc = TFd.Discriminator(n_domains=3, device="cpu", **head)
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(2, 48, 48, 48, 1)).astype(np.float32),
                np.array([0, 1]), np.array([2, 0])) for _ in range(2)]
    ref = collect_latents(enc, batches, disc=disc, clf=clf, device="cpu")
    on_card = [copy.deepcopy(m).to(cuda_device) for m in (enc, clf, disc)]
    K.reset_launch_counts()
    got = collect_latents(on_card[0], batches, disc=on_card[2],
                          clf=on_card[1], device=cuda_device)
    assert K.separable_conv3d.launches == 2 * (2 + 2)
    assert K.conv_axis.launches == 0
    for k in ("encoder", "disc", "clf"):
        assert np.abs(got[k] - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max()


@pytest.fixture
def hopper(cuda_device):
    if torch.cuda.get_device_capability(cuda_device) != (9, 0):
        pytest.skip("needs compute capability 9.0: the kernels are built "
                    "for sm_90a")
    return cuda_device


def _bn_train_case(dev, c, shifted, dtype, seed=0, faces=(True, True),
                   owned=None):
    """Packed y, a cotangent g and the dx pass's (8, C) rows as
    `BnActTrainPacked` builds them: mean and rstd from y's statistics over
    the owned cells, k2 and k3 from the reduction of a g that follows yh,
    so that the statistics term is of the size of dy's other term."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cells = (7, 6, 9) if shifted else (6, 5, 8)
    y = (torch.randn(2, *cells, 8 * c, generator=g, device=dev) * 2
         + 0.5).to(dtype)
    kw = {"shifted": shifted, "d_faces": faces,
          "owned_d": y.shape[1] if owned is None else owned}
    valid = K.bn_train_stats_plain(torch.ones_like(y), **kw)[0, 0].item()
    mean, _, rstd, kept = TP.bn_train_moments(
        K.bn_train_stats_plain(y, **kw), valid)
    prm = torch.stack([mean, rstd,
                       torch.rand(c, generator=g, device=dev) + 0.5,
                       torch.randn(c, generator=g, device=dev),
                       torch.rand(c, generator=g, device=dev) * 0.5])
    yh = (y.float() - mean.repeat(8)) * rstd.repeat(8)
    gr = (torch.randn(y.shape, generator=g, device=dev) + yh).to(dtype)
    sums = K.bn_train_reduce_plain(y, gr, prm, shifted=shifted,
                                   d_faces=faces)
    return y, gr, TP.bn_train_dx_rows(prm, sums[:2], valid, kept)


BN_TRAIN_CASES = [(8, True, (True, True), None),
                  (8, False, (True, True), None),
                  (64, True, (False, True), -1), (16, True, (True, False), -1),
                  (3, True, (True, True), None),
                  (32, False, (True, True), -2)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,shifted,faces,narrow", BN_TRAIN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_kernels_match_plain(hopper, c, shifted, faces, narrow,
                                      dtype):
    """Each of the four passes of `csrc/bn_train_packed.cu` against its
    plain version on the same card: the sums to float32 summation order
    over the sums of magnitudes, the elementwise passes to one rounding
    of the dtype."""
    owned = (7 if shifted else 6) + (narrow or 0)
    y, gr, prm = _bn_train_case(hopper, c, shifted, dtype, faces=faces,
                                owned=owned)
    kw = {"shifted": shifted, "d_faces": faces}
    before = [k.launches for k in (K.bn_train_stats, K.bn_train_apply,
                                   K.bn_train_reduce, K.bn_train_dx)]
    stats = K.bn_train_stats(y, owned_d=owned, **kw)
    out = K.bn_train_apply(y, prm[:5], **kw)
    sums = K.bn_train_reduce(y, gr, prm[:5], **kw)
    dy = K.bn_train_dx(y, gr, prm, owned_d=owned, **kw)
    torch.cuda.synchronize()
    assert [k.launches for k in (K.bn_train_stats, K.bn_train_apply,
                                 K.bn_train_reduce, K.bn_train_dx)] == [
        b + 1 for b in before]
    ref_stats = K.bn_train_stats_plain(y, owned_d=owned, **kw)
    mag = K.bn_train_sum_scale(y, owned_d=owned, **kw)
    assert ((stats - ref_stats).abs() <= 1e-5 * mag + 1e-6).all()
    ref_sums = K.bn_train_reduce_plain(y, gr, prm[:5], **kw)
    mag = K.bn_train_sum_scale(y, gr, prm[:5], **kw)
    assert ((sums - ref_sums).abs() <= 1e-5 * mag + 1e-6).all()
    step = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    ref_dy = K.bn_train_dx_plain(y, gr, prm, owned_d=owned, **kw)
    for got, ref in ((out, K.bn_train_apply_plain(y, prm[:5], **kw)),
                     (dy, ref_dy)):
        assert got.dtype == dtype and got.shape == y.shape
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= step * ref.float().abs().max().item()
    # the statistics term is far above the tolerance: a dx kernel that
    # dropped it, or applied it to other cells, would fail
    no_stat = prm.clone()
    no_stat[6:] = 0
    gap = (K.bn_train_dx_plain(y, gr, no_stat, owned_d=owned, **kw).float()
           - ref_dy.float()).abs().max().item()
    assert gap >= 16 * 2.0 ** -7 * ref_dy.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shifted,bn", [(True, True), (False, True),
                                        (True, False)])
def test_bn_act_train_packed_on_card_matches_cpu(hopper, shifted, bn):
    """`BnActTrainPacked` forward and backward on the card (the kernels)
    against the CPU (the plain passes), float32; the repeated card run
    equals the first bit for bit."""
    y, gr, prm = _bn_train_case(hopper, 16, shifted, torch.float32, seed=1)
    gamma, beta, alpha = (prm[2], prm[3], prm[4][:1]) if bn else (
        None, None, prm[4][:1])

    def run(dev):
        leaves = [t.to(dev).clone().requires_grad_() if t is not None
                  else None for t in (y, gamma, beta, alpha)]
        outs = TP.BnActTrainPacked.apply(*leaves, shifted, 2.0 * 13 ** 3,
                                         y.shape[1])
        want = [t for t in leaves if t is not None]
        grads = torch.autograd.grad(outs[0], want, gr.to(dev))
        return [t.detach().cpu() for t in (*outs, *grads)]

    before = K.bn_train_dx.launches
    card, again, cpu = run(hopper), run(hopper), run("cpu")
    assert K.bn_train_dx.launches == before + 2
    for a, b, r in zip(card, again, cpu):
        assert torch.equal(a, b)
        assert (a - r).abs().max().item() <= 1e-5 * max(
            r.abs().max().item(), 1e-30)
