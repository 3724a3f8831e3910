"""Port parity: kernel B2 as the epilogue of B1's aligned->shifted launch
(`conv2_packed_as_bn_act`), through the plain version that the wrapper
takes on the CPU, against the JAX package's ConvBlock tail
`models/unet_packed.py::_block_as` (conv, bias, BN, PReLU, pad zeroing),
and the epilogue's index-arithmetic pad mask against
the JAX package's `ops/packed.py::_shifted_pad_axis_mask`.

The fused kernels themselves run only on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).  JAX runs at
Precision.HIGHEST; tolerance 1e-5 x max|ref| in float32, from summation
order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.models import UNet3D
from mri_epilepsy_diagnosis_torch.models import unet_packed as TU
from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_torch.ops import packed as TP
from mri_epilepsy_diagnosis_tpu.models import unet_packed as JU
from mri_epilepsy_diagnosis_tpu.ops import packed as JP

torch.set_num_threads(2)


def _conv_block(rng, ci, co, norm):
    """One ConvBlock: JAX params and stats, and the port's flat state dict
    under the block name "blk".  Without `norm` it is the BN-folded form
    (conv bias and PReLU only)."""
    w = (rng.normal(size=(3, 3, 3, ci, co)) / np.sqrt(27 * ci)).astype(
        np.float32)
    b = (0.1 * rng.normal(size=co)).astype(np.float32)
    a = np.asarray([0.25], np.float32)
    params = {"conv_layer": {"weight": w, "bias": b},
              "activation_layer": {"weight": a}}
    stats = {}
    sd = {"blk.conv_layer.weight": torch.tensor(np.transpose(w,
                                                             (4, 3, 0, 1, 2))),
          "blk.conv_layer.bias": torch.tensor(b),
          "blk.activation_layer.weight": torch.tensor(a)}
    if norm:
        gamma = rng.uniform(0.5, 1.5, co).astype(np.float32)
        beta, mean = (0.2 * rng.normal(size=(2, co))).astype(np.float32)
        var = rng.uniform(0.5, 1.5, co).astype(np.float32)
        params["norm_layer"] = {"weight": gamma, "bias": beta}
        stats = {"norm_layer": {"running_mean": mean, "running_var": var}}
        for k, v in (("weight", gamma), ("bias", beta),
                     ("running_mean", mean), ("running_var", var)):
            sd[f"blk.norm_layer.{k}"] = torch.tensor(v)
    return params, stats, sd


def _assert_close(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


@pytest.mark.parametrize("norm", [False, True], ids=["folded", "bn"])
def test_block_as_matches_jax(norm):
    """The fused aligned->shifted ConvBlock == JAX's `_block_as`."""
    rng = np.random.default_rng(20 + norm)
    params, stats, sd = _conv_block(rng, 4, 6, norm)
    xp = rng.normal(size=(2, 4, 5, 3, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = JU._block_as(jnp.asarray(xp), params, stats)
    got = TU._block_as(torch.from_numpy(xp), sd, "blk")
    _assert_close(got, ref)


@pytest.mark.parametrize("norm", [False, True], ids=["folded", "bn"])
def test_block_as_with_addend_matches_jax(norm):
    """The decoder form: the skip half's partial sum as the addend of the
    up half's fused launch == JAX's `_block_as` of the packed concat."""
    rng = np.random.default_rng(30 + norm)
    cs, cu = 2, 3
    params, stats, sd = _conv_block(rng, cs + cu, 4, norm)
    skip = rng.normal(size=(1, 3, 4, 5, 8 * cs)).astype(np.float32)
    up = rng.normal(size=(1, 3, 4, 5, 8 * cu)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = JU._block_as(JP.concat_channels_packed(skip, up), params, stats)
    w = sd["blk.conv_layer.weight"]
    partial = TP.conv3_packed_as(torch.from_numpy(skip),
                                 TP.pack_weights2_as(w[:, :cs]))
    got = TU._block_as(torch.from_numpy(up), sd, "blk", w=w[:, cs:],
                       addend=partial)
    _assert_close(got, ref)


@pytest.mark.parametrize("c8", [8, 64, 256])
@pytest.mark.parametrize("cells", [2, 3, 25, 49, 97])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pad_keep_matches_jax_masks(axis, cells, c8):
    """The epilogue's index arithmetic gives JAX's pad-mask planes at the
    ragged extents of the served shifted tensors (97, 49, 25)."""
    got = K.shifted_pad_keep(axis, cells, c8).numpy()
    np.testing.assert_array_equal(
        got, JP._shifted_pad_axis_mask(axis, cells, c8).astype(bool))


@pytest.mark.parametrize("with_addend", [False, True])
def test_fused_plain_is_b1_then_b2(with_addend):
    """conv2_packed_as_bn_act == bn_act_zero_pads(conv2_packed(pad=1) +
    addend) in float32."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 4, 2, 16, generator=g)
    wp = torch.randn(2, 2, 2, 16, 24, generator=g)
    scale, shift, alpha = (torch.rand(24, generator=g) for _ in range(3))
    add = torch.randn(2, 4, 5, 3, 24, generator=g) if with_addend else None
    got = K.conv2_packed_as_bn_act(x, wp, scale, shift, alpha, addend=add)
    y = K.conv2_packed(x, wp, pad=1)
    if add is not None:
        y = y + add
    ref = K.bn_act_zero_pads_plain(y, scale, shift, alpha,
                                   TP.shifted_pad_mask_tensors(y))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_fused_plain_rounds_bf16_once():
    """In bf16 the sum, the addend and the tail stay in float32 and are
    rounded once: every element within half a bf16 step of the float32
    result on the same (bf16-valued) inputs."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 3, 3, 4, 16, generator=g).bfloat16()
    wp = (torch.randn(2, 2, 2, 16, 16, generator=g) / 8).bfloat16()
    add = torch.randn(1, 4, 4, 5, 16, generator=g).bfloat16()
    scale, shift, alpha = (torch.rand(16, generator=g) for _ in range(3))
    got = K.conv2_packed_as_bn_act(x, wp, scale, shift, alpha, addend=add)
    ref = K.conv2_packed_as_bn_act(x.float(), wp.float(), scale, shift,
                                   alpha, addend=add.float())
    assert got.dtype == torch.bfloat16
    assert ((got.float() - ref).abs() <= 2.0 ** -8 * ref.abs()).all()


def test_cpu_call_takes_plain_version_and_counts_nothing():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 2, 3, 2, 64, generator=g)
    wp = torch.randn(2, 2, 2, 64, 64, generator=g)
    v = torch.rand(64, generator=g)
    before = (K.conv2_packed.launches, K.conv2_packed_as_bn_act.launches)
    got = K.conv2_packed_as_bn_act(x, wp, v, v, v)
    assert (K.conv2_packed.launches,
            K.conv2_packed_as_bn_act.launches) == before
    assert torch.equal(got, K.conv2_packed_as_bn_act_plain(x, wp, v, v, v))


@pytest.mark.parametrize("case", ["scale", "addend_shape", "addend_dtype",
                                  "channels", "rank", "device"])
def test_fused_rejects_bad_arguments(case):
    x = torch.zeros(1, 2, 2, 2, 8)
    wp = torch.zeros(2, 2, 2, 8, 16)
    v = torch.zeros(16)
    args, kw = [x, wp, v, v, v], {}
    if case == "scale":
        args[2] = torch.zeros(8)
    elif case == "addend_shape":
        kw["addend"] = torch.zeros(1, 2, 2, 2, 16)
    elif case == "addend_dtype":
        kw["addend"] = torch.zeros(1, 3, 3, 3, 16, dtype=torch.bfloat16)
    elif case == "channels":
        args[1] = torch.zeros(2, 2, 2, 8, 12)
        args[2:] = [torch.zeros(12)] * 3
    elif case == "rank":
        args[0] = x[0]
    else:
        args[:2] = [x.to("meta"), wp.to("meta")]
    with pytest.raises(ValueError):
        K.conv2_packed_as_bn_act(*args, **kw)


def test_served_forward_fuses_every_aligned_to_shifted_tail():
    """One packed forward calls B1 12 times: 5 with B2 fused (2 of them
    with the skip half as addend), none through the standalone B2."""
    torch.manual_seed(0)
    model = UNet3D(out_classes=2, num_encoding_blocks=3,
                   out_channels_first_layer=8, device="cpu").eval()
    params = TU.fold_bn_inference(model.state_dict())
    calls = {"conv2_packed": 0, "fused": 0, "addend": 0, "b2": 0}
    conv, fused, b2 = (K.conv2_packed, K.conv2_packed_as_bn_act,
                       K.bn_act_zero_pads)

    def rec_conv(*a, **kw):
        calls["conv2_packed"] += 1
        return conv(*a, **kw)

    def rec_fused(*a, addend=None, **kw):
        calls["fused"] += 1
        calls["addend"] += addend is not None
        return fused(*a, addend=addend, **kw)

    def rec_b2(*a, **kw):
        calls["b2"] += 1
        return b2(*a, **kw)

    K.conv2_packed, K.conv2_packed_as_bn_act, K.bn_act_zero_pads = (
        rec_conv, rec_fused, rec_b2)
    try:
        with torch.no_grad():
            TU.packed_unet_mask_v2(params, torch.zeros(1, 16, 16, 16, 1))
    finally:
        K.conv2_packed, K.conv2_packed_as_bn_act, K.bn_act_zero_pads = (
            conv, fused, b2)
    assert calls == {"conv2_packed": 7, "fused": 5, "addend": 2, "b2": 0}


@pytest.mark.parametrize("rc,match", [(-3, "168 registers"),
                                      (-4, "tile plan"), (2, "CUDA error 2")])
def test_launch_errors_raise(rc, match):
    with pytest.raises(RuntimeError, match=match):
        K._raise_on(rc, "conv2_packed_tc")


def test_build_error_raises(monkeypatch):
    """A failed build raises from `load`: no wrapper can fall back."""
    def broken():
        raise RuntimeError("nvcc failed")

    K.load.cache_clear()
    monkeypatch.setattr(K, "build", broken)
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            K.load()
    finally:
        K.load.cache_clear()
