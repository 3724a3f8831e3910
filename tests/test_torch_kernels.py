"""Port parity: the packed-layout ops and the plain versions of kernels B1
(`conv2_packed`) and B2 (`bn_act_zero_pads`) against the JAX package,
whose Pallas kernels run here in interpret mode.

On the CPU each kernel wrapper takes its plain version; the kernels
themselves run only on the card (`tests/test_torch_cuda.py` and
`chip_smoke.py`)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_torch.ops import functional as TFn
from mri_epilepsy_diagnosis_torch.ops import packed as TP
from mri_epilepsy_diagnosis_tpu.ops import functional as JF
from mri_epilepsy_diagnosis_tpu.ops import packed as JP
from mri_epilepsy_diagnosis_tpu.ops.pallas_kernels import (
    bn_act_zero_pads as jax_bn_act_zero_pads, conv2_packed_pallas)

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def _torch_w(w):
    """JAX (3,3,3,Ci,Co) -> torch (Co,Ci,3,3,3)."""
    return _t(np.transpose(w, (4, 3, 0, 1, 2)))


@pytest.fixture
def fine():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 10, 6, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 3, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    return x, w, b


# ---------------------------------------------------------------------------
# layout ops (exact)
# ---------------------------------------------------------------------------


def test_pack2_unpack2_exact(fine):
    x = fine[0]
    got = TP.pack2(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JP.pack2(x)))
    np.testing.assert_array_equal(TP.unpack2(got).numpy(), x)


@pytest.mark.parametrize("kind", ["sa", "as"])
def test_pack_weights_exact(fine, kind):
    w = fine[1]
    jfn, tfn = ((JP.pack_weights2, TP.pack_weights2) if kind == "sa"
                else (JP.pack_weights2_as, TP.pack_weights2_as))
    np.testing.assert_array_equal(tfn(_torch_w(w)).numpy(),
                                  np.asarray(jfn(jnp.asarray(w))))


def test_axis_tables_match_jax():
    np.testing.assert_array_equal(TP._axis_table_sa(), JP._axis_table_sa())
    np.testing.assert_array_equal(TP._axis_table_as(), JP._axis_table_as())


@pytest.mark.parametrize("cells,c8", [((5, 4, 3), 16), ((2, 2, 2), 8)])
def test_shifted_pad_masks_match_jax(cells, c8):
    for a in range(3):
        np.testing.assert_array_equal(
            TP._shifted_pad_axis_mask(a, cells[a], c8),
            JP._shifted_pad_axis_mask(a, cells[a], c8))


def test_zero_shifted_pads_matches_jax():
    xs = np.random.default_rng(4).normal(size=(2, 5, 4, 6, 24)).astype(
        np.float32)
    np.testing.assert_array_equal(TP.zero_shifted_pads(_t(xs)).numpy(),
                                  np.asarray(JP.zero_shifted_pads(xs)))


def test_maxpool2_packed_matches_jax(fine):
    xp = JP.pack2(fine[0][:, :8, :8, :4])
    np.testing.assert_array_equal(
        TP.maxpool2_packed(_t(np.asarray(xp))).numpy(),
        np.asarray(JP.maxpool2_packed(xp)))


def test_concat_channels_packed_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(1, 3, 2, 2, 16)).astype(np.float32)
    b = rng.normal(size=(1, 3, 2, 2, 24)).astype(np.float32)
    np.testing.assert_array_equal(
        TP.concat_channels_packed(_t(a), _t(b)).numpy(),
        np.asarray(JP.concat_channels_packed(a, b)))


def test_upsample2_packed_matches_jax():
    xp = np.random.default_rng(6).normal(size=(2, 3, 4, 2, 16)).astype(
        np.float32)
    np.testing.assert_allclose(TP.upsample2_packed(_t(xp)).numpy(),
                               np.asarray(JP.upsample2_packed(xp)),
                               atol=1e-5, rtol=0)


def test_upsample2_packed_is_fine_trilinear():
    """packed upsample == pack2(fine trilinear x2 of unpack2)."""
    xp = torch.randn(1, 3, 2, 4, 24, generator=torch.Generator().manual_seed(0))
    fine = TP.unpack2(xp)
    up = TFn.resize_linear(fine, [2 * s for s in fine.shape[1:4]])
    torch.testing.assert_close(TP.upsample2_packed(xp), TP.pack2(up),
                               atol=1e-6, rtol=0)


def test_conv1_packed_blockdiag_matches_jax():
    rng = np.random.default_rng(7)
    xp = rng.normal(size=(2, 3, 3, 3, 32)).astype(np.float32)
    w = rng.normal(size=(1, 1, 1, 4, 2)).astype(np.float32)
    b = rng.normal(size=(2,)).astype(np.float32)
    got = TP.conv1_packed_blockdiag(
        _t(xp), _t(np.transpose(w, (4, 3, 0, 1, 2))), _t(b))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JP.conv1_packed_blockdiag(xp, w, b)),
        atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# fine functional ops
# ---------------------------------------------------------------------------


def test_functional_ops_match_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 6, 8, 3)).astype(np.float32)
    a = np.asarray([0.3], np.float32)
    np.testing.assert_allclose(TFn.prelu(_t(x), _t(a)).numpy(),
                               np.asarray(JF.prelu(x, a)), atol=1e-6)
    mean, gamma, beta = (rng.normal(size=3).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 2, 3).astype(np.float32)
    np.testing.assert_allclose(
        TFn.batch_norm(_t(x), _t(mean), _t(var), _t(gamma), _t(beta)).numpy(),
        np.asarray(JF.batch_norm(x, mean, var, gamma, beta)), atol=1e-5)
    np.testing.assert_array_equal(TFn.maxpool3d(_t(x), 2).numpy(),
                                  np.asarray(JF.maxpool3d(x, 2)))
    np.testing.assert_allclose(
        TFn.resize_linear(_t(x), (8, 12, 5)).numpy(),
        np.asarray(JF.resize_linear(x, (8, 12, 5))), atol=1e-5)


# ---------------------------------------------------------------------------
# B1: k=2 packed conv, plain version (the CPU path of the wrapper)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_bias", [False, True])
def test_conv3_packed_matches_jax(fine, with_bias):
    """shifted -> aligned, against `P._conv3_packed_raw` (lax conv) and
    the Pallas kernel in interpret mode (tolerance of
    tests/test_pallas.py)."""
    x, w, b = fine
    xs = np.asarray(JP.pack2_shifted(x))
    wp = JP.pack_weights2(jnp.asarray(w))
    ref = np.asarray(JP._conv3_packed_raw(xs, wp))
    pallas = np.asarray(conv2_packed_pallas(xs, wp, interpret=True))
    if with_bias:
        ref = ref + np.tile(b, 8)
        pallas = pallas + np.tile(b, 8)
    got = TP.conv3_packed(_t(xs), TP.pack_weights2(_torch_w(w)),
                          _t(b) if with_bias else None).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_bias", [False, True])
def test_conv3_packed_as_matches_jax(fine, with_bias):
    """aligned -> shifted (pad-1), against `P._conv3_packed_as_raw` and
    the Pallas kernel over the one-cell zero-padded input."""
    x, w, b = fine
    xp = np.asarray(JP.pack2(x))
    wpa = JP.pack_weights2_as(jnp.asarray(w))
    ref = np.asarray(JP._conv3_packed_as_raw(xp, wpa))
    xpad = jnp.pad(xp, ((0, 0),) + ((1, 1),) * 3 + ((0, 0),))
    pallas = np.asarray(conv2_packed_pallas(xpad, wpa, interpret=True))
    if with_bias:
        ref = ref + np.tile(b, 8)
        pallas = pallas + np.tile(b, 8)
    got = TP.conv3_packed_as(_t(xp), TP.pack_weights2_as(_torch_w(w)),
                             _t(b) if with_bias else None).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_conv2_packed_plain_is_fine_conv(fine):
    """Both parities of the packed conv equal the fine k=3/pad=1 conv."""
    x, w, b = fine
    tx, tw = _t(x), _torch_w(w)
    ref = torch.nn.functional.conv3d(tx.permute(0, 4, 1, 2, 3), tw, _t(b),
                                     padding=1).permute(0, 2, 3, 4, 1)
    xs = TP.pack2(torch.nn.functional.pad(tx, (0, 0) + (1, 1) * 3))
    got = TP.unpack2(TP.conv3_packed(xs, TP.pack_weights2(tw), _t(b)))
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    got_as = TP.unpack2(TP.conv3_packed_as(TP.pack2(tx),
                                           TP.pack_weights2_as(tw), _t(b)))
    torch.testing.assert_close(got_as[:, 1:-1, 1:-1, 1:-1], ref, atol=1e-4,
                               rtol=0)


def test_conv2_packed_cpu_uses_plain_version(fine):
    x, w, _ = fine
    xs = TP.pack2(torch.nn.functional.pad(_t(x), (0, 0) + (1, 1) * 3))
    wp = TP.pack_weights2(_torch_w(w))
    before = K.conv2_packed.launches
    got = K.conv2_packed(xs, wp)
    assert K.conv2_packed.launches == before
    torch.testing.assert_close(got, K.conv2_packed_plain(xs, wp))
    bf = K.conv2_packed(xs.bfloat16(), wp.bfloat16())
    assert bf.dtype == torch.bfloat16 and bf.shape == got.shape


@pytest.mark.parametrize("bad", ["rank", "channels", "pad", "bias", "device"])
def test_conv2_packed_rejects_bad_arguments(bad):
    x = torch.zeros(1, 3, 3, 3, 8)
    wp = torch.zeros(2, 2, 2, 8, 16)
    kw = {}
    if bad == "rank":
        x = x[0]
    elif bad == "channels":
        wp = torch.zeros(2, 2, 2, 16, 16)
    elif bad == "pad":
        kw["pad"] = 2
    elif bad == "bias":
        kw["bias"] = torch.zeros(8)
    else:
        x, wp = x.to("meta"), wp.to("meta")
    with pytest.raises(ValueError):
        K.conv2_packed(x, wp, **kw)


# ---------------------------------------------------------------------------
# B2: fused BN + PReLU + pad zeroing, plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("folded", [False, True])
def test_bn_act_zero_pads_matches_pallas(folded):
    """The port's B2 against the Pallas kernel in interpret mode, in the
    BN case and in the BN-folded serving case (scale 1, shift = the tiled
    conv bias); tolerance of tests/test_pallas.py."""
    rng = np.random.default_rng(9)
    c = 4
    c8 = 8 * c
    xs = rng.normal(size=(2, 5, 4, 6, c8)).astype(np.float32)
    alpha = np.tile(rng.uniform(0, 0.3, c).astype(np.float32), 8)
    if folded:
        scale = np.ones(c8, np.float32)
        shift = np.tile(rng.normal(size=c).astype(np.float32), 8)
    else:
        gamma, beta, mean = (rng.normal(size=c).astype(np.float32)
                             for _ in range(3))
        var = rng.uniform(0.5, 1.5, c).astype(np.float32)
        s = gamma / np.sqrt(var + 1e-5)
        scale = np.tile(s, 8)
        shift = np.tile(beta - mean * s, 8)
    masks = [JP._shifted_pad_axis_mask(a, xs.shape[1 + a], c8)
             for a in range(3)]
    ref = np.asarray(jax_bn_act_zero_pads(
        xs, jnp.asarray(scale), jnp.asarray(shift), jnp.asarray(alpha),
        [jnp.asarray(m) for m in masks], interpret=True))
    got = TP.bn_act_zero_pads(_t(xs), _t(scale), _t(shift), _t(alpha))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    plain = K.bn_act_zero_pads_plain(_t(xs), _t(scale), _t(shift),
                                     _t(alpha), [_t(m) for m in masks])
    torch.testing.assert_close(got, plain)


def test_bn_act_zero_pads_is_the_composition():
    """B2 == zero_shifted_pads(prelu(x * scale + shift))."""
    g = torch.Generator().manual_seed(1)
    xs = torch.randn(1, 4, 3, 5, 16, generator=g)
    scale, shift = torch.rand(16, generator=g), torch.randn(16, generator=g)
    alpha = torch.rand(16, generator=g)
    ref = TP.zero_shifted_pads(TFn.prelu(xs * scale + shift, alpha))
    torch.testing.assert_close(TP.bn_act_zero_pads(xs, scale, shift, alpha),
                               ref)


def test_bn_act_zero_pads_rejects_bad_shapes():
    xs = torch.zeros(1, 3, 3, 3, 16)
    v = torch.zeros(16)
    masks = TP.shifted_pad_mask_tensors(xs)
    with pytest.raises(ValueError):
        K.bn_act_zero_pads(xs, torch.zeros(8), v, v, masks)
    with pytest.raises(ValueError):
        K.bn_act_zero_pads(xs, v, v, v, masks[:2])
    with pytest.raises(ValueError):
        K.bn_act_zero_pads(xs.to("meta"), v, v, v, masks)
