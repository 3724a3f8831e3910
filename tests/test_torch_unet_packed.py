"""Port parity: the packed UNet3D serving path (`models/unet_packed.py`)
against the JAX package's packed forward and fine UNet3D.

The port runs the decoder's up branch explicitly (upsample, then an
aligned->shifted k=2 conv); JAX's inference forward composes them into one
5^3 kernel with face corrections.  Both compute the fine UNet3D, so the
logits agree to f32 summation order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import unet_packed as TU
from mri_epilepsy_diagnosis_tpu.models import unet_packed as JU
from test_torch_bridge import jax_unet_variables, torch_unet

torch.set_num_threads(2)

SIZE = 16


@pytest.fixture(scope="module")
def setup():
    jmodel, variables = jax_unet_variables(ocfl=8, nb=3, seed=5)
    x = np.random.default_rng(6).normal(
        size=(2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    sd = variables_to_state_dict(variables, device="cpu")
    return jmodel, variables, sd, x


def test_fold_bn_inference_matches_jax(setup):
    _, variables, sd, _ = setup
    ours = TU.fold_bn_inference(sd)
    ref = variables_to_state_dict(JU.fold_bn_inference(variables),
                                  device="cpu")
    assert ours.keys() == ref.keys()
    assert not any("norm_layer" in k for k in ours)
    for k in ref:
        torch.testing.assert_close(ours[k], ref[k], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("folded", [False, True])
def test_packed_logits_match_jax(setup, folded):
    """The port's packed logits == JAX's (composed-decoder) packed
    forward and == `UNet3D.apply`, in f32 (JAX at HIGHEST)."""
    jmodel, variables, sd, x = setup
    jv = JU.fold_bn_inference(variables) if folded else variables
    params = TU.fold_bn_inference(sd) if folded else sd
    ref_packed = np.asarray(jax.jit(JU.packed_unet_apply_v2)(jv, x))
    ref_fine = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = TU.packed_unet_apply_v2(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref_packed, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, ref_fine, atol=1e-4, rtol=0)


def test_packed_logits_match_port_fine_unet(setup):
    _, variables, sd, x = setup
    with torch.no_grad():
        fine = torch_unet(variables)(torch.from_numpy(x))
        packed = TU.packed_unet_apply_v2(TU.fold_bn_inference(sd),
                                         torch.from_numpy(x))
    torch.testing.assert_close(packed, fine, atol=1e-5, rtol=0)


def test_packed_mask_matches_jax(setup):
    """Equal to JAX's packed mask except where JAX's |l1 - l0| < 1e-4."""
    _, variables, sd, x = setup
    jv = JU.fold_bn_inference(variables)
    ref = np.asarray(jax.jit(JU.packed_unet_mask_v2)(jv, x))
    logits = np.asarray(jax.jit(JU.packed_unet_apply_v2)(jv, x))
    with torch.no_grad():
        got = TU.packed_unet_mask_v2(TU.fold_bn_inference(sd),
                                     torch.from_numpy(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    clear = np.abs(logits[..., 1] - logits[..., 0]) >= 1e-4
    np.testing.assert_array_equal(got.numpy()[clear], ref[clear])
    assert clear.mean() > 0.9


def test_packed_mask_keeps_class0_on_ties(setup):
    """l1 == l0 everywhere gives class 0 everywhere, as argmax does."""
    _, _, sd, x = setup
    tied = dict(sd)
    tied["classifier.conv_layer.weight"] = torch.zeros_like(
        sd["classifier.conv_layer.weight"])
    tied["classifier.conv_layer.bias"] = torch.zeros(2)
    with torch.no_grad():
        mask = TU.packed_unet_mask_v2(tied, torch.from_numpy(x))
    assert not mask.any()


def test_packed_mask_needs_two_classes(setup):
    _, _, sd, x = setup
    three = dict(sd)
    w = sd["classifier.conv_layer.weight"]
    three["classifier.conv_layer.weight"] = torch.cat([w, w[:1]])
    three["classifier.conv_layer.bias"] = torch.zeros(3)
    with pytest.raises(ValueError, match="out_classes == 2"):
        TU.packed_unet_mask_v2(three, torch.from_numpy(x))
