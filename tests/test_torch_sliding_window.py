"""Port parity: sliding-window inference
(`mri_epilepsy_diagnosis_torch/infer/sliding_window.py`) against the JAX
package's, on the CPU.

The model is the BN-folded packed UNet3D of both packages with the same
JAX-initialised weights (out_channels_first_layer 4, 3 encoding blocks,
random BatchNorm statistics), through `interop/jax_bridge.py`: a 32^3
volume, patch 16, overlap 4 (27 patches), float32."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.infer import sliding_window as TW
from mri_epilepsy_diagnosis_torch.interop.jax_bridge import (
    variables_to_state_dict)
from mri_epilepsy_diagnosis_torch.models import unet_packed as TUP
from mri_epilepsy_diagnosis_tpu.infer import sliding_window as JW
from mri_epilepsy_diagnosis_tpu.models import unet_packed as JUP
from test_torch_bridge import jax_unet_variables

torch.set_num_threads(2)
SIZE, PATCH, OVERLAP = 32, 16, 4


@pytest.fixture(scope="module")
def model():
    _, variables = jax_unet_variables(ocfl=4, nb=3, seed=3)
    folded = JUP.fold_bn_inference(variables)
    params = TUP.fold_bn_inference(variables_to_state_dict(variables,
                                                           device="cpu"))
    vol = np.random.default_rng(4).normal(
        size=(SIZE, SIZE, SIZE, 1)).astype(np.float32)
    return folded, params, vol


@pytest.mark.parametrize("shape,patch,overlap", [
    ((32, 32, 32), 16, 4), ((30, 17, 9), (16, 8, 9), (4, 2, 0)),
    ((12, 40, 16), 16, 0), ((64, 64, 64), 64, 4), ((70, 66, 64), 64, 4)])
def test_grid_helpers_match_jax(shape, patch, overlap):
    locs = TW.grid_locations(shape, patch, overlap)
    ref = JW.grid_locations(shape, patch, overlap)
    np.testing.assert_array_equal(locs, ref)
    assert locs.dtype == ref.dtype
    p = tuple(np.broadcast_to(np.asarray(patch), (3,)))
    np.testing.assert_array_equal(TW._coverage(shape, locs, p).numpy(),
                                  JW._coverage(shape, ref, p))
    assert TW._crop_boxes(shape, locs, p, overlap) == JW._crop_boxes(
        shape, ref, p, overlap)


def test_extract_patches_matches_jax(model):
    _, _, vol = model
    locs = TW.grid_locations(vol.shape[:3], PATCH, OVERLAP)
    np.testing.assert_array_equal(
        TW.extract_patches(torch.from_numpy(vol), locs, PATCH).numpy(),
        np.asarray(JW.extract_patches(jnp.asarray(vol), locs, PATCH)))


@pytest.mark.parametrize("batch", [64, 8])
@pytest.mark.parametrize("mode", ["average", "crop"])
def test_sliding_window_predict_matches_jax(model, mode, batch):
    """Both modes, one call for the whole grid (batch 64, capped at 27)
    and chunks of 8 with a zero-padded last chunk: 1e-4 x max|ref|."""
    folded, params, vol = model
    ref = np.asarray(JW.sliding_window_predict(
        JUP.packed_unet_apply_v2, folded, jnp.asarray(vol),
        patch_size=PATCH, overlap=OVERLAP, batch_size=batch, mode=mode))
    calls = []

    def apply(p, x):
        calls.append(x.shape[0])
        return TUP.packed_unet_apply_v2(p, x)

    with torch.no_grad():
        got = TW.sliding_window_predict(
            apply, params, vol, patch_size=PATCH, overlap=OVERLAP,
            batch_size=batch, mode=mode, device="cpu")
    assert got.shape == ref.shape == (SIZE, SIZE, SIZE, 2)
    assert calls == ([27] if batch == 64 else [8, 8, 8, 8])
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), err


def _identity_logits(p, x):
    """A stand-in model whose logits are the patch itself and its
    negative: the aggregation alone decides the output."""
    return torch.cat([x, -x], -1)


@pytest.mark.parametrize("agg", ["scatter", "scan", "unrolled"])
def test_aggregation_names_give_identical_sums(agg):
    vol = np.random.default_rng(5).normal(size=(20, 18, 23, 1)).astype(
        np.float32)
    got = TW.sliding_window_predict(_identity_logits, None, vol, 8, 3, 5,
                                    agg=agg, device="cpu")
    ref = TW.sliding_window_predict(_identity_logits, None, vol, 8, 3, 5,
                                    agg="unrolled", device="cpu")
    assert torch.equal(got, ref)
    np.testing.assert_allclose(got[..., :1].numpy(), vol, atol=1e-6)
    jref = np.asarray(JW.sliding_window_predict(
        lambda p, x: jnp.concatenate([x, -x], -1), None, jnp.asarray(vol),
        8, 3, 5, agg=agg))
    np.testing.assert_allclose(got.numpy(), jref, atol=1e-6)


def test_small_volumes_are_padded_and_cropped_back():
    vol = np.random.default_rng(6).normal(size=(10, 16, 7, 1)).astype(
        np.float32)
    for mode in ("average", "crop"):
        got = TW.sliding_window_predict(_identity_logits, None, vol, 16, 4,
                                        mode=mode, device="cpu")
        ref = np.asarray(JW.sliding_window_predict(
            lambda p, x: jnp.concatenate([x, -x], -1), None,
            jnp.asarray(vol), 16, 4, mode=mode))
        assert got.shape == ref.shape == (10, 16, 7, 2)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_unknown_modes_raise():
    vol = torch.zeros(8, 8, 8, 1)
    with pytest.raises(ValueError, match="mode"):
        TW.sliding_window_predict(_identity_logits, None, vol, 8, mode="max")
    with pytest.raises(ValueError, match="impl"):
        TW.sliding_window_predict(_identity_logits, None, vol, 8, agg="sum")


def test_numpy_volumes_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.sliding_window_predict(_identity_logits, None,
                                  np.zeros((8, 8, 8, 1), np.float32), 8)


@pytest.mark.parametrize("mode", ["average", "crop"])
def test_grid_sampler_and_aggregator_match_jax(mode):
    rng = np.random.default_rng(7)
    vol = rng.normal(size=(26, 21, 30, 1)).astype(np.float32)
    ts, js = TW.GridSampler(vol, 12, 4), JW.GridSampler(vol, 12, 4)
    assert len(ts) == len(js)
    np.testing.assert_array_equal(ts.locations, js.locations)
    patches = ts.patches().numpy()
    np.testing.assert_array_equal(patches, np.asarray(js.patches()))
    labels = (patches[..., 0] > 0).astype(np.float32)
    kw = dict(num_classes=1, overlap_mode=mode, patch_overlap=4)
    ta = TW.GridAggregator(vol.shape[:3], **kw)
    ja = JW.GridAggregator(vol.shape[:3], **kw)
    for i in range(0, len(ts), 7):     # batches as a loader gives them
        ta.add_batch(labels[i:i + 7], ts.locations[i:i + 7])
        ja.add_batch(labels[i:i + 7], js.locations[i:i + 7])
    np.testing.assert_array_equal(ta.get_output_tensor(),
                                  ja.get_output_tensor())
    if mode == "crop":
        np.testing.assert_array_equal(ta.get_output_tensor()[..., 0],
                                      vol[..., 0] > 0)


def test_aggregator_crop_with_overlap_zero_follows_torchio():
    """An explicit overlap of 0 in crop mode pastes whole patches, as
    torchio does; the JAX package raises.  An unset overlap raises on
    both sides."""
    vol = np.random.default_rng(8).normal(size=(16, 16, 16, 1)).astype(
        np.float32)
    sampler = TW.GridSampler(vol, 8, 0)
    agg = TW.GridAggregator(vol.shape[:3], overlap_mode="crop",
                            patch_overlap=0)
    agg.add_batch(sampler.patches().numpy(), sampler.locations)
    np.testing.assert_array_equal(agg.get_output_tensor(), vol)
    with pytest.raises(ValueError):
        JW.GridAggregator(vol.shape[:3], overlap_mode="crop", patch_overlap=0)
    for aggregator in (TW.GridAggregator, JW.GridAggregator):
        with pytest.raises(ValueError, match="patch_overlap"):
            aggregator(vol.shape[:3], overlap_mode="crop")
