"""Port parity: spatial and intensity transforms and `preprocess_volume`
(`mri_epilepsy_diagnosis_torch/transforms/`) against the JAX package's,
on the CPU, with inputs made from a seed with numpy.  Volumes are 32^3 or
smaller."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.ops import functional as TF
from mri_epilepsy_diagnosis_torch.transforms import intensity as TI
from mri_epilepsy_diagnosis_torch.transforms import spatial as TS
from mri_epilepsy_diagnosis_torch.transforms.preprocessing import (
    preprocess_volume)
from mri_epilepsy_diagnosis_tpu.ops import functional as JF
from mri_epilepsy_diagnosis_tpu.transforms import intensity as JI
from mri_epilepsy_diagnosis_tpu.transforms import spatial as JS
from mri_epilepsy_diagnosis_tpu.transforms.preprocessing import (
    preprocess_volume as jax_preprocess_volume)

torch.set_num_threads(2)


def _vol(seed, shape=(20, 17, 23)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t1_like(seed, shape=(24, 24, 24)):
    """Background near 0, a brighter ellipsoid and noise: a histogram with
    the shape Nyul's landmarks are made for."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape],
                             indexing="ij"))
    inside = ((g / rng.uniform(0.5, 0.8, (3, 1, 1, 1))) ** 2).sum(0) < 1
    return (inside * rng.uniform(300, 600) + rng.normal(0, 30, shape)
            + 20).astype(np.float32)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rel * scale, (err, rel * scale)


# ---------------------------------------------------------------- spatial

@pytest.mark.parametrize("target", [(20, 17, 23), (16, 12, 20),
                                    (25, 22, 28), (13, 24, 23),
                                    (21, 10, 30)])
@pytest.mark.parametrize("form", ["3d", "4d", "5d"])
def test_crop_or_pad_matches_jax(target, form):
    """Odd and even crops and pads, with the floor-centred crop and the
    odd voxel on the far side, in every form: exact."""
    v = _vol(0)
    if form == "4d":
        v = np.stack([v, -v, 2 * v])
    elif form == "5d":
        v = np.stack([v, 3 * v])[..., None].repeat(2, -1)
    got = TS.crop_or_pad(torch.from_numpy(v), target, value=-1.5).numpy()
    ref = np.asarray(JS.crop_or_pad(jnp.asarray(v), target, value=-1.5))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("target", [(20, 17, 23), (23, 20, 30)])
def test_pad_to_matches_jax(target):
    v = _vol(1)[None, ..., None]
    got = TF.pad_to(torch.from_numpy(v), target, value=0.5).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JF.pad_to(jnp.asarray(v), target, value=0.5)))


@pytest.mark.parametrize("mode", ["edge", "reflect", "symmetric", "wrap"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_pad_to_modes_match_jnp_pad(mode, dtype):
    """`pad_to(mode=...)` pads as `jnp.pad` does in that mode, with the
    same symmetric split (the odd voxel on the far side), any dtype.
    JAX's own `pad_to` passes `constant_values` to every mode, which
    `jnp.pad` refuses for all but "constant", so its symmetric pads are
    taken as JAX's `pad_to` computes them."""
    v = (_vol(2)[None, ..., None] * 100).astype(dtype)
    target = (21, 17, 26)
    got = TF.pad_to(torch.from_numpy(v), target, mode=mode)
    pads = [(0, 0)] + [((t - n) // 2, t - n - (t - n) // 2)
                       for n, t in zip(v.shape[1:4], target)] + [(0, 0)]
    ref = np.asarray(jnp.pad(jnp.asarray(v), pads, mode=mode))
    assert got.dtype == torch.from_numpy(v).dtype
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError):
        JF.pad_to(jnp.asarray(v), target, mode=mode)


def test_pad_to_edge_mode_gradient_sums_into_the_edge():
    """The gather of a non-constant mode is differentiable: each padded
    voxel's gradient goes back to the voxel it copies."""
    v = torch.from_numpy(_vol(3)[None, :4, :3, :5, None]).requires_grad_()
    TF.pad_to(v, (6, 3, 5), mode="edge").sum().backward()
    want = np.ones(v.shape, np.float32)
    want[:, 0] += 1
    want[:, -1] += 1
    np.testing.assert_array_equal(v.grad.numpy(), want)


@pytest.mark.parametrize("axes", [(0,), (1, 2), (0, 1, 2)])
def test_flip_matches_jax(axes):
    v = _vol(2)
    np.testing.assert_array_equal(
        TS.flip(torch.from_numpy(v), axes).numpy(),
        np.asarray(JS.flip(jnp.asarray(v), axes)))


def _sample_coords(shape, seed):
    """Coordinates inside, exactly on each face and corner, and outside
    by less and more than one voxel."""
    rng = np.random.default_rng(seed)
    hi = np.asarray(shape, np.float32)[:, None] - 1
    inside = rng.uniform(0, 1, (3, 200)).astype(np.float32) * hi
    edge = inside[:, :60].copy()
    for ax in range(3):
        edge[ax, 20 * ax:20 * ax + 10] = 0
        edge[ax, 20 * ax + 10:20 * ax + 20] = hi[ax]
    corners = np.array(np.meshgrid(*[[0, h] for h in hi[:, 0]],
                                   indexing="ij"), np.float32).reshape(3, -1)
    outside = inside[:, :90].copy()
    outside[:, :30] -= rng.uniform(0.01, 0.99, (3, 30)).astype(np.float32)
    outside[0, 30:60] = hi[0] + rng.uniform(0.01, 3, 30)
    outside[2, 60:90] = -rng.uniform(1, 3, 30)
    # 358 points, as a (3, 2, 179) grid of coordinates
    return np.concatenate([inside, edge, corners, outside], 1).reshape(
        3, 2, -1)


@pytest.mark.parametrize("fill", [0.0, -2.5])
def test_trilinear_sample_matches_jax(fill):
    v = _vol(3)
    c = _sample_coords(v.shape, 4)
    got = TS.trilinear_sample(torch.from_numpy(v), torch.from_numpy(c),
                              fill).numpy()
    ref = np.asarray(JS.trilinear_sample(jnp.asarray(v), jnp.asarray(c),
                                         fill))
    _close(got, ref, 1e-6)
    # reads on the last voxel are values, not fill
    assert np.sum(ref == fill) < c[0].size // 4


def _rotation_affine(shape, angle, shift, scale=1.0):
    c, s = np.cos(angle), np.sin(angle)
    a = np.eye(4)
    a[:3, :3] = scale * np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    center = (np.asarray(shape) - 1) / 2
    a[:3, 3] = center - a[:3, :3] @ center + shift
    return a


@pytest.mark.parametrize("out_shape", [None, (16, 20, 18)])
@pytest.mark.parametrize("angle", [0.0, 0.3])
def test_affine_resample_matches_jax(out_shape, angle):
    v = _vol(5)
    a = _rotation_affine(v.shape, angle, [1.25, -0.5, 2.0], 1.07)
    got = TS.affine_resample(torch.from_numpy(v), a, out_shape,
                             fill_value=-1.0).numpy()
    ref = np.asarray(JS.affine_resample(jnp.asarray(v), a, out_shape,
                                        fill_value=-1.0))
    _close(got, ref, 1e-5)


def test_warp_dense_matches_jax():
    v = _vol(6)
    disp = np.random.default_rng(7).uniform(-3, 3, (3,) + v.shape).astype(
        np.float32)
    got = TS.warp_dense(torch.from_numpy(v), torch.from_numpy(disp),
                        0.5).numpy()
    ref = np.asarray(JS.warp_dense(jnp.asarray(v), jnp.asarray(disp), 0.5))
    _close(got, ref, 1e-5)


def test_world_affine_to_voxel_matches_jax():
    rng = np.random.default_rng(8)
    src, dst, world = (np.eye(4) + np.pad(rng.normal(0, 0.2, (3, 4)),
                                          ((0, 1), (0, 0)))
                       for _ in range(3))
    for wt in (None, world):
        _close(TS.world_affine_to_voxel(src, dst, wt),
               JS.world_affine_to_voxel(src, dst, wt), 1e-5)


# ---------------------------------------------------------------- intensity

@pytest.mark.parametrize("masking", [None, "mean"])
def test_znormalization_matches_jax(masking):
    v = _t1_like(9)
    _close(TI.znormalization(torch.from_numpy(v), masking).numpy(),
           JI.znormalization(jnp.asarray(v), masking), 1e-6)


@pytest.mark.parametrize("out,pcts", [((0.0, 1.0), (0.0, 100.0)),
                                      ((-1.0, 1.0), (0.5, 99.5)),
                                      ((0.0, 255.0), (2.0, 98.0))])
def test_rescale_intensity_matches_jax(out, pcts):
    v = _t1_like(10)
    _close(TI.rescale_intensity(torch.from_numpy(v), out, pcts).numpy(),
           JI.rescale_intensity(jnp.asarray(v), out, pcts), 1e-6)


def test_minmax_norm_matches_jax():
    v = _t1_like(11)
    _close(TI.minmax_norm(torch.from_numpy(v)).numpy(),
           JI.minmax_norm(jnp.asarray(v)), 1e-6)


def test_percentiles_match_numpy_linear():
    v = _t1_like(12, (17, 19, 23))
    pcts = TI._percentile_grid()
    np.testing.assert_allclose(
        TI._percentiles(torch.from_numpy(v), pcts).numpy(),
        np.percentile(v, pcts), rtol=1e-6)


def _landmarks():
    vols = [_t1_like(s) for s in (20, 21, 22)]
    return vols, JI.train_histogram_landmarks(vols)


def test_train_histogram_landmarks_matches_jax():
    """numpy on both sides: exact, with and without masks."""
    vols, ref = _landmarks()
    np.testing.assert_array_equal(TI.train_histogram_landmarks(vols), ref)
    masks = [v > 100 for v in vols]
    np.testing.assert_array_equal(
        TI.train_histogram_landmarks(vols, masks=masks),
        JI.train_histogram_landmarks(vols, masks=masks))


@pytest.mark.parametrize("case", ["t1", "ties", "degenerate", "cutoff"])
def test_histogram_standardization_matches_jax(case):
    """Including a volume with ties (integer intensities) and one whose
    low percentiles coincide (a degenerate bin: the inf guard)."""
    _, lm = _landmarks()
    v = _t1_like(13)
    cutoff = None
    if case == "ties":
        v = np.round(v / 40).astype(np.float32)
    elif case == "degenerate":
        v[v < np.percentile(v, 35)] = 0.0
    elif case == "cutoff":
        cutoff = (0.05, 0.95)
    got = TI.histogram_standardization(torch.from_numpy(v), lm, cutoff)
    ref = np.asarray(JI.histogram_standardization(jnp.asarray(v), lm,
                                                  cutoff))
    _close(got.numpy(), ref, 1e-5)
    if case == "degenerate":
        perc = np.percentile(v, TI._percentile_grid())[TI._RANGE_TO_USE]
        assert (np.diff(perc) < 1e-5).any()


def test_histogram_standardization_beyond_torch_quantile_limit():
    """More than 2^24 voxels, where `torch.quantile` refuses: the
    percentiles still equal numpy's."""
    rng = np.random.default_rng(14)
    v = torch.from_numpy(rng.normal(size=2 ** 24 + 3).astype(np.float32))
    with pytest.raises(RuntimeError):
        torch.quantile(v, 0.5)
    pcts = TI._percentile_grid()
    np.testing.assert_allclose(TI._percentiles(v, pcts).numpy(),
                               np.percentile(v.numpy(), pcts), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("landmarks,target,masking", [
    (True, (16, 30, 20), None), (False, None, "mean"),
    (True, None, "mean"), (False, (25, 24, 21), None)])
def test_preprocess_volume_matches_jax(landmarks, target, masking):
    _, lm = _landmarks()
    lm = lm if landmarks else None
    v = _t1_like(15)
    got = preprocess_volume(v, lm, target, masking, device="cpu")
    ref = np.asarray(jax_preprocess_volume(jnp.asarray(v), lm, target,
                                           masking))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-5)
    # a tensor is processed where it lies, with or without `device`
    same = preprocess_volume(torch.from_numpy(v), lm, target, masking)
    np.testing.assert_array_equal(same.numpy(), got.numpy())


def test_preprocess_volume_needs_a_device_for_arrays(monkeypatch):
    """A numpy volume goes to the card by default, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_volume(_vol(16))
