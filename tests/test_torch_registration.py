"""Port parity: MNI registration and bias correction
(`transforms/registration.py`, `transforms/preprocessing.py::
register_img_and_mask`) against the JAX package's on the CPU.

The volumes are synthetic heads of at most 32^3 (asymmetric blobs, so
that every rotation is told apart), made from a seed.  The JAX references
run in module fixtures under `jax.default_matmul_precision("highest")`:
`params_to_affine` and `_rotation_matrix` contract in JAX's default
precision, which is bf16-level even on the CPU.  Tolerances: the affine
and resampling 1e-6 x max|ref| (float32 rounding of a few products);
20 Adam steps 1e-4 (float32 sums over the volume in another order, fed
back through the steps); grid scores 1e-5.

Two tolerances are set by the JAX package's own float32 noise:
- A whole registration takes 350 Adam steps at lr 0.03, which end
  jittering about the optimum: the two packages' float32 gradients move
  the final translation by 1.4e-3 voxels from the identity start and
  3.6e-3 from the searched one on this input, so the affine is held to
  1e-2 (a wrong start, level scale or mask moves it by far more) and the
  NCC to 1e-4.  Grid points that are one rotation under two Euler
  parameterizations, e.g. (0, 0, 0) and (180, 180, 180) degrees, tie in
  exact arithmetic, so the coarse search's starts are compared as
  affines, in any order among themselves.
- The bias fit's normal equations have condition number 1.7e3 here:
  JAX sums them in float32, and its result lies 1.2e-4 x max from a
  float64 evaluation of the same fit.  The port sums them in float64
  (ROADMAP §C), so it is held to 1e-5 x max of that evaluation and to
  2e-4 x max|ref| of JAX's result."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_epilepsy_diagnosis_torch.transforms import registration as TR
from mri_epilepsy_diagnosis_torch.transforms.preprocessing import (
    register_img_and_mask)
from mri_epilepsy_diagnosis_torch.utils.nifti import NiftiImage
from mri_epilepsy_diagnosis_tpu.transforms import registration as JR

torch.set_num_threads(2)

SHAPE = (28, 32, 24)
# (tx, ty, tz, rx, ry, rz, log-scales, shears): the misalignment of
# `tests/test_transforms.py`'s quality gate, with shears
TRUE_PARAMS = np.array([2.0, -1.5, 1.0, 0.09, -0.07, 0.05, np.log(1.03),
                        np.log(0.97), 0.0, 0.02, -0.01, 0.015], np.float32)


def synthetic_head(shape=SHAPE, seed=0):
    """Gaussian blobs at seeded, asymmetric places inside an ellipsoid."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                             indexing="ij"))
    c = (np.array(shape, np.float32) - 1) / 2
    r = ((g - c[:, None, None, None]) / (0.38 * np.array(shape))[
        :, None, None, None])
    vol = 0.3 * (np.square(r).sum(0) < 1.0)
    for _ in range(6):
        mu = c + rng.uniform(-0.25, 0.25, 3) * np.array(shape)
        sd = rng.uniform(1.5, 3.5, 3)
        vol += rng.uniform(0.5, 1.0) * np.exp(-np.square(
            (g - mu[:, None, None, None]) / sd[:, None, None, None]).sum(0))
    return vol.astype(np.float32)


def _affine_jax(params, shape):
    with jax.default_matmul_precision("highest"):
        return np.asarray(JR.params_to_affine(jnp.asarray(params), shape))


@pytest.fixture(scope="module")
def pair():
    """(template, subject = template under TRUE_PARAMS, forward affine)."""
    tpl = synthetic_head()
    fwd = _affine_jax(TRUE_PARAMS, SHAPE)
    with jax.default_matmul_precision("highest"):
        subject = np.asarray(JR.apply_transform(tpl, fwd, SHAPE))
    return tpl, subject, fwd


def test_params_to_affine_matches_jax():
    rng = np.random.default_rng(1)
    params = rng.normal(0, 0.3, (5, 12)).astype(np.float32)
    params[:, :3] *= 10
    ref = np.stack([_affine_jax(p, SHAPE) for p in params])
    got = TR.params_to_affine(torch.from_numpy(params), SHAPE).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    one = TR.params_to_affine(torch.from_numpy(params[2]), SHAPE).numpy()
    np.testing.assert_array_equal(one, got[2])


def test_apply_transform_matches_jax(pair):
    tpl, subject, fwd = pair
    got = TR.apply_transform(tpl, fwd, SHAPE, device="cpu").numpy()
    np.testing.assert_allclose(got, subject, rtol=0,
                               atol=1e-6 * np.abs(subject).max())
    shifted = np.eye(4)
    shifted[:3, 3] = (3.5, -2.25, 40.0)      # reads outside: fill value
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JR.apply_transform(tpl, shifted, (20, 20, 20), -1.0))
    got = TR.apply_transform(torch.from_numpy(tpl), shifted, (20, 20, 20),
                             -1.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.fixture(scope="module")
def level_ref(pair):
    tpl, subject, _ = pair
    mask = jnp.ones(12, jnp.float32)
    with jax.default_matmul_precision("highest"):
        p, loss = JR._register_level(jnp.asarray(subject), jnp.asarray(tpl),
                                     jnp.zeros(12, jnp.float32), mask, 20,
                                     0.03)
    return np.asarray(p), float(loss)


def test_register_level_matches_jax(pair, level_ref):
    """20 Adam steps of the 12-parameter descent from the identity."""
    tpl, subject, _ = pair
    p, loss = TR._register_level(torch.from_numpy(subject),
                                 torch.from_numpy(tpl), torch.zeros(12),
                                 torch.ones(12), 20, 0.03)
    np.testing.assert_allclose(p.numpy(), level_ref[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(loss.item(), level_ref[1], rtol=0, atol=1e-4)
    assert loss.item() < -0.5


def test_register_level_batch_is_independent_runs(pair):
    """A (3, 12) batch of starts takes the steps each start takes alone."""
    tpl, subject, _ = pair
    rng = np.random.default_rng(2)
    starts = torch.from_numpy(rng.normal(0, 0.1, (3, 12)).astype(np.float32))
    rigid = torch.tensor([1.0] * 6 + [0.0] * 6)
    mv, fx = torch.from_numpy(subject), torch.from_numpy(tpl)
    p, losses = TR._register_level(mv, fx, starts, rigid, 8, 0.03)
    for i in range(3):
        pi, li = TR._register_level(mv, fx, starts[i], rigid, 8, 0.03)
        np.testing.assert_allclose(p[i].numpy(), pi.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(losses[i].item(), li.item(), rtol=0,
                                   atol=1e-6)
        # the rigid mask keeps the other six entries where they started
        assert torch.equal(p[i, 6:], starts[i, 6:])


@pytest.fixture(scope="module")
def search_ref(pair):
    """The JAX package's grid scores (search_step_deg=90: 4^3 = 64
    candidates) at level 2, and its coarse search's starts."""
    tpl, subject, _ = pair
    r90 = np.float32(np.pi / 2)
    quarter = _affine_jax(np.array([1.5, -1.0, 0.5, r90, 0, 0] + [0] * 6,
                                   np.float32), SHAPE)
    with jax.default_matmul_precision("highest"):
        moving = np.asarray(JR.apply_transform(tpl, quarter, SHAPE))
        mv = JR._downsample(jnp.asarray(moving), 2)
        fx = JR._downsample(jnp.asarray(tpl), 2)
        com_mv, com_fx = JR._center_of_mass(mv), JR._center_of_mass(fx)
        grid = np.deg2rad(np.array([-90.0, 0.0, 90.0, 180.0], np.float32))
        angles = np.array([(a, b, c) for a in grid for b in grid
                           for c in grid], np.float32)
        scores = np.asarray(JR._search_scores(mv, fx, com_mv, com_fx,
                                              jnp.asarray(angles)))
        starts = JR.coarse_search(moving, tpl, level=2, search_step_deg=90.0)
    return moving, angles, scores, [np.asarray(s) for s in starts]


def test_coarse_search_matches_jax(pair, search_ref):
    tpl = pair[0]
    moving, angles, scores_ref, starts_ref = search_ref
    mv = TR._downsample(torch.from_numpy(moving), 2)
    fx = TR._downsample(torch.from_numpy(tpl), 2)
    scores = TR._search_scores(mv, fx, TR._center_of_mass(mv),
                               TR._center_of_mass(fx),
                               torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(scores, scores_ref, rtol=0, atol=1e-5)
    # the same order wherever two scores differ by more than the tolerance
    i, j = np.triu_indices(len(scores), 1)
    apart = np.abs(scores_ref[i] - scores_ref[j]) > 1e-5
    assert np.array_equal((scores[i] > scores[j])[apart],
                          (scores_ref[i] > scores_ref[j])[apart])
    starts = TR.coarse_search(moving, tpl, level=2, search_step_deg=90.0,
                              device="cpu")
    assert len(starts) == len(starts_ref) == 3
    got = [TR.params_to_affine(p, SHAPE).numpy() for p in starts]
    ref = [_affine_jax(p, SHAPE) for p in starts_ref]
    for a in got:
        assert min(np.abs(a - b).max() for b in ref) < 1e-2
    for b in ref:
        assert min(np.abs(a - b).max() for a in got) < 1e-2


@pytest.fixture(scope="module")
def register_ref(pair):
    tpl, subject, _ = pair
    with jax.default_matmul_precision("highest"):
        aff, warped = JR.register_affine(subject, tpl, dof=12,
                                         search_range_deg=90.0,
                                         search_step_deg=90.0)
        ncc = float(JR._ncc(warped, jnp.asarray(tpl)))
    return np.asarray(aff), ncc


def test_register_affine_matches_jax(pair, register_ref):
    tpl, subject, fwd = pair
    aff, warped = TR.register_affine(subject, tpl, dof=12,
                                     search_range_deg=90.0,
                                     search_step_deg=90.0, device="cpu")
    assert aff.dtype == np.float32 and warped.device.type == "cpu"
    np.testing.assert_allclose(aff, register_ref[0], rtol=0, atol=1e-2)
    ncc = TR._ncc(warped, torch.from_numpy(tpl)).item()
    np.testing.assert_allclose(ncc, register_ref[1], rtol=0, atol=1e-4)
    assert ncc > 0.95


def _bias_fit_f64(vol, order=3):
    """The same fit in numpy's float64 on the float32 basis: the corrected
    volume."""
    basis = TR._poly_basis(vol.shape, order, "cpu").numpy()
    a = basis.reshape(len(basis), -1).astype(np.float64)
    w = (vol > vol.mean()).reshape(-1).astype(np.float64)
    y = np.log(np.maximum(vol, 1e-6)).reshape(-1).astype(np.float64)
    c = np.linalg.solve((a * w) @ a.T + 1e-6 * np.eye(len(a)), (a * w) @ y)
    log_bias = c @ a
    log_bias -= (log_bias * w).sum() / max(w.sum(), 1)
    return (vol.reshape(-1) / np.exp(log_bias)).reshape(vol.shape)


def test_bias_field_correction_matches_jax(pair):
    tpl = pair[0]
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in SHAPE], indexing="ij")
    corrupted = (tpl + 0.05) * np.exp(0.3 * g[0] - 0.2 * g[1] * g[2]
                                      + 0.15 * g[2] ** 2)
    corrupted = corrupted.astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref, ref_bias = (np.asarray(a) for a in JR.bias_field_correction(
            jnp.asarray(corrupted)))
    got, bias = TR.bias_field_correction(corrupted, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-4 * np.abs(ref).max())
    np.testing.assert_allclose(bias.numpy(), ref_bias, rtol=0,
                               atol=2e-4 * np.abs(ref_bias).max())
    exact = _bias_fit_f64(corrupted)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0,
                               atol=1e-5 * np.abs(exact).max())


def _blob(shape, center, r):
    g = np.mgrid[tuple(slice(0, s) for s in shape)].astype(np.float32)
    return np.exp(-sum(((g[i] - center[i]) / r[i]) ** 2 for i in range(3)))


def test_register_img_and_mask_pipeline():
    """`tests/test_preprocessing.py`'s scenario through the port: a shifted
    blob with a lesion mask registers back (correlation > 0.9), and the
    mask rides the same transform to within a voxel of where it belongs."""
    shape = (32, 32, 32)
    template = NiftiImage(_blob(shape, (16, 16, 16), (6, 5, 7)), np.eye(4))
    img_data = np.roll(template.data, (3, -2, 0), axis=(0, 1, 2))
    mask_data = np.zeros(shape, np.float32)
    mask_data[18:24, 10:16, 14:20] = 1.0
    img = NiftiImage(img_data * 90 + 10, np.eye(4))
    mask = NiftiImage(mask_data, np.eye(4))

    warped, corrected, wmask, affine = register_img_and_mask(
        img, template, mask, dof=6, levels=(2, 1), iters=(150, 80),
        bias_correct=True, device="cpu")
    assert warped.device.type == corrected.device.type == "cpu"
    assert affine.shape == (4, 4) and wmask.dtype == np.float32
    corr = np.corrcoef(warped.numpy().ravel(),
                       (template.data * 90 + 10).ravel())[0, 1]
    assert corr > 0.9
    assert wmask.sum() > 0
    com = np.array(np.nonzero(wmask)).mean(1)
    np.testing.assert_allclose(com, [20.5 - 3, 12.5 + 2, 16.5], atol=1.0)


def test_registration_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.zeros((8, 8, 8), np.float32)
    for call in (lambda: TR.register_affine(vol, vol, search=False),
                 lambda: TR.bias_field_correction(vol),
                 lambda: TR.apply_transform(vol, np.eye(4), vol.shape)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
