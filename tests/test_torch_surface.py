"""Port parity: the host-side surface metrics (`metrics/surface.py`), the
native EDT (`native/`) and the NIfTI codec (`utils/nifti.py`) of the port
against the JAX package's, on the same numpy masks and files.  Oracles
as in `tests/test_metrics.py`, `tests/test_native.py` and
`tests/test_data.py`.

All of it is float64 numpy on both sides over the same algorithm, so the
metrics must agree to 1e-12 (summation order only) and the EDT exactly."""
import numpy as np
import pytest
from scipy import ndimage

from mri_epilepsy_diagnosis_torch import native as TN
from mri_epilepsy_diagnosis_torch.metrics import surface as TS
from mri_epilepsy_diagnosis_torch.utils import nifti as TNii
from mri_epilepsy_diagnosis_tpu import native as JN
from mri_epilepsy_diagnosis_tpu.metrics import surface as JS
from mri_epilepsy_diagnosis_tpu.utils import nifti as JNii

TOL = 1e-12


def _blobs(rng, shape, n):
    """A binary mask of `n` random balls."""
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                                indexing="ij"), -1)
    mask = np.zeros(shape, bool)
    for _ in range(n):
        c = rng.uniform(0, shape)
        r = rng.uniform(2, min(shape) / 3)
        mask |= ((grid - c) ** 2).sum(-1) <= r * r
    return mask


def _masks(kind):
    rng = np.random.default_rng(0)
    shape = (20, 17, 23)
    if kind == "blobs":
        return _blobs(rng, shape, 3), _blobs(rng, shape, 4)
    if kind == "noise":
        return rng.random(shape) > 0.7, rng.random(shape) > 0.6
    if kind == "one_empty":
        return _blobs(rng, shape, 2), np.zeros(shape, bool)
    return np.zeros(shape, bool), np.zeros(shape, bool)


CASES = [(kind, spacing) for kind in ("blobs", "noise", "one_empty", "empty")
         for spacing in ((1.0, 1.0, 1.0), (0.7, 1.3, 2.1))]


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind,spacing", CASES)
def test_surface_metrics_match_jax(kind, spacing):
    """Surface distances, ASD, robust Hausdorff, surface overlap and
    surface dice at tolerance: random blobs, noise, one empty mask, two
    empty masks; isotropic and anisotropic spacing."""
    gt, pred = _masks(kind)
    got = TS.compute_surface_distances(gt, pred, spacing)
    ref = JS.compute_surface_distances(gt, pred, spacing)
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k], ref[k])
    _close(TS.compute_average_surface_distance(got),
           JS.compute_average_surface_distance(ref))
    for pct in (95, 100):
        _close(TS.compute_robust_hausdorff(got, pct),
               JS.compute_robust_hausdorff(ref, pct))
    for tol_mm in (1.0, 2.5):
        _close(TS.compute_surface_overlap_at_tolerance(got, tol_mm),
               JS.compute_surface_overlap_at_tolerance(ref, tol_mm))
        _close(TS.compute_surface_dice_at_tolerance(got, tol_mm),
               JS.compute_surface_dice_at_tolerance(ref, tol_mm))
    if kind == "blobs":
        assert len(got["distances_gt_to_pred"]) > 100


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.7, 1.3, 2.1)])
def test_area_table_matches_jax(spacing):
    np.testing.assert_array_equal(TS.neighbour_code_to_surface_area(spacing),
                                  JS.neighbour_code_to_surface_area(spacing))


def test_surface_metrics_reject_shape_mismatch():
    with pytest.raises(ValueError, match="shapes differ"):
        TS.compute_surface_distances(np.zeros((3, 3, 3)), np.zeros((3, 3, 4)),
                                     (1, 1, 1))


@pytest.mark.parametrize("kind", ["blobs", "noise", "single", "empty"])
@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.7, 1.3, 2.1)])
def test_edt3d_matches_jax_and_scipy(kind, spacing):
    """The port's native EDT == the JAX package's native EDT (same
    source) == scipy's exact EDT (1e-12); inf for an empty mask."""
    rng = np.random.default_rng(1)
    shape = (19, 24, 13)
    mask = {"blobs": _blobs(rng, shape, 2),
            "noise": rng.random(shape) > 0.97,
            "single": np.zeros(shape, bool),
            "empty": np.zeros(shape, bool)}[kind]
    if kind == "single":
        mask[3, 20, 7] = True
    assert TN.native_available()
    calls = TN.edt3d.native_calls
    got = TN.edt3d(mask, spacing)
    assert TN.edt3d.native_calls == calls + 1
    assert got.dtype == np.float64 and got.shape == shape
    np.testing.assert_array_equal(got, JN.edt3d(mask, spacing))
    if kind == "empty":
        assert np.isinf(got).all()
    else:
        ref = ndimage.distance_transform_edt(~mask, sampling=spacing)
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_edt3d_rejects_bad_input():
    with pytest.raises(ValueError, match="3-D"):
        TN.edt3d(np.zeros((4, 4)))
    with pytest.raises(ValueError, match="3 spacings"):
        TN.edt3d(np.zeros((4, 4, 4)), (1.0, 1.0))


AFFINE = np.array([[1., 0, 0, -90], [0, 1, 0, -126], [0, 0, 1, -72],
                   [0, 0, 0, 1]])


@pytest.mark.parametrize("name,dtype", [("x.nii.gz", np.float32),
                                        ("y.nii", np.int16),
                                        ("z.nii.gz", np.uint8)])
def test_nifti_round_trip_and_cross_read(tmp_path, name, dtype):
    """The port reads back what it wrote, reads what the JAX package
    wrote, and the JAX package reads what the port wrote: data, dtype and
    affine."""
    rng = np.random.default_rng(2)
    a = (rng.normal(size=(7, 9, 11)) * 50).astype(dtype)
    affine = AFFINE * np.array([[0.9], [1.1], [1.3], [1]])
    for writer, reader in ((TNii, TNii), (JNii, TNii), (TNii, JNii)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}_{name}")
        writer.save_nifti(path, a, affine)
        img = reader.load_nifti(path)
        assert img.data.dtype == a.dtype
        np.testing.assert_array_equal(img.data, a)
        np.testing.assert_allclose(img.affine, affine, rtol=1e-6)
    # the same bytes on disk
    t, j = tmp_path / "t.nii", tmp_path / "j.nii"
    TNii.save_nifti(str(t), a, affine)
    JNii.save_nifti(str(j), a, affine)
    assert t.read_bytes() == j.read_bytes()


def test_nifti_rejects_a_truncated_file(tmp_path):
    path = tmp_path / "bad.nii"
    path.write_bytes(b"\0" * 100)
    with pytest.raises(ValueError, match="truncated"):
        TNii.load_nifti(str(path))
