"""Port parity: datasets, loaders, the patch queue and the collates
(`mri_epilepsy_diagnosis_torch/utils/data.py`, `data/`) against the JAX
package's, on the CPU, over a tmp directory of tiny NIfTI pairs written
with the port's `save_nifti` and a targets CSV.

The port reads the CSV without pandas and returns the manifest as numpy
columns; the JAX package returns a DataFrame and a LabelEncoder.  Missing
values are NaN there and None (file columns, text) or NaN (numbers) here."""
import csv

import numpy as np
import pandas as pd
import pytest
import torch

from mri_epilepsy_diagnosis_torch import data as TD
from mri_epilepsy_diagnosis_torch.utils import data as TU
from mri_epilepsy_diagnosis_torch.utils.nifti import save_nifti
from mri_epilepsy_diagnosis_tpu import data as JD
from mri_epilepsy_diagnosis_tpu.data.collate import (
    fader_collate as jax_fader_collate)
from mri_epilepsy_diagnosis_tpu.utils import data as JU

torch.set_num_threads(2)
SIDE = 20
COMMON = dict(coord_min=(2, 1, 3), img_shape=(16, 16, 16))


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    """Seven subjects of four cohorts: pirogov with `.nii.gz` and `.nii`
    parcellations, substring cohorts with `_T1w_norm` names, one subject
    without a parcellation, one without an image, one whose id is a
    substring of another's, and lesion masks for most of them."""
    root = tmp_path_factory.mktemp("cohort")
    bank, masks = root / "bank", root / "masks"
    bank.mkdir()
    masks.mkdir()
    rng = np.random.default_rng(0)
    subjects = [("pirogov", "p01", "siemens", "gz"),
                ("pirogov", "p02", "ge", "nii"),
                ("pirogov", "p03", "siemens", "no_seg"),
                ("hcp", "h01", "philips", "gz"),
                ("hcp", "h011", "ge", "gz"),
                ("la5_study", "l01", "siemens", "no_img"),
                ("kulakov", "k01", "canon", "gz")]
    rows = []
    for i, (sample, pat, scan, kind) in enumerate(subjects):
        vol = (rng.normal(500, 80, (SIDE,) * 3)).astype(np.int16)
        seg = rng.choice([0, 2, 17, 41, 1000, 1021, 2030],
                         size=(SIDE,) * 3).astype(np.int32)
        norm = (f"{pat}_norm.nii.gz" if sample == "pirogov"
                else f"{pat}_T1w_norm.nii.gz")
        aseg = (f"{pat}_aparc+aseg.nii" + (".gz" if kind == "gz" else "")
                if sample == "pirogov" else f"{pat}_aseg.nii.gz")
        if kind != "no_img":
            save_nifti(str(bank / norm), vol)
        if kind != "no_seg":
            save_nifti(str(bank / aseg), seg)
        if i != 1:
            save_nifti(str(masks / f"{pat}.nii.gz"),
                       (rng.random((SIDE,) * 3) > 0.6).astype(np.uint8))
        rows.append([sample, pat, i % 2, 30 + i, scan,
                     "" if i == 3 else i % 3, "" if i % 2 else "note"])
    path = root / "targets.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["sample", "patient", "fcd", "age", "scan", "detection",
                    "comments"])
        w.writerows(rows)
    return dict(image_path=str(bank), mask_path=str(masks),
                targets_path=str(path))


def _column(values):
    """A manifest column with every missing value as None."""
    return [None if v is None or v is pd.NA
            or (isinstance(v, float) and np.isnan(v)) else v
            for v in np.asarray(values, object)]


CASES = [dict(sample="pirogov"),
         dict(sample="pirogov", prefix="p0"),
         dict(sample="pirogov", prefix="p02"),
         dict(sample="hcp"),
         dict(sample="all"),
         dict(sample="all", ignore_missing=False),
         dict(sample="all", data_type="img"),
         dict(sample="all", data_type="seg"),
         dict(sample="pirogov", mask=True),
         dict(sample="hcp", mask=True, ignore_missing=False),
         dict(sample="all", mask=True)]


@pytest.mark.parametrize("case", CASES, ids=[
    "-".join(f"{k}={v}" for k, v in c.items()) for c in CASES])
def test_targets_complete_matches_jax(bank, case):
    case = dict(case)
    kw = dict(image_path=bank["image_path"], targets_path=bank["targets_path"],
              mask_path=bank["mask_path"] if case.pop("mask", False)
              else False)
    ref, le = JU.targets_complete(**case, **kw)
    got, classes = TU.targets_complete(**case, **kw)
    assert set(got) == set(ref.columns)
    for col in ref.columns:
        assert _column(got[col]) == _column(ref[col]), col
    np.testing.assert_array_equal(classes, le.classes_)
    assert got["scan"].dtype.kind == "i"


def _datasets(bank, cls, **kw):
    args = dict(image_path=bank["image_path"],
                targets_path=bank["targets_path"], **COMMON, **kw)
    return getattr(TU, cls)(**args), getattr(JU, cls)(**args)


def _assert_items_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert type(x) is type(y) and x == y


@pytest.mark.parametrize("mask,sample", [("seg", "all"), ("bb", "pirogov"),
                                         ("combined", "pirogov"),
                                         ("combined", "hcp")])
def test_mri_segmentation_matches_jax(bank, mask, sample):
    kw = dict(mask=mask, mask_path=bank["mask_path"] if mask != "seg"
              else False)
    got, ref = _datasets(bank, "MriSegmentation", sample=sample, **kw)
    assert len(got) == len(ref) > 0
    for i in range(len(ref)):
        if mask != "seg" and got.img_mask[i] is None:
            # a subject without a lesion mask stays in the manifest, and
            # reading it fails on both sides
            for ds in (got, ref):
                with pytest.raises(TypeError):
                    ds[i]
            continue
        _assert_items_equal(got[i], ref[i])


@pytest.mark.parametrize("data_type", ["img", "seg"])
def test_mri_classification_matches_jax(bank, data_type):
    got, ref = _datasets(bank, "MriClassification", sample="all",
                         data_type=data_type)
    assert len(got) == len(ref) > 0
    np.testing.assert_array_equal(got.scan_keys, ref.scan_keys)
    for i in range(len(ref)):
        _assert_items_equal(got[i], ref[i])


def test_dataset_modes_are_checked(bank):
    with pytest.raises(AssertionError):
        _datasets(bank, "MriSegmentation", sample="all", mask="box")
    with pytest.raises(AssertionError):
        TU.MriClassification("all", data_type="pet", **COMMON)


def test_load_nii_to_array_on_a_missing_file(tmp_path):
    assert TU.load_nii_to_array(str(tmp_path / "none.nii.gz")) == ""
    v = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    save_nifti(str(tmp_path / "v.nii"), v)
    np.testing.assert_array_equal(
        TU.load_nii_to_array(str(tmp_path / "v.nii")),
        JU.load_nii_to_array(str(tmp_path / "v.nii")))


@pytest.mark.parametrize("kind", ["ones", "noise", "blobs"])
def test_synthetic_volumes_match_jax(kind):
    got = TU.SyntheticVolumes(n=5, img_shape=(12, 10, 14), kind=kind, seed=3)
    ref = JU.SyntheticVolumes(n=5, img_shape=(12, 10, 14), kind=kind, seed=3)
    np.testing.assert_array_equal(got.scan_keys, ref.scan_keys)
    for i in range(5):
        _assert_items_equal(got[i], ref[i])
        _assert_items_equal(got.as_segmentation(40.0)[i],
                            ref.as_segmentation(40.0)[i])
    fixed = TU.SyntheticVolumes(n=2, img_shape=(4, 4, 4), targets=[1, 0],
                                domains=[2, 5])
    assert [fixed[i][1:] for i in range(2)] == [(1, 2), (0, 5)]


def _tree_equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_default_collate_matches_jax():
    ds = TU.SyntheticVolumes(n=3, img_shape=(6, 5, 4), kind="noise")
    items = [ds[i] for i in range(3)]
    _tree_equal(TD.default_collate(items), JD.default_collate(items))
    pairs = [ds.as_segmentation(0.0)[i] for i in range(3)]
    _tree_equal(TD.default_collate(pairs), JD.default_collate(pairs))
    flat = [np.ones(4, np.float32) * i for i in range(3)]
    _tree_equal(TD.default_collate(flat), JD.default_collate(flat))


@pytest.mark.parametrize("batch,shuffle,drop_last", [
    (2, True, False), (3, True, True), (4, False, False)])
def test_subset_and_loader_match_jax(bank, batch, shuffle, drop_last):
    tds, jds = _datasets(bank, "MriSegmentation", sample="all")
    idx = [3, 0, 2, 1]
    tsub, jsub = TD.Subset(tds, idx), JD.Subset(jds, idx)
    np.testing.assert_array_equal(tsub.target, jsub.target)

    def transform(item):
        return item[0] * 2, item[1]

    kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last,
              transform=transform, seed=5)
    tl, jl = TD.DataLoader(tsub, **kw), JD.DataLoader(jsub, **kw)
    assert len(tl) == len(jl)
    for _ in range(2):      # a second pass draws a new permutation
        got, ref = list(tl), list(jl)
        assert len(got) == len(ref) == len(tl)
        for g, r in zip(got, ref):
            _tree_equal(g, r)


@pytest.mark.parametrize("workers", [0, 1, 2])
def test_patch_queue_matches_jax(bank, workers):
    tds, jds = _datasets(bank, "MriSegmentation", sample="all")
    kw = dict(max_length=5, samples_per_volume=3, patch_size=(8, 6, 10),
              seed=7, num_workers=workers)
    tq = TD.PatchQueue(tds, **kw)
    jq = JD.PatchQueue(jds, **kw)
    assert len(tq) == len(jq) == 3 * len(tds)
    got = list(TD.batched(tq, 4))
    ref = list(JD.batched(jq, 4))
    assert len(got) == len(ref) == -(-len(tq) // 4)
    for g, r in zip(got, ref):
        _tree_equal(g, r)
    # re-iterable: a new pass over the queue draws new patches
    again = list(TD.batched(tq, 4, drop_last=True))
    assert len(again) == len(tq) // 4
    assert not all(np.array_equal(a[0], g[0]) for a, g in zip(again, got))


def test_patch_queue_sync_and_threaded_agree(bank):
    tds, _ = _datasets(bank, "MriSegmentation", sample="all")
    out = [[p[0] for p in TD.PatchQueue(tds, max_length=4, patch_size=8,
                                        seed=1, num_workers=w)]
           for w in (0, 3)]
    assert len(out[0]) == len(out[1]) == 6 * len(tds)
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_patch_queue_surfaces_load_errors():
    class Broken:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            raise OSError("unreadable subject")

    for workers in (0, 1, 2):
        with pytest.raises(OSError, match="unreadable"):
            list(TD.PatchQueue(Broken(), num_workers=workers))


def test_fader_collate_matches_jax(bank):
    tds, _ = _datasets(bank, "MriClassification", sample="all",
                       data_type="img")
    items = [tds[i] for i in range(3)]
    lm = np.linspace(0, 100, 13)
    x, y, dom = TD.fader_collate(lm, device="cpu")(items)
    jx, jy, jdom = jax_fader_collate(lm)(items)
    assert x.device.type == "cpu" and x.shape == (3, 16, 16, 16, 1)
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() <= 1e-5 * np.abs(jx).max()
    _tree_equal((y, dom), (jy, jdom))


def test_fader_collate_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.fader_collate(np.linspace(0, 100, 13))


def test_prefetcher_passes_device_tensors_through(bank):
    """A batch whose volumes are already on the target device (as
    `fader_collate` returns them) goes through `DevicePrefetcher` as it
    is: the same tensor, not a copy; the numpy labels become tensors."""
    tds, _ = _datasets(bank, "MriClassification", sample="all",
                       data_type="img")
    loader = TD.DataLoader(tds, batch_size=2,
                           collate_fn=TD.fader_collate(np.linspace(
                               0, 100, 13), device="cpu"))
    batches = list(loader)
    pf = TD.DevicePrefetcher(iter(batches), device="cpu")
    for x, y, dom in batches:
        sx, sy, sdom = pf.get()
        assert sx is x
        assert torch.equal(sy, torch.from_numpy(y))
        assert torch.equal(sdom, torch.from_numpy(dom))
    assert pf.get() is None and pf.exhausted
    t = torch.ones(3)
    assert pf._upload(t) is t
