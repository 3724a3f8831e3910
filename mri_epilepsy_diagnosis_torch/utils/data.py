"""Dataset manifest assembly and MRI dataset classes (counterpart of the
JAX package's `utils/data.py`), host-side numpy.

- `reshape_image` / `load_nii_to_array`         (`utils/data.py:16-41`)
- `targets_complete` manifest join              (`utils/data.py:44-118`):
  filter the targets CSV by cohort (pirogov/kulakov/hcp/la5_study/
  soloviev or 'all'), glob `*norm*` T1 and `*aseg*` FreeSurfer
  parcellations, an optional lesion-mask dir, drop incomplete subjects,
  encode the scanner ids.
- `MriSegmentation` (mask modes 'seg'/'bb'/'combined') and
  `MriClassification` (data_type 'img'/'seg'), items as numpy float32
  channel-first `(1, D, H, W)` arrays, the reference's layout.
- `SyntheticVolumes`, the reference's synthetic smoke fixture
  (`train_AE.ipynb` cell 3: `np.ones((6,1,192,192,192))`).

Without pandas and sklearn: the CSV is read with the `csv` module, each
column typed as pandas infers it (int, then float with NaN for empty
cells, else str with None for empty cells), and the manifest is a dict
of numpy columns in place of a DataFrame.  The scanner ids are encoded
with `np.unique(..., return_inverse=True)`, the classes and codes of
sklearn's `LabelEncoder`.
"""
from __future__ import annotations

import csv
import glob
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..transforms.labels import LIST_FCD
from .nifti import load_nifti

_BANK = "/gpfs/gpfs0/sbi/data/fcd_classification_bank"


def reshape_image(img: np.ndarray, coord_min, img_shape) -> np.ndarray:
    """Fixed-offset crop to `img_shape`, then add a leading channel dim."""
    img = img[coord_min[0]:coord_min[0] + img_shape[0],
              coord_min[1]:coord_min[1] + img_shape[1],
              coord_min[2]:coord_min[2] + img_shape[2]]
    if tuple(img.shape[:3]) != tuple(img_shape):
        raise AssertionError(f"Current image shape {img.shape[:3]} != "
                             f"desired {tuple(img_shape)}")
    return img.reshape((1,) + tuple(img_shape))


def load_nii_to_array(nii_path: str):
    """Reference-compatible loader: returns '' on missing/inaccessible file."""
    try:
        return np.asanyarray(load_nifti(nii_path).data)
    except OSError:
        print(FileNotFoundError(f"No such file or no access: '{nii_path}'"))
        return ""


def _typed_column(values):
    """A CSV column as pandas' `read_csv` types it: int64 when every cell
    is an integer, float64 (NaN for empty cells) when every filled cell
    is a number, else an object array of str (None for empty cells)."""
    for kind in (int, float):
        try:
            if kind is int:
                return np.array([int(v) for v in values], np.int64)
            return np.array([float(v) if v != "" else np.nan
                             for v in values], np.float64)
        except ValueError:
            pass
    return np.array([v if v != "" else None for v in values], object)


def _read_targets(path: str) -> Dict[str, np.ndarray]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: _typed_column([r[i] for r in body])
            for i, name in enumerate(header)}


def targets_complete(sample: str,
                     prefix=False,
                     mask_path=False,
                     image_path: str = _BANK,
                     targets_path: str = "../targets/targets_fcd_bank.csv",
                     ignore_missing: bool = True,
                     data_type=False
                     ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Join the targets CSV with files on disk; returns (manifest, scanner
    classes).  The manifest maps each column ("patient", "scan", "fcd",
    "img_file", "img_seg", "detection", "comments", and "img_mask" with a
    mask dir) to a numpy array, one entry per kept subject, file columns
    None where no file matched; "scan" holds the codes of the classes.

    Matching rules of the reference: cohort 'pirogov' matches by exact
    file name (`<patient>_norm.nii.gz`, `<patient>_aparc+aseg.nii[.gz]`);
    other cohorts match by patient-id substring of the path, the last
    match winning.  Masks match `<patient>.nii.gz` under `mask_path`.
    """
    targets = _read_targets(targets_path)
    n = len(targets["patient"])
    if sample == "all" and not mask_path:
        clause = np.ones(n, bool)
    else:
        clause = targets["sample"] == sample
        if prefix:
            clause &= np.array([str(p).startswith(prefix)
                                for p in targets["patient"]], bool)
    files = {col: targets[col][clause]
             for col in ["patient", "fcd", "scan", "detection", "comments"]}
    m = int(clause.sum())
    file_cols = ["img_file", "img_seg"] + (["img_mask"] if mask_path else [])
    for col in file_cols:
        files[col] = np.full(m, None, object)

    norm_files = sorted(glob.glob(os.path.join(image_path, "*norm*")))
    aseg_files = sorted(glob.glob(os.path.join(image_path, "*aseg*")))
    mask_files = (sorted(glob.glob(os.path.join(mask_path, "*.nii*")))
                  if mask_path else [])

    for i, patient in enumerate(files["patient"]):
        for f in norm_files:
            base = os.path.basename(f)
            if sample == "pirogov":
                if base == f"{patient}_norm.nii.gz":
                    files["img_file"][i] = f
            elif patient in f:
                files["img_file"][i] = f
        for f in aseg_files:
            base = os.path.basename(f)
            if sample == "pirogov":
                if base in (f"{patient}_aparc+aseg.nii.gz",
                            f"{patient}_aparc+aseg.nii"):
                    files["img_seg"][i] = f
            elif patient in f:
                files["img_seg"][i] = f
        for f in mask_files:
            if os.path.basename(f) == f"{patient}.nii.gz":
                files["img_mask"][i] = f

    if ignore_missing:
        if data_type == "img":
            need = ["img_file"]
        elif data_type == "seg":
            need = ["img_seg"]
        else:
            need = ["img_seg", "img_file"]
        keep = np.all([files[c] != None for c in need], axis=0)  # noqa: E711
        files = {k: v[keep] for k, v in files.items()}

    classes, files["scan"] = np.unique(files["scan"], return_inverse=True)
    return files, classes


class _MriDatasetBase:
    def __init__(self, sample, prefix, mask_path, image_path, targets_path,
                 ignore_missing, coord_min, img_shape, data_type=False):
        print("Assembling data for: ", sample, " sample.")
        files, classes = targets_complete(sample, prefix, mask_path,
                                          image_path, targets_path,
                                          ignore_missing, data_type)
        self.img_files = files["img_file"]
        self.img_seg = files["img_seg"]
        self.scan = files["scan"]
        self.scan_keys = classes
        self.target = files["fcd"]
        self.detection = files["detection"]
        self.misc = files["comments"]
        if mask_path:
            self.img_mask = files["img_mask"]
        self.coord_min = tuple(coord_min)
        self.img_shape = tuple(img_shape)
        self.mask_path = mask_path

    def __len__(self):
        return len(self.img_files)


class MriSegmentation(_MriDatasetBase):
    """(image, mask) pairs.  mask in {'seg','bb','combined'}:
    'seg'      - binarized cortical structures from aseg+aparc (labels > 1000)
    'bb'       - lesion bounding-box masks from `mask_path`
    'combined' - logical AND of both.
    """

    def __init__(self, sample, prefix=False, mask_path=False,
                 image_path=_BANK,
                 targets_path="../targets/targets_fcd_bank.csv",
                 ignore_missing=True, coord_min=(30, 30, 30),
                 img_shape=(192, 192, 192), mask="seg"):
        if mask not in ["seg", "bb", "combined"]:
            raise AssertionError("Invalid mask name!")
        super().__init__(sample, prefix, mask_path, image_path, targets_path,
                         ignore_missing, coord_min, img_shape)
        self.mask = mask

    @staticmethod
    def binarize_cortex(seg: np.ndarray) -> np.ndarray:
        """Reference binarization (`utils/data.py:173-176`): <1000 -> 0,
        >1000 -> 1 (exactly 1000, 'ctx-lh-unknown', is left untouched,
        as in the reference)."""
        seg = seg.copy()
        seg[seg < 1000] = 0
        seg[seg > 1000] = 1
        return seg

    def __getitem__(self, index):
        img = reshape_image(load_nii_to_array(self.img_files[index]),
                            self.coord_min, self.img_shape).astype(np.float32)
        seg = reshape_image(load_nii_to_array(self.img_seg[index]),
                            self.coord_min, self.img_shape).astype(np.float32)
        if self.mask == "seg":
            return img, self.binarize_cortex(seg)
        mask = reshape_image(load_nii_to_array(self.img_mask[index]),
                             self.coord_min, self.img_shape).astype(np.float32)
        if self.mask == "bb":
            return img, mask
        comb = np.logical_and(mask, self.binarize_cortex(seg))
        return img, comb.astype(np.float32)


class MriClassification(_MriDatasetBase):
    """(volume, fcd-label, scanner-id) triples; data_type 'img' or 'seg'."""

    def __init__(self, sample, prefix=False, mask_path=False,
                 image_path=_BANK,
                 targets_path="../targets/targets_fcd_bank.csv",
                 ignore_missing=True, coord_min=(30, 30, 30),
                 img_shape=(192, 192, 192), data_type="seg"):
        if data_type not in ["seg", "img"]:
            raise AssertionError("Invalid file format!")
        super().__init__(sample, prefix, mask_path, image_path, targets_path,
                         ignore_missing, coord_min, img_shape, data_type)
        self.data_type = data_type

    def __getitem__(self, index):
        if self.data_type == "img":
            arr = load_nii_to_array(self.img_files[index])
        else:
            arr = load_nii_to_array(self.img_seg[index])
        vol = reshape_image(arr, self.coord_min, self.img_shape)
        vol = vol.astype(np.float32)
        return vol, int(self.target[index]), int(self.scan[index])


class SyntheticVolumes:
    """In-memory synthetic dataset (the reference's `np.ones((N,1,192^3))`
    smoke fixture, `train_AE.ipynb` cell 3) with optional labels/domains;
    the same arrays as the JAX package's for the same seed."""

    def __init__(self, n: int = 6, img_shape=(192, 192, 192),
                 targets: Optional[Sequence[int]] = None,
                 domains: Optional[Sequence[int]] = None,
                 kind: str = "ones", seed: int = 0):
        self.img_shape = tuple(img_shape)
        rng = np.random.default_rng(seed)
        if kind == "ones":
            self.volumes = np.ones((n, 1) + self.img_shape, np.float32)
        elif kind == "noise":
            self.volumes = rng.normal(
                size=(n, 1) + self.img_shape).astype(np.float32)
        elif kind == "blobs":
            vols = []
            for _ in range(n):
                g = np.mgrid[tuple(slice(0, s) for s in self.img_shape)]
                c = [rng.uniform(0.3, 0.7) * s for s in self.img_shape]
                r = [rng.uniform(0.2, 0.4) * s for s in self.img_shape]
                r2 = sum(((g[i] - c[i]) / r[i]) ** 2 for i in range(3))
                vols.append((r2 < 1.0).astype(np.float32)[None] * 100.0)
            self.volumes = np.stack(vols)
        else:
            raise ValueError(kind)
        self.target = np.asarray(
            targets if targets is not None else rng.integers(0, 2, n))
        self.scan = np.asarray(
            domains if domains is not None else rng.integers(0, 3, n))
        self.scan_keys = np.unique(self.scan)

    def __len__(self):
        return len(self.volumes)

    def __getitem__(self, index):
        return (self.volumes[index], int(self.target[index]),
                int(self.scan[index]))

    def as_segmentation(self, threshold: float = 50.0):
        """(img, mask) view: mask = volume > threshold."""
        return _SyntheticSeg(self, threshold)


class _SyntheticSeg:
    def __init__(self, base: SyntheticVolumes, threshold: float):
        self.base = base
        self.threshold = threshold
        self.target = base.target
        self.scan = base.scan

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index):
        img = self.base.volumes[index]
        return img, (img > self.threshold).astype(np.float32)
