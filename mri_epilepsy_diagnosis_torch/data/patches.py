"""2-D detection patch extraction (counterpart of the JAX package's
`data/patches.py`, after the reference's `detection/patch_utils.py`):
symmetric left/right-hemisphere patch pairs (2 x h x w, default 2 x 16 x
32) cut from rotated axial slices, guided by the MNI152 gray-matter
probability template (`gmpm`); labels are lesion-mask overlap; positives
are oversampled by re-striding the band offset k = 1 .. h-1.  The
template is an explicit argument, as in the JAX package (the reference
reads a module global).

Host numpy, a faithful copy of the JAX package's band walk; NIfTI files
are read through the port's `utils/nifti.py`.  The patches feed the model
in large batches on the card (`infer/detection.py`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils.nifti import load_nifti


def _band_geometry(slice_gmpm: np.ndarray, j: int, h: int, w: int):
    """For one horizontal band of a rotated slice, the side/middle column
    starts used by all patch kinds, or None if the band has no gray matter."""
    sub = slice_gmpm[j:j + h, :]
    if sub.sum() == 0.0:
        return None
    rodon = sub.sum(0) > 0
    start_idx = int(rodon.argmax())
    mid_idx = slice_gmpm.shape[1] // 2 - w
    assert start_idx != 0
    return start_idx, mid_idx


def _mirrored_pair(sub: np.ndarray, col: int, w: int, side: str):
    """A (2, h, w) patch: one hemisphere window + the mirrored window from
    the opposite hemisphere (reference patch_1..patch_4 constructions)."""
    if side == "left":
        return np.stack([sub[:, col:col + w],
                         sub[:, -col - 1:-col - w - 1:-1]])
    # right: window taken from the right edge, mirror from the left
    return np.stack([sub[:, -col - w:-col or None],
                     sub[:, col + w - 1:col - 1 if col >= 1 else None:-1]])


def iter_band_patches(target_np, gmpm, mask_np=None, h: int = 16, w: int = 32,
                      offset: int = 0):
    """Yield (slice_idx, band_idx, kind, patch, label) for every patch in the
    volume.  kind 0/3 = side pair, 1/2 = middle pair (the reference's
    patch_map_tensor channel assignment)."""
    for i in range(gmpm.shape[2]):
        sg = np.rot90(gmpm[:, :, i])
        st = np.rot90(target_np[:, :, i])
        sm = np.rot90(mask_np[:, :, i]) if mask_np is not None else None
        top = sg.shape[0] - h if offset else sg.shape[0]
        for j in range(0, top, h):
            geo = _band_geometry(sg, offset + j, h, w)
            if geo is None:
                continue
            start_idx, mid_idx = geo
            sub = st[offset + j:offset + j + h, :]
            subm = (sm[offset + j:offset + j + h, :]
                    if sm is not None else None)

            def lab(col, side):
                if subm is None:
                    return False
                if side == "left":
                    return bool(subm[:, col:col + w].sum() > 0)
                return bool(subm[:, -col - w:-col or None].sum() > 0)

            if start_idx < mid_idx:
                yield (i, j // h, 0, _mirrored_pair(sub, start_idx, w, "left"),
                       lab(start_idx, "left"))
                yield (i, j // h, 3, _mirrored_pair(sub, start_idx, w, "right"),
                       lab(start_idx, "right"))
            yield (i, j // h, 1, _mirrored_pair(sub, mid_idx, w, "left"),
                   lab(mid_idx, "left"))
            yield (i, j // h, 2, _mirrored_pair(sub, mid_idx, w, "right"),
                   lab(mid_idx, "right"))


def get_all_patches_and_labels(target_np, gmpm, mask_np, h: int = 16,
                               w: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """All base patches + labels, plus positive-only oversampling at band
    offsets k=1..h-1 (reference `get_all_patches_and_labels`)."""
    patches, labels = [], []
    for *_ignore, patch, label in iter_band_patches(target_np, gmpm, mask_np,
                                                    h, w):
        patches.append(patch)
        labels.append(label)
    for k in range(1, h):
        for *_ignore, patch, label in iter_band_patches(
                target_np, gmpm, mask_np, h, w, offset=k):
            if label:
                patches.append(patch)
                labels.append(True)
    return np.stack(patches), np.array(labels)


def get_only_patches(target_np, gmpm, h: int = 16, w: int = 32) -> np.ndarray:
    return np.stack([p for *_ignore, p, _l in
                     iter_band_patches(target_np, gmpm, None, h, w)])


def get_image_patches(input_img_name: str, gmpm,
                      input_mask_name: Optional[str] = None,
                      h: int = 16, w: int = 32):
    """Load a volume, min-max normalize, extract patches (+labels if a lesion
    mask is given) — reference `get_image_patches`, with `gmpm` explicit."""
    target_np = load_nifti(input_img_name).get_fdata()
    target_np = ((target_np - target_np.min())
                 / (target_np.max() - target_np.min()))
    if input_mask_name is not None:
        mask_np = load_nifti(input_mask_name).get_fdata() > 0
        return get_all_patches_and_labels(target_np, gmpm, mask_np, h, w)
    patches = get_only_patches(target_np, gmpm, h, w)
    return patches, np.zeros(patches.shape[0], dtype=bool)
