"""End-to-end preprocessing pipelines (counterpart of the JAX package's
`transforms/preprocessing.py`).

`register_img` and `register_img_and_mask` stand in for the reference's
FSL pipeline (`detection/preprocessing_utils.py`: FLIRT affine
registration to the MNI152 template, `.mat` reuse to carry the lesion
mask along, FAST bias-field correction) on the device.

`preprocess_volume` is the intensity graph run before training and
inference: optional histogram standardization -> z-normalization ->
crop-or-pad, the Compose([...]) of `pretraining_3d_unet.ipynb` cell 9.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import as_device_tensor
from ..utils.nifti import NiftiImage
from .intensity import histogram_standardization, znormalization
from .registration import (apply_transform, bias_field_correction,
                           register_affine)
from .spatial import crop_or_pad, world_affine_to_voxel


def register_img(img: NiftiImage, template: NiftiImage, *,
                 dof: int = 12, bias_correct: bool = True,
                 levels=(4, 2, 1), iters=(200, 100, 50), device=None):
    """FLIRT + FAST for control volumes (`detection/preprocessing_utils.py:
    56-73`): the subject is first resampled onto the template's grid
    through the NIfTI world affines, then registered by NCC descent.

    Returns (registered volume on the template grid, bias-corrected
    volume, both tensors on the card unless `device` names another; the
    float64 voxel-space affine, template voxel -> subject voxel, for
    reuse)."""
    init_vox = world_affine_to_voxel(img.affine, template.affine)
    moving = apply_transform(np.asarray(img.data, np.float32), init_vox,
                             template.shape, device=device)
    affine, warped = register_affine(
        moving, np.asarray(template.data, np.float32), dof=dof,
        levels=levels, iters=iters)
    corrected = warped
    if bias_correct:
        corrected, _ = bias_field_correction(warped)
    total_affine = np.asarray(init_vox) @ np.asarray(affine)
    return warped, corrected, total_affine


def register_img_and_mask(img: NiftiImage, template: NiftiImage,
                          mask: Optional[NiftiImage] = None, **kwargs):
    """FLIRT + mask transform + FAST for patient volumes
    (`detection/preprocessing_utils.py:11-53`): register the image, then
    apply the same transform to the lesion mask (FLIRT's `.mat` reuse).
    Returns (warped, corrected, warped mask as a float32 0/1 numpy array or
    None, affine); keyword arguments go to `register_img`."""
    warped, corrected, affine = register_img(img, template, **kwargs)
    warped_mask = None
    if mask is not None:
        moved = apply_transform(np.asarray(mask.data, np.float32), affine,
                                template.shape, device=warped.device)
        warped_mask = (moved > 0.5).float().cpu().numpy()
    return warped, corrected, warped_mask, affine


def preprocess_volume(vol, landmarks=None,
                      target_shape: Optional[Tuple[int, ...]] = None,
                      masking_method: Optional[str] = None, *,
                      device=None) -> torch.Tensor:
    """[hist-std] -> znorm -> [crop-or-pad] of one volume, in float32.
    A tensor is processed on its own device; a numpy array on the card,
    unless `device` names another."""
    x = as_device_tensor(vol, device).float()
    if landmarks is not None:
        x = histogram_standardization(x, landmarks)
    x = znormalization(x, masking_method=masking_method)
    if target_shape is not None:
        x = crop_or_pad(x, target_shape)
    return x
