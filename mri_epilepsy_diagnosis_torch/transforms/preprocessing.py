"""The intensity graph run before training and inference (counterpart of
the JAX package's `transforms/preprocessing.py::preprocess_volume`):
optional histogram standardization -> z-normalization -> crop-or-pad, the
Compose([...]) of `pretraining_3d_unet.ipynb` cell 9.  The registration
pipelines (`register_img`, `register_img_and_mask`) are not ported yet
(ROADMAP A item 10)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.device import as_device_tensor
from .intensity import histogram_standardization, znormalization
from .spatial import crop_or_pad


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
