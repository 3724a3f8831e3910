"""Whole-brain FCD detection inference (counterpart of the JAX package's
`infer/detection.py`, after the reference's `detection/model_utils.py:
118-246` `FCDMaskGenerator`).

Every patch of the volume is cut on the host by the band walk that
training uses (`data/patches.iter_band_patches`) and classified in
batches of `batch_size` on the device: the argmax runs there, and one
array of labels per batch comes back.  The tail batch is padded with
zeros to `batch_size`, as in the JAX package.

Post-processing keeps the reference's numerics: a cross-kernel neighbour
vote over the patch map (isolated labels flip), then the voxel
back-projection of band and column windows into the final mask,
bug-compatible with the reference's rot90-inverse row band.

Where the JAX package takes `(apply_fn, variables)`, the port takes one
callable `model(x) -> logits` (a module in eval mode, or a function).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.patches import _band_geometry, iter_band_patches
from ..utils.nifti import NiftiImage, load_nifti, save_nifti


class FCDMaskGenerator:
    """`model(patches (B, h, w, 2) on the device) -> logits (B, 2)`;
    patches go to the card unless `device` names another."""

    def __init__(self, model: Callable, gmpm: np.ndarray, h: int = 16,
                 w: int = 32, batch_size: int = 512, device=None):
        self.model = model
        self.gmpm = np.asarray(gmpm)
        self.h = h
        self.w = w
        self.batch_size = batch_size
        self.device = resolve_device(device)

    # -- patch inference ----------------------------------------------------

    def _collect_patches(self, img):
        """All patches and their (kind, band, slice) destinations, from the
        band walk that training extraction uses."""
        patches, dests = [], []
        for i, band, kind, patch, _label in iter_band_patches(
                img, self.gmpm, None, self.h, self.w):
            patches.append(patch)
            dests.append((kind, band, i))
        return np.stack(patches).astype(np.float32), np.asarray(dests)

    def _predict(self, patches: np.ndarray) -> np.ndarray:
        """Labels of (N, 2, h, w) patches: channels-last batches of
        `batch_size` (the tail zero-padded) through the model on the
        device, the argmax there, one copy of labels back per batch."""
        x = np.ascontiguousarray(np.moveaxis(patches, 1, -1))
        n = len(x)
        pad = (-n) % self.batch_size
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        labels = []
        with torch.no_grad():
            for start in range(0, len(x), self.batch_size):
                xb = torch.from_numpy(x[start:start + self.batch_size]).to(
                    self.device)
                labels.append(torch.argmax(self.model(xb), dim=-1).cpu()
                              .numpy())
        return np.concatenate(labels)[:n]

    def _get_predictions_per_batches(self, img) -> np.ndarray:
        """(4, n_bands, n_slices) predicted patch labels."""
        patches, dests = self._collect_patches(img)
        pmt = np.zeros((4, self.gmpm.shape[1] // self.h, self.gmpm.shape[2]),
                       np.int64)
        pmt[dests[:, 0], dests[:, 1], dests[:, 2]] = self._predict(patches)
        return pmt

    # -- post-processing ----------------------------------------------------

    @staticmethod
    def _postprocess(patch_map_tensor: np.ndarray) -> np.ndarray:
        """Cross-kernel neighbour vote (reference `_postprocess`): a cell
        with all four in-plane neighbours set becomes 1; with none set, 0."""
        p = patch_map_tensor.astype(np.float64)
        res = np.zeros_like(p)
        res[:, 1:, :] += p[:, :-1, :]
        res[:, :-1, :] += p[:, 1:, :]
        res[:, :, 1:] += p[:, :, :-1]
        res[:, :, :-1] += p[:, :, 1:]
        res *= 0.25
        out = patch_map_tensor.copy()
        out[res == 1.0] = 1
        out[res == 0.0] = 0
        return out

    def _masking(self, img, patch_map_tensor) -> np.ndarray:
        """Back-project patch labels into a voxel mask (reference
        `_masking` index arithmetic, incl. the rot90-inverse row band
        `-j : -j-h : -1`)."""
        h, w = self.h, self.w
        final_mask = np.zeros_like(img)
        for i in range(self.gmpm.shape[2]):
            sg = np.rot90(self.gmpm[:, :, i])
            for j in range(0, self.gmpm.shape[1], h):
                geo = _band_geometry(sg, j, h, w)
                if geo is None:
                    continue
                start_idx, mid_idx = geo
                # the reference's slice `-j : -j-h : -1`, which is empty for
                # j == 0 (the top band is never back-projected): kept
                rows = slice(-j, -j - h, -1)
                if start_idx < mid_idx:
                    final_mask[start_idx:start_idx + w, rows, i] = \
                        patch_map_tensor[0, j // h, i]
                    final_mask[-start_idx - w:-start_idx, rows, i] = \
                        patch_map_tensor[3, j // h, i]
                final_mask[mid_idx:mid_idx + w, rows, i] = \
                    patch_map_tensor[1, j // h, i]
                final_mask[-mid_idx - w:-mid_idx, rows, i] = \
                    patch_map_tensor[2, j // h, i]
        return final_mask

    # -- public API ---------------------------------------------------------

    def get_mask(self, img) -> np.ndarray:
        pmt = self._get_predictions_per_batches(img)
        pmt = self._postprocess(pmt)
        return self._masking(img, pmt).astype(np.int64)

    @staticmethod
    def get_iou(pred_mask, true_mask) -> float:
        assert pred_mask.shape == true_mask.shape, "Wrong shape of masks"
        intersection = np.logical_and(pred_mask, true_mask)
        union = np.logical_or(pred_mask, true_mask)
        return intersection.sum() / union.sum()

    @staticmethod
    def save_nii_mask(mask, img: NiftiImage, name: str = "pred_mask.nii.gz"):
        save_nifti(name, np.asarray(mask), img.affine)

    def inference_pipeline(self, input_img_name: str,
                           input_mask_name: Optional[str] = None,
                           out_name: str = "pred_mask.nii.gz"):
        img = load_nifti(input_img_name)
        img_np = img.get_fdata()
        img_np = (img_np - img_np.min()) / (img_np.max() - img_np.min())
        pred_mask_np = self.get_mask(img_np)
        iou = None
        if input_mask_name is not None:
            true_mask_np = load_nifti(input_mask_name).get_fdata() > 0
            iou = self.get_iou(pred_mask_np, true_mask_np)
            print(f"Intersection over union = {iou:.5f}")
        self.save_nii_mask(pred_mask_np, img, out_name)
        return pred_mask_np, iou
