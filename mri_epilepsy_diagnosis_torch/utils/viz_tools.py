"""Visualization helpers (counterpart of the JAX package's
`utils/viz_tools.py`, after the reference's `utils/viz_tools.py`): central
triplanar cuts, the prediction overlay and the difference plot.

They accept numpy arrays, torch tensors (on the CPU or the card) and
`NiftiImage`, of shape (D, H, W), (C, D, H, W) or (N, C, D, H, W): the
leading dimensions are stripped as the reference does for torch tensors.
matplotlib is imported only when a figure is drawn, with the Agg backend.
"""
from __future__ import annotations

import numpy as np
import torch

from .nifti import NiftiImage


def _as_volume(img) -> np.ndarray:
    if isinstance(img, NiftiImage):
        img = img.get_fdata()
    if isinstance(img, torch.Tensor):
        img = img.detach().float().cpu().numpy()
    img = np.asarray(img)
    while img.ndim > 3:
        img = img[0]
    return img


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_central_cuts(img, title: str = "", save_path=None):
    img = _as_volume(img)
    plt = _plt()
    fig, axes = plt.subplots(nrows=1, ncols=3, figsize=(3 * 4, 4))
    axes[0].imshow(img[img.shape[0] // 2, :, :])
    axes[1].imshow(img[:, img.shape[1] // 2, :])
    axes[2].imshow(img[:, :, img.shape[2] // 2])
    if title:
        fig.suptitle(title)
    if save_path:
        fig.savefig(save_path)
    plt.close(fig)
    return fig


def _overlay(img, seg, delta, combine, save_path):
    """The three panels of `plot_predicted` / `plot_difference`: the image
    slice, the mask slice, and `combine(image slice, mask slice)`."""
    img, seg = _as_volume(img), _as_volume(seg).astype(np.uint8)
    plt = _plt()
    fig, axes = plt.subplots(nrows=1, ncols=3, figsize=(3 * 4, 4))
    im = img[img.shape[0] // 2 + delta, :, :]
    sg = seg[seg.shape[0] // 2 + delta, :, :]
    axes[0].imshow(im)
    axes[1].imshow(sg)
    axes[2].imshow(combine(im, sg), cmap="gray")
    if save_path:
        fig.savefig(save_path)
    plt.close(fig)
    return fig


def plot_predicted(img, seg, delta: int = 0, title: str = "",
                   save_path=None):
    return _overlay(img, seg, delta, lambda im, sg: im + sg * 100,
                    save_path)


def plot_difference(img, seg, delta: int = 0, title: str = "",
                    save_path=None):
    return _overlay(img, seg, delta, lambda im, sg: (im - sg) * 100,
                    save_path)
