"""Volumetric overlap metrics (counterpart of the JAX package's
`metrics/dice.py`).

`get_dice_score`/`get_dice_loss` are the reference's soft dice
(`segmentation/routine.py:239-253`: tp/fp/fn over spatial dims, eps=1e-9 in
the denominator) on tensors, differentiable; `get_iou_score` and
`compute_dice_coefficient` are the host-side numpy evaluation metrics
(`segmentation/routine.py:198-203`, `segmentation/metrics.py:312-329`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel import sharding as _S


def get_dice_score(output: torch.Tensor, target: torch.Tensor,
                   spatial_dimensions=(2, 3, 4),
                   epsilon: float = 1e-9) -> torch.Tensor:
    """Soft dice per (batch, channel).

    `output`/`target`: probabilities and binary targets with the channel
    axis anywhere outside `spatial_dimensions` (the reference's NCDHW calls
    use the default (2,3,4); channels-last callers pass (1,2,3)).  Under a
    spatial mesh a channels-last 5-D volume's sums are all-reduced over
    the spatial axis."""
    p0, g0 = output, target
    p1, g1 = 1 - p0, 1 - g0
    dims = tuple(spatial_dimensions)
    tp = (p0 * g0).sum(dim=dims)
    fp = (p0 * g1).sum(dim=dims)
    fn = (p1 * g0).sum(dim=dims)
    if output.ndim == 5 and 1 in dims and _S.spatial_mesh() is not None:
        # the volume's D is split over the spatial axis: whole-volume sums
        tp, fp, fn = (_S.all_reduce(t, ("spatial",)) for t in (tp, fp, fn))
    return 2 * tp / (2 * tp + fp + fn + epsilon)


def get_dice_loss(output: torch.Tensor, target: torch.Tensor,
                  spatial_dimensions=(2, 3, 4)) -> torch.Tensor:
    return 1 - get_dice_score(output, target, spatial_dimensions)


def get_iou_score(prediction, ground_truth) -> float:
    prediction = np.asarray(prediction)
    ground_truth = np.asarray(ground_truth)
    intersection = np.logical_and(prediction > 0, ground_truth > 0).sum()
    union = np.logical_or(prediction > 0, ground_truth > 0).sum()
    return float(intersection) / union


def compute_dice_coefficient(mask_gt, mask_pred) -> float:
    """Volumetric Dice; NaN when both masks are empty."""
    mask_gt = np.asarray(mask_gt).astype(bool)
    mask_pred = np.asarray(mask_pred).astype(bool)
    volume_sum = mask_gt.sum() + mask_pred.sum()
    if volume_sum == 0:
        return float("nan")
    return 2.0 * np.logical_and(mask_gt, mask_pred).sum() / volume_sum
