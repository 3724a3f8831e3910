"""Intensity transforms (counterpart of the JAX package's
`transforms/intensity.py`), on tensors of any shape, on their device.

- `znormalization`: torchio ZNormalization, with the masking_method='mean'
  variant of the segmentation notebooks.
- `histogram_standardization`: the Nyul-Udupa landmark method, numerics of
  the vendored numpy copy in `train_ENC_CLF.ipynb` cell 9 (cutoff
  standardization, 13-landmark percentile grid, range_to_use sub-grid,
  per-bin linear maps with an inf guard on degenerate bins).
- `rescale_intensity`, `minmax_norm`: torchio RescaleIntensity and the
  detection pipeline's (x - min) / (max - min).

Percentiles are taken as `np.percentile`'s "linear" method (which
`jnp.percentile` matches) computes them: one sort and the interpolation
by hand.  `torch.quantile` refuses inputs above 2^24 elements, fewer
than a 256^3 volume plus one voxel.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_CUTOFF = (0.01, 0.99)
STANDARD_RANGE = (0, 100)
# percentile grid: cutoffs + quartiles + deciles, sorted unique (13 values)
_RANGE_TO_USE = [0, 1, 2, 4, 5, 6, 7, 8, 10, 11, 12]


def _percentile_grid(cutoff=DEFAULT_CUTOFF) -> np.ndarray:
    c0 = min(max(cutoff[0], 0.0), 0.09)
    c1 = max(min(cutoff[1], 1.0), 0.91)
    pcts = sorted(set([100 * c0, 100 * c1] + [25, 50, 75]
                      + list(range(10, 100, 10))))
    return np.array(pcts, np.float64)


def _percentiles(x: torch.Tensor, pcts: Sequence[float]) -> torch.Tensor:
    """Percentiles `pcts` (0-100) of every element of `x`, float32, with
    linear interpolation between the neighbouring order statistics: the
    positions are taken in float64 on the host, the values as
    low * (1 - t) + high * t, as `jnp.percentile` computes them."""
    s = torch.sort(x.reshape(-1).float()).values
    n = s.numel()
    pos = np.asarray(pcts, np.float64) / 100.0 * (n - 1)
    lo = np.clip(np.floor(pos), 0, n - 1).astype(np.int64)
    hi = np.clip(np.ceil(pos), 0, n - 1).astype(np.int64)
    t = torch.as_tensor((pos - np.floor(pos)).astype(np.float32),
                        device=s.device)
    lo, hi = (torch.as_tensor(i, device=s.device) for i in (lo, hi))
    return s[lo] * (1 - t) + s[hi] * t


def znormalization(x: torch.Tensor, masking_method: Optional[str] = None,
                   eps: float = 1e-9) -> torch.Tensor:
    """torchio ZNormalization of one volume: (x - mean[mask]) / std[mask],
    statistics over every element of `x`, in float32, on x's device.

    masking_method=None   -> whole-volume statistics
    masking_method='mean' -> mask = x > mean(x)  (ZNormalization.mean)
    """
    xf = x.float()
    if masking_method == "mean":
        mask = xf > xf.mean()
        n = mask.sum().clamp_min(1)
        mean = torch.where(mask, xf, 0.0).sum() / n
        var = torch.where(mask, (xf - mean).square(), 0.0).sum() / n
    else:
        mean = xf.mean()
        var = xf.var(unbiased=False)
    return (xf - mean) / torch.sqrt(var + eps)


def rescale_intensity(x: torch.Tensor,
                      out_min_max: Tuple[float, float] = (0.0, 1.0),
                      percentiles: Tuple[float, float] = (0.0, 100.0)
                      ) -> torch.Tensor:
    """torchio RescaleIntensity: clamp to the percentile window, then scale
    it linearly onto `out_min_max`."""
    xf = x.float()
    lo, hi = _percentiles(xf, percentiles)
    xf = torch.minimum(torch.maximum(xf, lo), hi)
    scale = (out_min_max[1] - out_min_max[0]) / torch.clamp_min(hi - lo, 1e-9)
    return (xf - lo) * scale + out_min_max[0]


def minmax_norm(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    lo, hi = xf.min(), xf.max()
    return (xf - lo) / torch.clamp_min(hi - lo, 1e-20)


def histogram_standardization(x: torch.Tensor, landmarks, cutoff=None,
                              epsilon: float = 1e-5) -> torch.Tensor:
    """Nyul histogram standardization of one volume with trained
    `landmarks` (13,), in float32 on x's device; any number of voxels."""
    data = x.reshape(-1).float()
    mapping = torch.as_tensor(landmarks, dtype=torch.float32).to(x.device)
    perc = _percentiles(data, _percentile_grid(
        DEFAULT_CUTOFF if cutoff is None else cutoff))
    range_mapping = mapping[_RANGE_TO_USE]
    range_perc = perc[_RANGE_TO_USE]
    diff_perc = torch.diff(range_perc)
    diff_perc = torch.where(diff_perc < epsilon, torch.inf, diff_perc)
    slopes = torch.diff(range_mapping) / diff_perc
    intercepts = range_mapping[:-1] - slopes * range_perc[:-1]
    # np.digitize(data, bins, right=False) == searchsorted(bins, data,
    # side="right")
    bin_id = torch.searchsorted(range_perc[1:-1].contiguous(), data,
                                right=True)
    return (slopes[bin_id] * data + intercepts[bin_id]).reshape(x.shape)


def train_histogram_landmarks(volumes, cutoff=DEFAULT_CUTOFF,
                              masks=None) -> np.ndarray:
    """Train Nyul landmarks over a set of volumes (host-side, numpy): the
    averaged-percentile mapping that produced the reference's shipped
    `fcd_train_data_landmarks.npy` (shape (13,))."""
    pcts = _percentile_grid(cutoff)
    db = []
    for i, vol in enumerate(volumes):
        v = np.asarray(vol, np.float32).reshape(-1)
        if masks is not None:
            v = v[np.asarray(masks[i]).reshape(-1)]
        db.append(np.percentile(v, pcts))
    db = np.stack(db)  # (num_images, 13)
    pc1, pc2 = db[:, 0], db[:, -1]
    s1, s2 = STANDARD_RANGE
    slopes = np.nan_to_num((s2 - s1) / (pc2 - pc1))
    intercepts = np.mean(s1 - slopes * pc1)
    return slopes.dot(db) / len(db) + intercepts
