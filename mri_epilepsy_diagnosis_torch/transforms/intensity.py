"""Intensity transforms (counterpart of the JAX package's
`transforms/intensity.py`; this slice ports `znormalization`)."""
from __future__ import annotations

from typing import Optional

import torch


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
