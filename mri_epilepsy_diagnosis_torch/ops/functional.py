"""Channels-last functional ops the fine UNet3D needs (counterpart of the
JAX package's `ops/functional.py`: `prelu`, eval `batch_norm`,
`maxpool3d`, `resize_linear`).  Every function takes and returns
`(N, D, H, W, C)` tensors."""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


def prelu(x: torch.Tensor, a) -> torch.Tensor:
    """PReLU with torch's shared-parameter semantics (`num_parameters=1`)
    or one slope per channel (last axis)."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, x, x * a)


def batch_norm(x, mean, var, gamma, beta, eps: float = 1e-5):
    """Eval-mode BatchNorm of channels-last `x` with the given statistics;
    the reciprocal square root is taken in float32, as in JAX."""
    inv = torch.rsqrt(var.float() + eps).to(x.dtype)
    return ((x - mean.to(x.dtype)) * inv * gamma.to(x.dtype)
            + beta.to(x.dtype))


def maxpool3d(x: torch.Tensor, kernel: int = 2) -> torch.Tensor:
    """Non-overlapping `kernel`^3 max pool (torch `nn.MaxPool3d(kernel)`
    on spatial dims divisible by `kernel`)."""
    n, d, h, w, c = x.shape
    k = kernel
    if d % k or h % k or w % k:
        raise ValueError(f"spatial dims {(d, h, w)} not divisible by {k}")
    xr = x.reshape(n, d // k, k, h // k, k, w // k, k, c)
    return xr.amax(dim=(2, 4, 6))


@functools.lru_cache(maxsize=None)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool):
    """(out, in) 1-D linear interpolation matrix, PyTorch conventions."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1 and (align_corners or in_size == 1):
        m[0, 0] = 1.0
        return m
    o = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = o * (in_size - 1) / max(out_size - 1, 1)
    else:
        src = (o + 0.5) * in_size / out_size - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    t = src - i0
    m[np.arange(out_size), i0] += (1.0 - t)
    m[np.arange(out_size), i1] += t
    return m


def _apply_axis_matrix(x: torch.Tensor, m: np.ndarray, axis: int):
    """Contract spatial axis `axis` of x with the (out, in) matrix m."""
    mt = torch.as_tensor(m, dtype=x.dtype, device=x.device)
    y = torch.matmul(x.movedim(axis, -1), mt.t())
    return y.movedim(-1, axis)


def resize_linear(x: torch.Tensor, out_spatial: Sequence[int], *,
                  align_corners: bool = False) -> torch.Tensor:
    """Separable tri-linear resize of channels-last `x`, PyTorch
    `nn.Upsample(mode='trilinear')` semantics."""
    for ax, out_sz in zip(range(1, x.ndim - 1), out_spatial):
        in_sz = x.shape[ax]
        if in_sz != int(out_sz):
            x = _apply_axis_matrix(
                x, _linear_matrix(in_sz, int(out_sz), bool(align_corners)),
                ax)
    return x
