"""Channels-last functional ops of the fine UNet3D and the fader family
(counterpart of the JAX package's `ops/functional.py`: `prelu`, eval
`batch_norm`, `maxpool3d`, `resize_linear`, `resize_nearest`, and the
fader's `relu`/`l_relu` activations).  Every function takes and returns
`(N, D, H, W, C)` tensors."""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as TF


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


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """torch `nn.LeakyReLU()` (slope 0.01), the fader's `l_relu`."""
    return torch.where(x >= 0, x, slope * x)


def activation(name: str):
    """The fader family's `act` kwarg: "l_relu" or "relu"."""
    return leaky_relu if name == "l_relu" else relu


def maxpool3d(x: torch.Tensor, kernel: int = 2,
              stride: Optional[int] = None) -> torch.Tensor:
    """`kernel`^3 max pool with torch `nn.MaxPool3d(kernel, stride)`
    semantics (no padding, floor mode: a ragged edge is dropped).  The
    non-overlapping case (stride == kernel) is a reshape and a max."""
    k = kernel
    s = k if stride is None else stride
    if s != k:
        y = TF.max_pool3d(x.permute(0, 4, 1, 2, 3), k, s)
        return y.permute(0, 2, 3, 4, 1)
    n, d, h, w, c = x.shape
    x = x[:, :d - d % k, :h - h % k, :w - w % k]
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


@functools.lru_cache(maxsize=None)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output position, torch `mode='nearest'`
    (floor of dst * in/out, the scale taken in float32 as torch does)."""
    scale = np.float32(in_size / out_size)
    src = np.floor(np.arange(out_size, dtype=np.float32) * scale)
    return np.clip(src.astype(np.int64), 0, in_size - 1)


def resize_nearest(x: torch.Tensor,
                   out_spatial: Sequence[int]) -> torch.Tensor:
    """Nearest resize of channels-last `x`, torch `F.interpolate(mode=
    'nearest')` semantics, as one gather per resized axis."""
    for ax, out_sz in zip(range(1, x.ndim - 1), out_spatial):
        in_sz = x.shape[ax]
        if in_sz != int(out_sz):
            idx = torch.as_tensor(_nearest_index(in_sz, int(out_sz)),
                                  device=x.device)
            x = torch.index_select(x, ax, idx)
    return x
