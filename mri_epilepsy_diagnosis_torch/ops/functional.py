"""Channels-last functional ops of the fine UNet3D and the fader family
(counterpart of the JAX package's `ops/functional.py`: `prelu`,
`batch_norm` with the train-mode statistics of `ops/layers.py::BatchNorm`,
`maxpool3d`, `resize_linear`, `resize_nearest`, `module_batch_norm` and
`dropout` (with `generator_on`) for the train-mode layers, the fader's
`relu`/`l_relu` activations, and the shape utilities `pad_to` and
`crop_or_pad`).  Every function takes and returns `(N, D, H, W, C)`
tensors."""
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
    """BatchNorm of channels-last `x` with the given statistics (the
    running ones in eval mode, the batch's in train mode), in x's dtype;
    the reciprocal square root is taken in float32, as in JAX."""
    inv = torch.rsqrt(var.float() + eps).to(x.dtype)
    return ((x - mean.to(x.dtype)) * inv * gamma.to(x.dtype)
            + beta.to(x.dtype))


def batch_moments(x: torch.Tensor):
    """Train-mode BatchNorm statistics of channels-last `x`: the float32
    per-channel mean and biased (centered) variance over every other axis,
    differentiable (the JAX package's `ops/layers.py::BatchNorm`)."""
    xf = x.float()
    axes = tuple(range(x.ndim - 1))
    mean = xf.mean(dim=axes)
    return mean, (xf - mean).square().mean(dim=axes)


def update_running_stats(running_mean, running_var, mean, var,
                         count: float, momentum: float = 0.1):
    """torch's running-statistics rule, `(1 - m) * running + m * batch`,
    with the unbiased batch variance (`var * count / (count - 1)`); the
    results are new tensors, detached from the graph."""
    unbiased = var.detach() * (count / max(count - 1.0, 1.0))
    return ((1 - momentum) * running_mean + momentum * mean.detach(),
            (1 - momentum) * running_var + momentum * unbiased)


def module_batch_norm(bn, x: torch.Tensor) -> torch.Tensor:
    """Channels-last BatchNorm through the statistics and affine parameters
    of the torch module `bn` (`nn.BatchNorm1d`/`3d`).  In train mode, the
    batch's moments (`batch_moments`), with torch's running update in
    place (`update_running_stats`, `bn.momentum`, `num_batches_tracked`
    counted) and torch's refusal of a single value per channel; in eval
    mode, the running statistics.  The JAX package's `ops/layers.py::
    BatchNorm`."""
    if not bn.training:
        return batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                          bn.bias, bn.eps)
    count = x[..., 0].numel()
    if count <= 1:
        raise ValueError("Expected more than 1 value per channel when "
                         f"training, got input size {tuple(x.shape)}")
    mean, var = batch_moments(x)
    with torch.no_grad():
        new = update_running_stats(bn.running_mean, bn.running_var, mean,
                                   var, count, bn.momentum)
        bn.running_mean.copy_(new[0])
        bn.running_var.copy_(new[1])
        bn.num_batches_tracked.add_(1)
    return batch_norm(x, mean, var, bn.weight, bn.bias, bn.eps)


def dropout_core(x: torch.Tensor, keep_mask: torch.Tensor,
                 rate: float) -> torch.Tensor:
    """Inverted dropout with a given boolean keep mask: `x / (1 - rate)`
    where kept, 0 elsewhere (the JAX package's `ops/layers.py::Dropout`)."""
    return torch.where(keep_mask, x / (1.0 - rate), 0.0)


def generator_on(gen: torch.Generator, device: torch.device
                 ) -> torch.Generator:
    """`gen` if it lives on `device`, else a generator on `device` seeded
    from one draw of `gen`: a host generator then never moves a tensor
    between the host and the card."""
    if gen.device == device:
        return gen
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen,
                             device=gen.device))
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout in train mode, the identity otherwise or at rate 0.
    The keep mask (`u < 1 - rate` for u uniform in [0, 1)) is drawn on
    x's device, from `generator_on(generator, x.device)` (torch's default
    generator of that device if None).  JAX draws other bits from its
    keys (ROADMAP §C)."""
    if not training or rate == 0.0:
        return x
    gen = None if generator is None else generator_on(generator, x.device)
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return dropout_core(x, u < 1.0 - rate, rate)


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


def pad_to(x: torch.Tensor, target_spatial: Sequence[int],
           value: float = 0.0) -> torch.Tensor:
    """Pad the spatial axes of `(N, *spatial, C)` up to `target_spatial`
    with `value`, symmetrically; an odd voxel goes to the far side."""
    pads = []
    for ax, tgt in zip(range(1, x.ndim - 1), target_spatial):
        extra = max(0, int(tgt) - x.shape[ax])
        pads.append((extra // 2, extra - extra // 2))
    if not any(lo or hi for lo, hi in pads):
        return x
    # F.pad lists the last axis first: channels (unpadded), then spatial
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return TF.pad(x, flat, value=value)


def crop_or_pad(x: torch.Tensor, target_spatial: Sequence[int],
                value: float = 0.0) -> torch.Tensor:
    """torchio CropOrPad on `(N, *spatial, C)`: centre crop, then `pad_to`.
    Both are floor-centred, so an odd voxel is cropped from or padded on
    the far side."""
    slices = [slice(None)]
    for ax, tgt in zip(range(1, x.ndim - 1), target_spatial):
        cur, tgt = x.shape[ax], int(tgt)
        start = (cur - tgt) // 2 if cur > tgt else 0
        slices.append(slice(start, start + min(cur, tgt)))
    return pad_to(x[tuple(slices)], target_spatial, value=value)
