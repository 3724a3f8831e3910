"""Bayesian (variational, local-reparameterization) conv layers and the
conv + InstanceNorm + ReLU blocks of the reference's
`segmentation/models/3d_bayes_layers.py` (counterpart of the JAX
package's `models/bayes.py`).

`BayesConv3d` / `BayesConv2d` learn `mu_weight` / `logsigma_weight` (and
`mu_bias` / `logsigma_bias`) in torch's `(O, I, *k)` layout, the
reference's keys.  `bayes_moments` is the deterministic part of the
forward:
- `log_alpha = clip(logsigma - log(mu^2 + 1e-8), -5, 5)`;
- `var_w = mu^2 * exp(log_alpha)`, `var_b = logsigma_b^2` (a square, not
  an exponential: the reference's and JAX's formula, kept as it is);
- in eval mode the pruning mask `log_alpha < threshold` multiplies mu and
  var_w (variational-dropout pruning);
- `mu_out = conv(x, mu, mu_b)`, `sigma_out = sqrt(1e-4 + conv(x^2, var_w,
  var_b))`.
The layer then returns `eps * sigma_out + mu_out` in train and in eval
mode (`reparameterize`), with `eps` standard normal drawn by `draw_eps`
on x's device from the `sample_generator` passed to `forward`.  JAX draws
other bits from its "sample" stream (ROADMAP §C "RNG streams").

Activations are channels-last, `(N, D, H, W, C)` (`(N, H, W, C)` for the
2-D layers); the convolutions are `ops/functional.py`'s (cuDNN on the
card), with the weights cast to the input's dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as TF
from torch import nn

from ..core.device import resolve_device
from ..ops import functional as F

Size = Union[int, Sequence[int]]


def _tuple(v: Size, n: int):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def draw_eps(like: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Standard normal noise of `like`'s shape and dtype on its device,
    from `F.generator_on(generator, like.device)` (torch's default
    generator of that device if None)."""
    gen = None if generator is None else F.generator_on(generator,
                                                        like.device)
    return torch.randn(like.shape, generator=gen, device=like.device,
                       dtype=like.dtype)


def reparameterize(mu: torch.Tensor, sigma: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """`eps * sigma + mu`, the sample of JAX's layers for a given eps."""
    return eps * sigma + mu


def bayes_moments(x, mu_w, logsigma_w, mu_b, logsigma_b, conv, *,
                  train: bool, threshold: float = 3.0):
    """(mu_out, sigma_out) of the local reparameterization (module
    docstring); `conv(x, w, b)` is the layer's convolution."""
    log_alpha = torch.clamp(
        logsigma_w - torch.log(mu_w.square() + 1e-8), -5.0, 5.0)
    var_w = mu_w.square() * torch.exp(log_alpha)
    var_b = None if logsigma_b is None else logsigma_b.square()
    if not train:
        mask = (log_alpha < threshold).to(mu_w.dtype)
        mu_w, var_w = mu_w * mask, var_w * mask
    mu_out = conv(x, mu_w, mu_b)
    sigma_out = torch.sqrt(1e-4 + conv(x.square(), var_w, var_b))
    return mu_out, sigma_out


class _BayesConvNd(nn.Module):
    """Reference `_BayesConvNd` (`3d_bayes_layers.py:87-147`): mu ~
    N(0, 0.02) (or zeros with `zero_mean`), logsigma = -5, biases
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from torch's generator."""

    ndim = 3

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Size, stride: Size = 1, padding: Size = 0,
                 dilation: Size = 1, use_bias: bool = True,
                 zero_mean: bool = False, threshold: float = 3.0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        k = _tuple(kernel_size, self.ndim)
        self.stride = _tuple(stride, self.ndim)
        self.padding = _tuple(padding, self.ndim)
        self.dilation = _tuple(dilation, self.ndim)
        self.threshold = threshold
        shape = (out_channels, in_channels, *k)
        mu = torch.zeros(shape, device=device)
        if not zero_mean:
            nn.init.normal_(mu, 0.0, 0.02)
        self.mu_weight = nn.Parameter(mu)
        self.logsigma_weight = nn.Parameter(
            torch.full(shape, -5.0, device=device))
        if use_bias:
            bound = 1.0 / math.sqrt(in_channels * math.prod(k))
            self.mu_bias = nn.Parameter(torch.empty(
                out_channels, device=device).uniform_(-bound, bound))
            self.logsigma_bias = nn.Parameter(torch.empty(
                out_channels, device=device).uniform_(-bound, bound))
        else:
            self.mu_bias = self.logsigma_bias = None

    def _conv(self, x, w, b):
        conv = F.conv3d if self.ndim == 3 else F.conv2d
        return conv(x, w, b, stride=self.stride, padding=self.padding,
                    dilation=self.dilation)

    def moments(self, x: torch.Tensor):
        return bayes_moments(x, self.mu_weight, self.logsigma_weight,
                             self.mu_bias, self.logsigma_bias, self._conv,
                             train=self.training, threshold=self.threshold)

    def forward(self, x: torch.Tensor,
                sample_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        mu, sigma = self.moments(x)
        return reparameterize(mu, sigma, draw_eps(sigma, sample_generator))


class BayesConv3d(_BayesConvNd):
    """Reference `BayesConv3d` (`3d_bayes_layers.py:194-232`)."""
    ndim = 3


class BayesConv2d(_BayesConvNd):
    """Reference `BayesConv2d` (`3d_bayes_layers.py:149-192`); input
    (N, H, W, C)."""
    ndim = 2


class ConvSample(nn.Module):
    """Reference `ConvSample` (`3d_bayes_layers.py:259-271`): two 2-D
    convs give mu and logsigma := conv(log(x^2 + 1e-8)); the sample is
    `eps * exp(0.5 * logsigma) + mu`."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Size, device=None):
        super().__init__()
        device = resolve_device(device)
        self.conv_mu = nn.Conv2d(in_channels, out_channels, kernel_size,
                                 device=device)
        self.conv_sigma = nn.Conv2d(in_channels, out_channels, kernel_size,
                                    device=device)

    def forward(self, x: torch.Tensor,
                sample_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        mu = F.conv2d(x, self.conv_mu.weight, self.conv_mu.bias)
        logsigma = F.conv2d(torch.log(x.square() + 1e-8),
                            self.conv_sigma.weight, self.conv_sigma.bias)
        std = torch.exp(0.5 * logsigma)
        return reparameterize(mu, std, draw_eps(std, sample_generator))


def flatten(x: torch.Tensor) -> torch.Tensor:
    """Reference `Flatten`: (N, ...) -> (N, prod), in the channels-last
    element order of JAX's."""
    return x.reshape(x.shape[0], -1)


class DeFlatten(nn.Module):
    """Reference `DeFlatten`: (N, prod) -> (N, *shape), `shape` the
    channels-last (D, H, W, C) target (the reference's is (C, D, H, W))."""

    def __init__(self, shape: Sequence[int]):
        super().__init__()
        self.shape = tuple(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], *self.shape)


class ConvLayer(nn.Module):
    """Reference `Conv_Layer`: 3^3 conv (padding 1, bias) -> InstanceNorm
    (affine-free: no parameters) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 stride: Size = 1, device=None):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, 3, padding=1,
                              stride=stride, device=resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = F.conv3d(x, c.weight, c.bias, stride=c.stride, padding=1)
        return torch.relu(F.instance_norm(y))


class ConvTransposeLayer(nn.Module):
    """Reference `Conv_Transpose_Layer`: transposed conv (kernel 4, stride
    2, no padding: N -> 2N + 2) -> InstanceNorm -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 stride: Size = 2, kernel_size: Size = (4, 4, 4),
                 device=None):
        super().__init__()
        self.conv = nn.ConvTranspose3d(in_channels, out_channels,
                                       kernel_size, stride=stride,
                                       device=resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = F.conv3d_transpose(x, c.weight, c.bias, stride=c.stride)
        return torch.relu(F.instance_norm(y))


class DownConv(nn.Module):
    """Reference `Down_Conv`: a stride-2 conv layer, then a stride-1 one."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.conv_1 = ConvLayer(in_channels, out_channels, 2, device=device)
        self.conv_2 = ConvLayer(out_channels, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_2(self.conv_1(x))


class InitConv(nn.Module):
    """Reference `Init_Conv`: two stride-1 conv layers."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.conv_1 = ConvLayer(in_channels, out_channels, device=device)
        self.conv_2 = ConvLayer(out_channels, out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_2(self.conv_1(x))


class UpConv(nn.Module):
    """Reference `Up_Conv`: x1 up by the k4/s2 transposed conv layer
    (2N + 2), padded or, for a negative difference, cropped to the skip
    x2 as torch's `F.pad` with negative amounts does, concatenated after
    x2, then a conv layer."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.deconv = ConvTransposeLayer(in_channels, in_channels // 2,
                                         device=device)
        self.conv = ConvLayer(in_channels, out_channels, device=device)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = self.deconv(x1)
        slices, pads = [slice(None)], []
        for ax in range(1, 4):
            diff = x2.shape[ax] - x1.shape[ax]
            lo, hi = diff // 2, diff - diff // 2
            slices.append(slice(-min(lo, 0), x1.shape[ax] + min(hi, 0)))
            pads.append((max(lo, 0), max(hi, 0)))
        x1 = x1[tuple(slices)]
        flat = [0, 0]                     # channels, then W, H, D
        for lo, hi in reversed(pads):
            flat += [lo, hi]
        x1 = TF.pad(x1, flat)
        return self.conv(torch.cat([x2, x1], dim=-1))


class FinalConv(nn.Module):
    """Reference `Final_Conv`: a 1^3 conv head (bias)."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, 1,
                              device=resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.conv.weight, self.conv.bias)
