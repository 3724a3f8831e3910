"""Residual 3D U-Net with optional Bayesian convs (counterpart of the JAX
package's `models/residual_unet.py`; the reference's `3d_bayes_unet.py`
`UNet3D` with the blocks of `3d_bayes_layers.py`).

Pre-activation ConvBlocks (InstanceNorm -> ReLU -> conv, no bias),
residual down blocks with a strided 1^3 projection, up blocks that
upsample trilinearly with `align_corners=True` and *add* the skip, and a
1^3 output conv.  With `bayes=True` the 3^3 convs (and the first) are
`BayesConv3d`s, which sample in train and eval mode from the
`sample_generator` given to `forward`.

Submodules carry the reference's names: a ConvBlock is the reference's
`Sequential(InstanceNorm3d, ReLU, conv)`, so its conv's keys are
`conv.2.weight` (`down1.conv_1.conv.2.mu_weight` when Bayesian) and an up
block's input projection is `upsample.0`.  The forward applies them to
channels-last `(N, D, H, W, C)` tensors through `ops/functional.py`.  The
reference's two-device split of encoder and decoder is not kept, as the
JAX package does not keep it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..core.device import resolve_device
from ..ops import functional as F
from .bayes import BayesConv3d


class ConvBlock(nn.Module):
    """(InstanceNorm -> ReLU -> conv), the conv at Sequential index 2."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding: int = 1, bayes: bool = False,
                 device=None):
        super().__init__()
        if bayes:
            conv = BayesConv3d(in_channels, out_channels, kernel,
                               stride=stride, padding=padding,
                               use_bias=False, device=device)
        else:
            conv = nn.Conv3d(in_channels, out_channels, kernel,
                             stride=stride, padding=padding, bias=False,
                             device=device)
        self.conv = nn.Sequential(nn.InstanceNorm3d(in_channels), nn.ReLU(),
                                  conv)

    def forward(self, x: torch.Tensor,
                sample_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = F.maximum0(F.instance_norm(x))
        conv = self.conv[2]
        if isinstance(conv, BayesConv3d):
            return conv(x, sample_generator)
        return F.conv3d(x, conv.weight, stride=conv.stride,
                        padding=conv.padding)


class BasicDownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, downsample: bool,
                 bayes: bool = False, device=None):
        super().__init__()
        s = 2 if downsample else 1
        self.conv_1 = ConvBlock(in_channels, out_channels, 3, stride=s,
                                bayes=bayes, device=device)
        self.conv_2 = ConvBlock(out_channels, out_channels, 3, bayes=bayes,
                                device=device)
        self.down = (ConvBlock(in_channels, out_channels, 1, stride=2,
                               padding=0, device=device)
                     if downsample else None)

    def forward(self, inp: torch.Tensor,
                sample_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.conv_1(inp, sample_generator)
        x = self.conv_2(x, sample_generator)
        return x + (inp if self.down is None else self.down(inp))


class BasicUpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 bayes: bool = False, device=None):
        super().__init__()
        self.upsample = nn.Sequential(
            ConvBlock(in_channels, out_channels, 1, padding=0,
                      device=device),
            nn.Upsample(scale_factor=2, mode="trilinear",
                        align_corners=True))
        self.conv_1 = ConvBlock(out_channels, out_channels, 3, bayes=bayes,
                                device=device)
        self.conv_2 = ConvBlock(out_channels, out_channels, 3, bayes=bayes,
                                device=device)

    def forward(self, inp: torch.Tensor, skip: Optional[torch.Tensor] = None,
                sample_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.upsample[0](inp)
        x = F.resize_linear(x, tuple(2 * s for s in x.shape[1:4]),
                            align_corners=True)
        if skip is not None:
            x = x + skip
        x1 = self.conv_1(x, sample_generator)
        x1 = self.conv_2(x1, sample_generator)
        return x1 + x


class ResidualUNet3D(nn.Module):
    """`(N, D, H, W, n_channels[0])` -> logits `(N, D, H, W, n_classes)`;
    spatial extents divisible by 8.  `shorten=True` drops the three
    stride-1 blocks down7-down9 at the bottom."""

    def __init__(self, n_classes: int = 2,
                 n_channels: Sequence[int] = (1, 16, 32, 64, 128),
                 bayes: bool = False, shorten: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        nc = tuple(n_channels)
        self.bayes, self.shorten = bayes, shorten
        if bayes:
            self.init_conv = BayesConv3d(nc[0], nc[1], 3, padding=1,
                                         use_bias=False, device=device)
        else:
            self.init_conv = nn.Conv3d(nc[0], nc[1], 3, padding=1,
                                       bias=False, device=device)
        plan = [(nc[1], nc[2], True), (nc[2], nc[2], False),
                (nc[2], nc[3], True), (nc[3], nc[3], False),
                (nc[3], nc[4], True), (nc[4], nc[4], False)]
        if not shorten:
            plan += [(nc[4], nc[4], False)] * 3
        for i, (cin, cout, down) in enumerate(plan, start=1):
            setattr(self, f"down{i}", BasicDownBlock(cin, cout, down, bayes,
                                                     device=device))
        self.n_down = len(plan)
        self.up1 = BasicUpBlock(nc[4], nc[3], bayes, device=device)
        self.up2 = BasicUpBlock(nc[3], nc[2], bayes, device=device)
        self.up3 = BasicUpBlock(nc[2], nc[1], bayes, device=device)
        self.out = nn.Conv3d(nc[1], n_classes, 1, bias=False, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                sample_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        del generator  # no dropout
        if self.bayes:
            x1 = self.init_conv(x, sample_generator)
        else:
            x1 = F.conv3d(x, self.init_conv.weight, padding=1)
        x2 = self.down2(self.down1(x1, sample_generator), sample_generator)
        x3 = self.down4(self.down3(x2, sample_generator), sample_generator)
        x4 = x3
        for i in range(5, self.n_down + 1):
            x4 = getattr(self, f"down{i}")(x4, sample_generator)
        y = self.up1(x4, x3, sample_generator)
        y = self.up2(y, x2, sample_generator)
        y = self.up3(y, x1, sample_generator)
        return F.conv3d(y, self.out.weight)
