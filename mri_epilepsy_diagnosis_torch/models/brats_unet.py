"""BraTS2017-style 3D U-Net with GroupNorm and deep supervision
(counterpart of the JAX package's `models/brats_unet.py`; the reference's
`segmentation/models/unet3d.py`, after github.com/MIC-DKFZ/BraTS2017).

Kept as the JAX package keeps them:
- `ConvD` computes `relu(bn2(conv2(x)))` and its dropout, then overwrites
  the result with `bn3(conv3(x))` (`unet3d.py:46`).  What the port runs
  of that branch is what JAX's compiled step keeps of it: with
  `norm="bn"` in train mode, conv2 -> bn2 without autograd, for bn2's
  running statistics; else nothing (the ReLU and the Dropout mask are
  dead code, which XLA drops, so `dropout` changes no result).  conv2 and
  bn2 get no gradient: the training step gives them a zero one, as JAX's
  gradient is, so AdamW still decays them
  (`train/seg.py::_apply_gradients`).
- The deep-supervision upsample is a working trilinear resize with
  `align_corners=False` (the reference's `F.interpolate` at
  `unet3d.py:85` is called without an input).

`norm` is "gn" (`nn.GroupNorm(4, planes)`), "bn" (`nn.BatchNorm3d`, batch
statistics and torch's running update in train mode) or "in" (an
affine-free InstanceNorm: no parameters).  The norms carry the
reference's names (`convd1.bn1.weight`, `convd1.bn1.running_mean`), the
convs have no bias but the seg heads'.  Activations are channels-last
`(N, D, H, W, C)`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..ops import functional as F


def _make_norm(planes: int, norm: str, device) -> nn.Module:
    if norm == "bn":
        return nn.BatchNorm3d(planes, device=device)
    if norm == "gn":
        return nn.GroupNorm(4, planes, device=device)
    if norm == "in":
        return nn.InstanceNorm3d(planes)
    raise ValueError(f"normalization type {norm} is not supported")


def _apply_norm(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The norm module `m` on channels-last x, as JAX's `_Norm` runs it."""
    if isinstance(m, nn.BatchNorm3d):
        return F.module_batch_norm(m, x)
    if isinstance(m, nn.GroupNorm):
        return F.group_norm(x, m.num_groups, m.weight, m.bias, m.eps)
    return F.instance_norm(x, eps=m.eps)


def _conv(cin: int, cout: int, k: int, device) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, padding=k // 2, bias=False, device=device)


def _apply(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    return F.conv3d(x, conv.weight, conv.bias, padding=conv.padding)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.resize_linear(x, tuple(2 * s for s in x.shape[1:4]),
                           align_corners=False)


class ConvD(nn.Module):
    def __init__(self, inplanes: int, planes: int, dropout: float = 0.0,
                 norm: str = "gn", first: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.first, self.dropout = first, dropout
        self.conv1 = _conv(inplanes, planes, 3, device)
        self.bn1 = _make_norm(planes, norm, device)
        self.conv2 = _conv(planes, planes, 3, device)
        self.bn2 = _make_norm(planes, norm, device)
        self.conv3 = _conv(planes, planes, 3, device)
        self.bn3 = _make_norm(planes, norm, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.first:
            x = F.maxpool3d(x, 2, 2)
        x = _apply_norm(self.bn1, _apply(self.conv1, x))
        if self.training and isinstance(self.bn2, nn.BatchNorm3d):
            # the overwritten branch, for bn2's running statistics only
            # (module docstring)
            with torch.no_grad():
                _apply_norm(self.bn2, _apply(self.conv2, x))
        y = _apply_norm(self.bn3, _apply(self.conv3, x))
        return F.maximum0(x + y)


class ConvU(nn.Module):
    def __init__(self, planes: int, norm: str = "gn", first: bool = False,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.first = first
        if not first:
            self.conv1 = _conv(2 * planes, planes, 3, device)
            self.bn1 = _make_norm(planes, norm, device)
        self.conv2 = _conv(planes, planes // 2, 1, device)
        self.bn2 = _make_norm(planes // 2, norm, device)
        self.conv3 = _conv(planes, planes, 3, device)
        self.bn3 = _make_norm(planes, norm, device)

    def forward(self, x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        if not self.first:
            x = F.maximum0(_apply_norm(self.bn1, _apply(self.conv1, x)))
        y = F.maximum0(_apply_norm(self.bn2, _apply(self.conv2, _up2(x))))
        y = torch.cat([prev, y], dim=-1)
        return F.maximum0(_apply_norm(self.bn3, _apply(self.conv3, y)))


class BraTSUnet(nn.Module):
    """`(N, D, H, W, c)` -> logits `(N, D, H, W, num_classes)`; spatial
    extents divisible by 16."""

    def __init__(self, c: int = 4, n: int = 16, dropout: float = 0.5,
                 norm: str = "gn", num_classes: int = 5, device=None):
        super().__init__()
        d = resolve_device(device)
        self.convd1 = ConvD(c, n, dropout, norm, first=True, device=d)
        self.convd2 = ConvD(n, 2 * n, dropout, norm, device=d)
        self.convd3 = ConvD(2 * n, 4 * n, dropout, norm, device=d)
        self.convd4 = ConvD(4 * n, 8 * n, dropout, norm, device=d)
        self.convd5 = ConvD(8 * n, 16 * n, dropout, norm, device=d)
        self.convu4 = ConvU(16 * n, norm, True, device=d)
        self.convu3 = ConvU(8 * n, norm, device=d)
        self.convu2 = ConvU(4 * n, norm, device=d)
        self.convu1 = ConvU(2 * n, norm, device=d)
        self.seg3 = nn.Conv3d(8 * n, num_classes, 1, device=d)
        self.seg2 = nn.Conv3d(4 * n, num_classes, 1, device=d)
        self.seg1 = nn.Conv3d(2 * n, num_classes, 1, device=d)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                sample_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        del generator, sample_generator  # no live Dropout, no Bayesian layer
        x1 = self.convd1(x)
        x2 = self.convd2(x1)
        x3 = self.convd3(x2)
        x4 = self.convd4(x3)
        x5 = self.convd5(x4)
        y4 = self.convu4(x5, x4)
        y3 = self.convu3(y4, x3)
        y2 = self.convu2(y3, x2)
        y1 = self.convu1(y2, x1)
        s3 = _apply(self.seg3, y3)
        s2 = _apply(self.seg2, y2) + _up2(s3)
        return _apply(self.seg1, y1) + _up2(s2)
