"""Modified 3D U-Net: context and localization pathways with deep
supervision (counterpart of the JAX package's `models/modified_unet.py`;
the reference's `segmentation/models/modified_3dunet.py`).

InstanceNorm (affine-free, so parameterless) and LeakyReLU (slope 0.01),
nearest upsampling, residual context blocks whose `norm_lrelu_conv_c*`
module is applied twice per level with one set of weights, and the
deep-supervision heads ds2 / ds3 summed into the output.  The convs have
no bias.  Submodules carry the reference's Sequential names, so its keys
are the reference's (`norm_lrelu_conv_c2.2.weight`,
`conv_norm_lrelu_l1.0.weight`, `lrelu_conv_c1.1.weight`,
`norm_lrelu_upscale_conv_norm_lrelu_l0.3.weight`, ...); the forward
applies them to channels-last `(N, D, H, W, C)` tensors through
`ops/functional.py`.

`dropout3d` follows the JAX package: an elementwise inverted Dropout
(rate 0.6, JAX's `ops/layers.py::Dropout`), not torch's channel-wise
`nn.Dropout3d`; its masks are drawn from the `generator` passed to
`forward`, one per call, in train mode only.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..ops import functional as F

DROPOUT = 0.6


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


def _norm_lrelu(x: torch.Tensor) -> torch.Tensor:
    return _lrelu(F.instance_norm(x))


def _conv3(cin: int, cout: int, device, stride: int = 1) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, 3, stride=stride, padding=1, bias=False,
                     device=device)


def _conv1(cin: int, cout: int, device) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, 1, bias=False, device=device)


def _apply(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    return F.conv3d(x, conv.weight, stride=conv.stride, padding=conv.padding)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.resize_nearest(x, tuple(2 * s for s in x.shape[1:4]))


def _conv_norm_lrelu(cin, cout, device):
    """Sequential(conv, InstanceNorm, LeakyReLU): the conv at index 0."""
    return nn.Sequential(_conv3(cin, cout, device), nn.InstanceNorm3d(cout),
                         nn.LeakyReLU())


def _norm_lrelu_conv(cin, cout, device):
    """Sequential(InstanceNorm, LeakyReLU, conv): the conv at index 2."""
    return nn.Sequential(nn.InstanceNorm3d(cin), nn.LeakyReLU(),
                         _conv3(cin, cout, device))


def _lrelu_conv(cin, cout, device):
    """Sequential(LeakyReLU, conv): the conv at index 1."""
    return nn.Sequential(nn.LeakyReLU(), _conv3(cin, cout, device))


def _norm_lrelu_upscale_conv_norm_lrelu(cin, cout, device):
    """Sequential(IN, LReLU, Upsample(nearest, x2), conv, IN, LReLU): the
    conv at index 3."""
    return nn.Sequential(nn.InstanceNorm3d(cin), nn.LeakyReLU(),
                         nn.Upsample(scale_factor=2, mode="nearest"),
                         _conv3(cin, cout, device), nn.InstanceNorm3d(cout),
                         nn.LeakyReLU())


class Modified3DUNet(nn.Module):
    """`(N, D, H, W, in_channels)` -> logits `(N, D, H, W, n_classes)`;
    spatial extents divisible by 16."""

    def __init__(self, in_channels: int = 1, n_classes: int = 2,
                 base_n_filter: int = 8, device=None):
        super().__init__()
        d = resolve_device(device)
        b = base_n_filter
        self.conv3d_c1_1 = _conv3(in_channels, b, d)
        self.conv3d_c1_2 = _conv3(b, b, d)
        self.lrelu_conv_c1 = _lrelu_conv(b, b, d)
        for tag, cin, cout in (("c2", b, 2 * b), ("c3", 2 * b, 4 * b),
                               ("c4", 4 * b, 8 * b), ("c5", 8 * b, 16 * b)):
            setattr(self, f"conv3d_{tag}", _conv3(cin, cout, d, stride=2))
            setattr(self, f"norm_lrelu_conv_{tag}",
                    _norm_lrelu_conv(cout, cout, d))
        self.norm_lrelu_upscale_conv_norm_lrelu_l0 = (
            _norm_lrelu_upscale_conv_norm_lrelu(16 * b, 8 * b, d))
        self.conv3d_l0 = _conv1(8 * b, 8 * b, d)
        self.conv_norm_lrelu_l1 = _conv_norm_lrelu(16 * b, 16 * b, d)
        self.conv3d_l1 = _conv1(16 * b, 8 * b, d)
        self.norm_lrelu_upscale_conv_norm_lrelu_l1 = (
            _norm_lrelu_upscale_conv_norm_lrelu(8 * b, 4 * b, d))
        self.conv_norm_lrelu_l2 = _conv_norm_lrelu(8 * b, 8 * b, d)
        self.conv3d_l2 = _conv1(8 * b, 4 * b, d)
        self.norm_lrelu_upscale_conv_norm_lrelu_l2 = (
            _norm_lrelu_upscale_conv_norm_lrelu(4 * b, 2 * b, d))
        self.conv_norm_lrelu_l3 = _conv_norm_lrelu(4 * b, 4 * b, d)
        self.conv3d_l3 = _conv1(4 * b, 2 * b, d)
        self.norm_lrelu_upscale_conv_norm_lrelu_l3 = (
            _norm_lrelu_upscale_conv_norm_lrelu(2 * b, b, d))
        self.conv_norm_lrelu_l4 = _conv_norm_lrelu(2 * b, 2 * b, d)
        self.conv3d_l4 = _conv1(2 * b, n_classes, d)
        self.ds2_1x1_conv3d = _conv1(8 * b, n_classes, d)
        self.ds3_1x1_conv3d = _conv1(4 * b, n_classes, d)

    def _upscale(self, level: str, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"norm_lrelu_upscale_conv_norm_lrelu_{level}")[3]
        return _norm_lrelu(_apply(conv, _up2(_norm_lrelu(x))))

    def _localize(self, level: str, x: torch.Tensor) -> torch.Tensor:
        return _norm_lrelu(_apply(getattr(
            self, f"conv_norm_lrelu_{level}")[0], x))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                sample_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        del sample_generator  # no Bayesian layers

        def drop(y):
            return F.dropout(y, DROPOUT, self.training, generator)

        # level 1 of the context pathway
        out = _apply(self.conv3d_c1_1, x)
        residual_1 = out
        out = _apply(self.conv3d_c1_2, _lrelu(out))
        out = drop(out)
        out = _apply(self.lrelu_conv_c1[1], _lrelu(out)) + residual_1
        context_1 = _lrelu(out)           # the skip is taken before the norm
        out = _norm_lrelu(out)
        # levels 2-5: one norm_lrelu_conv module applied twice per level
        contexts = []
        for tag in ("c2", "c3", "c4", "c5"):
            out = _apply(getattr(self, f"conv3d_{tag}"), out)
            residual = out
            conv = getattr(self, f"norm_lrelu_conv_{tag}")[2]
            out = _apply(conv, _norm_lrelu(out))
            out = drop(out)
            out = _apply(conv, _norm_lrelu(out)) + residual
            if tag != "c5":
                out = _norm_lrelu(out)
                contexts.append(out)
        context_2, context_3, context_4 = contexts
        # localization level 0
        out = self._upscale("l0", out)
        out = _norm_lrelu(_apply(self.conv3d_l0, out))
        # localization levels 1-4
        out = self._localize("l1", torch.cat([out, context_4], dim=-1))
        out = self._upscale("l1", _apply(self.conv3d_l1, out))
        out = self._localize("l2", torch.cat([out, context_3], dim=-1))
        ds2 = out
        out = self._upscale("l2", _apply(self.conv3d_l2, out))
        out = self._localize("l3", torch.cat([out, context_2], dim=-1))
        ds3 = out
        out = self._upscale("l3", _apply(self.conv3d_l3, out))
        out = self._localize("l4", torch.cat([out, context_1], dim=-1))
        out_pred = _apply(self.conv3d_l4, out)
        ds_sum = (_up2(_apply(self.ds2_1x1_conv3d, ds2))
                  + _apply(self.ds3_1x1_conv3d, ds3))
        return out_pred + _up2(ds_sum)
