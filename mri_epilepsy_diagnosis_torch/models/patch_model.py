"""2-D patch detection CNN (counterpart of the JAX package's
`models/patch_model.py`, after the reference's `detection/
model_utils.py:19-52` `PatchModel` / `ConvolutionBlock`): five valid 3x3
conv-BN-ReLU blocks (2 -> 16 -> 32 -> 64 -> 128 -> 256 channels) on
2-channel mirrored-hemisphere 16 x 32 patches, max pool 2, Dropout 0.4,
FC 3*11*256 -> 256 -> 2.

Input is channels-last `(N, 16, 32, 2)`.  The convs are torch's
`nn.Conv2d` (cuDNN on the card; the JAX package leaves them to XLA),
BatchNorm goes through `ops/functional.py::module_batch_norm`, and Dropout
draws its mask from the `generator` passed to `forward`, as in
`models/cnn.py`.  The features are flattened in torch's (N, C, H, W)
order, as the JAX package flattens them, so `fc1`'s bridged weights need
no permutation.  The submodule names (`conv_blocks.{i}.conv`, `.bn`,
`fc1`, `fc2`) are the keys `interop.variables_to_state_dict` gives for
the JAX package's variables.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..ops import functional as F

WIDTHS = ((2, 16), (16, 32), (32, 64), (64, 128), (128, 256))
DROPOUT = 0.4


class ConvolutionBlock(nn.Module):
    """3x3 conv (padding `pad`), BatchNorm, ReLU on channels-last x."""

    def __init__(self, in_c: int, out_c: int, pad: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        self.conv = nn.Conv2d(in_c, out_c, 3, padding=pad, device=device)
        self.bn = nn.BatchNorm2d(out_c, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.conv2d(x, c.weight, c.bias, padding=c.padding)
        return F.relu(F.module_batch_norm(self.bn, x))


class PatchModel(nn.Module):
    """The reference's patch classifier; returns (N, 2) logits."""

    def __init__(self, device=None):
        super().__init__()
        device = resolve_device(device)
        self.conv_blocks = nn.ModuleList(
            [ConvolutionBlock(ci, co, device=device) for ci, co in WIDTHS])
        self.fc1 = nn.Linear(3 * 11 * 256, 256, device=device)
        self.fc2 = nn.Linear(256, 2, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block in self.conv_blocks:
            x = block(x)
        x = F.maxpool2d(x, 2)
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        x = F.dropout(x, DROPOUT, self.training, generator)
        x = F.relu(F.dense(x, self.fc1.weight, self.fc1.bias))
        return F.dense(x, self.fc2.weight, self.fc2.bias)
