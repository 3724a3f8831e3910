"""3D U-Net segmenter with fepegar `unet.UNet` checkpoint parity
(counterpart of the JAX package's `models/unet.py`).

Submodules carry the checkpoint's names (`encoder.encoding_blocks.0.conv1.
conv_layer.weight`, ...), so a reference `.pth` state dict loads with
`load_state_dict`.  The forward takes and returns channels-last
`(N, D, H, W, C)` tensors.  In eval mode BatchNorm uses the running
statistics; in train mode (`.train()`) it normalizes with the batch's and
updates the running buffers, as `nn.BatchNorm3d` does (torch momentum,
unbiased variance into the running statistics).  Its convolutions are
`F.conv3d` (cuDNN on the card), with the weights cast to the input's
dtype.  This model is the weight container of the packed serving and
training paths (`models/unet_packed.py`), their parity oracle, and the
fine `seg_train_step`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF
from torch import nn

from ..core.device import resolve_device
from ..ops import functional as F


class ConvBlock(nn.Module):
    """conv3 + optional BatchNorm + PReLU (`conv_layer` / `norm_layer` /
    `activation_layer`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 normalization: bool = True, kernel_size: int = 3,
                 padding: int = 1, activation: bool = True, device=None):
        super().__init__()
        self.padding = padding
        self.conv_layer = nn.Conv3d(in_channels, out_channels, kernel_size,
                                    padding=padding, device=device)
        self.norm_layer = (nn.BatchNorm3d(out_channels, device=device)
                           if normalization else None)
        self.activation_layer = nn.PReLU(device=device) if activation else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv_layer
        bias = None if conv.bias is None else conv.bias.to(x.dtype)
        y = TF.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight.to(x.dtype),
                      bias, padding=self.padding)
        y = y.permute(0, 2, 3, 4, 1)
        if self.norm_layer is not None:
            y = F.module_batch_norm(self.norm_layer, y)
        if self.activation_layer is not None:
            y = F.prelu(y, self.activation_layer.weight)
        return y


class EncodingBlock(nn.Module):
    def __init__(self, in1: int, out1: int, out2: int, first: bool = False,
                 device=None):
        super().__init__()
        # the first encoder block's conv1 has no normalization
        self.conv1 = ConvBlock(in1, out1, normalization=not first,
                               device=device)
        self.conv2 = ConvBlock(out1, out2, device=device)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class DecodingBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.conv1 = ConvBlock(in_channels, out_channels, device=device)
        self.conv2 = ConvBlock(out_channels, out_channels, device=device)

    def forward(self, x, skip):
        up = F.resize_linear(x, tuple(2 * s for s in x.shape[1:-1]),
                             align_corners=False)
        # fepegar decoding: torch.cat((skip_connection, x), dim=CHANNELS)
        return self.conv2(self.conv1(torch.cat([skip, up], dim=-1)))


class _Encoder(nn.Module):
    def __init__(self, in_channels: int, ocfl: int, num_blocks: int,
                 device=None):
        super().__init__()
        blocks = []
        c_in = in_channels
        for i in range(num_blocks - 1):
            if i == 0:
                blocks.append(EncodingBlock(c_in, ocfl, 2 * ocfl, first=True,
                                            device=device))
                c_in = 2 * ocfl
            else:
                blocks.append(EncodingBlock(c_in, c_in, 2 * c_in,
                                            device=device))
                c_in = 2 * c_in
        self.encoding_blocks = nn.ModuleList(blocks)
        self.out_channels = c_in

    def forward(self, x):
        skips = []
        for blk in self.encoding_blocks:
            x = blk(x)
            skips.append(x)
            x = F.maxpool3d(x, 2)
        return x, skips


class _Decoder(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.decoding_blocks = nn.ModuleList(
            DecodingBlock(cin, cout, device=device) for cin, cout in channels)

    def forward(self, x, skips):
        for i, blk in enumerate(self.decoding_blocks):
            x = blk(x, skips[-(i + 1)])
        return x


class UNet3D(nn.Module):
    """Parity UNet: `(N, D, H, W, in_channels)` -> logits
    `(N, D, H, W, out_classes)`.  Spatial dims must be divisible by
    2^(num_encoding_blocks - 1)."""

    def __init__(self, in_channels: int = 1, out_classes: int = 2,
                 num_encoding_blocks: int = 3,
                 out_channels_first_layer: int = 8, device=None):
        super().__init__()
        device = resolve_device(device)
        ocfl = out_channels_first_layer
        nb = num_encoding_blocks
        self.encoder = _Encoder(in_channels, ocfl, nb, device=device)
        cb = self.encoder.out_channels
        self.bottom_block = EncodingBlock(cb, cb, 2 * cb, device=device)
        # decoder channel plan: at step i the upsampled input has c_up
        # channels, the skip c_up // 2, and the output c_up // 2
        dec_channels = []
        c_up = 2 * cb
        for _ in range(nb - 1):
            dec_channels.append((c_up + c_up // 2, c_up // 2))
            c_up //= 2
        self.decoder = _Decoder(dec_channels, device=device)
        self.classifier = ConvBlock(c_up, out_classes, normalization=False,
                                    activation=False, kernel_size=1,
                                    padding=0, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, skips = self.encoder(x)
        x = self.bottom_block(x)
        x = self.decoder(x, skips)
        return self.classifier(x)
