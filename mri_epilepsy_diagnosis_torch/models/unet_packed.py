"""Packed-layout (space-to-depth) inference path of UNet3D: the served
path (counterpart of the JAX package's `models/unet_packed.py`, v2 forward).

Runs the `UNet3D` eval forward on the packed `(N, S/2, S/2, S/2, 8C)`
layout of `ops/packed.py`, from the same `state_dict`, alternating
aligned->shifted and shifted->aligned k=2 convs so that no repack is ever
needed.  Every 3x3x3 conv goes through kernel B1 (`conv2_packed`) and the
BN/PReLU/pad-mask tail of every aligned->shifted conv through kernel B2
(`bn_act_zero_pads`): 12 B1 and 5 B2 launches per forward at
num_encoding_blocks=3.

The decoder's up branch is explicit: `upsample2_packed` followed by an
aligned->shifted k=2 conv of the upsampled tensor with the up half of the
first decoder conv's weights (the JAX package's `dec_up="explicit"` form of
`packed_unet_train_apply`).  JAX's inference forward composes upsample and
conv into one 5^3 kernel with face corrections instead; both compute the
same function.

`state_dict` arguments are the `UNet3D` state dict, optionally BN-folded
by `fold_bn_inference`: a flat mapping of fepegar keys to tensors.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..ops import functional as F
from ..ops import packed as P

StateDict = Mapping[str, torch.Tensor]


def fold_bn_inference(state_dict: StateDict, eps: float = 1e-5
                      ) -> Dict[str, torch.Tensor]:
    """Fold eval-mode BatchNorm into the preceding conv's weight and bias:
    with s = gamma / sqrt(var + eps),

        BN(conv(x, W) + b) == conv(x, W * s) + (b * s + beta - mean * s).

    Returns a new state dict without the folded `norm_layer` entries.
    Inference only: training needs live batch statistics."""
    norm = ".norm_layer.weight"
    blocks = [k[:-len(norm)] for k in state_dict if k.endswith(norm)
              and k[:-len(norm)] + ".conv_layer.weight" in state_dict]
    out = {k: v for k, v in state_dict.items()
           if not any(k.startswith(b + ".norm_layer.") for b in blocks)}
    for b in blocks:
        gamma = state_dict[f"{b}.norm_layer.weight"]
        beta = state_dict[f"{b}.norm_layer.bias"]
        mean = state_dict[f"{b}.norm_layer.running_mean"]
        var = state_dict[f"{b}.norm_layer.running_var"]
        s = gamma / torch.sqrt(var + eps)
        w = state_dict[f"{b}.conv_layer.weight"]
        out[f"{b}.conv_layer.weight"] = w * s.reshape(-1, *([1] * (w.ndim - 1)))
        bias = state_dict.get(f"{b}.conv_layer.bias")
        out[f"{b}.conv_layer.bias"] = ((bias * s if bias is not None else 0.0)
                                       + beta - mean * s)
    return out


def _epilogue_params(sd: StateDict, block: str, bias, c: int, device):
    """Packed (8C,) float32 scale, shift and PReLU slope of the tail of an
    aligned->shifted ConvBlock: conv bias, eval BN (if not folded), PReLU
    (slope 1, the identity, if the block has none)."""
    shift = (bias.float() if bias is not None
             else torch.zeros(c, device=device))
    scale = torch.ones(c, device=device)
    if f"{block}.norm_layer.weight" in sd:
        inv = torch.rsqrt(sd[f"{block}.norm_layer.running_var"].float()
                          + 1e-5)
        scale = sd[f"{block}.norm_layer.weight"].float() * inv
        shift = (sd[f"{block}.norm_layer.bias"].float()
                 + (shift - sd[f"{block}.norm_layer.running_mean"].float())
                 * scale)
    alpha = sd.get(f"{block}.activation_layer.weight")
    alpha = (torch.ones(c, device=device) if alpha is None
             else alpha.float().expand(c))
    return (P.tile_channel_param(scale), P.tile_channel_param(shift),
            P.tile_channel_param(alpha))


def _bn_act(y, sd: StateDict, block: str):
    """Eval BN (if not folded) + PReLU of a shifted->aligned ConvBlock."""
    if f"{block}.norm_layer.weight" in sd:
        y = P.batch_norm_packed(
            y, sd[f"{block}.norm_layer.running_mean"],
            sd[f"{block}.norm_layer.running_var"],
            sd[f"{block}.norm_layer.weight"], sd[f"{block}.norm_layer.bias"])
    alpha = sd.get(f"{block}.activation_layer.weight")
    return y if alpha is None else F.prelu(y, alpha)


def _block_as(xp_aligned, sd: StateDict, block: str):
    """ConvBlock as an aligned->shifted packed conv (B1), then bias, BN,
    PReLU and re-zeroed shifted pad voxels in one pass (B2)."""
    w = sd[f"{block}.conv_layer.weight"]
    y = P.conv3_packed_as(xp_aligned, P.pack_weights2_as(w))
    params = _epilogue_params(sd, block, sd.get(f"{block}.conv_layer.bias"),
                              w.shape[0], y.device)
    return P.bn_act_zero_pads(y, *params)


def _block_sa(xs, sd: StateDict, block: str):
    """ConvBlock as a shifted->aligned packed conv (B1, bias fused) + BN
    and PReLU."""
    y = P.conv3_packed(xs, P.pack_weights2(sd[f"{block}.conv_layer.weight"]),
                       sd.get(f"{block}.conv_layer.bias"))
    return _bn_act(y, sd, block)


def _decoder_conv1(xp, skip, sd: StateDict, block: str):
    """First conv of a decoding block, conv(cat(skip, up(xp))), split over
    its input channels into an aligned->shifted conv of the skip and one of
    the explicitly upsampled input (two B1 launches), summed in place,
    then the B2 tail."""
    w = sd[f"{block}.conv_layer.weight"]
    c_skip = skip.shape[-1] // 8
    y = P.conv3_packed_as(skip, P.pack_weights2_as(w[:, :c_skip]))
    y += P.conv3_packed_as(P.upsample2_packed(xp),
                           P.pack_weights2_as(w[:, c_skip:]))
    params = _epilogue_params(sd, block, sd.get(f"{block}.conv_layer.bias"),
                              w.shape[0], y.device)
    return P.bn_act_zero_pads(y, *params)


def _trunk_v2(sd: StateDict, x: torch.Tensor, num_encoding_blocks: int = 3):
    """Fine (N, S, S, S, 1) input -> the head's ALIGNED packed output."""
    nb = num_encoding_blocks
    xp = P.pack2(x)
    skips = []
    for i in range(nb - 1):
        blk = f"encoder.encoding_blocks.{i}"
        xs = _block_as(xp, sd, f"{blk}.conv1")
        xp = _block_sa(xs, sd, f"{blk}.conv2")
        skips.append(xp)
        xp = P.maxpool2_packed(xp)

    xs = _block_as(xp, sd, "bottom_block.conv1")
    xp = _block_sa(xs, sd, "bottom_block.conv2")

    for i in range(nb - 1):
        blk = f"decoder.decoding_blocks.{i}"
        xs = _decoder_conv1(xp, skips[-(i + 1)], sd, f"{blk}.conv1")
        xp = _block_sa(xs, sd, f"{blk}.conv2")

    return P.conv1_packed_blockdiag(xp, sd["classifier.conv_layer.weight"],
                                    sd.get("classifier.conv_layer.bias"))


def packed_unet_apply_v2(state_dict: StateDict, x: torch.Tensor,
                         num_encoding_blocks: int = 3) -> torch.Tensor:
    """Fine (N, S, S, S, 1) -> logits (N, S, S, S, out_classes), equal to
    `UNet3D(...).eval()(x)` up to summation order.  S must be divisible by
    2^num_encoding_blocks."""
    return P.unpack2(_trunk_v2(state_dict, x, num_encoding_blocks))


def packed_unet_mask_v2(state_dict: StateDict, x: torch.Tensor,
                        num_encoding_blocks: int = 3) -> torch.Tensor:
    """Fine (N, S, S, S, 1) -> int32 mask (N, S, S, S), equal to
    `argmax(packed_unet_apply_v2(...), -1)` for out_classes == 2: the class
    channels are compared in packed space (l1 > l0, so ties keep class 0,
    as argmax does) and only the 1-channel mask is unpacked."""
    yp = _trunk_v2(state_dict, x, num_encoding_blocks)
    if yp.shape[-1] != 16:
        raise ValueError("packed_unet_mask_v2 needs out_classes == 2; got "
                         f"{yp.shape[-1] // 8} classes")
    mask = yp[..., 1::2] > yp[..., 0::2]
    return P.unpack2(mask)[..., 0].to(torch.int32)
