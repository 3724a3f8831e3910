"""Packed-layout (space-to-depth) inference and training paths of UNet3D:
the served path and the trained one (counterpart of the JAX package's
`models/unet_packed.py`: the v2 forward with its calibration `tap`,
`packed_unet_train_apply` with the explicit up branch, and
`packed_dice_loss`).

Runs the `UNet3D` eval forward on the packed `(N, S/2, S/2, S/2, 8C)`
layout of `ops/packed.py`, from the same `state_dict`, alternating
aligned->shifted and shifted->aligned k=2 convs so that no repack is ever
needed.  Every 3x3x3 conv goes through kernel B1 (`conv2_packed`), and the
BN/PReLU/pad-mask tail of every aligned->shifted conv (kernel B2) runs as
the epilogue of that conv's launch (`conv2_packed_as_bn_act`): 12 B1
launches per forward at num_encoding_blocks=3, 5 of them with B2 fused.

The decoder's up branch is explicit: `upsample2_packed` followed by an
aligned->shifted k=2 conv of the upsampled tensor with the up half of the
first decoder conv's weights (the JAX package's explicit form of
`packed_unet_train_apply`'s up branch), in serving and in training.
JAX's inference forward composes upsample and conv into one 5^3 kernel
with face corrections instead (`ops/packed.py::upconv_packed`, which the
int8 path runs as kernel K2); both compute the same function.

The train-mode forward (`packed_unet_train_apply`) runs the same 12 convs
through B1 without the epilogue, since BatchNorm normalizes with the
statistics of the conv's output; its backward runs every input gradient
but the stem's through B1 as well (`ops/packed.py::Conv3Packed`).  The
BN/PReLU/pad-mask tail of each of its ConvBlocks is one
`ops/packed.py::BnActTrainPacked` (four hand-written passes).

`state_dict` arguments are the `UNet3D` state dict, optionally BN-folded
by `fold_bn_inference`: a flat mapping of fepegar keys to tensors.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from ..ops import functional as F
from ..ops import packed as P
from ..parallel import sharding as _S

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


def _block_as(xp_aligned, sd: StateDict, block: str, w=None, addend=None):
    """ConvBlock as an aligned->shifted packed conv (B1) with bias, BN,
    PReLU and re-zeroed shifted pad voxels (B2) as its epilogue, one
    launch.  `w` replaces the block's conv weight (a slice of its input
    channels) and `addend`, the partial sum of the other slice, is added
    to the f32 sum first."""
    if w is None:
        w = sd[f"{block}.conv_layer.weight"]
    params = _epilogue_params(sd, block, sd.get(f"{block}.conv_layer.bias"),
                              w.shape[0], xp_aligned.device)
    return P.conv3_packed_as_bn_act(xp_aligned, P.pack_weights2_as(w),
                                    *params, addend=addend)


def _block_sa(xs, sd: StateDict, block: str):
    """ConvBlock as a shifted->aligned packed conv (B1, bias fused) + BN
    and PReLU."""
    y = P.conv3_packed(xs, P.pack_weights2(sd[f"{block}.conv_layer.weight"]),
                       sd.get(f"{block}.conv_layer.bias"))
    return _bn_act(y, sd, block)


def _decoder_conv1(xp, skip, sd: StateDict, block: str):
    """First conv of a decoding block, conv(cat(skip, up(xp))), split over
    its input channels: an aligned->shifted conv of the skip stores its
    partial sum (B1), and the conv of the explicitly upsampled input adds
    it to its own f32 sum in the B2 epilogue (B1 + B2, one launch)."""
    w = sd[f"{block}.conv_layer.weight"]
    c_skip = skip.shape[-1] // 8
    partial = P.conv3_packed_as(skip, P.pack_weights2_as(w[:, :c_skip]))
    return _block_as(P.upsample2_packed(xp), sd, block, w=w[:, c_skip:],
                     addend=partial)


def _trunk_v2(sd: StateDict, x: torch.Tensor, num_encoding_blocks: int = 3,
              tap=None):
    """Fine (N, S, S, S, 1) input -> the head's ALIGNED packed output.

    `tap(name, tensor) -> tensor` is an optional identity hook called at
    every conv-input site (the int8 calibration of `models/unet_packed_q.py`
    records each site's absolute maxima through it), as in JAX's
    `_trunk_v2`.  The sites here are those of the explicit decoder, which
    equal JAX's composed ones up to float rounding."""
    nb = num_encoding_blocks
    t = (lambda name, v: v) if tap is None else tap
    xp = t("in", P.pack2(x))
    skips = []
    for i in range(nb - 1):
        blk = f"encoder.encoding_blocks.{i}"
        xs = t(f"e{i}c1", _block_as(xp, sd, f"{blk}.conv1"))
        xp = t(f"e{i}c2", _block_sa(xs, sd, f"{blk}.conv2"))
        skips.append(xp)
        xp = P.maxpool2_packed(xp)

    xs = t("bc1", _block_as(xp, sd, "bottom_block.conv1"))
    xp = t("bc2", _block_sa(xs, sd, "bottom_block.conv2"))

    for i in range(nb - 1):
        blk = f"decoder.decoding_blocks.{i}"
        xs = t(f"d{i}c1", _decoder_conv1(xp, skips[-(i + 1)], sd,
                                         f"{blk}.conv1"))
        xp = t(f"d{i}c2", _block_sa(xs, sd, f"{blk}.conv2"))

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


# ---------------------------------------------------------------------------
# training in packed layout
#
# BatchNorm batch statistics are computed exactly as the fine layout would:
# per-fine-channel sums fold the 8 sub-position blocks, and shifted tensors
# have their pad voxels (fine -1 / S) zeroed, so they add nothing to the
# sums and only the N*S^3 real voxels divide them.
# ---------------------------------------------------------------------------


def _bn_train_packed(y, bn, block: str = "", *, valid: float,
                     momentum: float = 0.1, eps: float = 1e-5, owned=None):
    """Normalize packed `y` (pad voxels zeroed, or aligned) with its own
    fine-exact batch statistics: one pass of float32 sums E[x] and E[x^2],
    var = max(E[x^2] - E[x]^2, 0), `valid` = N*S^3 fine voxels per
    channel; normalized in y's dtype.  Zeroed pad voxels add nothing to
    either sum, so only `valid` divides them.  No model runs it: it is
    the plain composition that `ops/packed.py::BnActTrainPacked` replaced,
    kept for the tests that hold the Function to it.

    `bn` is the UNet's state dict, with `block` the ConvBlock whose
    `norm_layer` normalizes, or an `nn.BatchNorm3d`, whose own momentum
    and eps then apply.  Returns (normalized y, the new running statistics
    as new tensors, keyed like the state dict or, for a module, like its
    buffers), as the JAX package's `models/unet_packed.py::
    _bn_train_packed`.

    Under a mesh `valid` counts this rank's voxels; s1, s2 and the count
    are summed over the ranks, so the statistics are the global batch's.
    `owned` (default y) is the part of y whose voxels this rank counts: a
    shifted slab leaves out the cell it shares with the next rank."""
    if isinstance(bn, nn.BatchNorm3d):
        prefix, momentum, eps = "", bn.momentum, bn.eps
        gamma, beta, rm, rv = bn.weight, bn.bias, bn.running_mean, \
            bn.running_var
    else:
        prefix = f"{block}.norm_layer."
        gamma, beta, rm, rv = (bn[prefix + k] for k in (
            "weight", "bias", "running_mean", "running_var"))
    c = y.shape[-1] // 8
    yf = (y if owned is None else owned).float()
    s1 = yf.sum(dim=(0, 1, 2, 3)).reshape(8, c).sum(0)
    s2 = yf.square().sum(dim=(0, 1, 2, 3)).reshape(8, c).sum(0)
    mesh = _S.current_mesh()
    if mesh is not None:
        over = _S.sharded_axes(y)
        s1, s2 = _S.all_reduce(s1, over), _S.all_reduce(s2, over)
        valid = valid * _S.shard_count(mesh, over)
    mean = s1 / valid
    # f32 cancellation can round E[x^2]-E[x]^2 slightly negative for a
    # near-constant channel with a large mean; rsqrt(var+eps) would NaN
    var = torch.clamp_min(s2 / valid - mean * mean, 0.0)
    out = F.batch_norm(y, P.tile_channel_param(mean),
                       P.tile_channel_param(var),
                       P.tile_channel_param(gamma),
                       P.tile_channel_param(beta), eps)
    rm, rv = F.update_running_stats(rm, rv, mean, var, valid, momentum)
    return out, {f"{prefix}running_mean": rm, f"{prefix}running_var": rv}


def _block_train(y, sd: StateDict, block: str, *, shifted: bool,
                 valid: float):
    """Train-mode tail of a ConvBlock whose conv output is `y` (shifted or
    aligned packed): zero the pads, BN with batch statistics, PReLU, zero
    the pads again, as one `ops/packed.py::BnActTrainPacked` (four
    hand-written passes on CUDA).  Returns (activated y, new running
    statistics).  Under a spatial mesh a shifted slab's last cell is
    counted by the next rank, unless this rank holds the volume's last
    face."""
    norm = f"{block}.norm_layer."
    gamma = sd.get(norm + "weight")
    running = (None if gamma is None else
               (sd[norm + "running_mean"], sd[norm + "running_var"]))
    y, new = P.bn_act_train_packed(
        y, gamma, sd.get(norm + "bias"),
        sd.get(f"{block}.activation_layer.weight"), running,
        shifted=shifted, valid=valid)
    if new is None:
        return y, {}
    return y, {norm + "running_mean": new[0], norm + "running_var": new[1]}


def packed_unet_train_apply(state_dict: StateDict, x: torch.Tensor,
                            num_encoding_blocks: int = 3):
    """Train-mode packed forward: fine (N, S, S, S, 1) -> (packed logits
    (N, S/2, S/2, S/2, 8 out_classes), new running statistics keyed like
    the state dict), matching `UNet3D(...).train()(x)` (BN normalizes with
    the batch statistics; the running ones come back as new tensors, the
    caller stores them).  Differentiable in every parameter of
    `state_dict` (pass `model.state_dict(keep_vars=True)`).

    Every 3x3x3 conv is a B1 launch (12 at num_encoding_blocks=3, none
    with the B2 epilogue: BN needs the batch statistics of the conv's
    output), every input gradient but the stem's another (11).  The
    decoder's first conv is the sum of an aligned->shifted conv of the
    skip and of the up branch: `upsample2_packed`, then an
    aligned->shifted B1 conv with the up half of the weights."""
    sd = state_dict
    nb = num_encoding_blocks
    n = x.shape[0]
    # this rank's fine voxels per sample at full scale (D is its slab);
    # each pooling divides them by 8
    s = x.shape[1] * x.shape[2] * x.shape[3]

    def conv_as(xp, block, w=None, bias=True):
        w = sd[f"{block}.conv_layer.weight"] if w is None else w
        b = sd.get(f"{block}.conv_layer.bias") if bias else None
        return P.conv3_packed_as(xp, P.pack_weights2_as(w), b)

    def conv_sa(xs, block):
        return P.conv3_packed(xs, P.pack_weights2(
            sd[f"{block}.conv_layer.weight"]),
            sd.get(f"{block}.conv_layer.bias"))

    def tail(y_s, blk, s):
        valid = float(n) * s
        y, st1 = _block_train(y_s, sd, f"{blk}.conv1", shifted=True,
                              valid=valid)
        out, st2 = _block_train(conv_sa(y, f"{blk}.conv2"), sd,
                                f"{blk}.conv2", shifted=False, valid=valid)
        return out, {**st1, **st2}

    def double_block(xp, blk, s):
        return tail(conv_as(xp, f"{blk}.conv1"), blk, s)

    def dec_block(xp, skip, blk, s):
        w = sd[f"{blk}.conv1.conv_layer.weight"]
        c_skip = skip.shape[-1] // 8
        y_s = conv_as(skip, f"{blk}.conv1", w[:, :c_skip])
        y_u = conv_as(P.upsample2_packed(xp), f"{blk}.conv1", w[:, c_skip:],
                      bias=False)
        return tail(y_s + y_u, blk, s)

    new_stats = {}
    xp = P.pack2(x)
    skips = []
    for i in range(nb - 1):
        xp, st = double_block(xp, f"encoder.encoding_blocks.{i}", s)
        new_stats.update(st)
        skips.append(xp)
        xp = P.maxpool2_packed(xp)
        s //= 8
    xp, st = double_block(xp, "bottom_block", s)
    new_stats.update(st)
    for i in range(nb - 1):
        s *= 8
        xp, st = dec_block(xp, skips[-(i + 1)],
                           f"decoder.decoding_blocks.{i}", s)
        new_stats.update(st)
    yp = P.conv1_packed_blockdiag(xp, sd["classifier.conv_layer.weight"],
                                  sd.get("classifier.conv_layer.bias"))
    return yp, new_stats


def packed_dice_loss(logits_packed: torch.Tensor,
                     targets_fine: torch.Tensor) -> torch.Tensor:
    """Soft dice loss from packed logits (N, S/2, S/2, S/2, 8 C) and fine
    targets (N, S, S, S, 1): the softmax runs over the class channels of
    each sub-position, and the sub-position axis is folded into a spatial
    axis (dice is a voxel sum, so the layout does not matter as long as
    probabilities and targets align; the targets are packed with `pack2`).
    Binary (0/1 float) targets for out_classes == 2, integer class labels
    otherwise.  Mean over batch and classes (the global batch's, and
    sums over the whole volume, under a mesh)."""
    from ..metrics.dice import get_dice_loss

    n, d2, h2, w2, c8 = logits_packed.shape
    co = c8 // 8
    probs = torch.softmax(logits_packed.reshape(n, d2, h2, w2, 8, co), -1)
    probs = probs.reshape(n, d2, h2, w2 * 8, co)
    tp = P.pack2(targets_fine.float()).reshape(n, d2, h2, w2 * 8, 1)
    if co == 2:
        onehot = torch.cat([1.0 - tp, tp], dim=-1)
    else:
        onehot = torch.nn.functional.one_hot(
            tp[..., 0].long(), co).to(probs.dtype)
    return _S.global_mean(get_dice_loss(probs, onehot,
                                        spatial_dimensions=(1, 2, 3)))
