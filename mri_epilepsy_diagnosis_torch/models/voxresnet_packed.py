"""Packed-layout (space-to-depth) execution of VoxResNet: the eval and
train forward and the train step (counterpart of the JAX package's
`models/voxresnet_packed.py`).

The trunk of `models/cnn.py::VoxResNet` runs on the packed `(N, S/2, S/2,
S/2, 8C)` layout of `ops/packed.py`, from the same module and its
parameters, with every conv on kernel B1 (`conv2_packed`) at stride 2:
- the stem (k=3, stride 2) packs INTO the layout: `pack4` and one k=2
  pad-1 B1 launch emit the shifted packing of its output
  (`conv_input_packed_s2_p4`); at stride 1 the stem is one cuDNN conv
  (`conv_input_packed`);
- `conv3d_2` runs shifted -> aligned; each residual block alternates
  aligned -> shifted -> aligned (`conv3_packed_as` / `conv3_packed`), so
  the identity skip adds in the aligned layout;
- each downsample (k=3, stride 2) is aligned -> aligned at the next scale
  (`conv3s2_packed_aa`: one B1 launch over the low-padded input, then
  `pack2`);
- train-mode BatchNorm takes fine-exact batch statistics by folding the 8
  sub-positions (`models/unet_packed.py::_bn_train_packed`) and moves the
  running ones with torch's rule.
At stride 2 a train step launches B1 22 times forward (the stem,
`conv3d_2`, 4 downsamples and 16 block convs at n_blocks 4) and 21 times
for input gradients (all but the stem's, whose input takes none); the
weight gradients are `ops/packed.py::_dw_packed_qgroup`'s GEMMs.  In eval
mode the stem's and each block's first conv run BN, ReLU and the pad
zeroing as B1's B2 epilogue (`conv3_packed_as_bn_act`, slope 0, the conv
bias folded into the shift).

Dropout draws through `ops/functional.py::dropout` from the caller's
generator, as the fine `VoxResNet.forward` does, so for one generator
state the packed and the fine step draw the same mask (JAX's packed path
draws another mask than its fine one).  ReLU is `jnp.maximum(x, 0)`'s
(`F.maximum0`), as in JAX's packed forward.

Reference: classification/models/cnn_model.py:43-101 (VoxResNet).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops import functional as F
from ..ops import packed as P
from .cnn import VoxResNet, _flatten_torch_order, _linear
from .unet_packed import _bn_train_packed

_relu = F.maximum0


def _bn_packed(y: torch.Tensor, bn: nn.BatchNorm3d, *, train: bool,
               shifted: bool, fine_size: int, batch: int):
    """BatchNorm on a packed tensor (shifted or aligned).  Returns
    (normalized y, new running statistics keyed like bn's buffers, or None
    in eval mode).  Train mode zeroes shifted pad voxels first, so that
    they stay out of the batch statistics; eval mode is elementwise, so
    pads hold whatever the conv left there: callers re-zero after the
    activation."""
    if train:
        if shifted:
            y = P.zero_shifted_pads(y)
        valid = float(batch) * float(fine_size) ** 3
        pads = (float(batch) * 8.0 * (fine_size // 2 + 1) ** 3 - valid
                if shifted else 0.0)
        return _bn_train_packed(y, bn, valid=valid, pad_entries=pads)
    return P.batch_norm_packed(y, bn.running_mean, bn.running_var,
                               bn.weight, bn.bias, bn.eps), None


def _bn_relu_epilogue(bn: nn.BatchNorm3d, bias: Optional[torch.Tensor]):
    """Packed (8C,) float32 scale, shift and slope of eval BN + ReLU after
    a conv with `bias`: B2's epilogue with alpha 0, the bias folded into
    the shift."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    shift = bn.bias.float() - bn.running_mean.float() * scale
    if bias is not None:
        shift = shift + bias.float() * scale
    return (P.tile_channel_param(scale), P.tile_channel_param(shift),
            P.tile_channel_param(torch.zeros_like(scale)))


def _basic_block_packed(xp: torch.Tensor, block: nn.Module, *, train: bool,
                        fine_size: int, batch: int):
    """BasicBlock (conv-bn-relu-conv-bn + identity, relu) on ALIGNED packed
    input, returning (ALIGNED packed output, new running statistics keyed
    like the block's buffers; empty in eval mode)."""
    new = {}
    wp1 = P.pack_weights2_as(block.conv1.weight)
    if train:
        y = P.conv3_packed_as(xp, wp1)
        y, ns = _bn_packed(y, block.bn1, train=True, shifted=True,
                           fine_size=fine_size, batch=batch)
        new.update({f"bn1.{k}": v for k, v in ns.items()})
        y = P.zero_shifted_pads(_relu(y))
    else:
        y = P.conv3_packed_as_bn_act(xp, wp1,
                                     *_bn_relu_epilogue(block.bn1, None))
    y = P.conv3_packed(y, P.pack_weights2(block.conv2.weight))
    y, ns = _bn_packed(y, block.bn2, train=train, shifted=False,
                       fine_size=fine_size, batch=batch)
    if ns is not None:
        new.update({f"bn2.{k}": v for k, v in ns.items()})
    return _relu(y + xp), new


def voxresnet_apply_packed(model: VoxResNet, x: torch.Tensor, *,
                           train: bool = False,
                           generator: Optional[torch.Generator] = None):
    """Packed-layout forward of `models.cnn.VoxResNet`.

    model: the VoxResNet (configuration and parameters; its train/eval
    mode is not read: `train` decides).  x: fine (N, S, S, S, 1); S /
    stride must be divisible by 2^(stages + 1), so that the packed cells
    stay even at every scale.  generator: the Dropout mask's, as for
    `model(x, generator)`.
    Returns (logits (N, num_classes), the new running statistics keyed
    like `model.state_dict()` when train, else None); differentiable in
    the model's parameters."""
    m = model.model
    stride = m["conv3d_1"].stride[0]
    if stride not in (1, 2):
        raise ValueError(f"packed VoxResNet supports stride 1 or 2, got "
                         f"{stride}")
    n, s = x.shape[0], x.shape[1]
    if s % stride or (s // stride) % 2 ** (model.stages + 1):
        raise ValueError(f"packed VoxResNet needs S / stride divisible by "
                         f"{2 ** (model.stages + 1)}; got S = {s}")
    new_stats: Dict[str, torch.Tensor] = {}

    def bn(y, name, *, shifted, fine_size):
        out, ns = _bn_packed(y, m[name], train=train, shifted=shifted,
                             fine_size=fine_size, batch=n)
        if ns is not None:
            new_stats.update({f"model.{name}.{k}": v for k, v in ns.items()})
        return out

    def block(xp, name, fine_size):
        out, ns = _basic_block_packed(xp, m[name], train=train,
                                      fine_size=fine_size, batch=n)
        new_stats.update({f"model.{name}.{k}": v for k, v in ns.items()})
        return out

    # ---- stem: fine input -> SHIFTED packing
    c1 = m["conv3d_1"]
    f = s // stride
    if stride == 2 and not train:
        y = P.conv3_packed_as_bn_act(
            P.pack4(x), P.pack_input_weights_s2_p4(c1.weight),
            *_bn_relu_epilogue(m["batch_norm_1"], c1.bias))
    else:
        if stride == 2:
            y = P.conv_input_packed_s2_p4(
                x, P.pack_input_weights_s2_p4(c1.weight), c1.bias)
        else:
            y = P.conv_input_packed(x, P.pack_input_weights(c1.weight),
                                    c1.bias)
        y = bn(y, "batch_norm_1", shifted=True, fine_size=f)
        y = P.zero_shifted_pads(_relu(y))
    c2 = m["conv3d_2"]
    xp = P.conv3_packed(y, P.pack_weights2(c2.weight), c2.bias)
    xp = _relu(bn(xp, "batch_norm_2", shifted=False, fine_size=f))

    # ---- stages: downsample (aligned -> aligned), 2 blocks, stage BN
    for i in range(model.stages):
        conv = m[f"conv3d_{i + 3}"]
        xp = P.conv3s2_packed_aa(xp, P.pack_weights2_s2(conv.weight),
                                 conv.bias)
        f //= 2
        xp = block(xp, f"block_{2 * i + 1}", f)
        xp = block(xp, f"block_{2 * i + 2}", f)
        xp = _relu(bn(xp, f"batch_norm_{i + 3}", shifted=False,
                      fine_size=f))

    # ---- head (f^3 voxels): back to fine, torch flatten order
    h = _linear(m["fully_conn_1"], _flatten_torch_order(P.unpack2(xp)))
    if model.n_blocks < 4:
        # the reference registers `activation_6` twice for n_blocks >= 4,
        # so there is no activation after fully_conn_1 there
        h = _relu(h)
    h = F.dropout(h, model.dropout, train, generator)
    logits = _linear(m["fully_conn_2"], h)
    return logits, (new_stats if train else None)


def voxresnet_class_step_packed(state, x: torch.Tensor, y: torch.Tensor,
                                generator: Optional[torch.Generator], *,
                                model: Optional[VoxResNet] = None):
    """`train.classification._class_step` (train mode) through the packed
    forward: cross entropy on the logits, backward, the optimizer's step,
    then the new running statistics stored in the model's buffers
    (`num_batches_tracked` counted).  `model` is `state.model`, the
    default.  Returns (state, loss, softmax probabilities), both detached,
    the contract of `_class_step`."""
    from ..train.classification import cross_entropy
    from ..train.seg import _store_running_stats

    model = state.model if model is None else model
    if model is not state.model:
        raise ValueError("model must be the state's model")
    model.train(True)
    logits, stats = voxresnet_apply_packed(model, x, train=True,
                                           generator=generator)
    loss = cross_entropy(logits, y)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    _store_running_stats(model, stats)
    return (state, loss.detach(),
            torch.softmax(logits.detach().float(), dim=-1))
