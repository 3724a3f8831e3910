"""Fader-network family: separable-conv autoencoder, encoder, decoder,
domain discriminator and FCD classifier, in eval and train mode
(counterpart of the JAX package's `models/fader.py`).

Every conv of a block is separable, (k,1,1) then (1,k,1) then (1,1,k), and
each stack of three is one call of `ops/cuda_kernels.py::separable_conv3d`
(kernel B3, the three axes fused into one launch) with the torch weights
(O, I, k, 1, 1) viewed as (k, I, O) and the biases fused, through
`SeparableConv3dFn`, whose backward runs B3's gradient kernels
(`conv_axis_dx`, `conv_axis_dw`) where autograd records.  Only the
dense convs that the JAX package leaves to XLA (the `reduce_size` 4^3/s4
stem, `Decoder.vox`, the `transpose_conv` up mode) run as
`torch.nn.functional` convs.

The kwargs schemas are the reference's (`down_block_kwargs`,
`up_block_kwargs`, `ae_kwargs`, `discriminator_kwargs`,
`classificator_kwargs` of `train_AE.ipynb` cell 8 and `train_ENC_CLF.ipynb`
cell 17), and submodules carry the names of the reference checkpoints
(`classification/{encoder,clf,disc}_93_6_4.pth`): `encode.0.block.
1_convx.weight`, `clf.5_l1.weight`, `clf.6_batch_norm.running_mean`, ...
so the bridged JAX variables and those checkpoints load with
`load_state_dict(strict=True)`.

Activations are channels-last `(N, D, H, W, C)`.  In eval mode BatchNorm
runs on its running statistics and Dropout is the identity; in train mode
BatchNorm normalizes with the batch's statistics and moves the running
ones with torch's momentum (`ops/functional.py::module_batch_norm`), and
the heads' Dropout draws its mask from the `generator` passed to their
forward (torch's global generator if None).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as TF
from torch import nn

from ..core.device import resolve_device
from ..ops import cuda_kernels as K
from ..ops import functional as F


def _separable_convs(c_in: int, c_out: int, k: int, s: int, p: int,
                     names: Sequence[str], device) -> list:
    """The named (k,1,1) / (1,k,1) / (1,1,k) nn.Conv3d factors, each with
    its stride and pad on its own axis."""
    out = []
    for axis, (name, ci) in enumerate(zip(names, (c_in, c_out, c_out))):
        shape, stride, pad = [1, 1, 1], [1, 1, 1], [0, 0, 0]
        shape[axis], stride[axis], pad[axis] = k, s, p
        out.append((name, nn.Conv3d(ci, c_out, tuple(shape),
                                    stride=tuple(stride),
                                    padding=tuple(pad), device=device)))
    return out


def _separable_conv(convs: Sequence[nn.Conv3d],
                    x: torch.Tensor) -> torch.Tensor:
    """One B3 call for the stack, conv `i` along spatial axis i + 1, each
    with the (O, I, k, 1, 1)-style weight viewed as (k, I, O) in the
    activations' dtype (JAX casts conv weights to x.dtype) and its bias
    fused, through `SeparableConv3dFn` (the fused forward; B3's backward
    where autograd records)."""
    ws = []
    for conv in convs:
        w = conv.weight.to(x.dtype)
        ws.append(w.reshape(w.shape[0], w.shape[1], -1).permute(2, 1, 0))
    stride = tuple(c.stride[a] for a, c in enumerate(convs))
    pad = tuple(c.padding[a] for a, c in enumerate(convs))
    biases = tuple(c.bias for c in convs)
    return K.SeparableConv3dFn.apply(x, *ws, *biases, stride, pad)


def _dense_conv(conv: nn.Module, x: torch.Tensor, *,
                transpose: bool = False) -> torch.Tensor:
    """A dense nn.Conv3d / nn.ConvTranspose3d on channels-last x."""
    fn = TF.conv_transpose3d if transpose else TF.conv3d
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = fn(x.permute(0, 4, 1, 2, 3), conv.weight.to(x.dtype), bias,
           stride=conv.stride, padding=conv.padding)
    return y.permute(0, 2, 3, 4, 1)


def _flatten_torch_order(x: torch.Tensor) -> torch.Tensor:
    """Flatten (N,D,H,W,C) in torch's (N,C,D,H,W) element order so imported
    Linear weights line up."""
    n = x.shape[0]
    return x.permute(0, 4, 1, 2, 3).reshape(n, -1)


class DownBlock(nn.Module):
    """separable conv x3 -> maxpool -> [BN] -> act.  Returns (y, pre-pool
    spatial shape)."""

    def __init__(self, c_in: int, c_out: int, conv_k: int = 3,
                 conv_s: int = 1, conv_pad: int = 1, maxpool_k: int = 2,
                 maxpool_s: int = 2, batch_norm: bool = True,
                 act: str = "relu", device=None):
        super().__init__()
        self.maxpool_k, self.maxpool_s = maxpool_k, maxpool_s
        self.act = act
        layers = _separable_convs(c_in, c_out, conv_k, conv_s, conv_pad,
                                  ("1_convx", "2_convy", "3_convz"), device)
        if batch_norm:
            layers.append(("5_batch_norm",
                           nn.BatchNorm3d(c_out, device=device)))
        self.block = nn.ModuleDict(OrderedDict(layers))

    def pre_norm(self, x: torch.Tensor):
        """The separable convs and the max pool: (pooled, pre-pool shape)."""
        b = self.block
        x = _separable_conv((b["1_convx"], b["2_convy"], b["3_convz"]), x)
        shape_before_pool = tuple(x.shape[1:4])
        x = F.maxpool3d(x, self.maxpool_k, self.maxpool_s)
        return x, shape_before_pool

    def forward(self, x: torch.Tensor):
        x, shape_before_pool = self.pre_norm(x)
        if "5_batch_norm" in self.block:
            x = F.module_batch_norm(self.block["5_batch_norm"], x)
        return F.activation(self.act)(x), shape_before_pool


class UpBlock(nn.Module):
    """upsample (nearest/linear or transpose conv) -> odd-size fixup ->
    separable conv x3 -> [BN] -> act."""

    def __init__(self, c_in: int, c_out: int, up: str = "upsample",
                 scale: int = 2, scale_mode: str = "nearest",
                 t_conv_pad: int = 0, conv_k: int = 3, conv_s: int = 1,
                 conv_pad: int = 1, batch_norm: bool = True,
                 act: str = "relu", device=None):
        super().__init__()
        self.up, self.scale, self.scale_mode = up, scale, scale_mode
        self.act = act
        layers = []
        if up == "transpose_conv":
            layers.append(("1_upsample", nn.ConvTranspose3d(
                c_in, c_out, scale, stride=scale, padding=t_conv_pad,
                device=device)))
        # the reference declares 2_convx with in_channels=c_in even after a
        # transpose conv has mapped channels to c_out; as in the JAX
        # package, take the channels that arrive (the same for 'upsample',
        # the only mode the reference runs)
        c2_in = c_out if up == "transpose_conv" else c_in
        layers += _separable_convs(c2_in, c_out, conv_k, conv_s, conv_pad,
                                   ("2_convx", "3_convy", "4_convz"), device)
        if batch_norm:
            layers.append(("5_batch_norm",
                           nn.BatchNorm3d(c_out, device=device)))
        self.block = nn.ModuleDict(OrderedDict(layers))

    def forward(self, x: torch.Tensor, shape_before_pool=None):
        b = self.block
        if self.up == "transpose_conv":
            x = _dense_conv(b["1_upsample"], x, transpose=True)
        else:
            out_sp = tuple(self.scale * s for s in x.shape[1:4])
            if self.scale_mode == "nearest":
                x = F.resize_nearest(x, out_sp)
            else:
                x = F.resize_linear(x, out_sp, align_corners=False)
        if shape_before_pool is not None and any(
                t > c for t, c in zip(shape_before_pool, x.shape[1:4])):
            # reference fixup: F.interpolate(x, shape_before_pool), nearest
            x = F.resize_nearest(x, shape_before_pool)
        x = _separable_conv((b["2_convx"], b["3_convy"], b["4_convz"]), x)
        if "5_batch_norm" in b:
            x = F.module_batch_norm(b["5_batch_norm"], x)
        return F.activation(self.act)(x)


class Encoder(nn.Module):
    """Stack of DownBlocks; returns (latent, size_list)."""

    def __init__(self, deapth: int, chanels: Sequence[int],
                 down_block_kwargs: Dict[str, Any], reduce_size: bool = False,
                 skip_map: Optional[Sequence[bool]] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.reduce_size = reduce_size
        blocks = []
        if reduce_size:
            blocks.append(nn.Conv3d(1, 1, 4, stride=4, device=device))
        blocks += [DownBlock(chanels[i], chanels[i + 1], device=device,
                             **down_block_kwargs) for i in range(deapth)]
        self.encode = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor):
        size_list = []
        for i, blk in enumerate(self.encode):
            if i == 0 and self.reduce_size:
                x = _dense_conv(blk, x)
                continue
            x, size = blk(x)
            size_list.append(size)
        return x, size_list


class Decoder(nn.Module):
    """Stack of UpBlocks over the reversed channel list, then the dense
    `vox` conv (1 -> 1, 3^3)."""

    def __init__(self, deapth: int, chanels: Sequence[int],
                 up_block_kwargs: Dict[str, Any], reduce_size: bool = False,
                 skip_map: Optional[Sequence[bool]] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.deapth, self.reduce_size = deapth, reduce_size
        blocks = [UpBlock(chanels[i], chanels[i + 1], device=device,
                          **up_block_kwargs) for i in range(deapth)]
        if reduce_size:
            blocks.append(nn.ConvTranspose3d(1, 1, 4, stride=4,
                                             device=device))
        self.decode = nn.ModuleList(blocks)
        self.vox = nn.Conv3d(1, 1, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor, size_list):
        sizes = list(size_list)[::-1]
        for i in range(self.deapth):
            x = self.decode[i](x, sizes[i])
        if self.reduce_size:
            x = _dense_conv(self.decode[self.deapth], x, transpose=True)
        return _dense_conv(self.vox, x)


def _build_channels(c_in: int, c_base: int, inc_size: int, deapth: int):
    chanels = [c_in]
    c = c_base
    for _ in range(deapth):
        chanels.append(c)
        c = inc_size * c
    return chanels


class AE(nn.Module):
    """Autoencoder; the reference's `ae_kwargs` schema."""

    def __init__(self, c_in: int = 1, deapth: int = 3, c_base: int = 8,
                 inc_size: int = 2, is_skip: bool = False,
                 skip_map: Optional[Sequence[bool]] = None,
                 reduce_size: bool = False,
                 down_block_kwargs: Optional[Dict[str, Any]] = None,
                 up_block_kwargs: Optional[Dict[str, Any]] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        chanels = _build_channels(c_in, c_base, inc_size, deapth)
        self.enc = Encoder(deapth, chanels, dict(down_block_kwargs or {}),
                           reduce_size=reduce_size, device=device)
        self.dec = Decoder(deapth, chanels[::-1], dict(up_block_kwargs or {}),
                           reduce_size=reduce_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z, size_list = self.enc(x)
        return self.dec(z, size_list)

    def encode(self, x: torch.Tensor):
        return self.enc(x)


def make_encoder(ae_kwargs: Dict[str, Any], device=None) -> Encoder:
    """Standalone encoder with the state-dict layout of
    `AE(**ae_kwargs).enc` in the reference (keys `encode.N....`)."""
    chanels = _build_channels(ae_kwargs["c_in"], ae_kwargs["c_base"],
                              ae_kwargs["inc_size"], ae_kwargs["deapth"])
    return Encoder(ae_kwargs["deapth"], chanels,
                   dict(ae_kwargs["down_block_kwargs"]),
                   reduce_size=ae_kwargs.get("reduce_size", False),
                   device=device)


def _head_layers(c_in, c_out, conv_k, conv_s, conv_pad, l_in, l_out,
                 n_final, batch_norm, device) -> nn.ModuleDict:
    layers = _separable_convs(c_in, c_out, conv_k, conv_s, conv_pad,
                              ("1_convx", "2_convy", "3_convz"), device)
    layers.append(("5_l1", nn.Linear(l_in, l_out, device=device)))
    if batch_norm:
        layers.append(("6_batch_norm", nn.BatchNorm1d(l_out, device=device)))
    layers.append(("9_l_f", nn.Linear(l_out, n_final, device=device)))
    return nn.ModuleDict(OrderedDict(layers))


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return TF.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _conv_head_features(head: nn.ModuleDict,
                        x: torch.Tensor) -> torch.Tensor:
    """Separable convs, torch-order flatten, first Linear (pre-BN)."""
    x = _separable_conv((head["1_convx"], head["2_convy"], head["3_convz"]),
                        x)
    return _linear(head["5_l1"], _flatten_torch_order(x))


def _conv_head(head: nn.ModuleDict, x: torch.Tensor, act: str,
               p_drop: float, training: bool,
               generator: Optional[torch.Generator]):
    """Shared Discriminator/Classificator body.  Returns (logits, hidden),
    hidden = the post-dropout embedding of the reference's t-SNE analysis
    (`train_ENC_CLF.ipynb` cells 26/28); dropout is the identity in eval."""
    x = _conv_head_features(head, x)
    if "6_batch_norm" in head:
        x = F.module_batch_norm(head["6_batch_norm"], x)
    hidden = F.dropout(F.activation(act)(x), p_drop, training, generator)
    return _linear(head["9_l_f"], hidden), hidden


class _ConvHead(nn.Module):
    """Conv head of `prefix` (`clf` or `disc`): separable conv x3 ->
    flatten -> Linear -> [BN] -> act -> dropout -> Linear."""
    prefix = ""

    def __init__(self, c_in: int, c_out: int, conv_k: int, conv_s: int,
                 conv_pad: int, l_in: int, l_out: int, n_final: int,
                 batch_norm: bool = True, act: str = "relu",
                 p_drop: float = 0.5, device=None):
        super().__init__()
        device = resolve_device(device)
        self.act, self.p_drop = act, p_drop
        self.add_module(self.prefix, _head_layers(
            c_in, c_out, conv_k, conv_s, conv_pad, l_in, l_out, n_final,
            batch_norm, device))

    @property
    def head(self) -> nn.ModuleDict:
        return getattr(self, self.prefix)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The first Linear's output, before BN and the activation."""
        return _conv_head_features(self.head, x)

    def forward(self, x: torch.Tensor, return_hidden: bool = False,
                generator: Optional[torch.Generator] = None):
        """Logits (and the hidden embedding); in train mode the dropout
        mask comes from `generator`."""
        logits, hidden = _conv_head(self.head, x, self.act, self.p_drop,
                                    self.training, generator)
        return (logits, hidden) if return_hidden else logits


class Discriminator(_ConvHead):
    """Domain (scanner) discriminator; `discriminator_kwargs` schema."""
    prefix = "disc"

    def __init__(self, c_in: int, c_out: int, conv_k: int, conv_s: int,
                 conv_pad: int, l_in: int, l_out: int, n_domains: int,
                 batch_norm: bool = True, act: str = "relu",
                 p_drop: float = 0.5, device=None):
        super().__init__(c_in, c_out, conv_k, conv_s, conv_pad, l_in, l_out,
                         n_domains, batch_norm, act, p_drop, device)


class Classificator(_ConvHead):
    """FCD / no-FCD classifier head; `classificator_kwargs` schema."""
    prefix = "clf"

    def __init__(self, c_in: int, c_out: int, conv_k: int, conv_s: int,
                 conv_pad: int, l_in: int, l_out: int, n_class: int,
                 batch_norm: bool = True, act: str = "relu",
                 p_drop: float = 0.5, device=None):
        super().__init__(c_in, c_out, conv_k, conv_s, conv_pad, l_in, l_out,
                         n_class, batch_norm, act, p_drop, device)
