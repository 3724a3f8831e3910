"""Whole-volume classification CNNs (counterpart of the JAX package's
`models/cnn.py`): VoxResNet (3-D ResNet), CNN (VGG-like 3-D feature
extractor), ConvLSTM (CNN per frame with an LSTM head, for 4-D fMRI) and
DilatedCNN (the classification baseline on 180^3 volumes,
`baseline_sample_classification.ipynb`).

Activations are channels-last `(N, D, H, W, C)`; Flatten takes torch's
(N, C, D, H, W) element order, so the reference's Linear weights line up.
Submodules carry the reference's Sequential names (`model.conv3d_1.weight`,
`model.block_1.bn1.running_mean`, `lstm.weight_ih_l0`, ...), the keys that
`interop.variables_to_state_dict` gives for the JAX package's variables.

The convolutions are dense or dilated 3-D convs, which the JAX package
leaves to XLA: here they are `torch.nn.functional.conv3d` (cuDNN on the
card), not kernels of the port.  BatchNorm and Dropout follow
`ops/functional.py`'s `module_batch_norm` and `dropout`: batch statistics
and torch's running update in train mode, Dropout's mask drawn from the
`generator` passed to `forward`.

Kept from the reference, as the JAX package keeps them:
- VoxResNet registers `activation_6` twice when n_blocks >= 4, so there is
  no activation after `fully_conn_1` then;
- DilatedCNN ends in a softmax inside the model, and the trainer's cross
  entropy is taken on top of it;
- the LSTM's gates are ordered i, f, g, o (torch's `nn.LSTM`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..ops import functional as F


def _conv(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """A dense or dilated nn.Conv3d on channels-last x, its weight and bias
    cast to x's dtype (JAX casts conv weights to x.dtype)."""
    return F.conv3d(x, conv.weight, conv.bias, stride=conv.stride,
                    padding=conv.padding, dilation=conv.dilation)


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.dense(x, lin.weight, lin.bias)


def _flatten_torch_order(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3).reshape(x.shape[0], -1)


def _conv_bn(c_in: int, c_out: int, device, **kw):
    return (nn.Conv3d(c_in, c_out, 3, device=device, **kw),
            nn.BatchNorm3d(c_out, device=device))


class BasicBlock(nn.Module):
    """3-D residual block: conv-bn-relu-conv-bn + identity, relu."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = nn.Conv3d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False, device=device)
        self.bn1 = nn.BatchNorm3d(planes, device=device)
        self.conv2 = nn.Conv3d(planes, planes, 3, padding=1, bias=False,
                               device=device)
        self.bn2 = nn.BatchNorm3d(planes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(F.module_batch_norm(self.bn1, _conv(self.conv1, x)))
        out = F.module_batch_norm(self.bn2, _conv(self.conv2, out))
        return F.relu(out + x)


class VoxResNet(nn.Module):
    """3-D ResNet classifier (reference `VoxResNet`); returns logits."""

    def __init__(self, input_shape: Sequence[int] = (128, 128, 128),
                 num_classes: int = 2, n_filters: int = 32, stride: int = 2,
                 n_blocks: int = 3, n_flatten_units: Optional[int] = None,
                 dropout: float = 0.0, n_fc_units: int = 128, device=None):
        super().__init__()
        device = resolve_device(device)
        nf = n_filters
        self.n_blocks, self.dropout = n_blocks, dropout
        layers = [("conv3d_1", nn.Conv3d(1, nf, 3, stride=stride, padding=1,
                                         device=device)),
                  ("batch_norm_1", nn.BatchNorm3d(nf, device=device)),
                  ("conv3d_2", nn.Conv3d(nf, nf, 3, padding=1,
                                         device=device)),
                  ("batch_norm_2", nn.BatchNorm3d(nf, device=device))]
        # stage i: a stride-2 conv, two residual blocks, BN
        widths = [(nf, 2 * nf), (2 * nf, 2 * nf), (2 * nf, 4 * nf),
                  (4 * nf, 4 * nf)]
        self.stages = min(max(n_blocks, 1), 4)   # the first stage always
        for i in range(self.stages):
            c_in, c_out = widths[i]
            layers += [
                (f"conv3d_{i + 3}", nn.Conv3d(c_in, c_out, 3, stride=2,
                                              padding=1, device=device)),
                (f"block_{2 * i + 1}", BasicBlock(c_out, c_out,
                                                  device=device)),
                (f"block_{2 * i + 2}", BasicBlock(c_out, c_out,
                                                  device=device)),
                (f"batch_norm_{i + 3}", nn.BatchNorm3d(c_out, device=device))]
        if n_flatten_units is None:
            n_flatten_units = 4 * nf * int(np.prod(
                np.array(input_shape) // (2 ** n_blocks * stride)))
        layers += [("fully_conn_1", nn.Linear(n_flatten_units, n_fc_units,
                                              device=device)),
                   ("fully_conn_2", nn.Linear(n_fc_units, num_classes,
                                              device=device))]
        self.model = nn.ModuleDict(OrderedDict(layers))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        m = self.model
        for i in (1, 2):
            x = F.relu(F.module_batch_norm(m[f"batch_norm_{i}"],
                                           _conv(m[f"conv3d_{i}"], x)))
        for i in range(self.stages):
            x = _conv(m[f"conv3d_{i + 3}"], x)
            x = m[f"block_{2 * i + 2}"](m[f"block_{2 * i + 1}"](x))
            x = F.relu(F.module_batch_norm(m[f"batch_norm_{i + 3}"], x))
        x = _linear(m["fully_conn_1"], _flatten_torch_order(x))
        if self.n_blocks < 4:   # the duplicated `activation_6`
            x = F.relu(x)
        x = F.dropout(x, self.dropout, self.training, generator)
        return _linear(m["fully_conn_2"], x)


class CNN(nn.Module):
    """VGG-like 3-D feature extractor (reference `CNN`): returns the
    n_fc_units embedding after BatchNorm1d and ReLU, as in the reference,
    which puts an LSTM head on it (`ConvLSTM`)."""

    def __init__(self, input_shape: Sequence[int] = (64, 76, 48),
                 n_filters: int = 16, n_blocks: int = 3, stride: int = 1,
                 n_fc_units: int = 128, device=None):
        super().__init__()
        device = resolve_device(device)
        nf = n_filters
        self.n_blocks = n_blocks
        widths = [(1, nf), (nf, nf), (nf, 2 * nf), (2 * nf, 2 * nf),
                  (2 * nf, 4 * nf), (4 * nf, 4 * nf), (4 * nf, 8 * nf),
                  (8 * nf, 8 * nf)]
        layers = []
        for i, (c_in, c_out) in enumerate(widths[:2 * n_blocks], start=1):
            conv, bn = _conv_bn(c_in, c_out, device, padding=1,
                                stride=stride if i == 1 else 1)
            layers += [(f"conv3d_{i}", conv), (f"batch_norm_{i}", bn)]
        mult = {1: nf, 2: 2 * nf, 3: 4 * nf, 4: 8 * nf}[n_blocks]
        div = 2 ** n_blocks * stride
        n_flat = mult * int(np.prod([s // div for s in input_shape]))
        layers += [("fully_conn_1", nn.Linear(n_flat, n_fc_units,
                                              device=device)),
                   ("batch_norm_9", nn.BatchNorm1d(n_fc_units,
                                                   device=device))]
        self.model = nn.ModuleDict(OrderedDict(layers))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator  # no dropout
        m = self.model
        for i in range(1, 2 * self.n_blocks + 1):
            x = F.relu(F.module_batch_norm(m[f"batch_norm_{i}"],
                                           _conv(m[f"conv3d_{i}"], x)))
            if i % 2 == 0:
                x = F.maxpool3d(x, 2)
        x = _linear(m["fully_conn_1"], _flatten_torch_order(x))
        return F.relu(F.module_batch_norm(m["batch_norm_9"], x))


class LSTM(nn.LSTM):
    """Multi-layer LSTM with `nn.LSTM(batch_first=True)` semantics and
    parameters (`weight_ih_l{k}` (4H, in), gates i, f, g, o), zero initial
    state; returns the hidden state at every step, (N, T, H).  It computes
    in float32, as the JAX package's LSTM does for bf16 features (bf16
    times its float32 weights promotes to float32)."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 2, device=None):
        super().__init__(input_size, hidden_size, num_layers,
                         batch_first=True, device=resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())[0]


class ConvLSTM(nn.Module):
    """CNN per frame and an LSTM head for 4-D fMRI (reference `ConvLSTM`);
    input (N, T, D, H, W, C)."""

    def __init__(self, input_shape: Sequence[int] = (48, 64, 32),
                 n_outputs: int = 1, hidden_size: int = 128,
                 n_layers: int = 2, n_fc_units_rnn: int = 128,
                 dropout: float = 0.0, stride: int = 1, n_filters: int = 16,
                 n_blocks: int = 3, n_fc_units_cnn: int = 128, device=None):
        super().__init__()
        device = resolve_device(device)
        self.model = CNN(input_shape, n_filters, n_blocks, stride,
                         n_fc_units_cnn, device=device)
        self.lstm = LSTM(n_fc_units_cnn, hidden_size, n_layers,
                         device=device)
        self.fc1 = nn.Linear(hidden_size, n_fc_units_rnn, device=device)
        self.fc2 = nn.Linear(n_fc_units_rnn, n_outputs, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator  # `dropout` is not applied, as in the reference
        n, t = x.shape[:2]
        feats = self.model(x.reshape(n * t, *x.shape[2:]))
        out = self.lstm(feats.reshape(n, t, -1))
        out = F.relu(_linear(self.fc1, out[:, -1, :]))
        return _linear(self.fc2, out)


class DilatedCNN(nn.Module):
    """Dilated 3-D CNN classification baseline (reference `DilatedCNN`).
    Its last layer is a softmax, so it returns probabilities."""

    # (name, c_in multiple, c_out multiple, stride, padding): dilation 3
    _CONVS = (("conv3d_1", 0, 1, 2, 0), ("conv3d_2", 1, 1, 1, 3),
              ("conv3d_3", 1, 2, 2, 0), ("conv3d_4", 2, 2, 1, 3),
              ("conv3d_5", 2, 4, 1, 3), ("conv3d_6", 4, 4, 1, 0))

    def __init__(self, input_shape: Sequence[int] = (180, 180, 180),
                 n_channels: int = 32, device=None):
        super().__init__()
        device = resolve_device(device)
        nc = n_channels
        layers = []
        for i, (name, mi, mo, s, p) in enumerate(self._CONVS, start=1):
            conv, bn = _conv_bn(mi * nc if mi else 1, mo * nc, device,
                                stride=s, padding=p, dilation=3)
            layers += [(name, conv), (f"batch_norm_{i}", bn)]
        n_flat = 4 * nc * ((input_shape[0] - 61) // 16 - 5) ** 3
        layers += [("fully_conn_1", nn.Linear(n_flat, 256, device=device)),
                   ("fully_conn_2", nn.Linear(256, 128, device=device)),
                   ("fully_conn_3", nn.Linear(128, 2, device=device))]
        self.model = nn.ModuleDict(OrderedDict(layers))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator  # no dropout
        m = self.model
        for i in range(1, 7):
            x = F.leaky_relu(F.module_batch_norm(m[f"batch_norm_{i}"],
                                                 _conv(m[f"conv3d_{i}"], x)))
            if i in (2, 4):
                x = F.maxpool3d(x, 4, 2)
        x = _flatten_torch_order(x)
        x = F.leaky_relu(_linear(m["fully_conn_1"], x))
        x = F.leaky_relu(_linear(m["fully_conn_2"], x))
        return torch.softmax(_linear(m["fully_conn_3"], x), dim=-1)
