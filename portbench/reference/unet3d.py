"""Plain float32 reference of fepegar's UNet3D (`unet.UNet`, as the
segmentation notebooks build it), its soft dice loss and AdamW, in
channels-first `torch.nn.functional` calls with TF32 off.

It imports nothing of the program.  Parameters are a flat dict under the
names of the reference checkpoint (`encoder.encoding_blocks.0.conv1.
conv_layer.weight`, ...), so the benchmark can load the same tensors into
the program's model.  Train-mode BatchNorm normalizes with the batch's
biased variance and moves the running statistics with torch's momentum and
the unbiased variance; eval mode uses the running statistics.

`quant="fp8"` computes in float8 what the program computes in bf16: every
conv operand and every activation the forward makes is rounded to e4m3,
and the gradient flowing back through each of them to e5m2, scaled per
tensor by its largest magnitude: the control that a correct run must tell
apart from the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import precision


def blocks(cfg: dict) -> List[Tuple[str, int, int, int, bool, bool]]:
    """(name, c_in, c_out, kernel, batch norm, PReLU) of every ConvBlock in
    the order of the forward."""
    nb, oc = cfg["num_encoding_blocks"], cfg["out_channels_first_layer"]
    out, c = [], cfg["in_channels"]
    for i in range(nb - 1):
        name = f"encoder.encoding_blocks.{i}"
        c1, c2 = (oc, 2 * oc) if i == 0 else (c, 2 * c)
        out += [(f"{name}.conv1", c, c1, 3, i != 0, True),
                (f"{name}.conv2", c1, c2, 3, True, True)]
        c = c2
    out += [("bottom_block.conv1", c, c, 3, True, True),
            ("bottom_block.conv2", c, 2 * c, 3, True, True)]
    up = 2 * c
    for i in range(nb - 1):
        name = f"decoder.decoding_blocks.{i}"
        out += [(f"{name}.conv1", up + up // 2, up // 2, 3, True, True),
                (f"{name}.conv2", up // 2, up // 2, 3, True, True)]
        up //= 2
    out.append(("classifier", up, cfg["out_classes"], 1, False, False))
    return out


def make_weights(cfg: dict, gen: torch.Generator, device
                 ) -> Dict[str, torch.Tensor]:
    """Every parameter and BatchNorm buffer, float32: conv weights and
    biases U(+-1/sqrt(fan_in)) (torch's default bounds) from one draw of
    `gen`, PReLU slopes 0.25, BatchNorm affine (1, 0) and running
    statistics (0, 1)."""
    from ..lib.gen import uniform_leaves

    shapes, bounds, keys = [], [], []
    for name, ci, co, k, bn, act in blocks(cfg):
        for suffix, shape in (("weight", (co, ci, k, k, k)), ("bias", (co,))):
            keys.append(f"{name}.conv_layer.{suffix}")
            shapes.append(shape)
            bounds.append(1 / math.sqrt(ci * k ** 3))
    leaves = dict(zip(keys, uniform_leaves(gen, shapes, bounds, device)))
    for name, ci, co, k, bn, act in blocks(cfg):
        if bn:
            p = f"{name}.norm_layer."
            leaves[p + "weight"] = torch.ones(co, device=device)
            leaves[p + "bias"] = torch.zeros(co, device=device)
            leaves[p + "running_mean"] = torch.zeros(co, device=device)
            leaves[p + "running_var"] = torch.ones(co, device=device)
            leaves[p + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64, device=device)
        if act:
            leaves[f"{name}.activation_layer.weight"] = torch.full(
                (1,), 0.25, device=device)
    return leaves


def param_keys(cfg: dict) -> List[str]:
    """The trainable leaves (conv weights and biases, BatchNorm affine,
    PReLU slopes)."""
    out = []
    for name, ci, co, k, bn, act in blocks(cfg):
        out += [f"{name}.conv_layer.weight", f"{name}.conv_layer.bias"]
        if bn:
            out += [f"{name}.norm_layer.weight", f"{name}.norm_layer.bias"]
        if act:
            out.append(f"{name}.activation_layer.weight")
    return out


def stat_keys(cfg: dict) -> List[str]:
    return [f"{name}.norm_layer.{s}" for name, *_, bn, _ in blocks(cfg)
            if bn for s in ("running_mean", "running_var")]


def _conv_block(w, name, x, k, bn, act, train, stats, quant):
    q = precision.quantizer(quant)
    y = q(F.conv3d(q(x), q(w[f"{name}.conv_layer.weight"]),
                   w[f"{name}.conv_layer.bias"], padding=k // 2))
    if bn:
        p = f"{name}.norm_layer."
        if train:
            count = y.numel() // y.shape[1]
            mean = y.mean(dim=(0, 2, 3, 4))
            var = (y - mean[:, None, None, None]).square().mean(
                dim=(0, 2, 3, 4))
            with torch.no_grad():
                stats[p + "running_mean"] = (0.9 * w[p + "running_mean"]
                                             + 0.1 * mean)
                stats[p + "running_var"] = (0.9 * w[p + "running_var"]
                                            + 0.1 * var * count / (count - 1))
        else:
            mean, var = w[p + "running_mean"], w[p + "running_var"]
        shape = (1, -1, 1, 1, 1)
        y = q((y - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + 1e-5)
              * w[p + "weight"].reshape(shape) + w[p + "bias"].reshape(shape))
    if act:
        y = q(torch.where(y >= 0, y,
                          w[f"{name}.activation_layer.weight"] * y))
    return y


def forward(w: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
            train: bool, quant: Optional[str] = None):
    """x (N, C, D, H, W) -> (logits (N, classes, D, H, W), new running
    statistics {key: tensor} in train mode)."""
    stats: Dict[str, torch.Tensor] = {}
    spec = {b[0]: b[1:] for b in blocks(cfg)}
    nb = cfg["num_encoding_blocks"]

    def run(name, x):
        _, _, k, bn, act = spec[name]
        return _conv_block(w, name, x, k, bn, act, train, stats, quant)

    q = precision.quantizer(quant)
    skips = []
    for i in range(nb - 1):
        name = f"encoder.encoding_blocks.{i}"
        x = run(f"{name}.conv2", run(f"{name}.conv1", x))
        skips.append(x)
        x = F.max_pool3d(x, 2)
    x = run("bottom_block.conv2", run("bottom_block.conv1", x))
    for i in range(nb - 1):
        name = f"decoder.decoding_blocks.{i}"
        up = q(F.interpolate(x, scale_factor=2, mode="trilinear",
                             align_corners=False))
        x = torch.cat([skips[-(i + 1)], up], dim=1)
        x = run(f"{name}.conv2", run(f"{name}.conv1", x))
    return run("classifier", x), stats


def dice_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft dice (reference `segmentation/routine.py:239-253`): softmax over
    the classes, one-hot of the binary target, tp/fp/fn over the voxels,
    eps 1e-9; mean of 1 - dice over the batch and both classes."""
    p = torch.softmax(logits, dim=1)
    g = torch.cat([1 - target, target], dim=1)
    dims = (2, 3, 4)
    tp = (p * g).sum(dims)
    fp = (p * (1 - g)).sum(dims)
    fn = ((1 - p) * g).sum(dims)
    return (1 - 2 * tp / (2 * tp + fp + fn + 1e-9)).mean()


@torch.no_grad()
def adamw(params, grads, state, step: int, lr=1e-3, betas=(0.9, 0.999),
          eps=1e-8, weight_decay=1e-2):
    """torch.optim.AdamW's update, in place: decoupled decay, then the
    bias-corrected moment step."""
    b1, b2 = betas
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for k, p in params.items():
        g = grads[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.mul_(1 - lr * weight_decay)
        p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + eps, value=-lr / bc1)


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                quant: Optional[str] = None, half_batch: bool = False):
    """Run AdamW train steps from `weights` (not modified) over `batches` of
    (inputs (N, S, S, S, 1) float, labels (N, S, S, S, 1) ids), in float32
    with TF32 off.  Returns {"losses": [...], "grads": {key: first step's
    gradient}, "params": {key: after the last step}, "stats": {key:
    running statistics after the last step}}.  `half_batch` drops the
    second half of every batch (a fault the comparison must catch)."""
    from ..lib.gen import binarize

    keys = param_keys(cfg)
    w = {k: v.detach().clone().float() for k, v in weights.items()}
    opt_state: dict = {}
    out = {"losses": [], "grads": None}
    with precision.exact_f32():
        for step, (x, lab) in enumerate(batches, start=1):
            if half_batch:
                x, lab = x[:x.shape[0] // 2], lab[:lab.shape[0] // 2]
            x = x.float().permute(0, 4, 1, 2, 3)
            t = binarize(lab).permute(0, 4, 1, 2, 3)
            params = {k: w[k].detach().requires_grad_(True) for k in keys}
            logits, stats = forward({**w, **params}, cfg, x, True, quant)
            loss = dice_loss(logits, t)
            grads = dict(zip(keys, torch.autograd.grad(
                loss, [params[k] for k in keys])))
            del logits, params
            adamw({k: w[k] for k in keys}, grads, opt_state, step)
            w.update(stats)
            out["losses"].append(float(loss.detach()))
            if out["grads"] is None:
                out["grads"] = grads
    out["params"] = {k: w[k] for k in keys}
    out["stats"] = {k: w[k] for k in stat_keys(cfg)}
    return out
