"""Plain float32 reference of the reference repository's VoxResNet
classifier (`classification/models/cnn_model.py:43-101`), its cross
entropy and Adam with L2 weight decay, in channels-first
`torch.nn.functional` calls with TF32 off.

It imports nothing of the program.  Parameters are a flat dict under the
names of the port's `VoxResNet.state_dict()` (`model.conv3d_1.weight`,
`model.block_1.bn1.running_mean`, ...), so the benchmark can load the same
tensors into the program's model.  Train-mode BatchNorm normalizes with
the batch's biased variance and moves the running statistics with torch's
momentum and the unbiased variance.  The reference's quirk stays: with 4
stages `activation_6` is registered twice, so there is no activation after
`fully_conn_1`.

Dropout keeps a unit where u < 1 - rate, u uniform from `torch.rand` of
the unit's shape, drawn for each train step from a generator on the
input's device: the caller's generator if it lives there, else one seeded
from a single `torch.randint(0, 2**62)` draw of the caller's generator.
Handed a generator in the same state as the program's, the reference
draws the program's masks.

`quant="fp8"` computes in float8 what the program computes in bf16: every
conv and linear operand and every activation the forward makes is
rounded to e4m3, and the gradient flowing back through each of them to
e5m2, scaled per tensor by its largest magnitude: the control that a
correct run must tell apart from the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import precision

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def stages(cfg: dict) -> int:
    return min(max(cfg["n_blocks"], 1), 4)


def _widths(cfg: dict) -> List[Tuple[int, int]]:
    nf = cfg["n_filters"]
    return [(nf, 2 * nf), (2 * nf, 2 * nf), (2 * nf, 4 * nf),
            (4 * nf, 4 * nf)][:stages(cfg)]


def convs(cfg: dict) -> List[Tuple[str, int, int, int, bool]]:
    """(name, c_in, c_out, stride, bias) of every 3x3x3 conv in the order
    of the forward."""
    nf = cfg["n_filters"]
    out = [("model.conv3d_1", cfg.get("in_channels", 1), nf, cfg["stride"],
            True),
           ("model.conv3d_2", nf, nf, 1, True)]
    for i, (ci, co) in enumerate(_widths(cfg)):
        out.append((f"model.conv3d_{i + 3}", ci, co, 2, True))
        for b in (2 * i + 1, 2 * i + 2):
            out += [(f"model.block_{b}.conv1", co, co, 1, False),
                    (f"model.block_{b}.conv2", co, co, 1, False)]
    return out


def batch_norms(cfg: dict) -> List[Tuple[str, int]]:
    """(name, channels) of every BatchNorm in the order of the forward."""
    nf = cfg["n_filters"]
    out = [("model.batch_norm_1", nf), ("model.batch_norm_2", nf)]
    for i, (_, co) in enumerate(_widths(cfg)):
        for b in (2 * i + 1, 2 * i + 2):
            out += [(f"model.block_{b}.bn1", co), (f"model.block_{b}.bn2", co)]
        out.append((f"model.batch_norm_{i + 3}", co))
    return out


def flatten_units(cfg: dict) -> int:
    """fc1's input: 4 n_filters channels over input / (2^n_blocks stride)
    voxels per axis (the reference's count)."""
    div = 2 ** cfg["n_blocks"] * cfg["stride"]
    return 4 * cfg["n_filters"] * math.prod(s // div
                                            for s in cfg["input_shape"])


def linears(cfg: dict) -> List[Tuple[str, int, int]]:
    return [("model.fully_conn_1", flatten_units(cfg), cfg["n_fc_units"]),
            ("model.fully_conn_2", cfg["n_fc_units"], cfg["num_classes"])]


def make_weights(cfg: dict, gen: torch.Generator, device
                 ) -> Dict[str, torch.Tensor]:
    """Every parameter and BatchNorm buffer, float32: conv and linear
    weights and biases U(+-1/sqrt(fan_in)) (torch's default bounds) from
    one draw of `gen`, BatchNorm affine (1, 0) and running statistics
    (0, 1)."""
    from ..lib.gen import uniform_leaves

    shapes, bounds, keys = [], [], []
    for name, ci, co, _, bias in convs(cfg):
        for suffix, shape in (("weight", (co, ci, 3, 3, 3)), ("bias", (co,))):
            if suffix == "bias" and not bias:
                continue
            keys.append(f"{name}.{suffix}")
            shapes.append(shape)
            bounds.append(1 / math.sqrt(ci * 27))
    for name, fi, fo in linears(cfg):
        keys += [f"{name}.weight", f"{name}.bias"]
        shapes += [(fo, fi), (fo,)]
        bounds += [1 / math.sqrt(fi)] * 2
    leaves = dict(zip(keys, uniform_leaves(gen, shapes, bounds, device)))
    for name, c in batch_norms(cfg):
        leaves[f"{name}.weight"] = torch.ones(c, device=device)
        leaves[f"{name}.bias"] = torch.zeros(c, device=device)
        leaves[f"{name}.running_mean"] = torch.zeros(c, device=device)
        leaves[f"{name}.running_var"] = torch.ones(c, device=device)
        leaves[f"{name}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64, device=device)
    return leaves


def param_keys(cfg: dict) -> List[str]:
    """The trainable leaves (conv and linear weights and biases, BatchNorm
    affine)."""
    out = []
    for name, _, _, _, bias in convs(cfg):
        out += [f"{name}.weight"] + ([f"{name}.bias"] if bias else [])
    out += [f"{name}.{s}" for name, _ in batch_norms(cfg)
            for s in ("weight", "bias")]
    out += [f"{name}.{s}" for name, _, _ in linears(cfg)
            for s in ("weight", "bias")]
    return out


def stat_keys(cfg: dict) -> List[str]:
    return [f"{name}.{s}" for name, _ in batch_norms(cfg)
            for s in ("running_mean", "running_var")]


def parameter_count(cfg: dict) -> int:
    meta = make_weights(cfg, torch.Generator(), torch.device("meta"))
    return sum(meta[k].numel() for k in param_keys(cfg))


def dropout_keep(gen: torch.Generator, shape, device, rate: float
                 ) -> torch.Tensor:
    """One train step's keep mask (see the module docstring)."""
    device = torch.device(device)
    if gen.device != device:
        seed = int(torch.randint(0, 2 ** 62, (), generator=gen,
                                 device=gen.device))
        gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def forward(w: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
            train: bool, keep: Optional[torch.Tensor] = None,
            quant: Optional[str] = None):
    """x (N, C, D, H, W) -> (logits (N, classes), new running statistics
    {key: tensor} in train mode).  `keep`: the Dropout keep mask (N,
    n_fc_units), or None for none."""
    q = precision.quantizer(quant)
    stats: Dict[str, torch.Tensor] = {}
    strides = {name: stride for name, _, _, stride, _ in convs(cfg)}

    def conv(x, name):
        return q(F.conv3d(q(x), q(w[f"{name}.weight"]), w.get(f"{name}.bias"),
                          stride=strides[name], padding=1))

    def bn(y, name):
        if train:
            count = y.numel() // y.shape[1]
            mean = y.mean(dim=(0, 2, 3, 4))
            var = (y - mean[:, None, None, None]).square().mean(
                dim=(0, 2, 3, 4))
            with torch.no_grad():
                stats[f"{name}.running_mean"] = (
                    (1 - BN_MOMENTUM) * w[f"{name}.running_mean"]
                    + BN_MOMENTUM * mean)
                stats[f"{name}.running_var"] = (
                    (1 - BN_MOMENTUM) * w[f"{name}.running_var"]
                    + BN_MOMENTUM * var * count / (count - 1))
        else:
            mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
        shape = (1, -1, 1, 1, 1)
        return q((y - mean.reshape(shape))
                 / torch.sqrt(var.reshape(shape) + BN_EPS)
                 * w[f"{name}.weight"].reshape(shape)
                 + w[f"{name}.bias"].reshape(shape))

    def relu(y):
        return q(torch.relu(y))

    def linear(h, name):
        return q(F.linear(q(h), q(w[f"{name}.weight"]), w[f"{name}.bias"]))

    x = relu(bn(conv(x, "model.conv3d_1"), "model.batch_norm_1"))
    x = relu(bn(conv(x, "model.conv3d_2"), "model.batch_norm_2"))
    for i in range(stages(cfg)):
        x = conv(x, f"model.conv3d_{i + 3}")
        for b in (2 * i + 1, 2 * i + 2):
            p = f"model.block_{b}"
            out = relu(bn(conv(x, f"{p}.conv1"), f"{p}.bn1"))
            out = bn(conv(out, f"{p}.conv2"), f"{p}.bn2")
            x = relu(out + x)
        x = relu(bn(x, f"model.batch_norm_{i + 3}"))
    h = linear(x.reshape(x.shape[0], -1), "model.fully_conn_1")
    if cfg["n_blocks"] < 4:
        h = relu(h)
    if train and keep is not None:
        h = torch.where(keep, h / (1.0 - cfg["dropout"]), 0.0)
    return linear(h, "model.fully_conn_2"), stats


@torch.no_grad()
def adam_l2(params, grads, state, step: int, lr, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=0.0):
    """torch.optim.Adam's update with L2 weight decay, in place: the decay
    added to the gradient, then the bias-corrected moment step."""
    b1, b2 = betas
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for k, p in params.items():
        g = grads[k] + weight_decay * p
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + eps, value=-lr / bc1)


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                dropout_gen: Optional[torch.Generator] = None,
                quant: Optional[str] = None, half_batch: bool = False):
    """Run Adam train steps from `weights` (not modified) over `batches` of
    (inputs (N, S, S, S, 1) float, labels (N,) class ids), in float32 with
    TF32 off; Dropout masks from `dropout_gen` (one draw a step, see the
    module docstring), or none.  Returns {"losses": [...], "logits": the
    first step's (N, classes), "grads": {key: the first step's gradient
    of the loss, without the decay}, "params": {key: after the last
    step}, "stats": {key: running statistics after the last step}}.
    `half_batch` drops the second half of every batch (a fault the
    comparison must catch)."""
    keys = param_keys(cfg)
    opt = cfg["optimizer"]
    w = {k: v.detach().clone().float() for k, v in weights.items()}
    opt_state: dict = {}
    out = {"losses": [], "grads": None, "logits": None}
    with precision.exact_f32():
        for step, (x, y) in enumerate(batches, start=1):
            if half_batch:
                x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
            x = x.float().permute(0, 4, 1, 2, 3)
            keep = None
            if dropout_gen is not None and cfg["dropout"] > 0:
                keep = dropout_keep(dropout_gen,
                                    (x.shape[0], cfg["n_fc_units"]),
                                    x.device, cfg["dropout"])
            params = {k: w[k].detach().requires_grad_(True) for k in keys}
            logits, stats = forward({**w, **params}, cfg, x, True, keep,
                                    quant)
            loss = F.cross_entropy(logits.float(), y.long())
            grads = dict(zip(keys, torch.autograd.grad(
                loss, [params[k] for k in keys])))
            del params
            adam_l2({k: w[k] for k in keys}, grads, opt_state, step,
                    opt["lr"], tuple(opt["betas"]), opt["eps"],
                    opt["weight_decay"])
            w.update(stats)
            out["losses"].append(float(loss.detach()))
            if out["grads"] is None:
                out["grads"] = grads
                out["logits"] = logits.detach()
    out["params"] = {k: w[k] for k in keys}
    out["stats"] = {k: w[k] for k in stat_keys(cfg)}
    return out
