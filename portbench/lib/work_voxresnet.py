"""The work the benchmark counts in a VoxResNet training step (the
counterpart of `lib/work.py`'s UNet3D counts, on the same peaks): model
FLOPs from the plain reference under `FlopCounterMode` on the `meta`
device; the bound of kernel B1's sites by the fine function's operations
and bytes; and the byte bound of the train-mode BatchNorm tail's passes.
"""
from __future__ import annotations

from typing import List

import torch

from .work import ITEM_BYTES, Site, count_flops

# reads or writes of a BatchNorm site's tensor over the tail's four
# passes: statistics reads y; apply reads y and writes out; the backward
# reduction reads y and g; dx reads y and g and writes dy
BN_TAIL_PASSES = 8


def step_flops(cfg: dict, n: int, size: int, train: bool,
               conv_only: bool = False) -> float:
    """FLOPs of one VoxResNet step at batch `n` of size^3: the forward
    and cross entropy, plus in training the backward as autograd runs it
    (the input takes no gradient)."""
    from ..reference import voxresnet as R

    cfg = {**cfg, "input_shape": [size] * 3}
    meta = torch.device("meta")

    def run():
        w = R.make_weights(cfg, torch.Generator(), meta)
        x = torch.empty((n, 1, size, size, size), device=meta)
        if not train:
            R.forward(w, cfg, x, False)
            return
        keys = R.param_keys(cfg)
        for k in keys:
            w[k].requires_grad_(True)
        logits, _ = R.forward(w, cfg, x, True)
        y = torch.zeros((n,), dtype=torch.long, device=meta)
        torch.autograd.grad(torch.nn.functional.cross_entropy(logits, y),
                            [w[k] for k in keys])

    return count_flops(run, conv_only)


def _conv_outputs(cfg: dict, size: int):
    """(name, c_in, c_out, fine input size, fine output size) of every
    3x3x3 conv in the order of the forward."""
    from ..reference import voxresnet as R

    out, f = [], size
    for name, ci, co, stride, _ in R.convs(cfg):
        out.append((name, ci, co, f, f // stride))
        f //= stride
    return out


def conv_sites(cfg: dict, n: int, size: int, dtype: str,
               backward: bool) -> List[Site]:
    """The fine 3x3x3 convs of VoxResNet at batch `n` of size^3 (22 at 4
    stages), forward and, with `backward`, the input gradient of every
    conv but the stem's: 2*27*Ci*Co operations per output voxel; input,
    weight and output counted once each (for a gradient: the output's
    gradient read, the input's written)."""
    b = ITEM_BYTES[dtype]
    out = []
    for j, (name, ci, co, fin, fout) in enumerate(_conv_outputs(cfg, size)):
        vin, vout = n * fin ** 3, n * fout ** 3
        flops = 2.0 * 27 * ci * co * vout
        nbytes = (vin * ci + 27 * ci * co + vout * co) * b
        out.append(Site(name, flops, nbytes))
        if backward and j > 0:
            out.append(Site(name + ".dx", flops, nbytes))
    return out


def bn_sites(cfg: dict, n: int, size: int, dtype: str) -> List[Site]:
    """Each train-mode BatchNorm of VoxResNet at batch `n` of size^3 (22
    at 4 stages), bound by bytes: BN_TAIL_PASSES reads or writes of its
    fine tensor (N f^3 C elements) over the four passes, no operations
    counted."""
    from ..reference import voxresnet as R

    b = ITEM_BYTES[dtype]
    f = size // cfg["stride"]
    sizes = {"model.batch_norm_1": f, "model.batch_norm_2": f}
    for i in range(R.stages(cfg)):
        f //= 2
        for key in (f"model.block_{2 * i + 1}", f"model.block_{2 * i + 2}"):
            sizes[f"{key}.bn1"] = sizes[f"{key}.bn2"] = f
        sizes[f"model.batch_norm_{i + 3}"] = f
    return [Site(name, 0.0, BN_TAIL_PASSES * n * sizes[name] ** 3 * c * b)
            for name, c in R.batch_norms(cfg)]
