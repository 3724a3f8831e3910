"""The work the benchmark counts: model FLOPs of a step, from the plain
reference under `FlopCounterMode` on the `meta` device, and the bound of
each hand-written kernel's sites by the fine function's operations and
bytes (never by the packed layout's).

Peaks are those of one H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s
in bf16, 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s HBM.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEM_BYTES = {"bfloat16": 2, "float32": 4}


class Site(NamedTuple):
    name: str
    flops: float
    nbytes: float


def bound_s(sites: List[Site], dtype: str) -> float:
    """Sum over the sites of max(operations / peak, bytes / bandwidth)."""
    return sum(max(s.flops / PEAK_FLOPS[dtype], s.nbytes / HBM_BYTES_PER_S)
               for s in sites)


def count_flops(fn, conv_only: bool = False) -> float:
    """FLOPs that `FlopCounterMode` counts while `fn()` runs (those of the
    convolutions alone with `conv_only`)."""
    with FlopCounterMode(display=False) as counter:
        fn()
    if conv_only:
        return float(sum(v for op, v in counter.get_flop_counts()[
            "Global"].items() if "convolution" in str(op)))
    return float(counter.get_total_flops())


# ---------------------------------------------------------------------------
# UNet3D
# ---------------------------------------------------------------------------


def unet_step_flops(cfg: dict, n: int, size: int, train: bool,
                    conv_only: bool = False) -> float:
    """FLOPs of one UNet3D step at batch `n` of size^3: the forward, plus
    in training the backward as autograd runs it (the input takes no
    gradient), no recompute."""
    from ..reference import unet3d as R

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
        t = torch.empty((n, 1, size, size, size), device=meta)
        torch.autograd.grad(R.dice_loss(logits, t), [w[k] for k in keys])

    return count_flops(run, conv_only)


def unet_conv_sites(cfg: dict, n: int, size: int, dtype: str,
                    backward: bool) -> List[Site]:
    """The fine 3x3x3 convs of UNet3D at batch `n` of size^3 (each decoder
    conv1 as one conv of the concatenated input), forward and, with
    `backward`, the input gradient of every conv but the first: 2*27*Ci*Co
    operations per voxel, input, weight and output counted once each."""
    from ..reference import unet3d as R

    b = ITEM_BYTES[dtype]
    nb = cfg["num_encoding_blocks"]
    levels = {}
    for i in range(nb - 1):
        levels[f"encoder.encoding_blocks.{i}"] = i
        levels[f"decoder.decoding_blocks.{nb - 2 - i}"] = i
    levels["bottom_block"] = nb - 1
    out = []
    for j, (name, ci, co, k, _, _) in enumerate(R.blocks(cfg)):
        if k != 3:
            continue
        vox = n * (size // 2 ** levels[name.rsplit(".", 1)[0]]) ** 3
        flops = 2.0 * 27 * ci * co * vox
        nbytes = (vox * ci + 27 * ci * co + vox * co) * b
        out.append(Site(name, flops, nbytes))
        if backward and j > 0:
            out.append(Site(name + ".dx", flops, nbytes))
    return out
