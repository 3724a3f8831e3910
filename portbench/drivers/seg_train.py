"""Segmentation training through the program's epoch loop: UNet3D in the
packed layout, bf16 compute with float32 master weights and AdamW
(`train/seg.py::run_epoch(..., packed=True, input_dtype=bfloat16)`).

The feed is an endless loader over a seeded pool of T1w-like volumes and
FreeSurfer-like label maps in host memory, staged by the program's own
prefetcher: whole volumes in seeded order (`patch` null), or patch batches
drawn ahead of time at seeded corners.  It stops drawing once the window
has closed.  The first `checked_steps` steps (all on different rows) are
followed by the plain reference after the window.
"""
from __future__ import annotations

import numpy as np
import torch

from ..lib import compare, gen, work
from ..lib.window import StepLogger, Window
from ..reference import unet3d as R


def _feed(mix, seed, device):
    """`draw(i)`: the i-th batch of the feed, a pair of numpy arrays
    (inputs float32, labels int16), both (N, S, S, S, 1)."""
    g = gen.generator(seed, device)
    x, lab = gen.seg_pool(g, mix["pool"], mix["size"], device)
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    n, b = mix["pool"], mix["batch"]
    if mix.get("patch"):
        p = mix["patch"]
        batches = []
        for _ in range(mix["patch_batches"]):
            idx = rng.integers(0, n, b)
            corners = rng.integers(0, mix["size"] - p + 1, (b, 3))
            xs = torch.stack([x[i, c0:c0 + p, c1:c1 + p, c2:c2 + p]
                              for i, (c0, c1, c2) in zip(idx, corners)])
            ls = torch.stack([lab[i, c0:c0 + p, c1:c1 + p, c2:c2 + p]
                              for i, (c0, c1, c2) in zip(idx, corners)])
            batches.append((xs.cpu().numpy(), ls.cpu().numpy()))

        def draw(i):
            return batches[i % len(batches)]
    else:
        hx, hl = x.cpu().numpy(), lab.cpu().numpy()
        order = np.concatenate([rng.permutation(n) for _ in range(4)])

        def draw(i):
            j = (i * b) % len(order)
            idx = order[j:j + b]
            return hx[idx], hl[idx]
    del x, lab
    return draw


def run(ctx):
    from mri_epilepsy_diagnosis_torch.train.optim import torch_adamw
    from mri_epilepsy_diagnosis_torch.train.seg import Action, run_epoch
    from mri_epilepsy_diagnosis_torch.train.state import create_train_state
    from mri_epilepsy_diagnosis_torch.models.unet import UNet3D

    cfg, mix, device = ctx.cfg, ctx.mix, ctx.device
    draw = _feed(mix, ctx.seed, device)
    ctx.mark("inputs")
    weights = R.make_weights(cfg, gen.generator(ctx.seed + 1, device), device)
    model = UNet3D(in_channels=cfg["in_channels"],
                   out_classes=cfg["out_classes"],
                   num_encoding_blocks=cfg["num_encoding_blocks"],
                   out_channels_first_layer=cfg["out_channels_first_layer"],
                   device=device)
    model.load_state_dict(weights)
    opt = cfg["optimizer"]
    state = create_train_state(model, torch_adamw(
        opt["lr"], tuple(opt["betas"]), opt["eps"], opt["weight_decay"]))
    ctx.mark("model")

    n_check = mix["checked_steps"]
    window = Window(ctx.seconds, mix["warmup_steps"], ctx.stretches)
    logger = StepLogger(window)
    seen = {}
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    beta1 = opt["betas"][0]

    def first_grads():
        # a parameter the optimizer never stepped has no state: it reads 0
        st = state.optimizer.state
        seen["grads"] = {k: (st[p]["exp_avg"] / (1 - beta1)).norm()
                         if "exp_avg" in st.get(p, {}) else torch.zeros(())
                         for k, p in named.items()}

    def changes():
        seen["change"] = {k: (p.detach() - weights[k]).norm()
                          for k, p in named.items()}
        seen["stats"] = {k: (buffers[k] - weights[k]).norm()
                         for k in R.stat_keys(cfg)}

    window.callbacks[1] = first_grads
    window.callbacks[n_check] = changes
    first = []

    def loader():
        i = 0
        while not window.closed():
            batch = draw(i)
            if i < n_check:
                first.append(batch)
            i += 1
            yield batch

    run_epoch(0, Action.TRAIN, loader(), state, experiment=logger,
              packed=True, input_dtype=getattr(torch, cfg["dtype"]))
    if ctx.stretches is not None:
        ctx.stretches.close()
    ctx.window_closed()

    w0, steps = mix["warmup_steps"], window.n_steps
    losses = [next(iter(v.values())) for v in logger.values]
    failed = sum(not np.isfinite(v) for v in losses[w0:w0 + steps])
    prog = {k: {n: float(t) for n, t in seen[k].items()}
            for k in ("grads", "change", "stats")}
    del state, model, named, buffers, seen
    ctx.free()

    prog["losses"] = losses[:n_check]
    batches = [tuple(torch.as_tensor(a).to(device) for a in b)
               for b in first]
    ref = compare.readings(R.train_steps(weights, cfg, batches), weights)
    checks = compare.training_checks(prog, ref, mix["limits"])
    extra = {}
    if getattr(ctx, "calibrate", False):
        extra = {"prog": prog, "ref": ref, "control": compare.readings(
            R.train_steps(weights, cfg, batches, quant="fp8"), weights),
            "half_batch": compare.readings(R.train_steps(
                weights, cfg, batches, half_batch=True), weights)}
    wall = window.wall_s
    rate, tail = mix["metrics"]
    samples = steps * mix["batch"]
    return {
        "t0": window.t0, "attempted": steps, "failed": int(failed),
        "checks": checks, "extra": extra,
        "metrics": {
            rate: (samples / wall if wall > 0 else 0.0, "samples/s"),
            tail: (1e3 * ctx.p95(window.step_s), "ms"),
        },
        "work": {
            "kind": "train", "steps": steps, "wall_s": wall,
            "dtype": cfg["dtype"], "batch": mix["batch"],
            "step_flops": lambda: work.unet_step_flops(
                cfg, mix["batch"], mix.get("patch") or mix["size"], True),
            "b1_sites": lambda: work.unet_conv_sites(
                cfg, mix["batch"], mix.get("patch") or mix["size"],
                cfg["dtype"], backward=True),
        },
    }
