"""Subject-level FCD classification training through the program's epoch
loop: VoxResNet in the packed layout, bf16 compute with float32 master
weights and Adam with L2 decay, the plateau scheduler stepping on every
batch's loss (`train/classification.py::run_one_epoch(..., packed=True,
input_dtype=bfloat16)`).

The feed is an endless loader over a seeded pool of T1w-like volumes,
half of them (class 1) with a brightened labelled lesion sphere, held in
host memory (pinned on a CUDA machine) and staged by the program's own
prefetcher: every pass over the pool is reshuffled by the seed and
interleaved by class as the reference's `stratified_batch_indices`
does, and each batch is gathered from the pool into a new pinned tensor
in the prefetcher's thread, as a host dataset's collate would.  It stops
drawing once the window has closed.  The first `checked_steps` steps
are followed by the plain reference after the window, with the
program's Dropout masks (the reference draws them by the program's rule
from a generator in the same state).

A program whose `run_one_epoch` has no packed route cannot run the cell:
the driver exits at once, before it makes any input.
"""
from __future__ import annotations

import inspect
import math

import numpy as np
import torch

from ..lib import compare, gen, work_voxresnet as work
from ..lib.window import StepLogger, Window
from ..reference import voxresnet as R


def cls_pool(g: torch.Generator, n: int, size: int, device):
    """(inputs (n, S, S, S, 1) z-normalized float32, labels (n,) int64) of
    a classification pool: `gen.t1_like` volumes, of which n // 2, chosen
    by `g`, carry `gen.with_labels`' brightened cortical sphere and are
    class 1."""
    v = gen.t1_like(g, n, size, device)
    labels = (torch.randperm(n, generator=g, device=device)
              < n // 2).long()
    lesioned = labels.nonzero()[:, 0]
    v[lesioned] = gen.with_labels(g, v[lesioned])[0]
    return gen.znorm(v)[..., None], labels


def batch_order(labels: np.ndarray, batch: int, seed: int):
    """Endless row indices of the batches: per pass over the pool a
    seeded permutation, interleaved by class
    (`stratified_batch_indices`), cut into whole batches."""
    from mri_epilepsy_diagnosis_torch.train.classification import (
        stratified_batch_indices)

    rng = np.random.default_rng(int(seed) % (2 ** 63))
    n = len(labels)
    while True:
        perm = rng.permutation(n)
        order = stratified_batch_indices(perm, labels[perm])
        for j in range(0, n - batch + 1, batch):
            yield order[j:j + batch]


def logit_gap(prog, ref) -> float:
    """|program - reference| over |reference| (L2 over the batch) of the
    first step's logit differences log(p1 / p0); inf where the batches
    differ in length or a logit is not finite."""
    if len(prog) != len(ref) or not all(map(math.isfinite, prog)):
        return math.inf
    num = math.sqrt(sum((p - r) ** 2 for p, r in zip(prog, ref)))
    return num / max(math.sqrt(sum(r * r for r in ref)), 1e-30)


def grad_bias_gap(prog, ref) -> float:
    """The worst gap (`compare.leaf_gap`, against the moved leaves' median)
    of the first gradient among the conv biases that take one: those
    under no BatchNorm (the downsamples'), whose gradient is the sum of
    the conv's output gradient over every voxel of the batch.  That sum
    cancels to a small share of its terms, so it reads the rounding of
    the gradient's format, magnified."""
    moved = compare.moved_keys(ref["grads"])
    keys = [k for k in moved if k.endswith(".bias")
            and k[:-len("bias")] + "weight" in ref["convs"]]
    if not keys:
        return 0.0
    return compare.leaf_gap(prog["grads"],
                            {k: ref["grads"][k] for k in moved}, keys)


def _logits_of(probs):
    return [math.log(p / (1.0 - p)) if 0.0 < p < 1.0 else math.inf
            for p in probs]


def run(ctx):
    from mri_epilepsy_diagnosis_torch.train import classification as C

    if "packed" not in inspect.signature(C.run_one_epoch).parameters:
        raise SystemExit("portbench: this program's run_one_epoch has no "
                         "packed route; the cell cannot run")
    from mri_epilepsy_diagnosis_torch.models.cnn import VoxResNet
    from mri_epilepsy_diagnosis_torch.train.optim import (ReduceLROnPlateau,
                                                          torch_adam)
    from mri_epilepsy_diagnosis_torch.train.state import create_train_state

    cfg, mix, device = ctx.cfg, ctx.mix, ctx.device
    size, b = mix["size"], mix["batch"]
    if list(cfg["input_shape"]) != [size] * 3:
        raise SystemExit(f"portbench: the traffic's {size}^3 volumes do not "
                         f"fit the configuration's input {cfg['input_shape']}")
    x, y = cls_pool(gen.generator(ctx.seed, device), mix["pool"], size,
                    device)
    order = batch_order(y.cpu().numpy(), b, ctx.seed)
    pinned = device.type == "cuda"
    px = torch.empty(x.shape, pin_memory=pinned).copy_(x)
    py = y.cpu()
    del x, y
    ctx.mark("inputs")
    weights = R.make_weights(cfg, gen.generator(ctx.seed + 1, device),
                             device)
    model = VoxResNet(input_shape=tuple(cfg["input_shape"]),
                      num_classes=cfg["num_classes"],
                      n_filters=cfg["n_filters"], stride=cfg["stride"],
                      n_blocks=cfg["n_blocks"], dropout=cfg["dropout"],
                      n_fc_units=cfg["n_fc_units"], device=device)
    model.load_state_dict(weights)
    opt = cfg["optimizer"]
    state = create_train_state(model, torch_adam(
        opt["lr"], tuple(opt["betas"]), opt["eps"], opt["weight_decay"]))
    # `create_model_opt`'s scheduler; it first acts after the checked steps
    scheduler = ReduceLROnPlateau(state.optimizer, mode="min", factor=0.5,
                                  patience=2, threshold=1e-3)
    drop_seed = (int(ctx.seed) + 2) % (2 ** 63)
    ctx.mark("model")

    n_check = mix["checked_steps"]
    window = Window(ctx.seconds, mix["warmup_steps"], ctx.stretches)
    logger = StepLogger(window)
    seen = {}
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    beta1, decay = opt["betas"][0], opt["weight_decay"]

    def first_grads():
        # Adam's first moment after one step is (1 - beta1) (g + decay w):
        # the loss's own gradient is what is left after the decay
        st = state.optimizer.state
        seen["grads"] = {k: (st[p]["exp_avg"] / (1 - beta1)
                             - decay * weights[k]).norm()
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
        while not window.closed():
            rows = next(order)
            bx = torch.empty((b, *px.shape[1:]), pin_memory=pinned)
            for j, r in enumerate(rows.tolist()):
                bx[j].copy_(px[r])      # one contiguous volume each
            batch = (bx, py[torch.from_numpy(rows)])
            if len(first) < n_check:
                first.append(batch)
            yield batch

    state, _, probs, _ = C.run_one_epoch(
        state, loader(), True, rng_stream=torch.Generator().manual_seed(
            drop_seed), scheduler=scheduler, experiment=logger,
        prefetch=mix["prefetch"], input_dtype=getattr(torch, cfg["dtype"]),
        packed=True)
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
    prog["logits"] = _logits_of(probs[:b])
    batches = [tuple(t.to(device) for t in batch) for batch in first]

    def reference(**kw):
        out = R.train_steps(weights, cfg, batches, torch.Generator()
                            .manual_seed(drop_seed), **kw)
        read = compare.readings(out, weights)
        d = out["logits"]
        read["logits"] = (d[:, 1] - d[:, 0]).tolist()
        return read

    ref = reference()
    limits = mix["limits"]
    checks = compare.training_checks(prog, ref, limits)
    if "logit_gap" in limits:
        checks.append(compare.check(
            "logit_gap", logit_gap(prog["logits"], ref["logits"]),
            limits["logit_gap"]))
    if "grad_bias_gap" in limits:
        checks.append(compare.check(
            "grad_bias_gap", grad_bias_gap(prog, ref),
            limits["grad_bias_gap"]))
    extra = {}
    if getattr(ctx, "calibrate", False):
        extra = {"prog": prog, "ref": ref,
                 "control": reference(quant="fp8"),
                 "half_batch": reference(half_batch=True)}
        extra["logit_gap"] = {side: logit_gap(extra[side]["logits"],
                                              ref["logits"])
                              for side in ("prog", "control", "half_batch")}
        extra["grad_bias_gap"] = {side: grad_bias_gap(extra[side], ref)
                                  for side in ("prog", "control",
                                               "half_batch")}
    wall = window.wall_s
    rate, tail = mix["metrics"]
    return {
        "t0": window.t0, "attempted": steps, "failed": int(failed),
        "checks": checks, "extra": extra,
        "metrics": {
            rate: (steps * b / wall if wall > 0 else 0.0, "samples/s"),
            tail: (1e3 * ctx.p95(window.step_s), "ms"),
        },
        "work": {
            "kind": "train", "steps": steps, "wall_s": wall,
            "dtype": cfg["dtype"], "batch": b,
            "step_flops": lambda: work.step_flops(cfg, b, size, True),
            "b1_sites": lambda: work.conv_sites(cfg, b, size, cfg["dtype"],
                                                backward=True),
            "bn_sites": lambda: work.bn_sites(cfg, b, size, cfg["dtype"]),
        },
    }
