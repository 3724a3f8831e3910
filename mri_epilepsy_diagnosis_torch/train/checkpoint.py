"""Checkpoint save/restore (counterpart of the JAX package's
`train/checkpoint.py`): the model's state dict (parameters and BatchNorm
running statistics), the optimizer's state, the step and any extras, in
one `torch.save` file, so training resumes exactly.

The loaders also read the JAX package's checkpoints, flax msgpack files
with the same `{stem}_epoch_{i}.ckpt` names, and tell the two formats
apart by content (`interop/flax_msgpack.py::is_flax_msgpack`): a torch
file is a zip archive, a flax one a msgpack map.  `load_jax_checkpoint`
maps the JAX train state onto the port's (see there); the port writes
only its own format.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch.optim.lr_scheduler import ReduceLROnPlateau, StepLR

from ..interop.flax_msgpack import is_flax_msgpack, msgpack_restore
from ..interop.jax_bridge import variables_to_state_dict
from .state import TrainState


def save_checkpoint(path: str, state: TrainState, **extra):
    """Extras must be tensors or plain Python data: loading reads with
    `weights_only=True`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"step": int(state.step),
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "extra": extra}, path)


def _is_jax_checkpoint(path: str) -> bool:
    with open(path, "rb") as f:
        return is_flax_msgpack(f.read(1))


def _read_jax(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _load(path: str) -> Dict[str, Any]:
    # onto the host: `load_state_dict` copies each tensor to its parameter's
    # device, and the optimizer's non-capturable `step` counters stay on
    # the host, where torch keeps them
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint_extra(path: str) -> Dict[str, Any]:
    """The **extra payload saved alongside a checkpoint of either package;
    {} if none."""
    payload = _read_jax(path) if _is_jax_checkpoint(path) else _load(path)
    return payload.get("extra") or {}


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore into an existing state (same model and optimizer kind);
    shapes must match.  Reads the port's files and the JAX package's
    (`load_jax_checkpoint`).  Returns the state."""
    if _is_jax_checkpoint(path):
        return load_jax_checkpoint(path, state)
    payload = _load(path)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def load_jax_checkpoint(path: str, state: TrainState) -> TrainState:
    """Fill a port `TrainState` (model and a torch Adam/AdamW optimizer)
    from a checkpoint that the JAX package's `save_checkpoint` wrote, so
    that training resumes where JAX left it:

    - `params` and `batch_stats` through `variables_to_state_dict` (the
      JAX tree must name every entry of the model's state dict); JAX keeps
      no batch counter, so every `num_batches_tracked` becomes the step, the
      count a port run that took the same steps would hold;
    - the optax state of `torch_adamw`/`torch_adam`
      (`inject_hyperparams` over a chain holding `scale_by_adam`): the Adam
      entry's `mu`/`nu`/`count` become each parameter's `exp_avg`/
      `exp_avg_sq`/`step`, and `hyperparams.learning_rate` each param
      group's `lr` (betas, eps and weight decay are the optimizer's own);
    - `step`.

    The scheduler's state rides in the checkpoint's extras
    (`load_scheduler_state`).  Returns the state."""
    payload = _read_jax(path)
    device = state.device
    step = int(payload["step"])
    sd = variables_to_state_dict({"params": payload["params"],
                                  "batch_stats": payload["batch_stats"]},
                                 device)
    for k in sd:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(step, dtype=torch.long, device=device)
    state.model.load_state_dict(sd)

    opt = payload["opt_state"]
    adam = [s for s in opt["inner_state"].values()
            if isinstance(s, dict) and {"mu", "nu", "count"} <= s.keys()]
    if len(adam) != 1:
        raise ValueError(f"{path}: no single scale_by_adam state in the "
                         "optimizer state")
    mu = variables_to_state_dict({"params": adam[0]["mu"]}, device)
    nu = variables_to_state_dict({"params": adam[0]["nu"]}, device)
    count = float(adam[0]["count"])
    names = {p: n for n, p in state.model.named_parameters()}
    if mu.keys() != set(names.values()):
        raise ValueError(f"{path}: the Adam moments name other parameters "
                         "than the model's")
    lr = float(opt["hyperparams"]["learning_rate"])
    for group in state.optimizer.param_groups:
        group["lr"] = lr
        on_device = group.get("capturable") or group.get("fused")
        for p in group["params"]:
            state.optimizer.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32,
                                     device=p.device if on_device else None),
                "exp_avg": mu[names[p]].to(p.dtype),
                "exp_avg_sq": nu[names[p]].to(p.dtype)}
    state.step = step
    return state


def load_scheduler_state(scheduler, sd: Dict[str, Any]) -> None:
    """Restore a torch scheduler from a checkpoint's `extra["scheduler"]`:
    the port's own `state_dict()`, or the JAX package's controller state.
    JAX's `ReduceLROnPlateau` keeps `scale`, `best`, `num_bad_epochs` and
    `cooldown_counter`: the last three carry over, and `scale` already
    arrived as the learning rate of the optimizer state.  JAX's `StepLR`
    keeps `epoch`, which is torch's `last_epoch`.  The other fields keep
    the values the scheduler was built with."""
    lrs = [g["lr"] for g in scheduler.optimizer.param_groups]
    if isinstance(scheduler, ReduceLROnPlateau) and "scale" in sd:
        scheduler.best = float(sd["best"])
        scheduler.num_bad_epochs = int(sd["num_bad_epochs"])
        scheduler.cooldown_counter = int(sd["cooldown_counter"])
        scheduler._last_lr = lrs
    elif isinstance(scheduler, StepLR) and set(sd) == {"epoch"}:
        scheduler.last_epoch = int(sd["epoch"])
        scheduler._last_lr = lrs
    else:
        scheduler.load_state_dict(sd)
