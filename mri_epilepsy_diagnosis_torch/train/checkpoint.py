"""Checkpoint save/restore (counterpart of the JAX package's
`train/checkpoint.py`): the model's state dict (parameters and BatchNorm
running statistics), the optimizer's state, the step and any extras, in
one `torch.save` file, so training resumes exactly."""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

from .state import TrainState


def save_checkpoint(path: str, state: TrainState, **extra):
    """Extras must be tensors or plain Python data: loading reads with
    `weights_only=True`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"step": int(state.step),
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "extra": extra}, path)


def _load(path: str, device) -> Dict[str, Any]:
    return torch.load(path, map_location=device, weights_only=True)


def load_checkpoint_extra(path: str) -> Dict[str, Any]:
    """The **extra payload saved alongside a checkpoint; {} if none."""
    return _load(path, "cpu").get("extra") or {}


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore into an existing state (same model and optimizer kind);
    shapes must match.  Returns the state."""
    payload = _load(path, state.device)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state
