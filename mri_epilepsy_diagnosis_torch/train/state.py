"""Train state: the model (the weight container: parameters and BatchNorm
running statistics), its optimizer and the step count (counterpart of the
JAX package's `train/state.py`).  PyTorch updates the model and optimizer
in place, so the steps return the same state object."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(model: nn.Module,
                       tx: Callable[[Iterable[nn.Parameter]],
                                    torch.optim.Optimizer]) -> TrainState:
    """`tx` is an optimizer factory such as `train.optim.torch_adamw()`."""
    return TrainState(model=model, optimizer=tx(model.parameters()))
