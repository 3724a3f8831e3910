"""Optimizers and learning-rate schedulers (counterpart of the JAX
package's `train/optim.py`, whose optax chains and host-side controllers
replicate these torch classes).

- `torch_adam(lr, weight_decay)`: `torch.optim.Adam` (weight decay coupled
  into the gradient), the reference's classification factory.
- `torch_adamw()`: `torch.optim.AdamW` defaults (lr 1e-3, decoupled weight
  decay 0.01), the segmentation factory.
- `ReduceLROnPlateau` / `StepLR`: `torch.optim.lr_scheduler`'s own
  classes, which set the optimizer's learning rate themselves.
"""
from __future__ import annotations

import functools

import torch
from torch.optim.lr_scheduler import ReduceLROnPlateau, StepLR

__all__ = ["ReduceLROnPlateau", "StepLR", "torch_adam", "torch_adamw"]


def torch_adam(learning_rate: float = 1e-3, betas=(0.9, 0.999),
               eps: float = 1e-8, weight_decay: float = 0.0):
    """Factory `params -> torch.optim.Adam(params, ...)`."""
    return functools.partial(torch.optim.Adam, lr=learning_rate, betas=betas,
                             eps=eps, weight_decay=weight_decay)


def torch_adamw(learning_rate: float = 1e-3, betas=(0.9, 0.999),
                eps: float = 1e-8, weight_decay: float = 1e-2):
    """Factory `params -> torch.optim.AdamW(params, ...)`."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=betas, eps=eps, weight_decay=weight_decay)
