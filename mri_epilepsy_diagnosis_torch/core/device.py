"""Device choice shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the current CUDA device; it raises when there is none,
    so a run meant for the card never carries on silently on the CPU.
    Pass `device="cpu"` to run on the CPU on purpose."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def as_device_tensor(x, device: Optional[Union[str, torch.device]] = None
                     ) -> torch.Tensor:
    """`x` as a tensor for an entry point that runs where its input lies:
    a tensor stays on its own device unless `device` names another; any
    other input (a numpy array, a list) goes to `resolve_device(device)`,
    the card unless `device="cpu"`."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(resolve_device(device))
