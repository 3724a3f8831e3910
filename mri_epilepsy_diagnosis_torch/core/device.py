"""Device choice shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

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
