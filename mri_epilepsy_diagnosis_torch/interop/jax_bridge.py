"""Weight bridge: JAX `variables` pytrees <-> the port's torch `state_dict`.

The JAX package names its flax modules so that joining a parameter path
with '.' and turning every `__` into '.' gives the torch key
(`encoding_blocks__0` -> `encoding_blocks.0`), and stores arrays
channels-last.  `variables_to_state_dict` inverts the JAX importer's
per-rank transpose:

  rank 5 (conv3d): (kD,kH,kW,I,O) -> (O,I,kD,kH,kW)
  rank 4 (conv2d): (kH,kW,I,O)    -> (O,I,kH,kW)
  rank 2 (linear): (in,out)       -> (out,in)
  rank 0/1 (bias, norm stats, PReLU): unchanged

`batch_stats` entries keep their leaf names (`running_mean`,
`running_var`) and land beside the `params` of the same module, as in a
torch BatchNorm; every such module also gets torch's
`num_batches_tracked` counter (0), so `load_state_dict` takes the result
with `strict=True`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a torch state dict into plain numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _path_to_key(path) -> str:
    return ".".join(comp.replace("__", ".") for comp in path)


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 5:
        arr = arr.transpose(4, 3, 0, 1, 2)
    elif arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif arr.ndim == 2:
        arr = arr.transpose(1, 0)
    return np.ascontiguousarray(arr)


def variables_to_state_dict(
        variables: Mapping[str, Any],
        device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, torch.Tensor]:
    """JAX `{"params": ..., "batch_stats": ...}` (leaves as numpy arrays or
    anything `np.asarray` takes) -> torch state_dict on `device`."""
    device = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            key = _path_to_key(path)
            arr = _to_torch_layout(np.asarray(leaf, np.float32))
            out[key] = torch.tensor(arr, device=device)
            if collection == "batch_stats" and path[-1] == "running_mean":
                out[_path_to_key(path[:-1] + ("num_batches_tracked",))] = (
                    torch.zeros((), dtype=torch.long, device=device))
    return out
