"""Weight bridge: JAX `variables` pytrees <-> the port's torch `state_dict`,
and JAX's int8 inference pytree -> the port's (`quantized_to_torch`).

The JAX package names its flax modules so that joining a parameter path
with '.' and turning every `__` into '.' gives the torch key
(`encoding_blocks__0` -> `encoding_blocks.0`), and stores arrays
channels-last.  `variables_to_state_dict` inverts the JAX importer's
per-rank transpose:

  rank 5 (conv3d): (kD,kH,kW,I,O) -> (O,I,kD,kH,kW)
                   (a transposed conv's (kD,kH,kW,O,I) -> torch's (I,O,...))
  rank 4 (conv2d): (kH,kW,I,O)    -> (O,I,kH,kW)
  rank 2 (linear): (in,out)       -> (out,in)
  rank 0/1 (bias, norm stats, PReLU): unchanged

A flax automatic norm name (`GroupNorm_0`, `BatchNorm_0`, the norm
inside BraTSUnet's named `bn1`) is dropped from the key, as the
reference's torch keys have no such segment.

`batch_stats` entries keep their leaf names (`running_mean`,
`running_var`) and land beside the `params` of the same module, as in a
torch BatchNorm; every such module also gets torch's
`num_batches_tracked` counter (0), so `load_state_dict` takes the result
with `strict=True`.
"""
from __future__ import annotations

import re
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


# flax's automatic name of a norm built without a name inside a named
# wrapper module (`brats_unet.py::_Norm`: `convd1/bn1/GroupNorm_0/weight`);
# the reference's torch key has no such segment (`convd1.bn1.weight`)
_AUTO_NORM_NAME = re.compile(r"(BatchNorm|GroupNorm|InstanceNorm)_\d+")


def _path_to_key(path) -> str:
    return ".".join(comp.replace("__", ".") for comp in path
                    if not _AUTO_NORM_NAME.fullmatch(comp))


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
        for path, leaf in _flatten(variables.get(collection) or {}):
            key = _path_to_key(path)
            arr = _to_torch_layout(np.asarray(leaf, np.float32))
            out[key] = torch.tensor(arr, device=device)
            if collection == "batch_stats" and path[-1] == "running_mean":
                out[_path_to_key(path[:-1] + ("num_batches_tracked",))] = (
                    torch.zeros((), dtype=torch.long, device=device))
    return out


def quantized_to_torch(q: Mapping[str, Any],
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Dict[str, Any]:
    """The JAX package's int8 inference pytree (`models/unet_packed_q.py::
    quantize_inference`, leaves as numpy arrays or anything `np.asarray`
    takes) -> the port's (`models.unet_packed_q`), on `device`.

    Per site `w8`, `dq`, `b`, `alpha`, `rq`; at each decoder conv1 also
    `w8_u`, `dq_u` and `w_u_fine`; then `in_rq`, `head` and `nb`.  The
    packed int8 kernels ((2, 2, 2, 8Ci, 8Co), the composed (5, 5, 5, 8Ci,
    8Co), the head's (8Ci, 8Co)) have the same layout in both packages and
    keep their values and dtype; the fine `w_u_fine` goes from JAX's
    (kD, kH, kW, Ci, Co) to torch's (Co, Ci, kD, kH, kW); `nb` becomes an
    int and a None leaf stays None."""
    device = resolve_device(device)

    def leaf(key, v):
        if v is None:
            return None
        arr = np.asarray(v)
        if key == "w_u_fine":
            arr = _to_torch_layout(arr.astype(np.float32))
        return torch.tensor(np.ascontiguousarray(arr), device=device)

    out: Dict[str, Any] = {}
    for key, value in q.items():
        if key == "nb":
            out[key] = int(np.asarray(value))
        elif isinstance(value, Mapping):
            out[key] = {k: leaf(k, v) for k, v in value.items()}
        else:
            out[key] = leaf(key, value)
    return out
