"""Spatial transforms: crop-or-pad, flips, dense warps and affine
resampling (counterpart of the JAX package's `transforms/spatial.py`).

`affine_resample` is the FLIRT-equivalent applicator: given a
voxel->voxel affine it resamples a volume onto a target grid with
trilinear interpolation.  Sampling is the 8-corner gather of the JAX
package, with clamped indices and `fill_value` only outside
`[0, s - 1]`; `F.grid_sample`'s zero padding would instead blend partial
corners at the border.  Every function runs on its input's device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.functional import crop_or_pad as _crop_or_pad_op


def crop_or_pad(x: torch.Tensor, target_spatial: Sequence[int],
                value: float = 0.0) -> torch.Tensor:
    """torchio CropOrPad on a bare volume (D, H, W), a channel-first
    volume (C, D, H, W), or a channels-last batch (N, D, H, W, C)."""
    if x.ndim == 3:
        return _crop_or_pad_op(x[None, ..., None], target_spatial,
                               value=value)[0, ..., 0]
    if x.ndim == 4:
        y = _crop_or_pad_op(x.movedim(0, -1)[None], target_spatial,
                            value=value)
        return y[0].movedim(-1, 0)
    return _crop_or_pad_op(x, target_spatial, value=value)


def flip(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Flip the listed axes of a (D, H, W) volume."""
    return torch.flip(x, dims=tuple(axes))


def trilinear_sample(vol: torch.Tensor, coords: torch.Tensor,
                     fill_value: float = 0.0) -> torch.Tensor:
    """Sample (D, H, W) `vol` at float `coords` (3, ...) with trilinear
    interpolation; reads outside `[0, s - 1]` on any axis give
    `fill_value`, and the corners of a read on the last voxel are clamped
    into the volume."""
    d, h, w = vol.shape
    cd, ch, cw = coords[0], coords[1], coords[2]
    d0, h0, w0 = (torch.floor(c).to(torch.int64) for c in (cd, ch, cw))
    td, th, tw = cd - d0, ch - h0, cw - w0
    valid = ((cd >= 0) & (cd <= d - 1) & (ch >= 0) & (ch <= h - 1)
             & (cw >= 0) & (cw <= w - 1))
    flat = vol.reshape(-1)

    def gather(dd, hh, ww):
        dd, hh = dd.clamp(0, d - 1), hh.clamp(0, h - 1)
        return flat[(dd * h + hh) * w + ww.clamp(0, w - 1)]

    out = torch.zeros(td.shape, dtype=vol.dtype, device=vol.device)
    for bd in (0, 1):
        for bh in (0, 1):
            for bw in (0, 1):
                wgt = ((td if bd else 1 - td) * (th if bh else 1 - th)
                       * (tw if bw else 1 - tw))
                out = out + wgt * gather(d0 + bd, h0 + bh, w0 + bw)
    return torch.where(valid, out, fill_value)


def _output_grid(shape: Sequence[int], device) -> torch.Tensor:
    """(3, *shape) float32 voxel coordinates of the output grid."""
    return torch.stack(torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=device)
          for s in shape], indexing="ij"))


def affine_resample(vol: torch.Tensor, affine_vox, out_shape=None,
                    fill_value: float = 0.0) -> torch.Tensor:
    """Resample (D, H, W) `vol` onto `out_shape` through a 4x4 voxel->voxel
    affine mapping *output* voxel coordinates to *input* ones, or through
    each of a batch (..., 4, 4) of them: (..., *out_shape).  The
    coordinates are formed in float32 by explicit products and sums, not
    a matmul, so that TF32 cannot round them (JAX forms them with a
    `Precision.HIGHEST` matmul); a tensor affine stays differentiable."""
    out_shape = tuple(vol.shape if out_shape is None else out_shape)
    g = _output_grid(out_shape, vol.device)
    a = torch.as_tensor(affine_vox, dtype=torch.float32).to(vol.device)
    batch = a.shape[:-2]
    a = a.reshape(-1, 4, 4)[..., None, None, None]
    src = torch.stack([a[:, i, 0] * g[0] + a[:, i, 1] * g[1]
                       + a[:, i, 2] * g[2] + a[:, i, 3] for i in range(3)])
    return trilinear_sample(vol, src, fill_value).reshape(*batch, *out_shape)


def warp_dense(vol: torch.Tensor, displacement: torch.Tensor,
               fill_value: float = 0.0) -> torch.Tensor:
    """Warp (D, H, W) `vol` by a dense displacement field (3, D, H, W) in
    voxels: out[p] = vol[p + disp[p]] (a backward warp)."""
    return trilinear_sample(vol, _output_grid(vol.shape, vol.device)
                            + displacement, fill_value)


def world_affine_to_voxel(src_affine: np.ndarray, dst_affine: np.ndarray,
                          world_transform=None) -> np.ndarray:
    """Compose NIfTI affines into the voxel->voxel matrix `affine_resample`
    expects (dst voxel -> src voxel): inv(src) @ inv(world) @ dst."""
    wt = np.eye(4) if world_transform is None else np.asarray(world_transform)
    return (np.linalg.inv(np.asarray(src_affine)) @ np.linalg.inv(wt)
            @ np.asarray(dst_affine))
