"""Batched sliding-window whole-volume inference (counterpart of the JAX
package's `infer/sliding_window.py`).

Replaces the torchio GridSampler/GridAggregator pattern the reference
uses for patch-trained models (`pretraining_3d_unet.ipynb` cells 26/35:
patch 64^3, overlap 4, argmax -> aggregate):

- `grid_locations` computes the patch grid (stride = patch - overlap, the
  last patch clamped to the far edge: torchio semantics);
- the patches are sliced out of the volume on its device and run through
  the model in chunks of `batch_size` (the last chunk padded with zeros);
- aggregation averages overlaps ('average') or performs torchio's
  centre-crop paste ('crop': crop overlap // 2 on each face that does not
  touch the border, overwrite in grid order).

`GridSampler` and `GridAggregator` are the host-side torchio facades.
"""
from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.device import as_device_tensor


def _axis_locations(size: int, patch: int, stride: int) -> np.ndarray:
    if size <= patch:
        return np.array([0])
    locs = list(range(0, size - patch + 1, stride))
    if locs[-1] != size - patch:
        locs.append(size - patch)
    return np.array(locs)


def grid_locations(spatial_shape: Sequence[int], patch_size, overlap=0
                   ) -> np.ndarray:
    """(P, 3) corner indices covering the volume (torchio GridSampler)."""
    patch = np.broadcast_to(np.asarray(patch_size), (3,))
    over = np.broadcast_to(np.asarray(overlap), (3,))
    strides = patch - over
    axes = [_axis_locations(s, p, st)
            for s, p, st in zip(spatial_shape, patch, strides)]
    return np.array(list(itertools.product(*axes)), np.int32)


def extract_patches(vol: torch.Tensor, locations, patch_size
                    ) -> torch.Tensor:
    """vol (D, H, W, C), locations (P, 3) -> (P, pd, ph, pw, C)."""
    pd, ph, pw = (int(p) for p in np.broadcast_to(np.asarray(patch_size),
                                                  (3,)))
    return torch.stack([vol[a:a + pd, b:b + ph, c:c + pw]
                        for a, b, c in np.asarray(locations).tolist()])


def _coverage(spatial, locations, patch, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """Patches covering each voxel (at least 1), (*spatial, 1), built on
    `device` (the CPU by default) with one in-place add per patch."""
    cnt = torch.zeros(tuple(spatial) + (1,), dtype=dtype, device=device)
    for l0, l1, l2 in np.asarray(locations).tolist():
        cnt[l0:l0 + patch[0], l1:l1 + patch[1], l2:l2 + patch[2]] += 1.0
    return cnt.clamp_min_(1.0)


def _crop_boxes(spatial, locations, patch, overlap):
    """Per-patch centre-crop boxes, torchio GridAggregator
    `overlap_mode='crop'` semantics (`pretraining_3d_unet.ipynb` cells
    26/35 run this mode by default): every patch is cropped by
    ``overlap // 2`` on each face EXCEPT faces touching the volume border,
    which keep their margin; the cropped patch is pasted (overwritten, not
    averaged) in grid order.  Returns [(lead, stop, dst_lo, dst_hi)] per
    patch, all python ints."""
    half = np.broadcast_to(np.asarray(overlap), (3,)) // 2
    boxes = []
    for loc in np.asarray(locations):
        lead = [int(h) if int(l) > 0 else 0 for h, l in zip(half, loc)]
        trail = [int(h) if int(l) + int(p) < int(s) else 0
                 for h, l, p, s in zip(half, loc, patch, spatial)]
        stop = [int(p) - t for p, t in zip(patch, trail)]
        dst_lo = [int(l) + ld for l, ld in zip(loc, lead)]
        dst_hi = [int(l) + st for l, st in zip(loc, stop)]
        boxes.append((lead, stop, dst_lo, dst_hi))
    return boxes


def sliding_window_predict(apply_fn: Callable, variables, vol,
                           patch_size=64, overlap=4, batch_size: int = 64,
                           mode: str = "average", num_classes: int = 2,
                           agg: str = "unrolled", *, device=None
                           ) -> torch.Tensor:
    """Whole-volume logits via overlapping patches.

    vol: (D, H, W, C).  Returns (D, H, W, num_classes) aggregated logits
    in the model's output dtype, on the volume's device (a tensor stays
    where it is; a numpy array goes to the card unless `device="cpu"`).
    `apply_fn(variables, patches)` maps (B, pd, ph, pw, C) -> (B, pd, ph,
    pw, classes), typically `models.unet_packed.packed_unet_apply_v2` on
    a BN-folded state dict.  Volumes smaller than a patch are zero-padded
    at the far side; the grid is run in chunks of `batch_size` patches
    (capped at the grid size), the last one zero-padded to a full chunk.
    `agg` takes the JAX package's names ("scatter", "scan", "unrolled"),
    which gave identical sums there; here all three are one loop of
    in-place adds.
    """
    if mode not in ("average", "crop"):
        raise ValueError(f"unknown aggregation mode {mode}")
    if agg not in ("scatter", "scan", "unrolled"):
        raise ValueError(f"unknown aggregation impl {agg}")
    vol = as_device_tensor(vol, device)
    patch = tuple(int(p) for p in np.broadcast_to(np.asarray(patch_size),
                                                  (3,)))
    orig_spatial = tuple(vol.shape[:3])
    if any(s < p for s, p in zip(orig_spatial, patch)):
        # pad volumes smaller than the patch (torchio pads via CropOrPad)
        pads = [0, 0]
        for s, p in reversed(list(zip(orig_spatial, patch))):
            pads += [0, max(0, p - s)]
        vol = torch.nn.functional.pad(vol, pads)
    spatial = tuple(vol.shape[:3])
    locations = grid_locations(spatial, patch, overlap)
    n = len(locations)

    patches = extract_patches(vol, locations, patch)
    batch_size = min(batch_size, n)
    pad = (-n) % batch_size
    if pad:
        patches = torch.cat([patches, patches.new_zeros(
            (pad,) + tuple(patches.shape[1:]))])
    logits = torch.cat([apply_fn(variables, chunk)
                        for chunk in patches.split(batch_size)])[:n]
    del patches

    out = logits.new_zeros(spatial + (num_classes,))
    if mode == "crop":
        for i, (lead, stop, lo, hi) in enumerate(
                _crop_boxes(spatial, locations, patch, overlap)):
            out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = logits[i][
                lead[0]:stop[0], lead[1]:stop[1], lead[2]:stop[2]]
    else:
        for i, (l0, l1, l2) in enumerate(locations.tolist()):
            out[l0:l0 + patch[0], l1:l1 + patch[1],
                l2:l2 + patch[2]] += logits[i]
        out = out / _coverage(spatial, locations, patch, out.device,
                              out.dtype)
    return out[:orig_spatial[0], :orig_spatial[1], :orig_spatial[2]]


class GridSampler:
    """torchio-compatible sampler facade over `grid_locations`."""

    def __init__(self, volume, patch_size=64, patch_overlap=4):
        self.volume = volume
        self.patch_size = patch_size
        self.patch_overlap = patch_overlap
        self.locations = grid_locations(volume.shape[:3], patch_size,
                                        patch_overlap)

    def __len__(self):
        return len(self.locations)

    def patches(self):
        return extract_patches(torch.as_tensor(self.volume), self.locations,
                               self.patch_size)


class GridAggregator:
    """torchio-compatible aggregator: add_batch(labels, locations) then
    get_output_tensor().  Host-side numpy.  `overlap_mode='average'`
    (default) averages overlapping contributions; `'crop'` reproduces
    torchio's centre-crop paste (crop ``patch_overlap // 2`` per
    non-border face, overwrite in batch order; see `_crop_boxes`).  As in
    torchio, 'crop' takes the sampler's overlap, 0 included (then every
    patch is pasted whole); only an unset overlap raises."""

    def __init__(self, spatial_shape, num_classes: int = 1,
                 overlap_mode: str = "average", patch_overlap=None):
        if overlap_mode not in ("average", "crop"):
            raise ValueError(f"unknown overlap_mode {overlap_mode}")
        if overlap_mode == "crop" and patch_overlap is None:
            raise ValueError(
                "overlap_mode='crop' needs the sampler's patch_overlap "
                "(e.g. GridAggregator(..., patch_overlap=sampler."
                "patch_overlap))")
        self.spatial = tuple(spatial_shape)
        self.overlap_mode = overlap_mode
        self.patch_overlap = 0 if patch_overlap is None else patch_overlap
        self.acc = np.zeros(self.spatial + (num_classes,), np.float64)
        self.cnt = np.zeros(self.spatial + (1,), np.float64)

    def add_batch(self, values, locations):
        values = np.asarray(values)
        if values.ndim == 4:  # (B, pd, ph, pw) labels
            values = values[..., None]
        locations = np.asarray(locations)
        if self.overlap_mode == "crop":
            boxes = _crop_boxes(self.spatial, locations, values.shape[1:4],
                                self.patch_overlap)
            for v, (lead, stop, lo, hi) in zip(values, boxes):
                dst = tuple(slice(a, b) for a, b in zip(lo, hi))
                self.acc[dst] = v[lead[0]:stop[0], lead[1]:stop[1],
                                  lead[2]:stop[2]]
                self.cnt[dst] = 1
            return
        for v, loc in zip(values, locations):
            sl = tuple(slice(l, l + s) for l, s in zip(loc, v.shape[:3]))
            self.acc[sl] += v
            self.cnt[sl] += 1

    def get_output_tensor(self):
        return self.acc / np.maximum(self.cnt, 1)
