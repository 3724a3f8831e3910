"""Seeded inputs and weights of the benchmark, made on the device from
`--seed` with one `torch.Generator` (after the generators of the port's
rehearsal script: T1w-like volumes and FreeSurfer-like label maps, with
subjects that differ as a cohort's do: noise, contrast, bias field, the
extent of the labelled structures).  Each property takes the same evenly spaced values in every
seed's pool, in the seed's own order, so every seed does the same work.
The same seed on the same device gives the same tensors; both the program
and the plain reference are handed what is made here.
"""
from __future__ import annotations

import math

import torch

# FreeSurfer subcortical ids that the segmentation target counts as
# foreground (reference `segmentation/routine.py:70-71`)
LIST_FCD = (8, 10, 11, 12, 13, 16, 17, 18, 26, 47, 49, 50, 51, 52, 53, 54,
            58, 85, 251, 252, 253, 254, 255)


def generator(seed: int, device) -> torch.Generator:
    """One generator for a run; a seed of any size keeps its low 63 bits."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def ladder(gen: torch.Generator, n: int, lo: float, hi: float,
           device) -> torch.Tensor:
    """n values evenly spaced over [lo, hi], in an order drawn from `gen`:
    every seed's pool holds the same set of subjects, in its own order."""
    steps = torch.linspace(lo, hi, n, device=device)
    return steps[torch.randperm(n, generator=gen, device=device)]


def _sphere_r2(ax, c):
    return ((ax - c[0])[:, None, None] ** 2 + (ax - c[1])[None, :, None] ** 2
            + (ax - c[2])[None, None, :] ** 2)


def t1_like(gen: torch.Generator, n: int, size: int, device
            ) -> torch.Tensor:
    """(n, size, size, size) float32 T1w-like cubes that differ from subject
    to subject as a cohort's scans do: N(600, sigma) noise (sigma 25-60),
    six smooth bright blobs (radius size/24 .. size/10,
    amplitude 250-550 by subject) and a linear bias field along one axis
    (gain -0.15 .. +0.15 across the volume by subject)."""
    ax = torch.arange(size, device=device, dtype=torch.float32)
    sigma = ladder(gen, n, 25, 60, device)
    amp = ladder(gen, n, 250, 550, device)
    bias = ladder(gen, n, -0.15, 0.15, device)
    v = 600 + sigma[:, None, None, None] * torch.randn(
        (n, size, size, size), generator=gen, device=device)
    centres = size / 8 + torch.rand((n, 6, 3), generator=gen,
                                    device=device) * (size * 3 / 4)
    radii = size / 24 + torch.rand((n, 6), generator=gen, device=device) * (
        size / 10 - size / 24)
    ramp = (ax - size / 2) / size
    for i in range(n):
        for b in range(6):
            r = radii[i, b]
            v[i] += amp[i] * torch.exp(-_sphere_r2(ax, centres[i, b])
                                       / (2 * r * r))
        v[i] *= 1 + bias[i] * ramp[:, None, None]
    return v


def znorm(v: torch.Tensor) -> torch.Tensor:
    """Per-volume (x - mean) / std over the whole volume, float32."""
    dims = tuple(range(1, v.ndim))
    mean = v.mean(dim=dims, keepdim=True)
    var = v.var(dim=dims, unbiased=False, keepdim=True)
    return (v - mean) / torch.sqrt(var + 1e-9)


def with_labels(gen: torch.Generator, v: torch.Tensor):
    """FreeSurfer-like int16 label maps for the float cubes `v` (n, S, S, S):
    background ids outside LIST_FCD (2 and 41 by hemisphere), cortical ids
    1000-1034 in a sphere of radius S/7 .. S/4 by subject (1.2-6.5% of the
    volume) that is also 150-450 brighter in the image, and the
    subcortical id 17 in a sphere of radius S/20 .. S/12.  Returns
    (brightened v, labels)."""
    n, size = v.shape[0], v.shape[1]
    ax = torch.arange(size, device=v.device, dtype=torch.float32)
    lab = torch.full(v.shape, 2, dtype=torch.int16, device=v.device)
    lab[:, :, :, size // 2:] = 41
    radius = (ladder(gen, n, size / 7, size / 4, v.device),
              ladder(gen, n, size / 20, size / 12, v.device))
    bright = ladder(gen, n, 150, 450, v.device)
    centres = size / 4 + torch.rand((n, 2, 3), generator=gen,
                                    device=v.device) * (size / 2)
    for i in range(n):
        for k in range(2):
            r2 = _sphere_r2(ax, centres[i, k])
            inside = r2 <= radius[k][i] ** 2
            if k == 0:
                ids = (1000 + r2.long() % 35).to(torch.int16)
                v[i] += bright[i] * inside
            else:
                ids = torch.full_like(lab[i], 17)
            lab[i] = torch.where(inside, ids, lab[i])
    return v, lab


def seg_pool(gen, n: int, size: int, device):
    """(inputs (n, S, S, S, 1) z-normalized float32, labels (n, S, S, S, 1)
    int16) of a segmentation training pool, on `device`."""
    v, lab = with_labels(gen, t1_like(gen, n, size, device))
    return znorm(v)[..., None], lab[..., None]


def binarize(labels: torch.Tensor) -> torch.Tensor:
    """The segmentation target: LIST_FCD ids, cortical ids >= 1000 and ids
    equal to 1 -> 1.0, the rest 0.0 (float32)."""
    li = labels.to(torch.int32)
    ids = torch.tensor(LIST_FCD, dtype=torch.int32, device=labels.device)
    return (torch.isin(li, ids) | (li >= 1000) | (li == 1)).float()


def uniform_leaves(gen, shapes, bounds, device) -> list:
    """Tensors of `shapes`, each U(-bound, bound), from one draw of the
    generator (float32)."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, o = [], 0
    for s, k, b in zip(shapes, sizes, bounds):
        out.append((flat[o:o + k] * b).reshape(s))
        o += k
    return out
