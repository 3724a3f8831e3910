"""Random augmentations (counterpart of the JAX package's
`transforms/augment.py`): the torchio transforms the reference composes in
`segmentation/baseline_3d_unet.ipynb` cell 8 (RandomFlip, RandomAffine,
RandomElasticDeformation, RandomNoise, RandomMotion, RandomBiasField).

Every transform has the signature `fn(gen, vol) -> vol` over a (D, H, W)
tensor and runs on the volume's device; `gen` is a `torch.Generator`,
where JAX takes a key.  Each draws its few parameters from `gen` (on the
generator's device) and then calls a deterministic core
(`_add_noise`, `_apply_bias_field`, `_affine_from_params`,
`_elastic_from_control_points`, `_motion`) that takes them explicitly.
The dense noise field is drawn on the volume's device: with `gen` when it
lives there, else with a generator on that device seeded from a draw of
`gen`, so one seed gives one result on either device pairing.  Affine
matrices are formed in float32 on the host (3x3 products and an inverse),
where no TF32 can round them.

`Compose` and `OneOf` mirror torchio's composition API; `OneOf` draws
its branch from the generator.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from ..ops.functional import generator_on as _generator_on
from ..ops.functional import resize_linear
from .spatial import affine_resample, flip, warp_dense


def _uniform(gen: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    """float32 U(lo, hi) draws from `gen`, on the generator's device."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def random_flip(gen, vol, axes: Sequence[int] = (0,),
                flip_probability: float = 0.5):
    """torchio RandomFlip: flip each listed axis with probability p."""
    draws = [float(_uniform(gen, (), 0.0, 1.0)) for _ in axes]
    flipped = [ax for ax, u in zip(axes, draws) if u < flip_probability]
    return flip(vol, flipped) if flipped else vol


def _add_noise(vol, mean: float, std, field):
    return vol + mean + std * field


def random_noise(gen, vol, mean: float = 0.0,
                 std: Tuple[float, float] = (0.0, 0.25)):
    """torchio RandomNoise: additive gaussian noise, std ~ U(std range)."""
    s = _uniform(gen, (), *std).to(vol.device)
    field = torch.randn(vol.shape, generator=_generator_on(gen, vol.device),
                        device=vol.device, dtype=vol.dtype)
    return _add_noise(vol, mean, s, field)


def _poly_terms(order: int):
    """Exponents (i, j, k) of the polynomial basis, in the JAX package's
    `_poly_basis` order."""
    return [(i, j, k) for i in range(order + 1)
            for j in range(order + 1 - i)
            for k in range(order + 1 - i - j)]


def _apply_bias_field(vol, coeffs, order: int):
    """vol * exp(sum_t coeffs[t] x^i y^j z^k), coordinates in [-1, 1]; the
    terms are summed one by one without a stacked (terms, D, H, W) basis."""
    g = [torch.linspace(-1.0, 1.0, s, device=vol.device) for s in vol.shape]
    gx, gy, gz = g[0][:, None, None], g[1][None, :, None], g[2][None, None, :]
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32).to(vol.device)
    field = torch.zeros(vol.shape, device=vol.device)
    for c, (i, j, k) in zip(coeffs, _poly_terms(order)):
        field = field + c * (gx ** i * gy ** j * gz ** k)
    return vol * torch.exp(field)


def random_bias_field(gen, vol, coefficients: float = 0.5, order: int = 3):
    """torchio RandomBiasField: multiply by exp(polynomial field)."""
    coeffs = _uniform(gen, (len(_poly_terms(order)),), -coefficients,
                      coefficients)
    return _apply_bias_field(vol, coeffs, order)


def _rotation_matrix(angles_rad: torch.Tensor) -> torch.Tensor:
    cx, cy, cz = torch.cos(angles_rad)
    sx, sy, sz = torch.sin(angles_rad)
    one, zero = torch.ones(()), torch.zeros(())
    rx = torch.stack([torch.stack(r) for r in (
        (one, zero, zero), (zero, cx, -sx), (zero, sx, cx))])
    ry = torch.stack([torch.stack(r) for r in (
        (cy, zero, sy), (zero, one, zero), (-sy, zero, cy))])
    rz = torch.stack([torch.stack(r) for r in (
        (cz, -sz, zero), (sz, cz, zero), (zero, zero, one))])
    return rx @ ry @ rz


def _affine_from_params(shape, scales, degrees, translation
                        ) -> torch.Tensor:
    """The 4x4 float32 output-voxel -> input-voxel affine of a scale,
    rotation (degrees about x, y, z) and translation about the volume's
    centre, on the host."""
    sc, ang, tr = (torch.as_tensor(v, dtype=torch.float32).cpu()
                   for v in (scales, degrees, translation))
    r = _rotation_matrix(torch.deg2rad(ang)) * sc[None, :]
    center = (torch.tensor(shape, dtype=torch.float32) - 1) / 2
    rinv = torch.linalg.inv(r)
    affine = torch.eye(4)
    affine[:3, :3] = rinv
    affine[:3, 3] = center - rinv @ (center + tr)
    return affine


def _affine_params(gen, scales, degrees, translation):
    return (_uniform(gen, (3,), *scales), _uniform(gen, (3,), -degrees,
                                                   degrees),
            _uniform(gen, (3,), -translation, translation))


def random_affine(gen, vol, scales: Tuple[float, float] = (0.9, 1.1),
                  degrees: float = 10.0, translation: float = 0.0,
                  fill_value: float = 0.0):
    """torchio RandomAffine: random scale, rotation and translation about
    the volume centre, trilinear resampling."""
    affine = _affine_from_params(
        vol.shape, *_affine_params(gen, scales, degrees, translation))
    return affine_resample(vol, affine, fill_value=fill_value)


def _elastic_from_control_points(vol, cp, fill_value: float = 0.0):
    """Warp by the (3, n, n, n) control-point displacements, upsampled to
    a dense field by separable linear interpolation (align_corners)."""
    cp = torch.as_tensor(cp, dtype=torch.float32).to(vol.device)
    field = resize_linear(cp.movedim(0, -1)[None], vol.shape,
                          align_corners=True)[0]
    return warp_dense(vol, field.movedim(-1, 0), fill_value)


def random_elastic_deformation(gen, vol, num_control_points: int = 7,
                               max_displacement: float = 7.5,
                               fill_value: float = 0.0):
    """torchio RandomElasticDeformation: random coarse control-grid
    displacements upsampled to a dense field (trilinear B-spline-lite)."""
    n = num_control_points
    cp = _uniform(gen, (3, n, n, n), -max_displacement, max_displacement)
    return _elastic_from_control_points(vol, cp, fill_value)


def _motion(vol, affines):
    acc = vol
    for affine in affines:
        acc = acc + affine_resample(vol, affine)
    return acc / (len(affines) + 1)


def random_motion(gen, vol, degrees: float = 10.0, translation: float = 10.0,
                  num_transforms: int = 2):
    """Simplified torchio RandomMotion: the mean of the volume and a few
    rigidly displaced copies (a ghosting-style artifact in image space,
    as in the JAX package)."""
    return _motion(vol, [
        _affine_from_params(vol.shape, *_affine_params(
            gen, (1.0, 1.0), degrees, translation))
        for _ in range(num_transforms)])


class Compose:
    """torchio-style Compose over `fn(gen, vol)` transforms."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, gen, vol):
        for fn in self.transforms:
            vol = fn(gen, vol)
        return vol


class OneOf:
    """torchio OneOf: apply one transform chosen at random (equal
    weights)."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, gen, vol):
        idx = int(torch.randint(0, len(self.transforms), (), generator=gen,
                                device=gen.device))
        return self.transforms[idx](gen, vol)
