"""MNI registration and bias-field correction (counterpart of the JAX
package's `transforms/registration.py`), in place of the reference's
shell-outs to FSL FLIRT and FAST (`detection/preprocessing_utils.py:
11-73`).

- `register_affine`: FLIRT's strategy on the device.  A coarse global
  search (`coarse_search`: centre-of-mass translation with a full-circle
  rotation grid scored by NCC at the coarsest pyramid level, the best 16
  refined there as one batch) picks the starts; each start, and the
  identity, descends the pyramid (Adam on the NCC of a 6/9/12-parameter
  affine, `_register_level`), and the best final NCC wins, a start at
  `early_accept_ncc` or above at once.  It returns the voxel -> voxel
  matrix, so that `apply_transform` carries masks along (FLIRT's
  `-applyxfm`).
- `bias_field_correction`: FAST-like multiplicative bias removal, a
  polynomial fit to the log-intensities of the foreground by one weighted
  least-squares solve.

Each level is a Python loop of autograd steps through `transforms/
spatial.py`'s trilinear sampling, where JAX compiles one `fori_loop`; the
optimizer is torch's Adam with optax's defaults.  The grid's candidates
are scored in chunks of `SEARCH_SAMPLES` sampled voxels, and the 16
refinements (vmapped in JAX) run as one (16, 12) parameter tensor whose
loss is the sum of the rows' losses: each row's gradient is its own, and
Adam is elementwise, so this is 16 independent runs.  Small 3 x 3
products are explicit sums (no TF32 on the card can round them), and the
bias fit's normal equations are summed in float64.
Every function runs on its input's device; arrays go to the card unless
`device` names another.
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.device import as_device_tensor
from .augment import _matmul3, _poly_terms, _rotation_matrix
from .spatial import affine_resample

# voxels sampled at once when the coarse search scores its candidates
SEARCH_SAMPLES = 2 ** 24
PRESELECT = 16          # grid candidates refined at the coarse level


def params_to_affine(params: torch.Tensor, shape) -> torch.Tensor:
    """(..., 12) vectors (tx, ty, tz, rx, ry, rz [rad], log-scales, shears)
    -> (..., 4, 4) output-voxel -> input-voxel matrices about the volume's
    centre, differentiable (`torch.linalg.inv_ex`: the inverse without a
    host check)."""
    t = params[..., 0:3]
    r = _rotation_matrix(params[..., 3:6])
    s = torch.exp(params[..., 6:9])
    sh = params[..., 9:12]
    one, zero = torch.ones_like(sh[..., 0]), torch.zeros_like(sh[..., 0])
    shear = torch.stack([one, sh[..., 0], sh[..., 1], zero, one, sh[..., 2],
                         zero, zero, one], -1).reshape(*sh.shape[:-1], 3, 3)
    m = _matmul3(r, shear) * s[..., None, :]
    center = (torch.tensor(shape, dtype=torch.float32,
                           device=params.device) - 1) / 2
    minv = torch.linalg.inv_ex(m).inverse
    offset = center - _matmul3(minv, (center + t)[..., None])[..., 0]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=params.device)
    return torch.cat([torch.cat([minv, offset[..., None]], -1),
                      bottom.expand(*minv.shape[:-2], 1, 4)], -2)


def _ncc(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8):
    """Normalized cross-correlation over the last three axes (a batch of
    volumes against one)."""
    dims = (-3, -2, -1)
    a = a - a.mean(dim=dims, keepdim=True)
    b = b - b.mean(dim=dims, keepdim=True)
    return (a * b).sum(dims) / torch.sqrt(
        (a * a).sum(dims) * (b * b).sum(dims) + eps)


def _downsample(vol: torch.Tensor, factor: int) -> torch.Tensor:
    """Mean over factor^3 blocks; a ragged edge is dropped."""
    if factor == 1:
        return vol
    d, h, w = (s - s % factor for s in vol.shape)
    v = vol[:d, :h, :w].reshape(d // factor, factor, h // factor, factor,
                                w // factor, factor)
    return v.mean(dim=(1, 3, 5))


def _register_level(moving, fixed, params0, dof_mask, iters: int,
                    lr: float):
    """`iters` Adam steps (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) on
    -NCC(moving warped by params * dof_mask, fixed) from `params0`, (12,)
    or a batch (B, 12) of independent runs.  Returns (params, -NCC at
    them), detached."""
    def losses(p):
        aff = params_to_affine(p * dof_mask, moving.shape)
        return -_ncc(affine_resample(moving, aff, fixed.shape), fixed)

    p = params0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        losses(p).sum().backward()
        opt.step()
    with torch.no_grad():
        return p.detach(), losses(p)


def _center_of_mass(v: torch.Tensor) -> torch.Tensor:
    """Intensity centre of mass over the soft foreground, voxel units."""
    v = torch.clamp_min(v - v.mean(), 0.0)
    total = v.sum() + 1e-8
    coms = []
    for ax in range(3):
        idx = torch.arange(v.shape[ax], dtype=torch.float32, device=v.device)
        marg = v.sum(dim=tuple(a for a in range(3) if a != ax))
        coms.append((marg * idx).sum() / total)
    return torch.stack(coms)


def _candidate_params(angles, com_mv, com_fx, center) -> torch.Tensor:
    """(B, 12) rigid params of rotation candidates (B, 3), each with the
    translation that aligns the centres of mass under its own rotation:
    t = com_fx - c - R(ang) (com_mv - c)."""
    r = _rotation_matrix(angles)
    t = com_fx - center - _matmul3(r, (com_mv - center)[:, None])[..., 0]
    return torch.cat([t, angles, torch.zeros_like(t).repeat(1, 2)], -1)


def _search_scores(moving, fixed, com_mv, com_fx, angles) -> torch.Tensor:
    """NCC of each candidate rigid start (angles (n, 3)) at one pyramid
    level, in chunks of about `SEARCH_SAMPLES` sampled voxels."""
    center = (torch.tensor(moving.shape, dtype=torch.float32,
                           device=moving.device) - 1) / 2
    chunk = max(1, SEARCH_SAMPLES // fixed.numel())
    scores = []
    with torch.no_grad():
        for i in range(0, len(angles), chunk):
            p = _candidate_params(angles[i:i + chunk], com_mv, com_fx, center)
            scores.append(_ncc(affine_resample(
                moving, params_to_affine(p, moving.shape), fixed.shape),
                fixed))
    return torch.cat(scores)


def coarse_search(moving, fixed, level: int = 4,
                  search_range_deg: float = 180.0,
                  search_step_deg: float = 30.0,
                  top_k: int = 3, *, device=None):
    """FLIRT-style global initialisation: centre-of-mass translation plus
    an exhaustive rotation grid (+-range, step, per axis) scored by NCC at
    the `level` downsampling; the best `PRESELECT` grid points each get 60
    rigid Adam steps there (one batch), and the `top_k` best refined ones
    come back as 12-vectors in full-resolution voxel units, on `moving`'s
    device (see `register_affine`)."""
    mv = _downsample(as_device_tensor(moving, device).float(), level)
    fx = _downsample(as_device_tensor(fixed, mv.device).float(), level)
    com_mv, com_fx = _center_of_mass(mv), _center_of_mass(fx)
    center = (torch.tensor(mv.shape, dtype=torch.float32,
                           device=mv.device) - 1) / 2
    grid_deg = np.arange(-search_range_deg, search_range_deg + 1e-6,
                         search_step_deg, dtype=np.float32)
    if search_range_deg >= 180:  # -180 == +180: count the flip once
        grid_deg = grid_deg[grid_deg > -180 + 1e-6]
    grid = np.deg2rad(grid_deg)
    angles = np.asarray(list(itertools.product(grid, grid, grid)), np.float32)
    scores = _search_scores(mv, fx, com_mv, com_fx,
                            torch.from_numpy(angles).to(mv.device))
    order = np.argsort(-scores.cpu().numpy())[:PRESELECT]
    cands = _candidate_params(torch.from_numpy(angles[order]).to(mv.device),
                              com_mv, com_fx, center)
    rigid = torch.tensor([1.0] * 6 + [0.0] * 6, device=mv.device)
    refined, losses = _register_level(mv, fx, cands, rigid, 60, 0.03)
    keep = np.argsort(losses.cpu().numpy())[:top_k]
    scale = torch.tensor([float(level)] * 3 + [1.0] * 9, device=mv.device)
    return [refined[int(i)] * rigid * scale for i in keep]


def register_affine(moving, fixed,
                    levels: Sequence[int] = (4, 2, 1),
                    iters: Sequence[int] = (200, 100, 50),
                    lr: float = 0.03,
                    dof: int = 12,
                    search: bool = True,
                    search_range_deg: float = 180.0,
                    search_step_deg: float = 30.0,
                    search_starts: int = 3,
                    early_accept_ncc: float = 0.95, *,
                    device=None) -> Tuple[np.ndarray, torch.Tensor]:
    """Affine-register `moving` (D, H, W) onto `fixed`'s grid.

    Returns (affine_voxel, a float32 4x4 fixed-voxel -> moving-voxel
    array; the warped volume, a tensor on the device).  dof: 6 (rigid), 9
    (+ scales), 12 (+ shears), FLIRT's -dof options.  `search` runs the
    coarse global stage first and descends the pyramid from its
    `search_starts` best candidates and then the identity, keeping the
    best final NCC; a start that reaches `early_accept_ncc` ends the
    search (pass a value above 1 to descend every start).  `moving` runs
    where it lies (a tensor) or on the card (an array), unless `device`
    names another; `fixed` joins it."""
    moving = as_device_tensor(moving, device).float()
    fixed = as_device_tensor(fixed, moving.device).float()
    dev = moving.device
    starts = [torch.zeros(12, device=dev)]
    if search:
        starts = coarse_search(moving, fixed, level=int(levels[0]),
                               search_range_deg=search_range_deg,
                               search_step_deg=search_step_deg,
                               top_k=search_starts) + starts
    mask = np.zeros(12, np.float32)
    mask[:3] = mask[3:6] = 1
    if dof >= 9:
        mask[6:9] = 1
    if dof >= 12:
        mask[9:12] = 1
    mask = torch.from_numpy(mask).to(dev)

    def descend(params):
        for level, it in zip(levels, iters):
            mv = _downsample(moving, level)
            fx = _downsample(fixed, level)
            # translation params live in voxel units: rescale across levels
            scale_t = torch.tensor([1 / level] * 3 + [1] * 9,
                                   dtype=torch.float32, device=dev)
            p_level, _ = _register_level(mv, fx, params * scale_t, mask,
                                         int(it), lr)
            params = p_level * mask / scale_t
        return params

    best = (None, None, -np.inf)
    for p0 in starts:
        params = descend(p0)
        with torch.no_grad():
            affine = params_to_affine(params, moving.shape)
            warped = affine_resample(moving, affine, out_shape=fixed.shape)
            score = float(_ncc(warped, fixed))
        if score > best[2]:
            best = (affine, warped, score)
        if score >= early_accept_ncc:
            break
    return best[0].cpu().numpy(), best[1]


def apply_transform(vol, affine, out_shape, fill_value: float = 0.0, *,
                    device=None) -> torch.Tensor:
    """Re-apply a registration transform (FLIRT's `.mat` reuse, for lesion
    masks: `detection/preprocessing_utils.py:33-41`)."""
    return affine_resample(as_device_tensor(vol, device).float(), affine,
                           out_shape=out_shape, fill_value=fill_value)


def _poly_basis(shape, order: int, device) -> torch.Tensor:
    """(n_terms, D, H, W) polynomial basis over coordinates in [-1, 1], in
    the JAX package's term order (`augment._poly_terms`)."""
    g = torch.meshgrid(*[torch.linspace(-1.0, 1.0, s, device=device)
                         for s in shape], indexing="ij")
    return torch.stack([g[0] ** i * g[1] ** j * g[2] ** k
                        for i, j, k in _poly_terms(order)])


def bias_field_correction(vol, order: int = 3, eps: float = 1e-6, *,
                          device=None):
    """FAST-like multiplicative bias removal (N4-lite).

    Fits a degree-`order` 3-D polynomial to the log-intensities of the
    foreground (x > mean) by weighted least squares and divides it out,
    its mean over the foreground removed so that the correction is
    shading, not scaling.  Returns (corrected, bias field), float32.

    The normal equations are summed and solved in float64 from the
    float32 basis, where the JAX package sums them in float32: their
    condition number runs to 1e3-1e4, so float32 sums over millions of
    voxels leave 1e-4 of the field's scale to the summation order (an
    H100 and the CPU disagree by that much at 182 x 218 x 182)."""
    vol = as_device_tensor(vol, device).float()
    basis = _poly_basis(vol.shape, order, vol.device)
    nb = basis.shape[0]
    logx = torch.log(torch.clamp_min(vol, eps))
    w = (vol > vol.mean()).float()
    a = basis.reshape(nb, -1).double()
    aw = a * w.reshape(1, -1).double()
    # weighted normal equations: (A W A^T) c = A W y
    coeffs = torch.linalg.solve(
        aw @ a.T + 1e-6 * torch.eye(nb, dtype=torch.float64,
                                    device=vol.device),
        aw @ logx.reshape(-1).double())
    del a, aw
    log_bias = (coeffs.float()[:, None, None, None] * basis).sum(0)
    log_bias = log_bias - (log_bias * w).sum() / torch.clamp_min(w.sum(), 1)
    bias = torch.exp(log_bias)
    return vol / bias, bias
