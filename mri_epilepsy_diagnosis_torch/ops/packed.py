"""Space-to-depth ("packed") layout ops of the packed UNet3D serving path
(counterpart of the JAX package's `ops/packed.py`, forward subset).

A channels-last `(N, D, H, W, C)` volume packs 2x2x2 voxel blocks into
channels: `(N, D/2, H/2, W/2, 8C)`, channel index `(sd, sh, sw, c)`
sub-position-major.  A fine k=3/pad=1 conv is then a k=2 conv over packed
cells in one of two parities:

- shifted -> aligned (`conv3_packed`): a VALID k=2 conv over the packing of
  the volume shifted by one voxel, `(N, S/2+1, ..., 8Ci)` -> `(N, S/2,
  ..., 8Co)`, with weights from `pack_weights2`;
- aligned -> shifted (`conv3_packed_as`): a pad-1 k=2 conv from the aligned
  packing to the shifted one, weights from `pack_weights2_as`.

Both run as kernel B1 (`ops/cuda_kernels.py::conv2_packed`).  The shifted
layout carries one pad voxel per axis (fine -1 and S); after the
aligned->shifted conv's BN/PReLU they are re-zeroed, fused into kernel B2
(`bn_act_zero_pads`) on the served path.

Fine conv weights arrive in torch layout `(Co, Ci, 3, 3, 3)`; packed
weights are `(2, 2, 2, 8Ci, 8Co)`, as in JAX.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import cuda_kernels as K
from . import functional as F

# ---------------------------------------------------------------------------
# packing / unpacking
# ---------------------------------------------------------------------------


def pack2(x: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D/2, H/2, W/2, 8C), channel = (sd, sh, sw, c).
    Spatial dims must be even."""
    n, d, h, w, c = x.shape
    x = x.reshape(n, d // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(n, d // 2, h // 2, w // 2, 8 * c)


def unpack2(y: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack2`."""
    n, d2, h2, w2, c8 = y.shape
    c = c8 // 8
    y = y.reshape(n, d2, h2, w2, 2, 2, 2, c)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(n, 2 * d2, 2 * h2, 2 * w2, c)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _axis_table_sa():
    """Per-axis tensor A[t, q, r, s] = 1 iff output sub s's tap t reads
    shifted-input cell offset q sub r ((q, r) = divmod(s + t, 2))."""
    a = np.zeros((3, 2, 2, 2), np.float32)
    for t in range(3):
        for s in range(2):
            q, r = divmod(s + t, 2)
            a[t, q, r, s] = 1.0
    return a


@functools.lru_cache(maxsize=None)
def _axis_table_as():
    """Per-axis tensor A[t, p, q, r] = 1 iff shifted output sub r's tap t
    reads aligned cell offset p (kernel index) sub q
    ((p - 1, q) = divmod(r + t - 2, 2))."""
    a = np.zeros((3, 2, 2, 2), np.float32)
    for t in range(3):
        for r in range(2):
            o, q = divmod(r + t - 2, 2)
            a[t, o + 1, q, r] = 1.0
    return a


@functools.lru_cache(maxsize=None)
def _packed_tap_index(kind: str) -> np.ndarray:
    """Flat fine-tap index (td*9 + th*3 + tw, or 27 for "no tap") of every
    packed weight entry, shaped (qd,qh,qw, rd,rh,rw, sd,sh,sw)."""
    a = _axis_table_sa() if kind == "sa" else _axis_table_as()
    tap = np.full((2, 2, 2), -1, np.int64)            # [q, r, s] -> t
    for t, q, r, s in zip(*np.nonzero(a)):
        tap[q, r, s] = t
    td = tap[:, None, None, :, None, None, :, None, None]
    th = tap[None, :, None, None, :, None, None, :, None]
    tw = tap[None, None, :, None, None, :, None, None, :]
    valid = (td >= 0) & (th >= 0) & (tw >= 0)
    return np.where(valid, td * 9 + th * 3 + tw, 27)


@functools.lru_cache(maxsize=None)
def _device_tap_index(kind: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_packed_tap_index(kind), device=device)


def _pack_weights(w: torch.Tensor, kind: str) -> torch.Tensor:
    co, ci = w.shape[0], w.shape[1]
    if tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"expected a (Co, Ci, 3, 3, 3) kernel, got "
                         f"{tuple(w.shape)}")
    taps = w.permute(2, 3, 4, 1, 0).reshape(27, ci, co)
    taps = torch.cat([taps, taps.new_zeros(1, ci, co)])
    # exact gather: (2,)*9 + (ci, co), one fine tap or zero per entry
    wp = taps[_device_tap_index(kind, w.device)]
    wp = wp.permute(0, 1, 2, 3, 4, 5, 9, 6, 7, 8, 10)
    return wp.reshape(2, 2, 2, 8 * ci, 8 * co)


def pack_weights2(w: torch.Tensor) -> torch.Tensor:
    """Fine (Co, Ci, 3, 3, 3) kernel -> packed (2, 2, 2, 8Ci, 8Co) for the
    shifted -> aligned conv: entry [q, (r, ci), (s, co)] = w[t] where output
    sub s's tap t lands on shifted-input cell offset q sub r,
    q, r = divmod(s + t, 2) per axis; 27 of 64 (q, r, s) are populated."""
    return _pack_weights(w, "sa")


def pack_weights2_as(w: torch.Tensor) -> torch.Tensor:
    """Fine (Co, Ci, 3, 3, 3) kernel -> packed (2, 2, 2, 8Ci, 8Co) mapping
    aligned input cells to shifted output cells (`conv3_packed_as`)."""
    return _pack_weights(w, "as")


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------


def tile_channel_param(p: torch.Tensor) -> torch.Tensor:
    """Fine per-channel parameter (C,) -> packed (8C,)."""
    return p.repeat(8)


def _tiled_bias(bias):
    return None if bias is None else tile_channel_param(bias).float()


def conv3_packed(xp_shifted: torch.Tensor, wp: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k=2 VALID conv over shifted-packed input == fine k=3/pad=1 conv.

    xp_shifted: (N, S/2+1, ..., 8Ci); wp: (2, 2, 2, 8Ci, 8Co) from
    `pack_weights2`, cast to the input dtype; bias: fine (Co,), added in
    float32 before the output's one rounding.  Returns the aligned packed
    output (N, S/2, ..., 8Co)."""
    wp = wp.to(xp_shifted.dtype).contiguous()
    return K.conv2_packed(xp_shifted.contiguous(), wp, _tiled_bias(bias),
                          pad=0)


def conv3_packed_as(xp_aligned: torch.Tensor, wp: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fine k=3/pad=1 conv as a k=2/pad=1 packed conv, aligned -> shifted.

    xp_aligned: (N, S/2, ..., 8Ci); wp from `pack_weights2_as`.  Returns
    the shifted packed output (N, S/2+1, ..., 8Co), whose pad voxels hold
    the conv's zero-padded extrapolation (bias alone)."""
    wp = wp.to(xp_aligned.dtype).contiguous()
    return K.conv2_packed(xp_aligned.contiguous(), wp, _tiled_bias(bias),
                          pad=1)


def conv1_packed_blockdiag(xp: torch.Tensor, w: torch.Tensor,
                           bias: Optional[torch.Tensor] = None):
    """Fine 1x1x1 conv (the classifier head) in packed layout, as one
    product with the block-diagonal (8Ci, 8Co) weight kron(I_8, w).
    w: torch (Co, Ci, 1, 1, 1) or (Co, Ci)."""
    co, ci = w.shape[0], w.shape[1]
    wt = w.reshape(co, ci).t().contiguous()
    wb = torch.kron(torch.eye(8, dtype=wt.dtype, device=wt.device), wt)
    y = torch.matmul(xp, wb.to(xp.dtype))
    if bias is not None:
        y = y + tile_channel_param(bias).to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# norm / pool / resize / concat
# ---------------------------------------------------------------------------


def batch_norm_packed(xp, mean, var, gamma, beta, eps: float = 1e-5):
    return F.batch_norm(xp, tile_channel_param(mean), tile_channel_param(var),
                        tile_channel_param(gamma), tile_channel_param(beta),
                        eps)


def maxpool2_packed(xp: torch.Tensor) -> torch.Tensor:
    """Fine 2x2x2/stride-2 maxpool, packed -> packed at the pooled scale:
    (N, S/2, ..., 8C) -> (N, S/4, ..., 8C).  The fine pooling windows are
    the packed sub-positions, so this is a sub-axis max + repack."""
    n, d, h, w, c8 = xp.shape
    pooled = xp.reshape(n, d, h, w, 8, c8 // 8).amax(dim=4)
    return pack2(pooled)


@functools.lru_cache(maxsize=None)
def _device_upsample_matrix(fine_in: int, dtype, device) -> torch.Tensor:
    """Fine trilinear x2 matrix (2 fine_in, fine_in), align_corners=False."""
    return torch.as_tensor(F._linear_matrix(fine_in, 2 * fine_in, False),
                           dtype=dtype, device=device)


def upsample2_packed(xp: torch.Tensor) -> torch.Tensor:
    """Fine trilinear 2x upsample (align_corners=False), packed -> packed:
    cells of the coarse grid -> cells of the doubled grid.  Per axis: move
    that axis's sub bit next to its cell axis (the fine axis), apply the
    fine interpolation matrix, re-fold the sub bit."""
    n = xp.shape[0]
    c8 = xp.shape[-1]
    y = xp.reshape(n, *xp.shape[1:4], 2, 2, 2, c8 // 8)
    for ax in range(3):
        fine_in = 2 * y.shape[1 + ax]
        m = _device_upsample_matrix(fine_in, y.dtype, y.device)
        y = y.movedim(4 + ax, 2 + ax)
        shp = y.shape
        y = y.reshape(*shp[:1 + ax], fine_in, *shp[3 + ax:])
        y = torch.matmul(y.movedim(1 + ax, -1), m.t()).movedim(-1, 1 + ax)
        y = y.reshape(*shp[:1 + ax], fine_in, 2, *shp[3 + ax:])
        y = y.movedim(2 + ax, 4 + ax)
    return y.reshape(n, *[2 * s for s in xp.shape[1:4]], c8)


def concat_channels_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fine channel concat in packed layout: per-sub interleave."""
    n, d, h, w, ca = a.shape
    cb = b.shape[-1]
    return torch.cat([a.reshape(n, d, h, w, 8, ca // 8),
                      b.reshape(n, d, h, w, 8, cb // 8)], dim=-1).reshape(
        n, d, h, w, ca + cb)


# ---------------------------------------------------------------------------
# shifted-layout pad masks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _shifted_pad_masks(c8: int):
    """Channel masks (numpy, (8C,)) keeping only NON-pad sub-positions for
    the first/last cell along each axis of a shifted tensor: the first
    cell's sub 0 of axis a is fine voxel -1 (pad); the last cell's sub 1 is
    fine S."""
    masks = []
    c = c8 // 8
    for axis in range(3):
        sub = np.arange(c8) // c
        bitval = (sub >> (2 - axis)) & 1
        lo = (bitval == 1).astype(np.float32)   # first cell: keep sub 1
        hi = (bitval == 0).astype(np.float32)   # last cell: keep sub 0
        masks.append((lo, hi))
    return masks


@functools.lru_cache(maxsize=None)
def _shifted_pad_axis_mask(axis: int, cells: int, c8: int) -> np.ndarray:
    """(cells, c8) multiplier: 1 everywhere except the pad sub-positions of
    the first/last cell along `axis`."""
    lo, hi = _shifted_pad_masks(c8)[axis]
    m = np.ones((cells, c8), np.float32)
    m[0] = lo
    m[-1] = hi
    return m


@functools.lru_cache(maxsize=None)
def _device_pad_masks(cells: tuple, c8: int, device: torch.device):
    return tuple(torch.as_tensor(_shifted_pad_axis_mask(a, cells[a], c8),
                                 device=device) for a in range(3))


def shifted_pad_mask_tensors(xs: torch.Tensor):
    """The three float32 (cells, C8) pad-mask planes of shifted tensor xs,
    on xs's device (made once per shape and device: a host-to-device copy
    per call would stall the host behind the device's queue)."""
    return _device_pad_masks(tuple(xs.shape[1:4]), xs.shape[-1], xs.device)


def zero_shifted_pads(xs: torch.Tensor) -> torch.Tensor:
    """Zero the pad voxels of a shifted packed tensor: one multiply by the
    product of three broadcast per-axis masks."""
    md, mh, mw = (m.to(xs.dtype) for m in shifted_pad_mask_tensors(xs))
    return (xs * md[:, None, None, :] * mh[None, :, None, :]
            * mw[None, None, :, :])


def bn_act_zero_pads(xs, scale, shift, alpha) -> torch.Tensor:
    """`zero_shifted_pads(prelu(xs * scale + shift, alpha))` with packed
    (8C,) scale, shift and alpha: kernel B2 on CUDA tensors."""
    return K.bn_act_zero_pads(xs.contiguous(), scale, shift, alpha,
                              shifted_pad_mask_tensors(xs))
