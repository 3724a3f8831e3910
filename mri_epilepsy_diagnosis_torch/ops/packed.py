"""Space-to-depth ("packed") layout ops of the packed UNet3D serving and
training paths (counterpart of the JAX package's `ops/packed.py`, the
explicit-decoder subset).

A channels-last `(N, D, H, W, C)` volume packs 2x2x2 voxel blocks into
channels: `(N, D/2, H/2, W/2, 8C)`, channel index `(sd, sh, sw, c)`
sub-position-major.  A fine k=3/pad=1 conv is then a k=2 conv over packed
cells in one of two parities:

- shifted -> aligned (`conv3_packed`): a VALID k=2 conv over the packing of
  the volume shifted by one voxel, `(N, S/2+1, ..., 8Ci)` -> `(N, S/2,
  ..., 8Co)`, with weights from `pack_weights2`;
- aligned -> shifted (`conv3_packed_as`): a pad-1 k=2 conv from the aligned
  packing to the shifted one, weights from `pack_weights2_as`.

Both run as kernel B1 (`ops/cuda_kernels.py::conv2_packed`), and both are
`torch.autograd.Function`s (`Conv3Packed`, `Conv3PackedAs`) whose input
gradient is B1 again in the other parity (`conv2_packed_dx`) and whose
weight gradient is one split-K wgmma launch and its fold
(`_dw_packed_qgroup`, `cuda_kernels.dw_packed`).  The shifted
layout carries one pad voxel per axis (fine -1 and S); after the
aligned->shifted conv's BN/PReLU they are re-zeroed.  On the served path
that tail (kernel B2) is the epilogue of the aligned->shifted B1 launch
(`conv3_packed_as_bn_act`); `bn_act_zero_pads` runs it standalone.  In
training the tail normalizes with the batch statistics of the conv's
output, after both parities' convs: `BnActTrainPacked`, four passes of
`csrc/bn_train_packed.cu` with a hand-written gradient.

Fine conv weights arrive in torch layout `(Co, Ci, 3, 3, 3)`; packed
weights are `(2, 2, 2, 8Ci, 8Co)`, as in JAX.

Under a spatial mesh (`parallel.use_mesh`) each rank holds a D slab of
cells.  An aligned slab of L cells has a shifted form of L + 1 cells: its
last cell straddles the next rank's slab and is held by both, whole.  So
an aligned->shifted conv takes one cell from each neighbour
(`halo_exchange`), launches B1 as it is and crops the two outer cells;
a shifted->aligned conv needs no halo.  The shifted pad voxels lie only
at the volume's faces, so the D pad mask follows the rank's place
(`shifted_pad_mask_tensors`); the trilinear upsample takes an edge-mode
halo cell.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ..parallel import sharding as _S
from . import cuda_kernels as K
from . import functional as F
from .functional import _exact_f32_convs

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


def pack4(x: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D/4, H/4, W/4, 64C), channel = (s4d, s4h,
    s4w, c) sub-position-major: the space-to-depth of JAX's identity
    stride-4 conv `_pack4_identity_kernel`, as a reshape.  Spatial dims
    must be multiples of 4."""
    n, d, h, w, c = x.shape
    x = x.reshape(n, d // 4, 4, h // 4, 4, w // 4, 4, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(n, d // 4, h // 4, w // 4, 64 * c)


@functools.lru_cache(maxsize=None)
def _pack2_identity_kernel(c: int) -> np.ndarray:
    """torch (8C, C, 2, 2, 2) identity space-to-depth kernel: output
    channel sub*C + i takes input channel i at tap (sd, sh, sw) = sub."""
    k = np.zeros((8 * c, c, 2, 2, 2), np.float32)
    for sub in range(8):
        sd, sh, sw = sub >> 2, (sub >> 1) & 1, sub & 1
        for i in range(c):
            k[sub * c + i, i, sd, sh, sw] = 1.0
    return k


def pack2_conv(x: torch.Tensor) -> torch.Tensor:
    """`pack2` as JAX's identity stride-2 conv (one cuDNN call on the
    card, TF32 off for float32): exact, since every output is a sum with
    one nonzero term."""
    k = torch.as_tensor(_pack2_identity_kernel(x.shape[-1]), device=x.device)
    with _exact_f32_convs(x.dtype):
        return F.conv3d(x, k, stride=2)


def pack2_shifted(x: torch.Tensor) -> torch.Tensor:
    """Packing of the volume shifted by +1 voxel per axis (one leading and
    one trailing zero plane), the input form `conv3_packed` consumes:
    (N, D, H, W, C) -> (N, D/2+1, H/2+1, W/2+1, 8C)."""
    return pack2(TF.pad(x, (0, 0) + (1, 1) * 3))


def repack_shifted(xp: torch.Tensor) -> torch.Tensor:
    """Aligned packed activation -> shifted packed, without a round trip
    through the fine layout: shifted cell Q sub r on an axis holds fine
    voxel 2Q-1+r, so sub 0 comes from the previous aligned cell's sub 1
    and sub 1 from this cell's sub 0.  Per axis a pad, two slices of the
    sub axis and a concat, as in JAX."""
    n, c8 = xp.shape[0], xp.shape[-1]
    y = xp.reshape(n, *xp.shape[1:4], 2, 2, 2, c8 // 8)
    for ax in range(3):
        spec = [0, 0] * (y.ndim - 1 - ax)
        spec[-2:] = (1, 1)
        yp = TF.pad(y, spec)
        size = y.shape[1 + ax] + 1
        prev = yp.narrow(1 + ax, 0, size).narrow(4 + ax, 1, 1)
        cur = yp.narrow(1 + ax, 1, size).narrow(4 + ax, 0, 1)
        y = torch.cat([prev, cur], dim=4 + ax)
    return y.reshape(n, *[s + 1 for s in xp.shape[1:4]], c8)


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


def _taps_of(table01: np.ndarray) -> np.ndarray:
    """A 0/1 per-axis table A[t, ...] -> its inverse map [...] -> t, or -1
    (one tap at most per entry)."""
    out = np.full(table01.shape[1:], -1, np.int64)
    for t, *rest in zip(*np.nonzero(table01)):
        out[tuple(rest)] = t
    return out


def _tap_index3(taps: np.ndarray) -> np.ndarray:
    """Flat fine-tap index (td*9 + th*3 + tw, or 27 where some axis has no
    tap) of a kernel whose per-axis map `taps` (its indices -> tap t, or
    -1) is the same on D, H and W: shape (taps' axes for D, for H, for
    W)."""
    k = taps.ndim
    td = taps.reshape(taps.shape + (1,) * 2 * k)
    th = taps.reshape((1,) * k + taps.shape + (1,) * k)
    tw = taps.reshape((1,) * 2 * k + taps.shape)
    valid = (td >= 0) & (th >= 0) & (tw >= 0)
    return np.where(valid, td * 9 + th * 3 + tw, 27)


@functools.lru_cache(maxsize=None)
def _packed_tap_index(kind: str) -> np.ndarray:
    """Flat fine-tap index of every entry of the packing `kind`, its
    spatial axes first: "sa" / "as" (qd, qh, qw, rd, rh, rw, sd, sh, sw) of
    `_axis_table_sa` / `_axis_table_as`; "s2" (wd, wh, ww, rd, rh, rw) of
    `_axis_table_s2`; "in" (kd, kh, kw, rd, rh, rw), k=4 window tap kk = r
    + t, and "in_s2", k=5, j = 2r + t; "in_s2_p4" (wd, wh, ww, s4d, s4h,
    s4w, rd, rh, rw) of `_axis_table_s2_p4`."""
    if kind in ("sa", "as"):
        taps = _taps_of(_axis_table_sa() if kind == "sa"
                        else _axis_table_as())                # [q, r, s]
        return _tap_index3(taps).transpose(0, 3, 6, 1, 4, 7, 2, 5, 8)
    if kind == "s2":
        return _tap_index3(_taps_of(_axis_table_s2())).transpose(
            0, 2, 4, 1, 3, 5)
    if kind == "in_s2_p4":
        taps = _taps_of(_axis_table_s2_p4()).transpose(1, 2, 0)  # wpos,s4,r
        return _tap_index3(taps).transpose(0, 3, 6, 1, 4, 7, 2, 5, 8)
    step, k = {"in": (1, 4), "in_s2": (2, 5)}[kind]
    taps = np.full((k, 2), -1, np.int64)                      # [kk, r]
    for r in range(2):
        for t in range(3):
            taps[step * r + t, r] = t
    return _tap_index3(taps).transpose(0, 2, 4, 1, 3, 5)


def _device_constant(array: np.ndarray, **kw) -> torch.Tensor:
    """A cached device constant that autograd may save for backward: made
    outside inference mode even when its first caller serves in it."""
    with torch.inference_mode(False):
        return torch.as_tensor(array, **kw)


@functools.lru_cache(maxsize=None)
def _device_tap_index(kind: str, device: torch.device) -> torch.Tensor:
    return _device_constant(_packed_tap_index(kind), device=device)


def _gather_taps(w: torch.Tensor, kind: str) -> torch.Tensor:
    """Exact gather of the torch (Co, Ci, 3, 3, 3) kernel into the packing
    `kind`, one fine tap or zero per entry: shape
    `_packed_tap_index(kind).shape + (Ci, Co)`."""
    co, ci = w.shape[0], w.shape[1]
    if tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"expected a (Co, Ci, 3, 3, 3) kernel, got "
                         f"{tuple(w.shape)}")
    taps = w.permute(2, 3, 4, 1, 0).reshape(27, ci, co)
    taps = torch.cat([taps, taps.new_zeros(1, ci, co)])
    return taps[_device_tap_index(kind, w.device)]


def _pack_weights(w: torch.Tensor, kind: str) -> torch.Tensor:
    ci, co = w.shape[1], w.shape[0]
    wp = _gather_taps(w, kind).permute(0, 1, 2, 3, 4, 5, 9, 6, 7, 8, 10)
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


def _dw_packed_qgroup(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Dense packed dw (2, 2, 2, 8Ci, 8Co), float32: the 8 per-offset
    contractions `x[:, q + cells - pad].T @ g` of the JAX package's
    `ops/packed.py::_dw_packed_qgroup`.  x is the conv's input with or
    without its one-cell zero pad: one cell longer than g on every axis
    is pad 0, one shorter pad 1 (`K.dw_pad`).  `K.dw_packed` computes it:
    on the card in bfloat16 one split-K wgmma launch and its fold, else
    the plain float32 GEMMs (`K.dw_packed_plain`)."""
    return K.dw_packed(x, g)


def _packed_conv_forward(ctx, x, wp, bias, pad: int):
    wpc = wp.to(x.dtype).contiguous()
    x = x.contiguous()
    ctx.save_for_backward(x, wpc)
    ctx.dtypes = (wp.dtype, None if bias is None else bias.dtype)
    return K.conv2_packed(x, wpc, _tiled_bias(bias), pad=pad)


def _packed_conv_backward(ctx, g, pad: int):
    """dx: B1 in the other parity with flipped, io-swapped weights, skipped
    where x takes no gradient (the stem's input); dw: the 8 per-offset
    contractions over the saved x as it is (its pad read from the
    extents), float32; bias: the sum of g over the cells with the 8
    sub-positions folded, in float32."""
    x, wp = ctx.saved_tensors
    g = g.contiguous()
    dx = dw = db = None
    if ctx.needs_input_grad[0]:
        dx = K.conv2_packed_dx(g, wp, pad=pad)
    if ctx.needs_input_grad[1]:
        dw = _dw_packed_qgroup(x, g).to(ctx.dtypes[0])
    if ctx.needs_input_grad[2]:
        c8o = g.shape[-1]
        db = g.sum(dim=(0, 1, 2, 3), dtype=torch.float32).reshape(
            8, c8o // 8).sum(0).to(ctx.dtypes[1])
    return dx, dw, db


class Conv3Packed(torch.autograd.Function):
    """Shifted->aligned packed conv (B1, pad 0) with the hand-rolled
    gradient of the JAX package's `_conv3_packed_core`
    (`_conv3_packed_bwd`): dx is an aligned->shifted B1 launch."""

    @staticmethod
    def forward(ctx, xp_shifted, wp, bias):
        return _packed_conv_forward(ctx, xp_shifted, wp, bias, 0)

    @staticmethod
    def backward(ctx, g):
        return _packed_conv_backward(ctx, g, 0)


class Conv3PackedAs(torch.autograd.Function):
    """Aligned->shifted packed conv (B1, pad 1) with the gradient of
    `_conv3_packed_as_core` (`_conv3_packed_as_bwd`): dx is a
    shifted->aligned B1 launch, dw contracts the one-cell zero-padded
    input."""

    @staticmethod
    def forward(ctx, xp_aligned, wp, bias):
        return _packed_conv_forward(ctx, xp_aligned, wp, bias, 1)

    @staticmethod
    def backward(ctx, g):
        return _packed_conv_backward(ctx, g, 1)


def conv3_packed(xp_shifted: torch.Tensor, wp: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k=2 VALID conv over shifted-packed input == fine k=3/pad=1 conv.

    xp_shifted: (N, S/2+1, ..., 8Ci); wp: (2, 2, 2, 8Ci, 8Co) from
    `pack_weights2`, cast to the input dtype; bias: fine (Co,), added in
    float32 before the output's one rounding.  Returns the aligned packed
    output (N, S/2, ..., 8Co).  Differentiable (`Conv3Packed`): the
    gradients of wp and bias come back in their own dtypes."""
    return Conv3Packed.apply(xp_shifted, wp, bias)


def conv3_packed_as(xp_aligned: torch.Tensor, wp: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fine k=3/pad=1 conv as a k=2/pad=1 packed conv, aligned -> shifted.

    xp_aligned: (N, S/2, ..., 8Ci); wp from `pack_weights2_as`.  Returns
    the shifted packed output (N, S/2+1, ..., 8Co), whose pad voxels hold
    the conv's zero-padded extrapolation (bias alone).  Differentiable
    (`Conv3PackedAs`).  Under a spatial mesh: one halo cell from each
    neighbour, the same launch, the outer cells cropped."""
    if _S.spatial_mesh() is None:
        return Conv3PackedAs.apply(xp_aligned, wp, bias)
    y = Conv3PackedAs.apply(_S.spatial_halo(xp_aligned, 1), wp, bias)
    return y.narrow(1, 1, y.shape[1] - 2)


def conv3_packed_as_bn_act(xp_aligned: torch.Tensor, wp: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor,
                           alpha: torch.Tensor,
                           addend: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """`bn_act_zero_pads(conv3_packed_as(xp_aligned, wp) + addend, scale,
    shift, alpha)` as one launch of B1 with B2 as its epilogue, the sum and
    the tail in float32 and one rounding.  addend: None or a shifted
    (N, S/2+1, ..., 8Co) partial sum in the input's dtype.  Under a
    spatial mesh the launch runs on the haloed slab (the addend padded to
    match), the outer cells are cropped and the D pad mask is applied
    where the rank holds a face of the volume."""
    wp = wp.to(xp_aligned.dtype).contiguous()
    mesh = _S.spatial_mesh()
    if mesh is not None:
        xp_aligned = _S.spatial_halo(xp_aligned, 1)
        if addend is not None:
            addend = TF.pad(addend, (0, 0, 0, 0, 0, 0, 1, 1))
    y = K.conv2_packed_as_bn_act(
        xp_aligned.contiguous(), wp, scale, shift, alpha,
        addend=None if addend is None else addend.contiguous())
    if mesh is None:
        return y
    y = y.narrow(1, 1, y.shape[1] - 2)
    first, last = _S.spatial_edges(mesh)
    if first or last:
        md = _device_pad_masks(tuple(y.shape[1:4]), y.shape[-1], y.device,
                               (first, last))[0]
        y = y * md[:, None, None, :].to(y.dtype)
    return y


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


def conv1_packed(xp: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fine 1x1x1 conv in packed layout as a per-sub channel contraction
    (JAX's `conv1_packed`; `conv1_packed_blockdiag` computes the same
    without the sub-axis reshape).  w: torch (Co, Ci, 1, 1, 1) or (Co,
    Ci)."""
    co, ci = w.shape[0], w.shape[1]
    n, d, h, wd, _ = xp.shape
    y = torch.matmul(xp.reshape(n, d, h, wd, 8, ci),
                     w.reshape(co, ci).t().to(xp.dtype))
    y = y.reshape(n, d, h, wd, 8 * co)
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
    the packed sub-positions, so this is a sub-axis max + repack.  Under
    a spatial mesh the slab's cells must be even."""
    n, d, h, w, c8 = xp.shape
    if _S.spatial_mesh() is not None and d % 2:
        raise ValueError(f"maxpool2_packed under a spatial mesh needs an "
                         f"even number of D cells per rank, got {d}")
    pooled = xp.reshape(n, d, h, w, 8, c8 // 8).amax(dim=4)
    return pack2(pooled)


def maxpool2_packed_cascade(xp: torch.Tensor) -> torch.Tensor:
    """`maxpool2_packed` as three halvings of the channel blocks (the sub
    bits w, h, d in turn) and a repack, as JAX's cascade."""
    c = xp.shape[-1] // 8
    x = torch.maximum(xp[..., :4 * c], xp[..., 4 * c:])
    x = torch.maximum(x[..., :2 * c], x[..., 2 * c:])
    return pack2(torch.maximum(x[..., :c], x[..., c:]))


@functools.lru_cache(maxsize=None)
def _device_upsample_matrix(fine_in: int, dtype, device) -> torch.Tensor:
    """Fine trilinear x2 matrix (2 fine_in, fine_in), align_corners=False."""
    return _device_constant(F._linear_matrix(fine_in, 2 * fine_in, False),
                            dtype=dtype, device=device)


def upsample2_packed(xp: torch.Tensor) -> torch.Tensor:
    """Fine trilinear 2x upsample (align_corners=False), packed -> packed:
    cells of the coarse grid -> cells of the doubled grid.  Per axis: move
    that axis's sub bit next to its cell axis (the fine axis), apply the
    fine interpolation matrix, re-fold the sub bit.

    Under a spatial mesh the slab takes one halo cell from each neighbour;
    at a face of the volume the halo cell repeats the boundary fine plane
    in both subs (the clamp), and after the upsample the two outer cells
    on each side are cropped."""
    if _S.spatial_mesh() is None:
        return _upsample2_packed(xp)
    first, last = _S.spatial_edges()
    xh = _S.spatial_halo(xp, 1)
    n_d = xh.shape[1]
    parts = [xh.narrow(1, 0, 1), xh.narrow(1, 1, n_d - 2),
             xh.narrow(1, n_d - 1, 1)]
    if first:
        parts[0] = _broadcast_sub_plane(xh.narrow(1, 1, 1), 0, 0)
    if last:
        parts[2] = _broadcast_sub_plane(xh.narrow(1, n_d - 2, 1), 0, 1)
    y = _upsample2_packed(torch.cat(parts, dim=1))
    return y.narrow(1, 2, y.shape[1] - 4)


def _upsample2_packed(xp: torch.Tensor) -> torch.Tensor:
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
def _device_pad_masks(cells: tuple, c8: int, device: torch.device,
                      d_faces: tuple = (True, True)):
    """The three float32 planes of `cuda_kernels.shifted_pad_keep`, made
    once per shape and device, outside inference mode (autograd may save
    them)."""
    with torch.inference_mode(False):
        return tuple(K.shifted_pad_keep(
            a, cells[a], c8, device,
            *(d_faces if a == 0 else (True, True))).float()
            for a in range(3))


def shifted_pad_mask_tensors(xs: torch.Tensor):
    """The three float32 (cells, C8) pad-mask planes of shifted tensor xs,
    on xs's device (made once per shape and device: a host-to-device copy
    per call would stall the host behind the device's queue).  Under a
    spatial mesh the D plane masks only the faces of the volume that this
    rank's slab holds: the slab faces between ranks are real voxels."""
    faces = _S.spatial_edges(_S.spatial_mesh())
    return _device_pad_masks(tuple(xs.shape[1:4]), xs.shape[-1], xs.device,
                             faces)


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


# ---------------------------------------------------------------------------
# the train-mode tail of a packed ConvBlock
# ---------------------------------------------------------------------------

# the UNet's BatchNorm3d defaults
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def bn_train_moments(s: torch.Tensor, valid: float):
    """(mean, var, rstd, var_kept), float32 (C,), from the statistics
    pass's (Σy, Σy²) over `valid` voxels: var = max(E[y²] - E[y]², 0),
    rstd = 1 / sqrt(var + eps), var_kept 0 where the clamp acts (float32
    cancellation can round E[y²] - E[y]² slightly negative for a
    near-constant channel with a large mean), else 1."""
    mean = s[0] / valid
    var = s[1] / valid - mean * mean
    var_kept = (var >= 0).float()
    var = var.clamp_min(0.0)
    return mean, var, torch.rsqrt(var + BN_EPS), var_kept


def bn_train_dx_rows(prm: torch.Tensor, reduced: Optional[torch.Tensor],
                     valid: float, var_kept: torch.Tensor) -> torch.Tensor:
    """The dx pass's (8, C) rows: the apply pass's five (mean, rstd,
    gamma, beta, alpha), then p = gamma * rstd and the statistics term's
    k2, k3 = p * (Σgz, Σgz·yh) / valid from the reduction pass's first two
    rows `reduced` (all-reduced over a mesh); k3 is 0 where the variance
    was clamped, and both are 0 without BatchNorm (`reduced` None)."""
    p = prm[2] * prm[1]
    if reduced is None:
        k = torch.zeros((2, p.shape[0]), device=prm.device)
    else:
        k = p * reduced / valid
        k[1] *= var_kept
    return torch.cat([prm, p[None], k])


class BnActTrainPacked(torch.autograd.Function):
    """`zero_shifted_pads(prelu(BN(zero_shifted_pads(y)), alpha))` with BN
    taking the batch statistics, as four passes (`cuda_kernels.
    bn_train_stats`, `bn_train_apply`, `bn_train_reduce`, `bn_train_dx`:
    the kernels of `csrc/bn_train_packed.cu` on CUDA, their plain versions
    on the CPU) and a hand-written gradient.

    forward(y, gamma, beta, alpha, shifted, valid, owned_d) -> (out,
    mean, var): y packed (N, D, H, W, 8C), shifted or aligned; gamma and
    beta fine (C,), or None for a block without BatchNorm (no statistics
    pass: mean 0, rstd 1, gamma 1 and beta 0 stand in); alpha (1,)
    or (C,), or None for no activation; `valid` the fine voxels per channel
    over the whole mesh; `owned_d` the D cells from the first whose voxels
    this rank counts.  Statistics in float32 over the kept entries, var =
    max(E[y²] - E[y]², 0), all-reduced over the mesh's ranks between the
    statistics and apply passes; mean and var come back for the running
    statistics, not differentiable.

    backward: with gz = keep * g * (z >= 0 ? 1 : alpha), yh the normalized
    y and z = gamma * yh + beta, dgamma = Σgz·yh, dbeta = Σgz and dalpha =
    Σ keep·g·z·[z < 0] over every cell of y (this rank's partial sums, as
    the composition's autograd gives them); dy = gamma * rstd * (gz -
    [owned] (Σgz + yh Σgz·yh) / valid) with both sums all-reduced over the
    mesh first (where var was clamped its term drops, as through
    `clamp_min`), 0 at the pads.  Saves y, the (5, C) parameters and the
    clamp's (C,) mask."""

    @staticmethod
    def forward(ctx, y, gamma, beta, alpha, shifted, valid, owned_d):
        y = y.contiguous()
        c = y.shape[-1] // 8
        mesh = _S.current_mesh()
        faces = _S.spatial_edges(_S.spatial_mesh())
        kw = {"shifted": shifted, "d_faces": faces}
        ones = torch.ones(c, device=y.device)
        ctx.bn = gamma is not None
        ctx.params = [(t.shape, t.dtype) if t is not None else None
                      for t in (gamma, beta, alpha)]
        if gamma is None:
            mean, var, var_kept = ones * 0.0, ones, ones
            rstd, gamma, beta = ones, ones, ones * 0.0
        else:
            s = K.bn_train_stats(y, owned_d=owned_d, **kw)
            if mesh is not None:
                s = _S.all_reduce(s, _S.sharded_axes(y))
            mean, var, rstd, var_kept = bn_train_moments(s, valid)
        slope = ones if alpha is None else alpha.float().expand(c)
        prm = torch.stack([mean, rstd, gamma.float(), beta.float(), slope])
        out = K.bn_train_apply(y, prm, **kw)
        ctx.save_for_backward(y, prm, var_kept)
        ctx.kw, ctx.mesh, ctx.valid, ctx.owned_d = kw, mesh, valid, owned_d
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _mean, _var):
        y, prm, var_kept = ctx.saved_tensors
        g = g.contiguous()
        sums = K.bn_train_reduce(y, g, prm, **ctx.kw)
        dy = None
        if ctx.needs_input_grad[0]:
            reduced = None
            if ctx.bn:
                reduced = sums[:2]
                if ctx.mesh is not None:
                    reduced = _S.all_reduce(reduced, _S.sharded_axes(y),
                                            mesh=ctx.mesh)
            dy = K.bn_train_dx(y, g, bn_train_dx_rows(prm, reduced, ctx.valid,
                                                      var_kept),
                               owned_d=ctx.owned_d, **ctx.kw)
        # dgamma = Σgz·yh, dbeta = Σgz, dalpha = Σ keep·g·z·[z < 0]
        grads = []
        for row, spec, needed in zip((1, 0, 2), ctx.params,
                                     ctx.needs_input_grad[1:4]):
            if not needed:
                grads.append(None)
                continue
            shape, dtype = spec
            v = sums[row] if shape.numel() > 1 else sums[row].sum()
            grads.append(v.reshape(shape).to(dtype))
        return (dy, *grads, None, None, None)


def bn_act_train_packed(y: torch.Tensor, gamma, beta, alpha, running, *,
                        shifted: bool, valid: float):
    """Train-mode tail of a packed ConvBlock whose conv output is `y`
    (`BnActTrainPacked`): zero the pads of a shifted y, BatchNorm with the
    batch statistics (gamma, beta fine (C,); None for a block without
    one), PReLU (alpha (1,) or (C,); None for none), zero the pads again.
    `valid` counts this rank's fine voxels per channel; under a mesh the
    statistics are the global batch's, and a shifted slab leaves its last
    cell, which the next rank holds too, to that rank.  `running` (mean,
    var), float32, or None, are updated by torch's rule
    (`F.update_running_stats`, momentum 0.1).  Returns (out, the new
    running statistics or None)."""
    owned_d = y.shape[1]
    if (shifted and _S.spatial_mesh() is not None
            and not _S.spatial_edges()[1]):
        owned_d -= 1
    mesh = _S.current_mesh()
    if mesh is not None:
        valid = valid * _S.shard_count(mesh, _S.sharded_axes(y))
    out, mean, var = BnActTrainPacked.apply(
        y, gamma, beta, alpha, shifted, valid, owned_d)
    if gamma is None or running is None:
        return out, None
    return out, F.update_running_stats(*running, mean, var, valid,
                                       BN_MOMENTUM)


# ---------------------------------------------------------------------------
# the composed decoder up branch (JAX's `ops/packed.py` "v2: fused decoder
# upsample+conv")
#
# The decoder's `conv3(cat(skip, up(x)), w)` splits over w's input
# channels into conv_s(skip) + conv_u(up(x)); conv_u o up composes into ONE
# lhs-dilated (stride-1/2) 5^3 convolution on the packed coarse cells.
# align_corners=False clamping is reproduced by edge-padding the coarse
# cells (`edge_pad_cells`); the taps that read up[-1] / up[S], which the
# fine conv zero-pads but the composed kernel extrapolates, touch exactly
# one fine output plane per face, which `upconv_fix_faces` overwrites with
# values computed directly.  In float the composed conv is one cuDNN
# transposed convolution (JAX leaves it to XLA too, outside any Pallas
# kernel); the int8 serving path runs it as kernel K2
# (`cuda_kernels.upconv_packed_s8`).
# ---------------------------------------------------------------------------

_UP_TAPS = np.asarray([0.25, 0.75, 0.75, 0.25])  # fine 2x, half-pixel


@functools.lru_cache(maxsize=None)
def _upconv_axis_table() -> np.ndarray:
    """C1[k, q, r, t]: per-axis coefficient of fine tap t for the dilated
    kernel's index k (of 5), input sub q and output sub r: v[j] with
    j = 5 - 2k + r + t - 2q when 0 <= j <= 3."""
    c1 = np.zeros((5, 2, 2, 3), np.float32)
    for k in range(5):
        for q in range(2):
            for r in range(2):
                for t in range(3):
                    j = 5 - 2 * k + r + t - 2 * q
                    if 0 <= j <= 3:
                        c1[k, q, r, t] = _UP_TAPS[j]
    return c1


def pack_upconv_weights(w_u: torch.Tensor) -> torch.Tensor:
    """Fine (Co, Ci, 3, 3, 3) kernel acting on the upsampled input -> the
    composed packed kernel (5, 5, 5, 8Ci, 8Co) of `upconv_packed`
    (lhs-dilation 2 over edge-padded coarse cells), summed in float32 and
    cast back to w_u's dtype."""
    co, ci = w_u.shape[:2]
    c1 = torch.as_tensor(_upconv_axis_table(), device=w_u.device)
    w = w_u.float().permute(2, 3, 4, 1, 0)          # (t, u, w, ci, co)
    k = torch.einsum("aqrt,bsmu,cvnw,tuwio->abcqsviormn", c1, c1, c1, w)
    # (kd, kh, kw, qd, qh, qw, ci, co, rd, rh, rw) -> channels sub-major
    k = k.permute(0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 7)
    return k.reshape(5, 5, 5, 8 * ci, 8 * co).to(w_u.dtype)


def _broadcast_sub_plane(plane: torch.Tensor, axis: int,
                         sub: int) -> torch.Tensor:
    """On a boundary cell plane (one cell thick along `axis`), set BOTH sub
    slots of that axis to the values of slot `sub` (fine edge replication
    at cell granularity).  The sub slots of axis a are contiguous channel
    runs of 8C >> (a + 1), repeated 2^a times."""
    block = plane.shape[-1] >> (axis + 1)
    parts = []
    for j in range(1 << axis):
        src = plane[..., (2 * j + sub) * block:(2 * j + sub + 1) * block]
        parts += [src, src]
    return torch.cat(parts, dim=-1)


def edge_pad_cells(xp: torch.Tensor) -> torch.Tensor:
    """Append one edge-replicating cell per side per axis: both subs of a
    padded cell hold the boundary fine voxel (the clamped interpolation).
    Any dtype: int8 goes through unchanged.  Each axis's planes are taken
    from the already padded tensor, so the later axes' corners replicate
    transitively, as in JAX."""
    pad = TF.pad(xp, (0, 0) + (1, 1) * 3)
    for axis in range(3):
        dim = 1 + axis
        n_ax = pad.shape[dim]
        lo = _broadcast_sub_plane(pad.narrow(dim, 1, 1), axis, 0)
        hi = _broadcast_sub_plane(pad.narrow(dim, n_ax - 2, 1), axis, 1)
        pad = torch.cat([lo, pad.narrow(dim, 1, n_ax - 2), hi], dim=dim)
    return pad


def _composed_conv_weight(wk: torch.Tensor) -> torch.Tensor:
    """(5, 5, 5, 8Ci, 8Co) composed kernel -> the flipped (8Ci, 8Co, 5, 5,
    5) weight of the transposed convolution that computes it."""
    return wk.permute(3, 4, 0, 1, 2).flip(2, 3, 4)


def upconv_packed(x_aligned: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """Composed trilinear-2x-upsample + fine k=3/pad=1 conv: packed aligned
    coarse cells (N, Sc, Sc, Sc, 8Ci) -> SHIFTED packed output at the
    doubled fine resolution (N, 2Sc+1, ..., 8Co); wk from
    `pack_upconv_weights`, cast to x's dtype; a new contiguous tensor
    (`upconv_fix_faces` updates it in place).  The lhs-dilated conv (pad
    1, kernel 5) over the edge-padded cells is the transposed convolution
    of stride 2 and padding 3 with the flipped kernel: one cuDNN call,
    TF32 off for float32.  Exact inside; one fine plane per face needs
    `upconv_fix_faces`."""
    xe = edge_pad_cells(x_aligned).permute(0, 4, 1, 2, 3)
    w = _composed_conv_weight(wk.to(x_aligned.dtype))
    with _exact_f32_convs(x_aligned.dtype):
        y = TF.conv_transpose3d(xe, w, stride=2, padding=3)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _coarse_fine_plane(xp: torch.Tensor, axis: int,
                       fine_idx: int) -> torch.Tensor:
    """Fine plane `fine_idx` (0, 1, -2 or -1) of `axis` from packed cells,
    still packed over the other two axes: (N, A, B, 4C) in (sub_b, sub_c,
    c) channel order."""
    cells = xp.shape[1 + axis]
    cell, sub = divmod(fine_idx % (2 * cells), 2)
    plane = xp.select(1 + axis, cell)
    block = xp.shape[-1] >> (axis + 1)
    parts = [plane[..., (2 * j + sub) * block:(2 * j + sub + 1) * block]
             for j in range(1 << axis)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _unpack2_2d(p2: torch.Tensor) -> torch.Tensor:
    """(N, A, B, 4C) packed 2-D plane -> fine (N, 2A, 2B, C)."""
    n, a, b, c4 = p2.shape
    p = p2.reshape(n, a, b, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return p.reshape(n, 2 * a, 2 * b, c4 // 4)


def _pack2_2d_shifted(x2: torch.Tensor) -> torch.Tensor:
    """Fine 2-D plane (N, Sf, Sf, C) -> SHIFTED packed (N, Sf/2+1, Sf/2+1,
    4C), sub-major over the two axes, zero pads at fine -1 and Sf."""
    x2 = TF.pad(x2, (0, 0, 1, 1, 1, 1))
    n, a2, b2, c = x2.shape
    p = x2.reshape(n, a2 // 2, 2, b2 // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return p.reshape(n, a2 // 2, b2 // 2, 4 * c)


def _conv2d_pad1(x2: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Channels-last 2-D conv, pad 1, torch (O, I, 3, 3) weight in x's
    dtype; TF32 off for float32."""
    with _exact_f32_convs(x2.dtype):
        return F.conv2d(x2, w2, padding=1)


def _upconv_face(x_aligned: torch.Tensor, w_u: torch.Tensor, axis: int,
                 side: int, dequant_scale=None) -> torch.Tensor:
    """Exact up-branch output on the fine boundary plane of `axis` (side 0:
    fine 0; side 1: fine Sf-1), as a SHIFTED packed 2-D plane (N, Sf/2+1,
    Sf/2+1, 4Co) over the other two axes: one 2-D conv over the two
    upsampled planes the plane's taps read, concatenated over channels.
    `dequant_scale`: for int8 `x_aligned` (the int8 serving path), its
    boundary planes are dequantized to w_u's dtype after slicing."""
    dt = w_u.dtype if dequant_scale is not None else x_aligned.dtype

    def plane(idx):
        p = _unpack2_2d(_coarse_fine_plane(x_aligned, axis, idx))
        if dequant_scale is not None:
            p = p.to(dt) * dequant_scale
        return p

    if side == 0:
        planes, taps = (plane(0), plane(1)), (1, 2)
        # up[g=0] = p0 (clamped); up[g=1] = .75 p0 + .25 p1
        mix = ((1.0, 0.0), (0.75, 0.25))
    else:
        planes, taps = (plane(-2), plane(-1)), (0, 1)
        # up[Sf-2] = .25 p[-2] + .75 p[-1]; up[Sf-1] = p[-1] (clamped)
        mix = ((0.25, 0.75), (0.0, 1.0))
    out_2d = tuple(2 * s for s in planes[0].shape[1:3])
    r = [F.resize_linear(p, out_2d).to(dt) for p in planes]
    ups = [a * r[0] + b * r[1] if b else a * r[0] for a, b in mix]
    # the fine kernel at the axis's tap: (Co, Ci, 3, 3) over the other two
    w_cat = torch.cat([w_u.select(2 + axis, t) for t in taps], dim=1)
    return _pack2_2d_shifted(_conv2d_pad1(torch.cat(ups, dim=-1),
                                          w_cat.to(dt)))


@functools.lru_cache(maxsize=None)
def _face_keep_mask(cells: int, ch: int, nbits: int, bit: int) -> np.ndarray:
    """(cells, ch) keep mask zeroing exactly the entries a face pair writes
    along one axis of a shifted tensor: the first cell's sub 1 and the
    last cell's sub 0 of the packed sub bit `bit` of `nbits`."""
    sub = np.arange(ch) // (ch >> nbits)
    b = (sub >> (nbits - 1 - bit)) & 1
    m = np.ones((cells, ch), np.float32)
    m[0, b == 1] = 0.0
    m[-1, b == 0] = 0.0
    return m


@functools.lru_cache(maxsize=None)
def _device_face_mask(cells: int, ch: int, nbits: int, bit: int, dtype,
                      device: torch.device) -> torch.Tensor:
    return _device_constant(_face_keep_mask(cells, ch, nbits, bit),
                            dtype=dtype, device=device)


def _embed_face(face: torch.Tensor, axis: int, side: int) -> torch.Tensor:
    """A face plane (N, A, B, 4C) embedded in the boundary cell plane it
    writes along `axis` (N, A, B, 8C; JAX's `_embed_face` also pads the
    cell axis to a full tensor, which the in-place update of
    `upconv_fix_faces` does not need): the written sub bit of `axis`
    (r = 1 for side 0, 0 for side 1) inserted into the channels, the other
    sub zero."""
    n, a_sz, b_sz, c4 = face.shape
    r = 1 if side == 0 else 0
    pre = 1 << axis              # face sub bits ordered before the new one
    f = face.reshape(n, a_sz, b_sz, pre, 1, c4 // pre)
    return TF.pad(f, (0, 0, r, 1 - r)).reshape(n, a_sz, b_sz, 2 * c4)


def upconv_fix_faces(ys: torch.Tensor, x_aligned: torch.Tensor,
                     w_u: torch.Tensor, dequant_scale=None) -> torch.Tensor:
    """Overwrite the six boundary fine planes of `upconv_packed`'s output
    with values computed directly (the fine conv's zero padding), as JAX's
    `upconv_fix_faces` does: ys times keep masks that zero every entry a
    face writes, plus the faces embedded.  Where faces overlap (edges,
    corners) the face of the highest axis wins: each lower-axis face is
    masked where a higher axis's faces cover.  Only the boundary cell
    planes change (the masks are 1 and the faces 0 elsewhere), so they
    are updated IN PLACE in ys, which is returned; autograd records the
    updates.  w_u: the fine (Co, Ci, 3, 3, 3) kernel; `dequant_scale` as
    for `_upconv_face` (int8 x_aligned)."""
    c8 = ys.shape[-1]
    dtype = ys.dtype
    for a in range(3):
        cells = ys.shape[1 + a]
        m = _device_face_mask(cells, c8, 3, a, dtype, ys.device)
        for idx in (0, cells - 1):
            ys.select(1 + a, idx).mul_(m[idx])
    for a in range(3):
        others = [ax for ax in range(3) if ax != a]
        for side in (0, 1):
            face = _upconv_face(x_aligned, w_u, a, side,
                                dequant_scale).to(dtype)
            for k, ax in enumerate(others):
                if ax > a:
                    shape = [1, 1, 1, face.shape[-1]]
                    shape[1 + k] = face.shape[1 + k]
                    face = face * _device_face_mask(
                        face.shape[1 + k], face.shape[-1], 2, k, dtype,
                        face.device).reshape(shape)
            idx = 0 if side == 0 else ys.shape[1 + a] - 1
            ys.select(1 + a, idx).add_(_embed_face(face, a, side))
    return ys


# ---------------------------------------------------------------------------
# stride-2 convs: VoxResNet's downsamples and stems (JAX's `ops/packed.py`
# "stride-2 conv variants")
#
# A fine k=3/s=2/p=1 conv maps fine grid S to S/2.  Split by output
# sub-position, it is 8 phase convolutions that share one (2, 2, 2, 8Ci,
# Co) kernel (`pack_weights2_s2`): phase s's window on an axis starts at
# cell 2X+s-1.  Together the 8 phases are ONE stride-1 k=2 conv of that
# kernel over the input padded by one cell on the low side of each axis,
# whose (N, S2, S2, S2, Co) output `pack2` folds into the packed result:
# `conv3s2_packed_aa` runs it as one B1 launch.  The stems map the fine
# input straight to the SHIFTED packing of the stem conv's output: at
# stride 1 one k=4/s=2/p=2 cuDNN conv (`conv_input_packed`, XLA's in JAX);
# at stride 2 a k=2 pad-1 B1 conv over `pack4` cells
# (`conv_input_packed_s2_p4`, the form VoxResNet runs) or the fused
# k=5/s=4 cuDNN conv (`conv_input_packed_s2`, kept as JAX keeps it).
# Every packed kernel here holds one fine tap or zero per entry, gathered
# exactly from the torch (Co, Ci, 3, 3, 3) weight.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _axis_table_s2() -> np.ndarray:
    """Per-axis table B[t, wpos, r]: output sub s's tap t reads, within its
    phase-s window [2X+s-1, 2X+s], window cell `wpos` sub `r`, with
    (wpos, r) = divmod(t + 1, 2), independent of s."""
    b = np.zeros((3, 2, 2), np.float32)
    for t in range(3):
        wpos, r = divmod(t + 1, 2)
        b[t, wpos, r] = 1.0
    return b


@functools.lru_cache(maxsize=None)
def _axis_table_s2_p4() -> np.ndarray:
    """Per-axis table A[t, r, wpos, s4] of the pack4-input stem: shifted
    output sub r's tap t reads pack4 window cell `wpos` sub4 `s4`
    (j = 2r + t; j <= 2 -> (0, j+1), else (1, j-3))."""
    a = np.zeros((3, 2, 2, 4), np.float32)
    for t in range(3):
        for r in range(2):
            j = 2 * r + t
            if j <= 2:
                a[t, r, 0, j + 1] = 1.0
            else:
                a[t, r, 1, j - 3] = 1.0
    return a


def pack_weights2_s2(w: torch.Tensor) -> torch.Tensor:
    """Fine (Co, Ci, 3, 3, 3) stride-2 kernel -> the shared phase kernel
    (2, 2, 2, 8Ci, Co) of `conv3s2_packed_aa`, input channels (rd, rh, rw,
    ci)."""
    ci, co = w.shape[1], w.shape[0]
    return _gather_taps(w, "s2").reshape(2, 2, 2, 8 * ci, co)


def conv3s2_packed_aa(xp_aligned: torch.Tensor, wk: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fine k=3/stride-2/pad-1 conv in packed space: ALIGNED packed input
    (N, S2, S2, S2, 8Ci) [fine 2 S2] -> ALIGNED packed output (N, S2/2,
    ..., 8Co) [fine S2]; S2 even; wk from `pack_weights2_s2`.

    JAX runs 8 stride-2 phase convs.  Here the 8 phases are one stride-1
    B1 launch (`Conv3Packed`, whose gradient is a B1 dx launch and the
    qgroup dw) over the input low-padded by one cell, and `pack2` of its
    (N, S2, S2, S2, Co) output.  The bias, fine (Co,), is added after the
    pack in the output's dtype, as in JAX."""
    s2 = xp_aligned.shape[1:4]
    if any(s % 2 for s in s2):
        raise ValueError(f"conv3s2_packed_aa needs even cell extents, got "
                         f"{tuple(s2)}")
    # B1's input gradient reads Co channels in groups of 8: narrower
    # layers (Co = 4 at 2 filters) run on zero output channels, dropped
    co = wk.shape[-1]
    wk = TF.pad(wk, (0, -co % 8))
    y = Conv3Packed.apply(TF.pad(xp_aligned, (0, 0, 1, 0, 1, 0, 1, 0)), wk,
                          None)
    conv3s2_packed_aa.launches += int(y.is_cuda)
    y = pack2(y[..., :co])
    if bias is not None:
        y = y + tile_channel_param(bias).to(y.dtype)
    return y


# B1 launches on the card, as `cuda_kernels`' counters count them
conv3s2_packed_aa.launches = 0


def pack_input_weights(w: torch.Tensor) -> torch.Tensor:
    """Fine (Co, Ci, 3, 3, 3) kernel -> (4, 4, 4, Ci, 8Co) for
    `conv_input_packed` (JAX's layout)."""
    ci, co = w.shape[1], w.shape[0]
    wp = _gather_taps(w, "in").permute(0, 1, 2, 6, 3, 4, 5, 7)
    return wp.reshape(4, 4, 4, ci, 8 * co)


def _stem_conv(x_fine: torch.Tensor, wp: torch.Tensor, bias, *, stride: int,
               pad) -> torch.Tensor:
    """One cuDNN conv of a JAX-layout (k, k, k, Ci, 8Co) stem kernel, TF32
    off for float32, then the fine bias tiled over the 8 sub-positions in
    the output's dtype, as JAX adds it."""
    x = TF.pad(x_fine, (0, 0) + tuple(pad) * 3)
    with _exact_f32_convs(x.dtype):
        y = F.conv3d(x, wp.permute(4, 3, 0, 1, 2), stride=stride)
    if bias is not None:
        y = y + tile_channel_param(bias).to(y.dtype)
    return y


def conv_input_packed(x_fine: torch.Tensor, wp: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fine (N, S, S, S, Ci) input -> the stride-1 stem conv's SHIFTED
    packed output (N, S/2+1, ..., 8Co), `pack2_shifted` folded into one
    k=4/stride-2/pad-2 conv (cuDNN; XLA's in JAX); wp from
    `pack_input_weights`."""
    return _stem_conv(x_fine, wp, bias, stride=2, pad=(2, 2))


def pack_input_weights_s2(w: torch.Tensor) -> torch.Tensor:
    """Fine (Co, Ci, 3, 3, 3) stride-2 kernel -> (5, 5, 5, Ci, 8Co) for
    `conv_input_packed_s2`."""
    ci, co = w.shape[1], w.shape[0]
    wp = _gather_taps(w, "in_s2").permute(0, 1, 2, 6, 3, 4, 5, 7)
    return wp.reshape(5, 5, 5, ci, 8 * co)


def conv_input_packed_s2(x_fine: torch.Tensor, wp: torch.Tensor,
                         bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Fine (N, S, S, S, Ci) -> SHIFTED packed (N, S/4+1, ..., 8Co) at fine
    S/2: a fine k=3/s=2/p=1 stem conv fused with `pack2_shifted` into one
    k=5/stride-4/pad-(3, 2) conv (cuDNN).  The shifted pad voxels hold the
    kernel's zero-pad extrapolation: `zero_shifted_pads` before batch
    statistics.  Wired to no model, as in JAX (VoxResNet runs
    `conv_input_packed_s2_p4`)."""
    return _stem_conv(x_fine, wp, bias, stride=4, pad=(3, 2))


def pack_input_weights_s2_p4(w: torch.Tensor) -> torch.Tensor:
    """Fine (Co, Ci, 3, 3, 3) stride-2 stem kernel -> (2, 2, 2, 64Ci, 8Co)
    for `conv_input_packed_s2_p4`: input channels (s4d, s4h, s4w, ci),
    output channels (rd, rh, rw, co)."""
    ci, co = w.shape[1], w.shape[0]
    wp = _gather_taps(w, "in_s2_p4").permute(0, 1, 2, 3, 4, 5, 9, 6, 7, 8,
                                              10)
    return wp.reshape(2, 2, 2, 64 * ci, 8 * co)


def conv_input_packed_s2_p4(x_fine: torch.Tensor, wk: torch.Tensor,
                            bias: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Fine (N, S, S, S, Ci) -> SHIFTED packed (N, S/4+1, ..., 8Co) at fine
    S/2: the fine k=3/s=2/p=1 stem conv as `pack4` (data movement) and one
    k=2 pad-1 aligned->shifted B1 launch over the pack4 cells
    (`Conv3PackedAs`, bias fused; the input takes no gradient, so the
    backward launches only dw).  The shifted pad voxels hold the zero-pad
    extrapolation: `zero_shifted_pads` before batch statistics."""
    y = Conv3PackedAs.apply(pack4(x_fine), wk, bias)
    conv_input_packed_s2_p4.launches += int(y.is_cuda)
    return y


conv_input_packed_s2_p4.launches = 0
