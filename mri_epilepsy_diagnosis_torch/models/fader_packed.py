"""Packed (space-to-depth) execution of the fader encoder, eval mode
(counterpart of the JAX package's `models/fader_packed.py`).

The fader `DownBlock` (reference `classification/models/AE_model.py:4-53`)
is three separable convs, (k,1,1), (1,k,1), (1,1,k), each stride 2 with
pad k/2-1, then a 2x2x2 max pool, BN and LeakyReLU.  On the packed layout
of `ops/packed.py` the geometry collapses onto cells:
- a fine k, s=2, p=k/2-1 conv along one axis is EXACTLY a (k/2+1)-cell,
  stride-2-cell conv over packed cells with channels 8Ci -> 8Co: with
  output fine index o = 2co + so and input i = 2ci + ri, the tap is
  t = 2q + ri - 2so (q the cell offset), and the fine padding becomes
  whole zero cells (`_axis_table_strided`);
- the 2x2x2 stride-2 pool windows are the packed cells, so the pool is a
  max over the 8 sub-position channel groups.
A block runs `pack2`, the three packed axis convs as ONE call of kernel B3
(`ops/cuda_kernels.py::separable_conv3d`: one fused launch, or three
`conv_axis` launches where `_separable_route` says so), the sub-group max
(fine layout out, at 1/4 resolution), BN on the running statistics and
the activation.  At the reference geometry (k 6, s 2, p 2) each axis
kernel has Q = 4 cells with cell padding 1 on both sides, which B3's
symmetric pad serves exactly; the encoder packs every block at 192^3.
Blocks whose input is not divisible by 4 run `downblock_apply_fine` (the
module's own separable stack through B3), as in JAX.

Eval only: the B3 launches here record no gradient.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from ..ops import cuda_kernels as K
from ..ops import packed as P
from .fader import (_DOWN_STACK, DownBlock, Encoder, _axis_weight,
                    _down_block_kwargs, _norm_act, encoder_stem)


@functools.lru_cache(maxsize=None)
def _axis_table_strided(k: int, p: int):
    """Connection table of a fine (k, stride 2, pad p) conv in cell space.

    Fine output o = 2*co + so reads fine input i = 2*o - p + t, i.e. input
    cell ci = 2*co + q' with 2*q' + ri = 2*so - p + t: each (t, so) pair
    lands on exactly one (q', ri).  Returns (A[q, r, s, t] 0/1 with
    q = q' - q'_min, pad_lo = -q'_min)."""
    entries = []
    for t in range(k):
        for s in range(2):
            r = (t - p) % 2
            q = (t - r + 2 * s - p) // 2
            entries.append((q, r, s, t))
    qmin = min(e[0] for e in entries)
    qmax = max(e[0] for e in entries)
    a = np.zeros((qmax - qmin + 1, 2, 2, k), np.float32)
    for q, r, s, t in entries:
        a[q - qmin, r, s, t] = 1.0
    return a, -qmin


@functools.lru_cache(maxsize=None)
def _packed_axis_tap_index(k: int, p: int, axis: int) -> np.ndarray:
    """Fine tap (or k, for zero) of each entry (q, rd, rh, rw, sd, sh, sw)
    of the packed strided kernel along `axis`: the table's tap where the
    other two axes keep their sub (r == s), else none."""
    table, _ = _axis_table_strided(k, p)
    q_cells = table.shape[0]
    idx = np.full((q_cells,) + (2,) * 6, k, np.int64)
    for q, r, s, t in zip(*np.nonzero(table)):
        for o1 in range(2):
            for o2 in range(2):
                rs = [o1, o2]
                rs.insert(axis, r)
                ss = [o1, o2]
                ss.insert(axis, s)
                idx[(q, *rs, *ss)] = t
    return idx


@functools.lru_cache(maxsize=None)
def _device_axis_tap_index(k: int, p: int, axis: int,
                           device: torch.device) -> torch.Tensor:
    return P._device_constant(_packed_axis_tap_index(k, p, axis),
                              device=device)


def pack_sepconv_weight(w_axis: torch.Tensor, axis: int, pad: int):
    """Fine separable kernel (k, Ci, Co) along `axis` (0 = D, 1 = H, 2 = W)
    -> (the packed strided kernel (Q, 8Ci, 8Co), B3's one-axis layout;
    cell pad_lo).  Channels (rd, rh, rw, ci) -> (sd, sh, sw, co), identity
    on the subs of the other two axes; each entry is one fine tap or zero,
    gathered exactly.  JAX returns the same kernel as a 5-D conv weight,
    (Q, 1, 1, 8Ci, 8Co) with Q on `axis`."""
    k, ci, co = w_axis.shape
    idx = _device_axis_tap_index(k, pad, axis, w_axis.device)
    taps = torch.cat([w_axis, w_axis.new_zeros(1, ci, co)])
    wp = taps[idx]
    # (q, rd, rh, rw, sd, sh, sw, ci, co) -> (q, (r, ci), (s, co))
    wp = wp.permute(0, 1, 2, 3, 7, 4, 5, 6, 8)
    return (wp.reshape(idx.shape[0], 8 * ci, 8 * co),
            _axis_table_strided(k, pad)[1])


def _symmetric_pad(q_cells: int, pad_lo: int) -> int:
    """B3 pads both ends alike: it serves cell padding (pad_lo, Q - 2 -
    pad_lo) exactly when the two are equal, which the fader's geometry (k
    even, s 2, p k/2 - 1) gives."""
    if q_cells - 2 - pad_lo != pad_lo:
        raise ValueError(f"packed axis conv needs symmetric cell padding; "
                         f"got ({pad_lo}, {q_cells - 2 - pad_lo})")
    return pad_lo


def conv_axis_packed(xp: torch.Tensor, wp: torch.Tensor, bias, axis: int,
                     pad_lo: int) -> torch.Tensor:
    """Packed strided separable conv along `axis` (0 = D, 1 = H, 2 = W):
    kernel Q cells (wp (Q, 8Ci, 8Co) from `pack_sepconv_weight`), stride
    2 cells, cell padding (pad_lo, Q - 2 - pad_lo), so out = in / 2 cells;
    bias fine (Co,), tiled.  One `conv_axis` launch (B3)."""
    pad = _symmetric_pad(wp.shape[0], pad_lo)
    bias = None if bias is None else P.tile_channel_param(bias)
    return K.conv_one_axis(xp, wp.to(xp.dtype), axis + 1, stride=2, pad=pad,
                           bias=bias)


def downblock_apply_fine(block: DownBlock, x: torch.Tensor, *,
                         conv_k: int = 6, conv_s: int = 2, conv_pad=None,
                         maxpool_k: int = 2, maxpool_s: int = 2,
                         batch_norm: bool = True, act: str = "l_relu"):
    """Fine-layout eval DownBlock: the module's separable convs (one B3
    call) and pool, with their own geometry, then BN on the running
    statistics and the activation.  The fallback for blocks the packed
    form cannot take.  Returns (y, pre-pool spatial shape)."""
    del conv_k, conv_s, conv_pad, maxpool_k, maxpool_s  # the block's own
    x, shape_before_pool = block.pre_norm(x)
    return _norm_act(block, x, batch_norm, act), shape_before_pool


def downblock_apply_packed(block: DownBlock, x: torch.Tensor, *,
                           conv_k: int = 6, conv_s: int = 2, conv_pad=None,
                           maxpool_k: int = 2, maxpool_s: int = 2,
                           batch_norm: bool = True, act: str = "l_relu"):
    """Eval-mode DownBlock in the packed layout.  x fine (N, D, H, W, C),
    D, H, W divisible by 4; returns (fine output at 1/4 resolution,
    pre-pool spatial shape).  Raises for any geometry but stride 2, even
    k, pad k/2-1 and a 2x2x2 pool (the reference fader's), which is what
    lets the convs and the pool collapse onto cells."""
    k = conv_k
    p = conv_pad if conv_pad is not None else k // 2 - 1
    if not (conv_s == 2 and k % 2 == 0 and p == k // 2 - 1):
        raise ValueError(f"packed DownBlock needs even k, s=2, p=k/2-1; got "
                         f"k={k} s={conv_s} p={p}")
    if maxpool_k != 2 or maxpool_s != 2:
        raise ValueError("packed pool needs k=s=2")
    if any(s % 4 for s in x.shape[1:4]):
        raise ValueError(f"spatial dims {tuple(x.shape[1:4])} must be "
                         f"divisible by 4 (2 for packing x 2 for the "
                         f"stride)")
    b = block.block
    ws, biases, pads = [], [], []
    for axis, name in enumerate(_DOWN_STACK):
        wp, pad_lo = pack_sepconv_weight(_axis_weight(b[name], x.dtype),
                                         axis, p)
        ws.append(wp)
        pads.append(_symmetric_pad(wp.shape[0], pad_lo))
        bias = b[name].bias
        biases.append(None if bias is None else P.tile_channel_param(bias))
    xp = K.separable_conv3d(P.pack2(x), *ws, stride=(2, 2, 2),
                            pad=tuple(pads), biases=tuple(biases))
    shape_before_pool = tuple(2 * s for s in xp.shape[1:4])
    n, dc, hc, wc, c8 = xp.shape
    # the fine 2x2x2 s2 max pool: a max over the 8 sub-position groups
    y = xp.reshape(n, dc, hc, wc, 8, c8 // 8).amax(dim=4)
    return _norm_act(block, y, batch_norm, act), shape_before_pool


def encoder_apply_packed(encoder: Encoder, x: torch.Tensor,
                         ae_kwargs: Dict[str, Any]):
    """Eval-mode `encoder(x)` -> (latent, size_list) in the packed layout:
    each DownBlock packed where the geometry and its input allow, the
    others (deep blocks shrunk below packability) in the fine layout.
    `ae_kwargs`: the encoder's schema (`train_ENC_CLF.ipynb` cell 17)."""
    x, offset = encoder_stem(encoder, x)
    kwargs = _down_block_kwargs(ae_kwargs, conv_pad=None)
    packable = (kwargs["conv_s"] == 2 and kwargs["conv_k"] % 2 == 0
                and kwargs["conv_pad"] in (None, kwargs["conv_k"] // 2 - 1)
                and kwargs["maxpool_k"] == 2 and kwargs["maxpool_s"] == 2)
    size_list = []
    for i in range(ae_kwargs["deapth"]):
        fn = (downblock_apply_packed
              if packable and all(s % 4 == 0 for s in x.shape[1:4])
              else downblock_apply_fine)
        x, size = fn(encoder.encode[i + offset], x, **kwargs)
        size_list.append(size)
    return x, size_list
