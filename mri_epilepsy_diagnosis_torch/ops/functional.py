"""Channels-last functional ops of the fine UNet3D, the fader family and
the detection PatchModel (counterpart of the JAX package's
`ops/functional.py`: `prelu`, `batch_norm` with the train-mode statistics
of `ops/layers.py::BatchNorm`, `instance_norm` and `group_norm`,
`maxpool3d` and `maxpool2d` with JAX's gradients at tied maxima,
`avgpool3d`, `conv3d`, `conv3d_transpose`, `conv2d` and `dense`,
`resize_linear`,
`resize_nearest`, `module_batch_norm` and `dropout` (with `generator_on`)
for the train-mode layers, the fader's `relu`/`l_relu` activations, and
the shape utilities `pad_to` and `crop_or_pad`).  Every function takes and
returns channels-last tensors, `(N, D, H, W, C)` or, for the 2-D ops,
`(N, H, W, C)`; weights keep torch's layouts (`(O, I, kH, kW)`,
`(out, in)`), where JAX's are channels-last.

Under an active mesh (`parallel.use_mesh`) the ops that see more than
their own shard become collective, as GSPMD makes them in JAX:
BatchNorm's statistics are all-reduced over the ranks, and InstanceNorm's
and GroupNorm's over the spatial ranks; `conv3d` and the trilinear x2
`resize_linear` take a D halo from the spatial neighbours; `maxpool3d`,
`avgpool3d`, `conv3d_transpose` and `resize_nearest` check that their
D windows stay inside the slab and raise otherwise; and `dropout` draws
its mask at the global shape and keeps the rank's block of it."""
from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.mesh import Sharding
from ..parallel import sharding as _S


@contextlib.contextmanager
def _exact_f32_convs(dtype: torch.dtype):
    """cuDNN convolutions without TF32 for float32 operands (torch's
    default lets cuDNN round them to TF32), as the port's float32 paths
    are held to float32 references; other dtypes run as they are."""
    if dtype != torch.float32:
        yield
        return
    with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False):
        yield


def _global_count(x: torch.Tensor) -> int:
    """Values per channel of channels-last `x` over every shard of the
    active mesh (x's own count without one)."""
    return x[..., 0].numel() * _S.shard_count(_S.current_mesh(),
                                              _S.sharded_axes(x))


def prelu(x: torch.Tensor, a) -> torch.Tensor:
    """PReLU with torch's shared-parameter semantics (`num_parameters=1`)
    or one slope per channel (last axis)."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, x, x * a)


def batch_norm(x, mean, var, gamma, beta, eps: float = 1e-5):
    """BatchNorm of channels-last `x` with the given statistics (the
    running ones in eval mode, the batch's in train mode), in x's dtype;
    the reciprocal square root is taken in float32, as in JAX."""
    inv = torch.rsqrt(var.float() + eps).to(x.dtype)
    return ((x - mean.to(x.dtype)) * inv * gamma.to(x.dtype)
            + beta.to(x.dtype))


def batch_moments(x: torch.Tensor):
    """Train-mode BatchNorm statistics of channels-last `x`: the float32
    per-channel mean and biased (centered) variance over every other axis,
    differentiable (the JAX package's `ops/layers.py::BatchNorm`).  Under
    a mesh the moments are the global batch's: the sums are all-reduced
    over the ranks the tensor is split over, first Σx for the mean, then
    Σ(x - mean)² for the variance."""
    xf = x.float()
    axes = tuple(range(x.ndim - 1))
    if _S.distributed_mesh() is None:
        mean = xf.mean(dim=axes)
        return mean, (xf - mean).square().mean(dim=axes)
    over, count = _S.sharded_axes(x), _global_count(x)
    mean = _S.all_reduce(xf.sum(dim=axes), over) / count
    var = _S.all_reduce((xf - mean).square().sum(dim=axes), over) / count
    return mean, var


def update_running_stats(running_mean, running_var, mean, var,
                         count: float, momentum: float = 0.1):
    """torch's running-statistics rule, `(1 - m) * running + m * batch`,
    with the unbiased batch variance (`var * count / (count - 1)`); the
    results are new tensors, detached from the graph."""
    unbiased = var.detach() * (count / max(count - 1.0, 1.0))
    return ((1 - momentum) * running_mean + momentum * mean.detach(),
            (1 - momentum) * running_var + momentum * unbiased)


def module_batch_norm(bn, x: torch.Tensor) -> torch.Tensor:
    """Channels-last BatchNorm through the statistics and affine parameters
    of the torch module `bn` (`nn.BatchNorm1d`/`3d`).  In train mode, the
    batch's moments (`batch_moments`), with torch's running update in
    place (`update_running_stats`, `bn.momentum`, `num_batches_tracked`
    counted) and torch's refusal of a single value per channel; in eval
    mode, the running statistics.  The JAX package's `ops/layers.py::
    BatchNorm`.  Under a mesh, the global batch's moments and count."""
    if not bn.training:
        return batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                          bn.bias, bn.eps)
    count = _global_count(x)
    if count <= 1:
        raise ValueError("Expected more than 1 value per channel when "
                         f"training, got input size {tuple(x.shape)}")
    mean, var = batch_moments(x)
    with torch.no_grad():
        new = update_running_stats(bn.running_mean, bn.running_var, mean,
                                   var, count, bn.momentum)
        bn.running_mean.copy_(new[0])
        bn.running_var.copy_(new[1])
        bn.num_batches_tracked.add_(1)
    return batch_norm(x, mean, var, bn.weight, bn.bias, bn.eps)


def dropout_core(x: torch.Tensor, keep_mask: torch.Tensor,
                 rate: float) -> torch.Tensor:
    """Inverted dropout with a given boolean keep mask: `x / (1 - rate)`
    where kept, 0 elsewhere (the JAX package's `ops/layers.py::Dropout`)."""
    return torch.where(keep_mask, x / (1.0 - rate), 0.0)


def generator_on(gen: torch.Generator, device: torch.device
                 ) -> torch.Generator:
    """`gen` if it lives on `device`, else a generator on `device` seeded
    from one draw of `gen`: a host generator then never moves a tensor
    between the host and the card."""
    if gen.device == device:
        return gen
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen,
                             device=gen.device))
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout in train mode, the identity otherwise or at rate 0.
    The keep mask (`u < 1 - rate` for u uniform in [0, 1)) is drawn on
    x's device, from `generator_on(generator, x.device)` (torch's default
    generator of that device if None).  JAX draws other bits from its
    keys (ROADMAP §C).  Under a mesh the mask is drawn at the global shape
    and each rank keeps its rows (and D slab), so the sharded step drops
    what the unsharded one does."""
    if not training or rate == 0.0:
        return x
    gen = None if generator is None else generator_on(generator, x.device)
    mesh = _S.current_mesh()
    if mesh is None:
        u = torch.rand(x.shape, generator=gen, device=x.device)
    else:
        axes = _S.sharded_axes(x)
        shape = list(x.shape)
        for dim, axis in enumerate(axes):
            shape[dim] *= mesh.axis_size(axis)
        u = _S.local_shard(torch.rand(shape, generator=gen, device=x.device),
                           Sharding(mesh, axes))
    return dropout_core(x, u < 1.0 - rate, rate)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def maximum0(x: torch.Tensor) -> torch.Tensor:
    """`jnp.maximum(x, 0)`, the ReLU of the JAX package's zoo models: at
    x == 0 the gradient is split, 0.5 (`torch.maximum`'s rule too), where
    `relu` passes all of it and `torch.relu` (`jax.nn.relu`) none."""
    return torch.maximum(x, x.new_zeros(()))


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """torch `nn.LeakyReLU()` (slope 0.01), the fader's `l_relu`."""
    return torch.where(x >= 0, x, slope * x)


def activation(name: str):
    """The fader family's `act` kwarg: "l_relu" or "relu"."""
    return leaky_relu if name == "l_relu" else relu


class _BlockMaxPool(torch.autograd.Function):
    """Non-overlapping max pool (stride == kernel, every spatial extent
    divisible by it): the forward is a reshape and a max; the gradient
    goes in full to every tied maximum of a block, as the custom VJP of
    the JAX package's `_maxpool3d_blocks` gives it."""

    @staticmethod
    def forward(ctx, x, k: int):
        n, d, h, w, c = x.shape
        y = x.reshape(n, d // k, k, h // k, k, w // k, k, c).amax(
            dim=(2, 4, 6))
        ctx.save_for_backward(x, y)
        ctx.k = k
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        k = ctx.k
        n, d, h, w, c = x.shape
        xr = x.reshape(n, d // k, k, h // k, k, w // k, k, c)
        at = (slice(None),) + (slice(None), None) * 3 + (slice(None),)
        return torch.where(xr == y[at], g[at], 0).reshape(x.shape), None


def _pool_padding_value(dtype: torch.dtype):
    """What `reduce_window` pads a max pool with: -inf, or the dtype's
    minimum for integers."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def maxpool3d(x: torch.Tensor, kernel: int = 2,
              stride: Optional[int] = None, padding: int = 0
              ) -> torch.Tensor:
    """`kernel`^3 max pool with torch `nn.MaxPool3d(kernel, stride,
    padding)` values (floor mode: a ragged edge is dropped) and the JAX
    package's gradients:
    - stride == kernel, no padding, every extent divisible:
      `_BlockMaxPool`, the full cotangent to every tied maximum;
    - kernel 4, stride 2, no padding: the pool of 2 and stride 2, then a
      pool of 2 and stride 1, composed as JAX composes them (the same
      values);
    - anything else: torch's pool, whose gradient goes to the first
      maximum of each window, as XLA's `select_and_scatter` does for
      JAX's `reduce_window`.  `padding` pads each spatial side with -inf,
      or with the dtype's minimum for integers, as `reduce_window` does
      (and, unlike torch, for any padding); integer inputs, which torch's
      pool refuses, take the max of the unfolded windows."""
    k = kernel
    s = k if stride is None else stride
    if _S.spatial_mesh() is not None and (s != k or padding
                                          or x.shape[1] % k):
        raise ValueError(
            f"maxpool3d under a spatial mesh needs stride == kernel, no "
            f"padding and the local D slab ({x.shape[1]}) divisible by "
            f"{k}")
    if padding == 0:
        if s == k and all(n % k == 0 for n in x.shape[1:4]):
            return _BlockMaxPool.apply(x, k)
        if (k, s) == (4, 2):
            return maxpool3d(maxpool3d(x, 2, 2), 2, 1)
    if padding:
        x = TF.pad(x, (0, 0) + (padding, padding) * 3,
                   value=_pool_padding_value(x.dtype))
    if not x.dtype.is_floating_point:
        win = x.unfold(1, k, s).unfold(2, k, s).unfold(3, k, s)
        return win.amax(dim=(-3, -2, -1))
    y = TF.max_pool3d(x.permute(0, 4, 1, 2, 3), k, s)
    return y.permute(0, 2, 3, 4, 1)


def maxpool2d(x: torch.Tensor, kernel: int = 2, stride: Optional[int] = None,
              padding: int = 0) -> torch.Tensor:
    """torch `nn.MaxPool2d(kernel, stride, padding)` on channels-last
    `(N, H, W, C)`; the gradient goes to the first maximum of each window,
    as JAX's `reduce_window` gives it."""
    y = TF.max_pool2d(x.permute(0, 3, 1, 2), kernel,
                      kernel if stride is None else stride, padding)
    return y.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, *, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """torch `F.conv2d` on channels-last `(N, H, W, C)` with a weight in
    torch's `(O, I / groups, kH, kW)` layout; the weight and bias are cast
    to x's dtype, as JAX casts them.  float32 runs without TF32."""
    with _exact_f32_convs(x.dtype):
        y = TF.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype),
                      None if b is None else b.to(x.dtype), stride=stride,
                      padding=padding, dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1)


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


def conv3d(x: torch.Tensor, w: torch.Tensor, b=None, *, stride=1,
           padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """torch `F.conv3d` on channels-last `(N, D, H, W, C)` with a weight in
    torch's `(O, I / groups, kD, kH, kW)` layout (JAX's is `(kD, kH, kW,
    I / groups, O)`); the weight and bias are cast to x's dtype, as JAX
    casts them.  cuDNN on the card, float32 without TF32: JAX's custom
    VJP for this conv computes the same gradients.

    Under a spatial mesh a conv that keeps D ("same" along D: stride 1,
    padding (kD - 1) / 2) takes that many planes from each neighbour
    (`halo_exchange`, zeros at the volume's faces) and runs with no D
    padding; other convs along a split D raise."""
    if _S.spatial_mesh() is not None and (w.shape[2] > 1 or
                                          _triple(padding)[0]):
        pd, ph, pw = _triple(padding)
        if (_triple(stride)[0] != 1 or _triple(dilation)[0] != 1
                or 2 * pd != w.shape[2] - 1):
            raise NotImplementedError(
                "conv3d under a spatial mesh needs a 'same' conv along D "
                f"(stride 1, padding (kD - 1) / 2); got kD {w.shape[2]}, "
                f"padding {padding}, stride {stride}")
        x = _S.spatial_halo(x, pd)
        padding = (0, ph, pw)
    with _exact_f32_convs(x.dtype):
        y = TF.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype),
                      None if b is None else b.to(x.dtype), stride=stride,
                      padding=padding, dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 4, 1)


def conv3d_transpose(x: torch.Tensor, w: torch.Tensor, b=None, *, stride=1,
                     padding=0, output_padding=0, dilation=1
                     ) -> torch.Tensor:
    """torch `nn.ConvTranspose3d` on channels-last `x` with torch's `(I, O,
    kD, kH, kW)` weight (JAX stores `(kD, kH, kW, O, I)` and flips it
    itself), the weight and bias cast to x's dtype; float32 without
    TF32.  Under a spatial mesh only a deconv whose D windows do not
    overlap (stride == kernel along D, no padding) maps each slab to its
    own output slab; others raise."""
    if _S.spatial_mesh() is not None:
        kd = w.shape[2]
        if (_triple(stride)[0] != kd or _triple(padding)[0]
                or _triple(output_padding)[0] or _triple(dilation)[0] != 1):
            raise NotImplementedError(
                "conv3d_transpose under a spatial mesh needs D windows that "
                "do not overlap (stride == kernel along D, no padding or "
                f"output padding); got kD {kd}, stride {stride}, padding "
                f"{padding}, output_padding {output_padding}")
    with _exact_f32_convs(x.dtype):
        y = TF.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype),
                                None if b is None else b.to(x.dtype),
                                stride=stride, padding=padding,
                                output_padding=output_padding,
                                dilation=dilation)
    return y.permute(0, 2, 3, 4, 1)


def avgpool3d(x: torch.Tensor, kernel=2, stride=None) -> torch.Tensor:
    """torch `nn.AvgPool3d(kernel, stride)` (no padding, floor mode) on
    channels-last `x`: JAX's window sum over `prod(kernel)`.  Under a
    spatial mesh the D windows must tile the local slab (stride ==
    kernel along D, the slab's D divisible by it); others raise."""
    kd = _triple(kernel)[0]
    sd = kd if stride is None else _triple(stride)[0]
    if _S.spatial_mesh() is not None and (sd != kd or x.shape[1] % kd):
        raise NotImplementedError(
            f"avgpool3d under a spatial mesh needs stride == kernel along D "
            f"and the local D slab ({x.shape[1]}) divisible by {kd}; got "
            f"kernel {kernel}, stride {stride}")
    y = TF.avg_pool3d(x.permute(0, 4, 1, 2, 3), kernel,
                      kernel if stride is None else stride)
    return y.permute(0, 2, 3, 4, 1)


def _affine(y: torch.Tensor, gamma, beta) -> torch.Tensor:
    if gamma is not None:
        y = y * gamma.to(y.dtype)
    if beta is not None:
        y = y + beta.to(y.dtype)
    return y


def _sample_moments(x: torch.Tensor, xr: torch.Tensor, axes):
    """Mean and biased (centred) variance of `xr`, a view of channels-last
    `x`, over `axes` (each sample's own voxels), in x's dtype.  When `x`
    is a volume split over D by the active mesh, the sums are all-reduced
    over the spatial ranks, first Σx for the mean, then Σ(x - mean)², so
    that every slab gets the whole volume's moments."""
    if x.ndim != 5 or _S.spatial_mesh() is None:
        mean = xr.mean(dim=axes, keepdim=True)
        return mean, (xr - mean).square().mean(dim=axes, keepdim=True)
    count = int(np.prod([xr.shape[a] for a in axes])) * _S.shard_count(
        _S.current_mesh(), ("spatial",))
    mean = _S.all_reduce(xr.sum(dim=axes, keepdim=True), ("spatial",)) / count
    var = _S.all_reduce((xr - mean).square().sum(dim=axes, keepdim=True),
                        ("spatial",)) / count
    return mean, var


def instance_norm(x: torch.Tensor, gamma=None, beta=None,
                  eps: float = 1e-5) -> torch.Tensor:
    """torch `nn.InstanceNorm3d` (no running statistics, affine if gamma
    and beta are given) on channels-last `x`: each (sample, channel)
    normalized over the spatial axes with its biased variance and
    `rsqrt(var + eps)`, in x's dtype, as JAX computes it; under a spatial
    mesh, over the whole volume (`_sample_moments`)."""
    mean, var = _sample_moments(x, x, tuple(range(1, x.ndim - 1)))
    return _affine((x - mean) * torch.rsqrt(var + eps), gamma, beta)


def group_norm(x: torch.Tensor, num_groups: int, gamma=None, beta=None,
               eps: float = 1e-5) -> torch.Tensor:
    """torch `nn.GroupNorm` on channels-last `x`: channel c belongs to
    group `c // (C / num_groups)`, each (sample, group) normalized over
    its channels and the spatial axes with the biased variance, in x's
    dtype, as JAX computes it; under a spatial mesh, over the whole
    volume (`_sample_moments`)."""
    n, c = x.shape[0], x.shape[-1]
    xg = x.reshape(n, -1, num_groups, c // num_groups)
    mean, var = _sample_moments(x, xg, (1, 3))
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return _affine(y, gamma, beta)


def dense(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """`x @ w.T (+ b)`, torch `nn.Linear` with its `(out, in)` weight (JAX
    stores `(in, out)`), the weight and bias cast to x's dtype."""
    return TF.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


@functools.lru_cache(maxsize=None)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool):
    """(out, in) 1-D linear interpolation matrix, PyTorch conventions."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1 and (align_corners or in_size == 1):
        m[0, 0] = 1.0
        return m
    o = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = o * (in_size - 1) / max(out_size - 1, 1)
    else:
        src = (o + 0.5) * in_size / out_size - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    t = src - i0
    m[np.arange(out_size), i0] += (1.0 - t)
    m[np.arange(out_size), i1] += t
    return m


def _apply_axis_matrix(x: torch.Tensor, m: np.ndarray, axis: int):
    """Contract spatial axis `axis` of x with the (out, in) matrix m."""
    mt = torch.as_tensor(m, dtype=x.dtype, device=x.device)
    y = torch.matmul(x.movedim(axis, -1), mt.t())
    return y.movedim(-1, axis)


def resize_linear(x: torch.Tensor, out_spatial: Sequence[int], *,
                  align_corners: bool = False) -> torch.Tensor:
    """Separable tri-linear resize of channels-last `x`, PyTorch
    `nn.Upsample(mode='trilinear')` semantics.

    Under a spatial mesh a x2 resize of D (align_corners False, the
    decoder's upsample) takes one edge-mode halo plane from each neighbour
    (the clamp at the volume's faces), resizes the extended slab and
    crops it back; any other resize of a split D raises."""
    out_spatial = [int(o) for o in out_spatial]
    crop = 0
    if _S.spatial_mesh() is not None and x.ndim == 5 \
            and out_spatial[0] != x.shape[1]:
        if out_spatial[0] != 2 * x.shape[1] or align_corners:
            raise NotImplementedError(
                "resize_linear under a spatial mesh resizes D only by 2 "
                "with align_corners=False")
        x = _S.spatial_halo(x, 1, mode="edge")
        out_spatial[0] = 2 * x.shape[1]
        crop = 2
    for ax, out_sz in zip(range(1, x.ndim - 1), out_spatial):
        in_sz = x.shape[ax]
        if in_sz != out_sz:
            x = _apply_axis_matrix(
                x, _linear_matrix(in_sz, out_sz, bool(align_corners)), ax)
    if crop:
        x = x.narrow(1, crop, x.shape[1] - 2 * crop)
    return x


@functools.lru_cache(maxsize=None)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output position, torch `mode='nearest'`
    (floor of dst * in/out, the scale taken in float32 as torch does)."""
    scale = np.float32(in_size / out_size)
    src = np.floor(np.arange(out_size, dtype=np.float32) * scale)
    return np.clip(src.astype(np.int64), 0, in_size - 1)


def resize_nearest(x: torch.Tensor,
                   out_spatial: Sequence[int]) -> torch.Tensor:
    """Nearest resize of channels-last `x`, torch `F.interpolate(mode=
    'nearest')` semantics, as one gather per resized axis.  Under a
    spatial mesh D is kept or doubled (each output plane then comes from
    the slab's own plane); other resizes of D raise."""
    if _S.spatial_mesh() is not None and x.ndim == 5 \
            and int(out_spatial[0]) not in (x.shape[1], 2 * x.shape[1]):
        raise NotImplementedError(
            f"resize_nearest under a spatial mesh keeps or doubles D; got "
            f"the local D {x.shape[1]} to {out_spatial[0]}")
    for ax, out_sz in zip(range(1, x.ndim - 1), out_spatial):
        in_sz = x.shape[ax]
        if in_sz != int(out_sz):
            idx = torch.as_tensor(_nearest_index(in_sz, int(out_sz)),
                                  device=x.device)
            x = torch.index_select(x, ax, idx)
    return x


# jnp.pad's modes that torch's constant pad does not cover, by the index
# map np.pad gives them (an exact gather along each padded axis)
_INDEX_PAD_MODES = ("edge", "reflect", "symmetric", "wrap")


def pad_to(x: torch.Tensor, target_spatial: Sequence[int],
           mode: str = "constant", value: float = 0.0) -> torch.Tensor:
    """Pad the spatial axes of `(N, *spatial, C)` up to `target_spatial`,
    symmetrically (an odd voxel goes to the far side), as `jnp.pad` does
    in `mode`: "constant" with `value`, or "edge", "reflect",
    "symmetric" and "wrap", each as one gather along each padded axis
    whose indices are `np.pad`'s own (any dtype, differentiable)."""
    if mode != "constant" and mode not in _INDEX_PAD_MODES:
        raise ValueError(f"pad_to: unsupported mode {mode!r}")
    pads = []
    for ax, tgt in zip(range(1, x.ndim - 1), target_spatial):
        extra = max(0, int(tgt) - x.shape[ax])
        pads.append((extra // 2, extra - extra // 2))
    if not any(lo or hi for lo, hi in pads):
        return x
    if mode != "constant":
        for ax, (lo, hi) in enumerate(pads, start=1):
            if lo or hi:
                idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=mode)
                x = torch.index_select(
                    x, ax, torch.as_tensor(idx, device=x.device))
        return x
    # F.pad lists the last axis first: channels (unpadded), then spatial
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return TF.pad(x, flat, value=value)


def crop_or_pad(x: torch.Tensor, target_spatial: Sequence[int],
                value: float = 0.0) -> torch.Tensor:
    """torchio CropOrPad on `(N, *spatial, C)`: centre crop, then `pad_to`.
    Both are floor-centred, so an odd voxel is cropped from or padded on
    the far side."""
    slices = [slice(None)]
    for ax, tgt in zip(range(1, x.ndim - 1), target_spatial):
        cur, tgt = x.shape[ax], int(tgt)
        start = (cur - tgt) // 2 if cur > tgt else 0
        slices.append(slice(start, start + min(cur, tgt)))
    return pad_to(x[tuple(slices)], target_spatial, value=value)
