"""Data parallelism and spatial (volume) partitioning over a process mesh
(counterpart of the JAX package's `parallel/sharding.py`).

In JAX a sharding is only a layout: a step on a mesh computes the same
function as on one device, and GSPMD inserts the collectives.  Here every
rank holds its shard (rows of the batch along ``data``, a slab of D along
``spatial``) and the collectives are explicit:

- `use_mesh(mesh)` makes a mesh active for a block; the ops that need a
  collective consult it (`ops/functional.py`: BatchNorm statistics, the
  D halo of `conv3d`, the trilinear upsample, Dropout's global mask;
  `ops/packed.py` and `models/unet_packed.py` for the packed layout;
  `metrics/dice.py`'s sums), so step functions keep their JAX signatures;
- `all_reduce` (differentiable: its backward all-reduces the cotangent)
  and `global_mean` give reductions over the whole mesh;
- `halo_exchange` appends the neighbours' boundary planes along D;
- `backward` and `sync_gradients` turn a loss that every rank holds whole
  into the global gradient: each rank backpropagates 1/world of it, and
  the parameter gradients are summed over the world before the
  optimizer's step, so every rank keeps the same parameters and state.

A tensor is taken to be split over ``spatial`` when it is 5-D
`(N, D, H, W, C)`; lower-rank tensors (pooled features, logits) are split
over ``data`` only.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.mesh import Mesh, Sharding

_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the enclosed steps on `mesh` (None: no mesh)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def distributed_mesh() -> Optional[Mesh]:
    """The active mesh if it has a process group (its collectives run)."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.distributed else None


def spatial_mesh() -> Optional[Mesh]:
    """The active mesh if its ``spatial`` axis has more than one rank."""
    mesh = current_mesh()
    if mesh is not None and mesh.axis_size("spatial") > 1:
        return mesh
    return None


def sharded_axes(x: torch.Tensor) -> tuple:
    """The mesh axes a tensor is split over: ``data`` and ``spatial`` for
    a 5-D volume, ``data`` alone otherwise."""
    return ("data", "spatial") if x.ndim == 5 else ("data",)


def shard_count(mesh: Optional[Mesh], axes: Sequence[str]) -> int:
    """Ranks across `axes`: how many shards a reduction over them joins."""
    if mesh is None:
        return 1
    return int(np.prod([mesh.axis_size(a) for a in axes]))


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Shard dim 0 (batch) over the data axis."""
    return Sharding(mesh, (axis,))


def volume_sharding(mesh: Mesh, data_axis: Optional[str] = "data",
                    spatial_axis: Optional[str] = "spatial") -> Sharding:
    """(N, D, H, W, C): batch over the data axis, D over the spatial axis."""
    return Sharding(mesh, (data_axis, spatial_axis))


def check_shard_divisibility(shape, mesh: Mesh, data_axis: Optional[str],
                             spatial_axis: Optional[str] = None):
    """Fail fast (clear message) when an array cannot shard evenly: the
    batch must divide by the data axis and, for volume sharding, D by the
    spatial axis, as in JAX."""
    if data_axis in mesh.axis_names:
        n = mesh.shape[data_axis]
        if n > 1 and shape[0] % n:
            raise ValueError(
                f"batch dim {shape[0]} not divisible by mesh '{data_axis}' "
                f"axis size {n}: pad or rebatch the input (uneven shards "
                f"would be silently zero-padded per device)")
    if spatial_axis and spatial_axis in mesh.axis_names:
        n = mesh.shape[spatial_axis]
        if n > 1 and len(shape) > 1 and shape[1] % n:
            raise ValueError(
                f"spatial dim D={shape[1]} not divisible by mesh "
                f"'{spatial_axis}' axis size {n}: crop/pad the volume so "
                f"every device holds an equal D slab")


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)))


def local_shard(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's block of a global tensor under `sharding` (a view).
    ``spatial`` splits only 5-D volumes (`sharded_axes`)."""
    mesh = sharding.mesh
    for dim, axis in enumerate(sharding.spec):
        if axis is None or axis not in mesh.shape or x.ndim <= dim \
                or (axis == "spatial" and x.ndim != 5):
            continue
        n = mesh.shape[axis]
        if n == 1:
            continue
        if x.shape[dim] % n:
            check_shard_divisibility(
                x.shape, mesh, axis if dim == 0 else None,
                axis if dim == 1 else None)
        per = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis) * per, per)
    return x


def _map_tree(tree, fn):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def shard_batch(batch, mesh: Mesh, sharding: Optional[Sharding] = None):
    """This rank's shard of every array of a batch (a tensor, an array, or
    a tuple, list or dict of them), on the mesh's device: rows over
    ``data`` (default), or as `sharding` says."""
    s = sharding or batch_sharding(mesh)

    def put(x):
        x = _as_tensor(x)
        if sharding is None:
            check_shard_divisibility(x.shape, mesh, "data")
        return local_shard(x, s).to(mesh.device)

    return _map_tree(batch, put)


def _broadcast_tensors(tensors, mesh: Mesh) -> None:
    for t in tensors:
        if torch.is_tensor(t):
            dist.broadcast(t.data, 0, group=mesh.group())


def replicate(tree, mesh: Mesh):
    """Make every rank hold rank 0's copy of a state: a `TrainState` (the
    model's parameters and buffers, the optimizer's tensors), an
    `nn.Module`, or a tuple, list or dict of tensors; broadcast in place,
    returned as given.  Without a process group there is nothing to do."""
    if not mesh.distributed:
        return tree
    from torch import nn

    def visit(obj):
        if isinstance(obj, nn.Module):
            _broadcast_tensors(list(obj.parameters()) + list(obj.buffers()),
                               mesh)
        elif hasattr(obj, "model") and hasattr(obj, "optimizer"):
            visit(obj.model)
            for st in obj.optimizer.state.values():
                _broadcast_tensors(
                    [v for v in st.values()
                     if torch.is_tensor(v) and v.device == mesh.device],
                    mesh)
        elif hasattr(obj, "__dataclass_fields__"):
            for name in obj.__dataclass_fields__:
                value = getattr(obj, name)
                if value is not None:
                    visit(value)
        else:
            _map_tree(obj, lambda t: _broadcast_tensors([t], mesh))

    visit(tree)
    return tree


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the cotangent is summed the same way, so
    each rank's input gets the gradient of the sum of every rank's use."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(t: torch.Tensor, axes: Sequence[str] = ("data", "spatial"),
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Differentiable sum of `t` over the ranks of the active mesh's `axes`;
    the identity without a mesh or a process group."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or not mesh.distributed:
        return t
    group = mesh.group(axes)
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduceSum.apply(t, group)
    out = t.detach().contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """`t.mean()` over the global batch of a tensor whose dim 0 is split
    over ``data`` (and replicated over ``spatial``): equal to `t.mean()`
    without a mesh."""
    mesh = distributed_mesh()
    if mesh is None:
        return t.mean()
    n = shard_count(mesh, ("data",))
    return all_reduce(t.sum(), ("data",)) / (t.numel() * n)


def world_size() -> int:
    """Ranks of the active mesh (1 without one)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.size


def backward(loss: torch.Tensor) -> None:
    """Backpropagate a loss that every rank of the active mesh holds whole
    (its global value): each rank takes 1/world of it, so that the
    all-reduce backward of the collectives inside it and `sync_gradients`
    add up to the global gradient exactly once."""
    n = world_size()
    (loss / n if n > 1 else loss).backward()


def sync_gradients(params) -> None:
    """Sum the `.grad` of every parameter over the active mesh's world
    (one flat all-reduce per dtype and device), in place."""
    mesh = current_mesh()
    if mesh is None or not mesh.distributed:
        return
    grads = [p.grad for p in params if p.grad is not None]
    buckets: dict = {}
    for g in grads:
        buckets.setdefault((g.dtype, g.device), []).append(g)
    group = mesh.group()
    for bucket in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def all_agree(flag: bool, mesh: Optional[Mesh] = None) -> bool:
    """True only if `flag` is True on every rank of the mesh (the active
    one by default); the identity without a process group."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or not mesh.distributed:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group())
    return bool(t.item() > 0.5)


def any_rank(flag: bool, mesh: Optional[Mesh] = None) -> bool:
    """True if `flag` is True on any rank of the mesh."""
    return not all_agree(not flag, mesh)


def barrier(mesh: Optional[Mesh] = None) -> None:
    mesh = current_mesh() if mesh is None else mesh
    if mesh is not None and mesh.distributed:
        dist.barrier(group=mesh.group())


def is_writer(mesh: Optional[Mesh] = None) -> bool:
    """Whether this rank writes shared files (checkpoints): rank 0 of the
    mesh, or the only process."""
    mesh = current_mesh() if mesh is None else mesh
    return mesh is None or not mesh.distributed or dist.get_rank() == 0


def gather(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """All-gather the shards of `x` back into the global tensor on every
    rank (the inverse of `local_shard`); not differentiable."""
    mesh = sharding.mesh
    if not mesh.distributed:
        return x
    for dim in reversed(range(len(sharding.spec))):
        axis = sharding.spec[dim]
        if axis is None or axis not in mesh.shape or x.ndim <= dim \
                or (axis == "spatial" and x.ndim != 5):
            continue
        group = mesh.group(axis)
        n = dist.get_world_size(group)
        if n == 1:
            continue
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim=dim)
    return x


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------


def _neighbours(group):
    """(left, right) global ranks along `group`'s order, None at the ends."""
    if group is None:
        return None, None
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    left = dist.get_global_rank(group, me - 1) if me > 0 else None
    right = dist.get_global_rank(group, me + 1) if me < n - 1 else None
    return left, right


def _swap(group, to_left, to_right, like):
    """Send `to_left` to the left neighbour and `to_right` to the right
    one; return (from_left, from_right), None where there is no
    neighbour."""
    left, right = _neighbours(group)
    ops, got = [], [None, None]
    for i, (peer, out) in enumerate(((left, to_left), (right, to_right))):
        if peer is None:
            continue
        got[i] = torch.empty_like(like, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.isend, out.contiguous(), peer))
        ops.append(dist.P2POp(dist.irecv, got[i], peer))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, halo: int, dim: int, mode: str):
        ctx.group, ctx.halo, ctx.dim, ctx.mode = group, halo, dim, mode
        n = x.shape[dim]
        first, last = x.narrow(dim, 0, halo), x.narrow(dim, n - halo, halo)
        from_left, from_right = _swap(group, first, last, first)
        ctx.edges = (from_left is None, from_right is None)
        if from_left is None:
            from_left = (x.narrow(dim, 0, 1).expand_as(first)
                         if mode == "edge" else torch.zeros_like(first))
        if from_right is None:
            from_right = (x.narrow(dim, n - 1, 1).expand_as(last)
                          if mode == "edge" else torch.zeros_like(last))
        return torch.cat([from_left, x, from_right], dim=dim)

    @staticmethod
    def backward(ctx, g):
        halo, dim = ctx.halo, ctx.dim
        n = g.shape[dim] - 2 * halo
        g_left = g.narrow(dim, 0, halo)
        g_right = g.narrow(dim, n + halo, halo)
        gx = g.narrow(dim, halo, n).clone()
        # my halo planes came from my neighbours: their cotangents go back
        back_left, back_right = _swap(ctx.group, g_left, g_right, g_left)
        at_left_edge, at_right_edge = ctx.edges
        if back_left is not None:
            gx.narrow(dim, 0, halo).add_(back_left)
        elif ctx.mode == "edge" and at_left_edge:
            gx.narrow(dim, 0, 1).add_(g_left.sum(dim, keepdim=True))
        if back_right is not None:
            gx.narrow(dim, n - halo, halo).add_(back_right)
        elif ctx.mode == "edge" and at_right_edge:
            gx.narrow(dim, n - 1, 1).add_(g_right.sum(dim, keepdim=True))
        return gx, None, None, None, None


def halo_exchange(x: torch.Tensor, group, halo: int, dim: int = 1,
                  mode: str = "zeros") -> torch.Tensor:
    """Append `halo` boundary planes from both neighbours along `dim`:
    the left neighbour's last planes before x, the right one's first
    planes after it (neighbours in `group`'s rank order; `group` None is a
    world of one).  Ranks at the ends get zero halos (`mode="zeros"`, a
    conv's zero padding) or copies of their own boundary plane
    (`mode="edge"`, the clamp of a trilinear resize).  Differentiable: the
    backward sends each halo's cotangent back to the rank it came from and
    adds it into the boundary planes.  Returns x extended by 2 * halo
    along `dim`."""
    if mode not in ("zeros", "edge"):
        raise ValueError(f"halo_exchange mode must be 'zeros' or 'edge', "
                         f"not {mode!r}")
    if not 0 < halo <= x.shape[dim]:
        raise ValueError(f"halo {halo} must be in [1, {x.shape[dim]}]")
    return _HaloExchange.apply(x, group, halo, dim, mode)


def spatial_halo(x: torch.Tensor, halo: int, mode: str = "zeros",
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """`halo_exchange` along D (dim 1) over the spatial axis of `mesh`
    (default: the active one)."""
    mesh = current_mesh() if mesh is None else mesh
    return halo_exchange(x, mesh.group("spatial"), halo, dim=1, mode=mode)


def spatial_edges(mesh: Optional[Mesh] = None):
    """(holds the volume's first D plane, holds its last) for this rank."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return True, True
    i, n = mesh.index("spatial"), mesh.axis_size("spatial")
    return i == 0, i == n - 1


# ---------------------------------------------------------------------------
# applying a function on a mesh
# ---------------------------------------------------------------------------


def make_parallel_apply(apply_fn, mesh: Mesh, in_volume_sharding=True):
    """`apply_fn(variables, x)` with the variables replicated and the global
    x split (batch over ``data``, and D over ``spatial`` if the mesh has
    that axis): each rank runs its shard under `use_mesh(mesh)` and the
    outputs are gathered into the global result on every rank."""
    has_spatial = "spatial" in mesh.axis_names and mesh.shape["spatial"] > 1
    x_shard = (volume_sharding(mesh, "data",
                               "spatial" if has_spatial else None)
               if in_volume_sharding else batch_sharding(mesh))

    @functools.wraps(apply_fn)
    def checked(variables, x):
        check_shard_divisibility(
            x.shape, mesh, "data",
            "spatial" if (in_volume_sharding and has_spatial) else None)
        xl = local_shard(_as_tensor(x), x_shard).to(mesh.device)
        with use_mesh(mesh):
            out = apply_fn(variables, xl)
        return gather(out, x_shard)

    return checked
