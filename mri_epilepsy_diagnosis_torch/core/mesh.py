"""Process mesh construction and canonical shardings (counterpart of the
JAX package's `core/mesh.py`).

The reference has no distributed runtime at all (SURVEY.md §2.3).  JAX
scales through a `jax.sharding.Mesh` of devices; the port lays the same
named axes over the ranks of a `torch.distributed` process group, one
rank per device:

- axis ``data``    — batch (data parallelism; BatchNorm statistics and
                     gradients are all-reduced over it)
- axis ``spatial`` — D-axis partitioning of whole volumes, with halo
                     exchanges around the convolutions
                     (`parallel/sharding.py`)

Ranks are laid out row-major over the axes, ``data`` outermost, as JAX
lays out its host-major global device order.  A mesh of world size 1
needs no process group: its collectives are then the identity.  With a
process group (NCCL on the card, gloo on the CPU) every collective runs,
at any size.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "spatial")
# a collective that waits longer than this raises on every rank, instead
# of hanging the job when one rank has died
PG_TIMEOUT_S = 120.0


def local_device_count() -> int:
    """CUDA devices visible to this process."""
    return torch.cuda.device_count()


def _world() -> Tuple[int, int]:
    """(world size, rank) of the default process group, (1, 0) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU; anything else raises.
    There is no fallback from NCCL to gloo on the card."""
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group needs a CUDA device; "
                               "pass device='cpu' for gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL backend")
        return "nccl"
    if device.type == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("this torch has no gloo backend")
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def _default_device() -> torch.device:
    """The device of this rank: the current CUDA device under NCCL, the
    CPU under gloo, and without a process group the card if there is one."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device=None) -> bool:
    """Join a multi-process run: `torch.distributed.init_process_group`
    at `coordinator_address` ("host:port" or "tcp://host:port") with
    `num_processes` ranks, this one `process_id`.  A single process without
    an address is a no-op that returns False.

    The backend follows `device` (default: the card if there is one, else
    the CPU): NCCL on CUDA, with this rank's device made current
    (`process_id` modulo the visible cards), and gloo on the CPU; a
    collective times out after PG_TIMEOUT_S.  Returns True once the group
    is up."""
    if num_processes in (None, 0, 1) and coordinator_address is None:
        return False  # single process: nothing to initialize
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize_distributed needs the coordinator "
                         "address, the number of processes and the "
                         "process id")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    backend = _backend_for(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else process_id % torch.cuda.device_count())
    address = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=address,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return True


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named axes over the ranks of the process group.  `shape` maps each
    axis to its size, as JAX's `Mesh.shape`; `device` is this rank's
    device; `device_mesh` is torch's `DeviceMesh` of the group, or None
    for a world of one without a process group."""

    axis_names: Tuple[str, ...]
    shape: dict
    device: torch.device
    device_mesh: object = None

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (0 on an absent axis)."""
        if axis not in self.shape or self.device_mesh is None:
            return 0
        return self.device_mesh.get_coordinate()[
            self.axis_names.index(axis)]

    def group(self, axes: Sequence[str] = AXES):
        """The process group spanning `axes` (one axis name or several):
        one axis's group, or the whole world for every axis of size > 1
        together.  None without a process group."""
        if self.device_mesh is None:
            return None
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in axes if a in self.shape)
        wide = [a for a in self.axis_names if self.shape[a] > 1]
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if set(wide) <= set(axes):
            return dist.group.WORLD
        if len(wide) == 1 and wide[0] in axes:
            return self.device_mesh.get_group(wide[0])
        raise ValueError(f"no process group spans {axes} of mesh "
                         f"{self.shape}")


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """Where the leading dims of an array lie on `mesh`: `spec[i]` is the
    axis that dim i is split over, or None (replicated).  `()` is fully
    replicated, `("data",)` the batch, `("data", "spatial")` the batch and
    the D slab (JAX's `NamedSharding(mesh, P(...))`)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


def process_batch_bounds(global_batch: int, num_hosts: Optional[int] = None,
                         host_id: Optional[int] = None, *,
                         mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """[start, stop) of the global batch this rank must feed when the batch
    dim is split over the data axis.  A rank's coordinate on ``data``
    plays the JAX host's part: the defaults come from `mesh`, or from the
    process group's world size and rank without one.  Requires
    `global_batch` divisible by `num_hosts`."""
    if num_hosts is None:
        num_hosts = mesh.axis_size("data") if mesh is not None else _world()[0]
    if host_id is None:
        host_id = mesh.index("data") if mesh is not None else _world()[1]
    if global_batch % num_hosts:
        raise ValueError(
            f"global batch {global_batch} not divisible by {num_hosts} "
            f"hosts: every host must contribute an equal shard")
    per = global_batch // num_hosts
    return host_id * per, (host_id + 1) * per


def host_local_batch(global_array, mesh: Mesh,
                     sharding: Optional[Sharding] = None, *,
                     process_rows: bool = False) -> torch.Tensor:
    """This rank's shard of `global_array` as a tensor on the rank's device:
    its rows (`process_batch_bounds`) and, under a sharding with
    ``spatial``, its D slab.  `process_rows=True` says the array holds
    this rank's rows already (each rank loads only its own), so only the
    slab is taken.  `sharding` defaults to the data sharding."""
    from ..parallel.sharding import local_shard

    if sharding is None:
        sharding = data_sharding(mesh)
    x = global_array
    if not isinstance(x, torch.Tensor):
        import numpy as np
        x = torch.as_tensor(np.asarray(x))
    spec = tuple(sharding.spec)
    if process_rows and spec and spec[0] == "data":
        spec = (None,) + spec[1:]
    return local_shard(x, Sharding(mesh, spec)).to(mesh.device)


def wait_for_backend(max_wait_s: float = 1200, probe_timeout_s: float = 150,
                     retry_sleep_s: float = 60, _probe_cmd=None) -> bool:
    """Block until the card answers, retrying through transient outages.

    The probe (`torch.cuda.is_available()` by default) runs in a
    subprocess, so that a failed or hung CUDA initialisation never
    poisons the caller's process.  A torch built without CUDA has no
    backend to wait for and returns at once.  Returns True if the backend
    came up, False after `max_wait_s` (callers may then proceed and
    surface the real in-process error)."""
    import subprocess
    import sys
    import time

    if _probe_cmd is None:
        if torch.version.cuda is None:
            return True
        _probe_cmd = [sys.executable, "-c",
                      "import sys, torch; "
                      "sys.exit(0 if torch.cuda.is_available() else 1)"]
    deadline = time.monotonic() + max_wait_s
    attempt = 0
    while True:
        attempt += 1
        try:
            proc = subprocess.run(_probe_cmd, capture_output=True,
                                  timeout=probe_timeout_s)
            if proc.returncode == 0:
                if attempt > 1:
                    print(f"# backend up after {attempt} probes", flush=True)
                return True
        except subprocess.TimeoutExpired:
            pass
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            print("# backend never came up within "
                  f"{max_wait_s:.0f}s; proceeding anyway", flush=True)
            return False
        print(f"# backend unavailable (probe {attempt}); retrying "
              f"({remaining:.0f}s left)", flush=True)
        time.sleep(min(retry_sleep_s, max(0.05, remaining)))


def create_mesh(axis_names: Sequence[str] = ("data",),
                axis_sizes: Optional[Sequence[int]] = None,
                devices=None, multi_host: bool = False) -> Mesh:
    """Lay `axis_names` out over the ranks of the process group.

    If `axis_sizes` is None, every rank goes to the first axis and the
    rest get size 1.  Without a process group the world is one rank, a
    valid mesh whose collectives are the identity.  `devices` is this
    rank's device (default: the group's, `_default_device`).
    `multi_host=True` asserts a multi-process runtime
    (`initialize_distributed`)."""
    world, _ = _world()
    if multi_host and world == 1:
        raise RuntimeError(
            "create_mesh(multi_host=True) requires a multi-process runtime: "
            "call core.mesh.initialize_distributed(...) on every host first")
    names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(names) - 1)
    sizes = tuple(int(s) for s in axis_sizes)
    if len(sizes) != len(names):
        raise ValueError(f"{len(names)} axis names for {len(sizes)} sizes")
    if math.prod(sizes) != world:
        raise ValueError(f"axis_sizes {sizes} do not multiply to #devices "
                         f"{world}")
    device = torch.device(devices) if devices is not None \
        else _default_device()
    device_mesh = None
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(device.type, sizes,
                                       mesh_dim_names=names)
    return Mesh(names, dict(zip(names, sizes)), device, device_mesh)


def data_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Batch-dim sharding: first array dim over the data axis."""
    return Sharding(mesh, (axis,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
