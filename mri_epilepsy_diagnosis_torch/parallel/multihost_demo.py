"""Real multi-process execution of the training step (counterpart of the
JAX package's `parallel/multihost_demo.py`).

The worker a real multi-process run executes: each process is one rank
of a `torch.distributed` group (gloo on the CPU, NCCL on the card), lays
the global ('data', 'spatial') mesh out over the ranks, feeds only its
`process_batch_bounds` rows of a deterministic global batch through
`host_local_batch` (which also takes its D slab), runs ONE
`seg_train_step` (or, with `--packed`, `packed_seg_train_step`) on the
mesh, and writes its loss and a parameter checksum as JSON, and its
parameters and gradients with `torch.save` beside it, for a parent to
compare against the unsharded step:

    python -m mri_epilepsy_diagnosis_torch.parallel.multihost_demo \\
        --init tcp://127.0.0.1:<port> --world-size 2 --rank <i> \\
        --mesh 2,1 --weights unet.pt --out /tmp/rank<i>.json

`--weights` is a `torch.save`d UNet3D state dict (2 encoding blocks, 4
first-layer channels; `--blocks` and `--ocfl` change them); without it
the model is built from torch's generator seeded with 0.
"""
from __future__ import annotations

import argparse
import json

# the deterministic toy problem every rank and the unsharded reference
# solve (fixed sizes, so every run computes the same function)
GLOBAL_BATCH = 4
SIZE = 16


def make_data():
    """The global batch: (x, binary labels), float32 numpy, from a seed."""
    import numpy as np

    r = np.random.default_rng(0)
    x = r.normal(size=(GLOBAL_BATCH, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    y = (r.random((GLOBAL_BATCH, SIZE, SIZE, SIZE, 1)) > 0.7).astype(
        np.float32)
    return x, y


def make_state(weights=None, blocks: int = 2, ocfl: int = 4,
               device="cpu"):
    """UNet3D (`blocks`, `ocfl`) with `weights` loaded, and AdamW(1e-3)."""
    import torch

    from ..models.unet import UNet3D
    from ..train.optim import torch_adamw
    from ..train.state import create_train_state

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = UNet3D(in_channels=1, out_classes=2,
                       num_encoding_blocks=blocks,
                       out_channels_first_layer=ocfl, device="cpu")
    if weights is not None:
        model.load_state_dict(torch.load(weights, map_location="cpu"))
    return create_train_state(model.to(device), torch_adamw(1e-3))


def param_checksum(model) -> float:
    return float(sum(p.detach().double().abs().sum()
                     for p in model.parameters()))


def run_worker(init: str, world_size: int, rank: int, mesh_sizes,
               weights=None, packed: bool = False, blocks: int = 2,
               ocfl: int = 4, device="cpu") -> dict:
    import torch
    import torch.distributed as dist

    from ..core.mesh import (create_mesh, host_local_batch,
                             initialize_distributed, process_batch_bounds)
    from ..parallel.sharding import replicate, use_mesh, volume_sharding
    from ..train.seg import packed_seg_train_step, seg_train_step

    assert initialize_distributed(init, world_size, rank, device=device)
    try:
        mesh = create_mesh(("data", "spatial"), tuple(mesh_sizes),
                           multi_host=world_size > 1)
        x, y = make_data()
        lo, hi = process_batch_bounds(GLOBAL_BATCH, mesh=mesh)
        vs = volume_sharding(mesh)
        xl = host_local_batch(x[lo:hi], mesh, vs, process_rows=True)
        yl = host_local_batch(y[lo:hi], mesh, vs, process_rows=True)
        # every rank builds the same seeded state; rank 0's is broadcast
        state = replicate(make_state(weights, blocks, ocfl, mesh.device),
                          mesh)
        step = packed_seg_train_step if packed else seg_train_step
        with use_mesh(mesh):
            state, loss = step(state, xl, yl)
        model = state.model
        result = {
            "rank": dist.get_rank(),
            "world_size": dist.get_world_size(),
            "backend": dist.get_backend(),
            "mesh": dict(mesh.shape),
            "coordinate": [mesh.index(a) for a in mesh.axis_names],
            "batch_bounds": [lo, hi],
            "local_shape": list(xl.shape),
            "loss": float(loss),
            "param_checksum": param_checksum(model),
        }
        tensors = {
            "state": {k: v.detach().cpu()
                      for k, v in model.state_dict().items()},
            "grads": {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()},
        }
        dist.barrier()
        return result, tensors
    finally:
        dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--init", required=True,
                   help="tcp://host:port of the process group")
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--mesh", default=None,
                   help="data,spatial sizes (default: world,1)")
    p.add_argument("--weights", default=None)
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--ocfl", type=int, default=4)
    p.add_argument("--packed", action="store_true")
    p.add_argument("--device", default="cpu")
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    torch.set_num_threads(args.threads)
    sizes = ((args.world_size, 1) if args.mesh is None
             else tuple(int(s) for s in args.mesh.split(",")))
    result, tensors = run_worker(args.init, args.world_size, args.rank,
                                 sizes, args.weights, args.packed,
                                 args.blocks, args.ocfl, args.device)
    torch.save(tensors, args.out + ".pt")
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(f"multihost worker {args.rank} ok: {result}", flush=True)


if __name__ == "__main__":
    main()
