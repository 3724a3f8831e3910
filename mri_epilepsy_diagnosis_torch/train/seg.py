"""Segmentation training: dice-loss steps and the epoch loop
(counterpart of the JAX package's `train/seg.py`).

Capability parity with `segmentation/routine.py:261-361`: an initial
VALIDATE epoch, then TRAIN/VALIDATE per epoch; softmax -> soft dice loss
(mean over batch and classes); ReduceLROnPlateau stepped on the mean
validation loss; periodic checkpoints to
`{weights_dir}/{stem}_epoch_{i}.ckpt`; optional per-batch experiment
logging.  Labels are binarized on the device (LIST_FCD + cortical >= 1000,
`transforms.binarize_segmentation`).

`seg_train_step` / `seg_eval_step` (and `run_epoch`,
`train_segmentation` with `packed=False`) train the fine UNet3D or any
model of the segmentation zoo (`models.BraTSUnet`, `Modified3DUNet`,
`ResidualUNet3D`, with or without Bayesian convs), with the random
streams of `step_generators`.

`packed=True` trains through the packed layout of `models/unet_packed.py`
(every 3x3x3 conv and every conv input gradient but the stem's on kernel
B1) and validates through the served packed forward (B1 with B2 fused);
`input_dtype=torch.bfloat16` trains in mixed precision: bf16 activations
and conv operands, float32 master weights, AdamW state and BatchNorm
statistics.

`manager` (a `train.resilience.CheckpointManager`) switches the loop to
its elastic mode; `validate_dsc_asd` and `sweep_checkpoints` score
checkpoints by per-subject DSC, average surface distance and IoU.

`sharding` (a `core.mesh.Sharding`: `parallel.volume_sharding(mesh)` or
`core.data_sharding(mesh)`) runs the loop on a process mesh: each rank
stages its shard of every global batch, the steps run under
`parallel.use_mesh`, so BatchNorm statistics and dice sums are the global
batch's and the gradients are summed over the ranks; every rank logs the
same global loss and keeps the same state; rank 0 writes the checkpoints.

`dashboard` (an `obs.TrainingDashboard`, or anything with its `update`)
is updated once per completed epoch with its mean train and validation
losses, as in the JAX package; under a mesh only rank 0 updates it, as
only rank 0 writes checkpoints.
"""
from __future__ import annotations

import contextlib
import copy
import enum
import functools
import glob
import time
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.mesh import Sharding
from ..data.pipeline import DevicePrefetcher
from ..metrics import (compute_average_surface_distance,
                       compute_dice_coefficient, compute_surface_distances,
                       get_dice_loss, get_iou_score)
from ..models.unet import UNet3D
from ..parallel import sharding as _S
from ..models.unet_packed import (fold_bn_inference, packed_dice_loss,
                                  packed_unet_apply_v2, packed_unet_mask_v2,
                                  packed_unet_train_apply)
from ..transforms.labels import binarize_segmentation
from .checkpoint import (load_checkpoint, load_scheduler_state,
                         save_checkpoint)
from .optim import ReduceLROnPlateau, torch_adamw
from .resilience import _PreemptionGuard
from .state import TrainState, create_train_state


class Action(enum.Enum):
    TRAIN = "Training"
    VALIDATE = "Validation"


def _dice_loss_from_logits(logits, targets):
    """softmax over the channel (last) axis -> soft dice -> mean."""
    probs = torch.softmax(logits, dim=-1)
    onehot = torch.cat([1.0 - targets, targets], dim=-1)
    return _S.global_mean(get_dice_loss(probs, onehot,
                                        spatial_dimensions=(1, 2, 3)))


def _apply_gradients(state: TrainState, loss: torch.Tensor) -> TrainState:
    """Backward, then one optimizer step.  A trainable parameter that the
    loss does not reach (BraTSUnet's `conv2` / `bn2`) gets a zero
    gradient first: JAX's gradient of it is zero, so optax's AdamW still
    decays it and counts the step, where torch's skips a parameter whose
    `.grad` is None.  Under a mesh the loss is the global one on every
    rank: each backpropagates its share and the gradients are summed over
    the ranks before the step (`parallel.sharding.backward`,
    `sync_gradients`)."""
    state.optimizer.zero_grad(set_to_none=True)
    _S.backward(loss)
    params = [p for group in state.optimizer.param_groups
              for p in group["params"]]
    for p in params:
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)
    _S.sync_gradients(params)
    state.optimizer.step()
    state.step += 1
    return state


def step_generators(step: int, device) -> dict:
    """The random streams of one train step: `generator` (Dropout masks)
    and `sample_generator` (Bayesian-layer noise), each a generator on
    `device` seeded from (its stream index, `step`), as JAX keys its
    "dropout" and "sample" streams from (stream index, `state.step`)."""
    # 2 * step + stream: the host generator's Mersenne Twister keeps only
    # the low 32 bits of a seed
    return {name: torch.Generator(device=device).manual_seed(
                2 * int(step) + i)
            for i, name in enumerate(("generator", "sample_generator"))}


def seg_loss(model, inputs, targets, *, generator=None,
             sample_generator=None) -> torch.Tensor:
    """Dice loss of a segmentation model in train mode: the fine
    `UNet3D` (`F.conv3d`) or a zoo model (`BraTSUnet`, `Modified3DUNet`,
    `ResidualUNet3D`); the forward updates the model's BatchNorm running
    statistics.  The generators go to the model's forward (Dropout's
    masks, the Bayesian layers' noise); models without randomness ignore
    them."""
    model.train()
    logits = model(inputs, generator=generator,
                   sample_generator=sample_generator)
    return _dice_loss_from_logits(logits, targets)


def seg_train_step(state: TrainState, inputs, raw_labels):
    """inputs (N, D, H, W, 1) float; raw_labels (N, D, H, W, 1) FreeSurfer
    ids or already-binary masks (binarize_segmentation keeps existing 1s,
    like the reference's prepare_batch).  Any model of `seg_loss`, with
    its random streams from `step_generators(state.step)` on the model's
    device.  Returns (state, loss), the loss a detached scalar tensor on
    the device."""
    loss = seg_loss(state.model, inputs, binarize_segmentation(raw_labels),
                    **step_generators(state.step, state.device))
    return _apply_gradients(state, loss), loss.detach()


def _num_encoding_blocks(model: UNet3D) -> int:
    return len(model.encoder.encoding_blocks) + 1


def packed_seg_loss(model: UNet3D, inputs, targets, remat: bool = False,
                    dec_up: str = "explicit"):
    """(dice loss, new BatchNorm running statistics) of the packed
    train-mode forward on the model's parameters; differentiable in them.
    The running statistics are new tensors, not yet stored."""
    logits_p, stats = packed_unet_train_apply(
        model.state_dict(keep_vars=True), inputs,
        num_encoding_blocks=_num_encoding_blocks(model), remat=remat,
        dec_up=dec_up)
    return packed_dice_loss(logits_p, targets), stats


@torch.no_grad()
def _store_running_stats(model: UNet3D, stats) -> None:
    """Write the running statistics of a packed train step into the
    model's BatchNorm buffers, and count the batch as `nn.BatchNorm3d`
    does (`num_batches_tracked`)."""
    buffers = dict(model.named_buffers())
    for key, value in stats.items():
        buffers[key].copy_(value)
        if key.endswith("running_mean"):
            buffers[key[:-len("running_mean")] + "num_batches_tracked"].add_(1)


def packed_seg_train_step(state: TrainState, inputs, raw_labels,
                          remat: bool = False, dec_up: str = "explicit"):
    """`seg_train_step` in the packed (space-to-depth) execution layout
    (`models/unet_packed.py`): the same numerics (fine-exact BatchNorm
    batch statistics, dice over the sub-position-folded voxel set), with
    the convs on kernel B1 forward and backward.  UNet3D (out_classes 2)
    only.  `remat=True` recomputes each two-conv block in the backward;
    `dec_up` picks the decoder's up branch ("explicit", the default,
    "composed" or "hybrid": `packed_unet_train_apply`)."""
    loss, stats = packed_seg_loss(state.model, inputs,
                                  binarize_segmentation(raw_labels), remat,
                                  dec_up)
    state = _apply_gradients(state, loss)
    _store_running_stats(state.model, stats)
    return state, loss.detach()


@torch.no_grad()
def seg_eval_step(state: TrainState, inputs, raw_labels):
    """Dice loss of the model in eval mode (running statistics, no
    Dropout).  Bayesian layers sample in eval mode too, from a fresh
    generator seeded with 0 (JAX's `key(0)`), so two evaluations agree."""
    state.model.eval()
    gen = torch.Generator(device=state.device).manual_seed(0)
    logits = state.model(inputs, sample_generator=gen)
    return _dice_loss_from_logits(logits, binarize_segmentation(raw_labels))


@torch.no_grad()
def packed_seg_eval_step(state: TrainState, inputs, raw_labels):
    """Validation through the served packed forward with BatchNorm left
    unfolded (B1 with its B2 epilogue at the aligned->shifted convs)."""
    logits = packed_unet_apply_v2(
        state.model.state_dict(), inputs,
        num_encoding_blocks=_num_encoding_blocks(state.model))
    return _dice_loss_from_logits(logits, binarize_segmentation(raw_labels))


def _device_batches(loader, prefetch: int, device: torch.device,
                    sharding=None):
    """(inputs, labels) of each batch of `loader` as tensors on `device`,
    staged `prefetch` batches ahead (`DevicePrefetcher`), or copied one at
    a time with `prefetch=0`; with `sharding`, this rank's shard of each
    global batch."""
    pairs = (tuple(batch[:2]) for batch in loader)
    if prefetch <= 0:
        for batch in pairs:
            if sharding is not None:
                yield tuple(_S.shard_batch(batch, sharding.mesh, sharding))
            else:
                yield tuple(torch.as_tensor(b).to(device) for b in batch)
        return
    staged = DevicePrefetcher(pairs, size=prefetch, device=device,
                              sharding=sharding)
    while (batch := staged.get()) is not None:
        yield batch


def _mesh_of(sharding):
    """The mesh of a `sharding` argument (None for None); anything but a
    `core.mesh.Sharding` raises."""
    if sharding is None:
        return None
    if not isinstance(sharding, Sharding):
        raise TypeError("`sharding` must be a core.mesh.Sharding (for "
                        "example parallel.volume_sharding(mesh)), got "
                        f"{type(sharding).__name__}")
    return sharding.mesh


def run_epoch(epoch_idx: int, action: Action, loader, state: TrainState,
              scheduler=None, experiment=None, prefetch: int = 2,
              sharding=None, packed=False,
              input_dtype: Optional[torch.dtype] = None):
    """One pass; returns (state, np.array of batch losses).

    Batches are staged on the model's device `prefetch` batches ahead.
    `packed=True` trains through the packed layout; `packed="remat"` also
    recomputes each two-conv block in the backward.  `input_dtype=
    torch.bfloat16` trains in mixed precision (see the module docstring).
    `scheduler` is stepped by the epoch loop, not here.  `sharding` runs
    the epoch on its mesh (see the module docstring); the losses are the
    global batches'."""
    del epoch_idx, scheduler  # the signature of the JAX package's loop
    train_step = (functools.partial(packed_seg_train_step,
                                    remat=(packed == "remat"))
                  if packed else seg_train_step)
    eval_step = packed_seg_eval_step if packed else seg_eval_step
    is_training = action == Action.TRAIN
    epoch_losses = []
    mesh = _mesh_of(sharding)
    for inputs, labels in _device_batches(loader, prefetch, state.device,
                                          sharding):
        if input_dtype is not None:
            inputs = inputs.to(input_dtype)
        with _S.use_mesh(mesh):
            if is_training:
                state, loss = train_step(state, inputs, labels)
            else:
                loss = eval_step(state, inputs, labels)
        loss_val = float(loss)
        epoch_losses.append(loss_val)
        if experiment:
            experiment.log_metric(
                "train_dice_loss" if is_training else "validate_dice_loss",
                loss_val)
    return state, np.array(epoch_losses)


def train_segmentation(num_epochs: int, training_loader, validation_loader,
                       state: TrainState, scheduler, weights_stem: str,
                       save_epoch: int = 1, experiment=None,
                       verbose: bool = True, weights_dir: str = "weights",
                       sharding=None, dashboard=None, packed=False,
                       manager=None, max_failures: int = 3,
                       input_dtype=None):
    """The reference's training routine; returns (state, per-epoch mean
    train losses, per-epoch mean validation losses).  `packed` and
    `input_dtype` as in `run_epoch`.  `manager` (a
    `train.resilience.CheckpointManager`) switches on elastic mode:
    auto-resume from the newest checkpoint (the scheduler's state
    included), atomic rolling per-epoch checkpoints (in place of the
    `save_epoch` cadence), rollback on a non-finite train or validation
    epoch (an error past `max_failures` in a row), and a checkpointed stop
    at the epoch boundary on SIGTERM/SIGINT.  `sharding` runs the loop on
    its mesh (see the module docstring): rank 0 writes the checkpoints
    while the others wait, every rank resumes from them, and rollback and
    the preemption stop are decided by all ranks together.  `dashboard`
    gets `update(train_loss=, val_loss=)` once per completed epoch (rank 0
    alone under a mesh)."""
    state, tr, va, _ = _train_loop(
        num_epochs, training_loader, validation_loader, state, scheduler,
        weights_stem, save_epoch, experiment, verbose, weights_dir, sharding,
        dashboard, packed, manager, max_failures, input_dtype)
    return state, tr, va


def _train_loop(num_epochs, training_loader, validation_loader, state,
                scheduler, weights_stem, save_epoch, experiment, verbose,
                weights_dir, sharding, dashboard, packed, manager,
                max_failures, input_dtype=None):
    """The one epoch loop behind `train_segmentation` and
    `train_segmentation_resilient`; returns (state, train_losses,
    val_losses, last_completed_epoch)."""
    start_time = time.time()
    epoch_train_loss, epoch_val_loss = [], []
    start_epoch, failures = 0, 0
    kw = dict(packed=packed, input_dtype=input_dtype, sharding=sharding)
    mesh = _mesh_of(sharding)

    def _restore_with_scheduler():
        st, ep = manager.restore_latest(state)
        if scheduler is not None and ep:
            sd = manager.load_extra(ep).get("scheduler")
            if sd:
                load_scheduler_state(scheduler, sd)
        return st, ep

    def _save(st, epoch):
        # one writer; the other ranks wait until the file is in place
        if manager is not None:
            if _S.is_writer(mesh):
                extra = ({} if scheduler is None
                         else {"scheduler": scheduler.state_dict()})
                manager.save(st, epoch, **extra)
            _S.barrier(mesh)
        elif epoch > 0 and epoch % save_epoch == 0:
            if _S.is_writer(mesh):
                save_checkpoint(
                    f"{weights_dir}/{weights_stem}_epoch_{epoch}.ckpt", st)
            _S.barrier(mesh)

    if manager is not None:
        state, start_epoch = _restore_with_scheduler()
        if verbose and start_epoch:
            print(f"resumed from epoch {start_epoch}")

    guard_cm = (_PreemptionGuard() if manager is not None
                else contextlib.nullcontext())
    with guard_cm as guard:
        def stop():
            # every rank stops at the same epoch boundary, or none does
            return manager is not None and _S.any_rank(guard.stop_requested,
                                                       mesh)

        if start_epoch == 0:  # the reference's initial VALIDATE epoch
            state, _ = run_epoch(0, Action.VALIDATE, validation_loader, state,
                                 scheduler, experiment, **kw)
            _save(state, 0)

        epoch_idx = start_epoch
        stopping = False
        while epoch_idx < num_epochs and not (stopping := stop()):
            epoch_idx += 1
            state, tr = run_epoch(epoch_idx, Action.TRAIN, training_loader,
                                  state, scheduler, experiment, **kw)
            state, va = run_epoch(epoch_idx, Action.VALIDATE,
                                  validation_loader, state, scheduler,
                                  experiment, **kw)
            if manager is not None and not _S.all_agree(
                    bool(np.all(np.isfinite(tr)) and np.all(np.isfinite(va))),
                    mesh):
                failures += 1
                if failures > max_failures:
                    raise RuntimeError(f"{failures} non-finite epochs; "
                                       f"aborting at epoch {epoch_idx}")
                if verbose:
                    print(f"epoch {epoch_idx}: non-finite loss, rolling "
                          f"back to the last checkpoint "
                          f"({failures}/{max_failures})")
                if manager.latest_epoch() is None:
                    # never "roll back" to the just-poisoned in-memory state
                    raise RuntimeError(
                        f"epoch {epoch_idx} produced a non-finite loss and "
                        "no checkpoint exists to roll back to (checkpoints "
                        "pruned externally?)")
                state, epoch_idx = _restore_with_scheduler()
                continue
            failures = 0
            epoch_train_loss.append(float(np.mean(tr)))
            epoch_val_loss.append(float(np.mean(va)))
            if dashboard is not None and _S.is_writer(mesh):
                dashboard.update(train_loss=epoch_train_loss[-1],
                                 val_loss=epoch_val_loss[-1])
            if verbose:
                print(f"Epoch {epoch_idx} of {num_epochs} took "
                      f"{time.time() - start_time:.3f}s")
                print(f"  training loss (in-iteration): \t{tr[-1]:.6f}")
                print(f"  validation loss: \t\t\t{va[-1]:.6f}")
            if isinstance(scheduler, ReduceLROnPlateau):
                scheduler.step(epoch_val_loss[-1])
            elif scheduler is not None:
                scheduler.step()
            if experiment:
                experiment.log_epoch_end(epoch_idx)
            _save(state, epoch_idx)
        if manager is not None and stopping and verbose:
            print(f"preemption requested: checkpointed at epoch "
                  f"{epoch_idx}, exiting cleanly")
    return state, epoch_train_loss, epoch_val_loss, epoch_idx


def sweep_checkpoints(weights_dir: str, state: TrainState, loader,
                      pattern: str = "*.ckpt"):
    """Evaluate every checkpoint in a directory, the port's and the JAX
    package's alike (the reference's sweep in
    `pretraining_3d_unet.ipynb` cell 17, printing DICE/IoU per epoch),
    through `validate_dsc_asd` on a copy of `state`, which stays as it
    was.  Returns {path: (mean_dsc, mean_iou)} sorted by path; a
    checkpoint that fails to load or evaluate is reported and skipped, as
    in the reference."""
    work = copy.deepcopy(state)
    results = {}
    for path in sorted(glob.glob(f"{weights_dir}/{pattern}")):
        try:
            st = load_checkpoint(path, work)
            dsc, _, _, iou = validate_dsc_asd(st, loader)
            results[path] = (float(np.nanmean(dsc)), float(np.mean(iou)))
            print(f"{path}: DICE {results[path][0]:.4f} "
                  f"IoU {results[path][1]:.4f}")
        except Exception as e:  # the reference's soft-fail sweep
            print(f"{path}: skipped ({type(e).__name__}: {e})")
    return results


def mask_forward(state: TrainState, packed: bool = False):
    """The segmenter's eval forward as `fn(inputs) -> uint8 masks (N, D, H,
    W)` on the model's device, as `validate_dsc_asd` runs it.
    `packed=True` folds the BatchNorms into the convs once
    (`fold_bn_inference`) and runs the served packed forward:
    `packed_unet_mask_v2` for 2 classes (B1 with B2 fused, the mask taken
    in packed space), else the argmax of `packed_unet_apply_v2`; otherwise
    the fine `UNet3D` in eval mode."""
    model = state.model
    if packed:
        params = fold_bn_inference(model.state_dict())
        nb = _num_encoding_blocks(model)
        if params["classifier.conv_layer.weight"].shape[0] == 2:
            def logits_or_mask(x):
                return packed_unet_mask_v2(params, x, nb)
        else:
            def logits_or_mask(x):
                return packed_unet_apply_v2(params, x, nb).argmax(-1)
    else:
        model.eval()

        def logits_or_mask(x):
            return model(x).argmax(-1)

    @torch.no_grad()
    def fn(inputs):
        return logits_or_mask(inputs).to(torch.uint8)

    return fn


def validate_dsc_asd(state: TrainState, loader, packed: bool = False):
    """Per-subject DSC, average surface distance and IoU over a loader of
    (inputs, labels) batches (reference `segmentation/routine.py:217-237`).
    The forward runs batched on the model's device (`mask_forward`:
    `packed=True` is the served packed forward with BatchNorm folded, the
    same masks as the fine one up to ties); the labels are binarized on
    the device; the surface metrics run on the host (native EDT).
    Returns lists (dsc, asd_mean, asd_std, iou), one entry per subject;
    asd_mean and asd_std are, under the reference's names, the two
    directed averages that `compute_average_surface_distance` returns
    (ground truth to prediction, prediction to ground truth), in mm at
    1 mm spacing."""
    fwd = mask_forward(state, packed)
    device = state.device
    dsc, asd_mean, asd_std, iou = [], [], [], []
    for batch in loader:
        inputs = torch.as_tensor(batch[0]).to(device)
        targets = binarize_segmentation(torch.as_tensor(batch[1]).to(device))
        targets = targets[..., 0].to(torch.uint8).cpu().numpy()
        preds = fwd(inputs).cpu().numpy()
        for gt, pred in zip(targets, preds):
            sd = compute_surface_distances(gt, pred, spacing_mm=(1, 1, 1))
            m, s = compute_average_surface_distance(sd)
            dsc.append(compute_dice_coefficient(gt, pred))
            asd_mean.append(m)
            asd_std.append(s)
            iou.append(get_iou_score(pred, gt))
    return dsc, asd_mean, asd_std, iou


def get_model_and_optimizer(sample_input=None, num_encoding_blocks: int = 3,
                            out_channels_first_layer: int = 16,
                            patience: int = 3, seed: int = 0, *,
                            device=None):
    """Seeded model/optimizer/scheduler factory
    (`segmentation/routine.py:338-361` semantics), with the JAX package's
    parameters in its order: the UNet3D is built on the CPU from torch's
    generator seeded with `seed` (the global generator is left as it was),
    then moved to `device`; AdamW defaults; plateau scheduler (factor 0.1,
    patience 3, threshold 0.01).  `sample_input` only shapes the JAX
    package's init and is ignored.  Returns (model, state, scheduler)."""
    del sample_input
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = UNet3D(in_channels=1, out_classes=2,
                       num_encoding_blocks=num_encoding_blocks,
                       out_channels_first_layer=out_channels_first_layer,
                       device="cpu")
    model = model.to(resolve_device(device))
    state = create_train_state(model, torch_adamw())
    scheduler = ReduceLROnPlateau(state.optimizer, mode="min", factor=0.1,
                                  patience=patience, threshold=0.01)
    return model, state, scheduler
