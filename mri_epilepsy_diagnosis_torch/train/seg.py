"""Segmentation training: dice-loss steps and the epoch loop
(counterpart of the JAX package's `train/seg.py`).

Capability parity with `segmentation/routine.py:261-361`: an initial
VALIDATE epoch, then TRAIN/VALIDATE per epoch; softmax -> soft dice loss
(mean over batch and classes); ReduceLROnPlateau stepped on the mean
validation loss; periodic checkpoints to
`{weights_dir}/{stem}_epoch_{i}.ckpt`; optional per-batch experiment
logging.  Labels are binarized on the device (LIST_FCD + cortical >= 1000,
`transforms.binarize_segmentation`).

`packed=True` trains through the packed layout of `models/unet_packed.py`
(every 3x3x3 conv and every conv input gradient but the stem's on kernel
B1) and validates through the served packed forward (B1 with B2 fused);
`input_dtype=torch.bfloat16` trains in mixed precision: bf16 activations
and conv operands, float32 master weights, AdamW state and BatchNorm
statistics.

Not here yet (ROADMAP A6): the surface-distance validation
(`validate_dsc_asd`, `sweep_checkpoints`, with A7), gradient accumulation
(`train/accum.py`) and the resilient loop (`train/resilience.py`: the
`manager` argument); `sharding` and `dashboard` come with A13 and A14.
"""
from __future__ import annotations

import enum
import functools
import time
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.pipeline import DevicePrefetcher
from ..metrics.dice import get_dice_loss
from ..models.unet import UNet3D
from ..models.unet_packed import (packed_dice_loss, packed_unet_apply_v2,
                                  packed_unet_train_apply)
from ..transforms.labels import binarize_segmentation
from .checkpoint import save_checkpoint
from .optim import ReduceLROnPlateau, torch_adamw
from .state import TrainState, create_train_state


class Action(enum.Enum):
    TRAIN = "Training"
    VALIDATE = "Validation"


def _dice_loss_from_logits(logits, targets):
    """softmax over the channel (last) axis -> soft dice -> mean."""
    probs = torch.softmax(logits, dim=-1)
    onehot = torch.cat([1.0 - targets, targets], dim=-1)
    return get_dice_loss(probs, onehot, spatial_dimensions=(1, 2, 3)).mean()


def _apply_gradients(state: TrainState, loss: torch.Tensor) -> TrainState:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state


def seg_loss(model: UNet3D, inputs, targets) -> torch.Tensor:
    """Dice loss of the fine `UNet3D` in train mode (`F.conv3d`); the
    forward updates the model's BatchNorm running statistics."""
    model.train()
    return _dice_loss_from_logits(model(inputs), targets)


def seg_train_step(state: TrainState, inputs, raw_labels):
    """inputs (N, D, H, W, 1) float; raw_labels (N, D, H, W, 1) FreeSurfer
    ids or already-binary masks (binarize_segmentation keeps existing 1s,
    like the reference's prepare_batch).  Returns (state, loss), the loss
    a detached scalar tensor on the device."""
    loss = seg_loss(state.model, inputs, binarize_segmentation(raw_labels))
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
    `dec_up` must be "explicit" (the others need the composed decoder,
    ROADMAP A3b)."""
    loss, stats = packed_seg_loss(state.model, inputs,
                                  binarize_segmentation(raw_labels), remat,
                                  dec_up)
    state = _apply_gradients(state, loss)
    _store_running_stats(state.model, stats)
    return state, loss.detach()


@torch.no_grad()
def seg_eval_step(state: TrainState, inputs, raw_labels):
    state.model.eval()
    return _dice_loss_from_logits(state.model(inputs),
                                  binarize_segmentation(raw_labels))


@torch.no_grad()
def packed_seg_eval_step(state: TrainState, inputs, raw_labels):
    """Validation through the served packed forward with BatchNorm left
    unfolded (B1 with its B2 epilogue at the aligned->shifted convs)."""
    logits = packed_unet_apply_v2(
        state.model.state_dict(), inputs,
        num_encoding_blocks=_num_encoding_blocks(state.model))
    return _dice_loss_from_logits(logits, binarize_segmentation(raw_labels))


def _device_batches(loader, prefetch: int, device: torch.device):
    """(inputs, labels) of each batch of `loader` as tensors on `device`,
    staged `prefetch` batches ahead (`DevicePrefetcher`), or copied one at
    a time with `prefetch=0`."""
    pairs = (tuple(batch[:2]) for batch in loader)
    if prefetch <= 0:
        for batch in pairs:
            yield tuple(torch.as_tensor(b).to(device) for b in batch)
        return
    staged = DevicePrefetcher(pairs, size=prefetch, device=device)
    while (batch := staged.get()) is not None:
        yield batch


def run_epoch(epoch_idx: int, action: Action, loader, state: TrainState,
              scheduler=None, experiment=None, prefetch: int = 2,
              packed=False, input_dtype: Optional[torch.dtype] = None):
    """One pass; returns (state, np.array of batch losses).

    Batches are staged on the model's device `prefetch` batches ahead.
    `packed=True` trains through the packed layout; `packed="remat"` also
    recomputes each two-conv block in the backward.  `input_dtype=
    torch.bfloat16` trains in mixed precision (see the module docstring).
    `scheduler` is stepped by the epoch loop, not here."""
    del epoch_idx, scheduler  # the signature of the JAX package's loop
    train_step = (functools.partial(packed_seg_train_step,
                                    remat=(packed == "remat"))
                  if packed else seg_train_step)
    eval_step = packed_seg_eval_step if packed else seg_eval_step
    is_training = action == Action.TRAIN
    epoch_losses = []
    for inputs, labels in _device_batches(loader, prefetch, state.device):
        if input_dtype is not None:
            inputs = inputs.to(input_dtype)
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
                       packed=False, input_dtype=None):
    """The reference's training routine; returns (state, per-epoch mean
    train losses, per-epoch mean validation losses).  `packed` and
    `input_dtype` as in `run_epoch`."""
    state, tr, va, _ = _train_loop(
        num_epochs, training_loader, validation_loader, state, scheduler,
        weights_stem, save_epoch, experiment, verbose, weights_dir, packed,
        input_dtype)
    return state, tr, va


def _train_loop(num_epochs, training_loader, validation_loader, state,
                scheduler, weights_stem, save_epoch, experiment, verbose,
                weights_dir, packed, input_dtype=None):
    """The epoch loop behind `train_segmentation`; returns (state,
    train_losses, val_losses, last_completed_epoch)."""
    start_time = time.time()
    epoch_train_loss, epoch_val_loss = [], []
    kw = dict(packed=packed, input_dtype=input_dtype)
    # the reference's initial VALIDATE epoch
    run_epoch(0, Action.VALIDATE, validation_loader, state, scheduler,
              experiment, **kw)
    for epoch_idx in range(1, num_epochs + 1):
        state, tr = run_epoch(epoch_idx, Action.TRAIN, training_loader,
                              state, scheduler, experiment, **kw)
        state, va = run_epoch(epoch_idx, Action.VALIDATE, validation_loader,
                              state, scheduler, experiment, **kw)
        epoch_train_loss.append(float(np.mean(tr)))
        epoch_val_loss.append(float(np.mean(va)))
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
        if epoch_idx % save_epoch == 0:
            save_checkpoint(
                f"{weights_dir}/{weights_stem}_epoch_{epoch_idx}.ckpt",
                state)
    return state, epoch_train_loss, epoch_val_loss, num_epochs


def get_model_and_optimizer(num_encoding_blocks: int = 3,
                            out_channels_first_layer: int = 16,
                            patience: int = 3, seed: int = 0, device=None):
    """Seeded model/optimizer/scheduler factory
    (`segmentation/routine.py:338-361` semantics): the UNet3D is built on
    the CPU from torch's generator seeded with `seed` (the global generator
    is left as it was), then moved to `device`; AdamW defaults; plateau
    scheduler (factor 0.1, patience 3, threshold 0.01).  Returns (model,
    state, scheduler)."""
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
