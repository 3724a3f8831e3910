"""Gradient-accumulation train steps (counterpart of the JAX package's
`train/accum.py`: `packed_seg_train_step_accum` for segmentation,
`class_train_step_accum` for classification).

An effective batch of B runs as B/micro micro-batches through the packed
train step's forward and backward, one after the other, and the optimizer
steps once on the mean gradient, so the effective batch is bounded by the
memory of one micro-batch, not of B.

Semantics, as in JAX:
- gradients: the loss of each micro-batch divided by their number is
  backpropagated into `.grad`, which sums to the gradient of the mean
  loss; for the dice loss (a mean over the batch) and micro = B this is
  the flat step's gradient;
- BatchNorm: train-mode normalization uses each micro-batch's own
  statistics (like sequential small batches), and the running statistics
  thread from one micro-batch to the next; `num_batches_tracked` counts
  every micro-batch, as `nn.BatchNorm3d` would;
- Dropout: one generator for the whole step, drawn from micro-batch by
  micro-batch.
"""
from __future__ import annotations

import torch

from ..transforms.labels import binarize_segmentation
from .classification import cross_entropy
from .seg import _store_running_stats, packed_seg_loss
from .state import TrainState


def packed_seg_train_step_accum(state: TrainState, inputs, raw_labels,
                                micro: int = 1, remat: bool = False):
    """`packed_seg_train_step` over `micro`-sized micro-batches (batch %
    micro == 0), one optimizer step on the mean gradient.  Each
    micro-batch launches B1 23 times (12 forward, 11 input gradients).
    Returns (state, mean loss as a detached scalar tensor)."""
    batch = inputs.shape[0]
    if batch % micro:
        raise ValueError(f"batch {batch} not divisible by micro={micro}")
    n = batch // micro
    model = state.model
    targets = binarize_segmentation(raw_labels)
    state.optimizer.zero_grad(set_to_none=True)
    loss_sum = torch.zeros((), device=inputs.device)
    for i in range(n):
        chunk = slice(i * micro, (i + 1) * micro)
        loss, stats = packed_seg_loss(model, inputs[chunk], targets[chunk],
                                      remat)
        (loss / n).backward()
        loss_sum += loss.detach()
        # the next micro-batch starts from these running statistics
        _store_running_stats(model, stats)
    state.optimizer.step()
    state.step += 1
    return state, loss_sum / n


def class_train_step_accum(state: TrainState, x, y, rng, micro: int = 2):
    """`_class_step(train=True)` over `micro`-sized micro-batches (batch %
    micro == 0), one optimizer step on the mean gradient: the reference's
    DilatedCNN batch 10 (`baseline_sample_classification.ipynb` cell 28)
    in the memory of `micro` volumes.  `rng`: the Dropout's generator or
    None.  Returns (state, mean loss, softmax probabilities), detached,
    like `_class_step`."""
    batch = x.shape[0]
    if batch % micro:
        raise ValueError(f"batch {batch} not divisible by micro={micro}")
    n = batch // micro
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss_sum = torch.zeros((), device=x.device)
    outputs = []
    for i in range(n):
        chunk = slice(i * micro, (i + 1) * micro)
        out = model(x[chunk], generator=rng)
        loss = cross_entropy(out, y[chunk])
        (loss / n).backward()
        loss_sum += loss.detach()
        outputs.append(out.detach())
    state.optimizer.step()
    state.step += 1
    return (state, loss_sum / n,
            torch.softmax(torch.cat(outputs).float(), dim=-1))
