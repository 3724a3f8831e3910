"""Classification training: the step, the epoch loop with early stopping,
stratified batches, and the cross-validation harness with its transfer
and finetune modes (counterpart of the JAX package's
`train/classification.py`, after the reference's `utils/routine.py` and
`classification/routine.py`).

- `run_one_epoch` returns (state, losses, probs, targets) with probs =
  softmax(outputs)[:, 1], the cross entropy taken on whatever the model
  emits (DilatedCNN's output is already a softmax, as in the reference);
  in train mode the plateau scheduler steps on every batch's loss.
- `train` stops early on patience over the best metric and on a train
  loss below `eps`, and checkpoints the best state to `model_save_path`.
  The reference's `patience_`/`patience` mix-up, by which patience never
  triggers, stays fixed as in the JAX package.
- `stratified_batch_indices` is the reference's interleave, exactly.
- `create_model_opt` seeds the model's parameters (on the host, then moved
  to the device), builds Adam with L2 weight decay and torch's
  `ReduceLROnPlateau` (factor 0.5, relative threshold 1e-3), loads `.pth`
  weights or a checkpoint, and in transfer mode freezes every parameter
  outside `head_name` (`requires_grad=False`, left out of the optimizer)
  and draws the head anew from `seed + 1`.
- `cross_val_score` runs the folds of any `cv` object with
  `.split(X, y)` (sklearn's splitters, or `StratifiedKFold` here), in
  scratch, transfer, finetune or evaluation-only mode.
- `StratifiedKFold` is sklearn's unshuffled splitter, fold for fold, in
  numpy (the card's machine has no sklearn).

`input_dtype=torch.bfloat16` trains in mixed precision: bf16 activations,
float32 master weights and Adam moments.  Batches reach the model's
device through `DevicePrefetcher`.  `dashboard` (an
`obs.TrainingDashboard`) is updated once per epoch with the epoch's mean
losses and metrics, as in the JAX package; under a mesh only rank 0
updates it.
"""
from __future__ import annotations

import copy
import time
from typing import Optional

import numpy as np
import torch
from scipy import stats
from torch import nn

from ..core.device import resolve_device
from ..data.pipeline import DataLoader, Subset
from .checkpoint import load_checkpoint, save_checkpoint
from ..parallel import sharding as _S
from .optim import ReduceLROnPlateau, torch_adam
from .seg import _device_batches
from .state import TrainState


def cross_entropy(outputs: torch.Tensor, targets: torch.Tensor,
                  weight=None) -> torch.Tensor:
    """torch `nn.CrossEntropyLoss` (mean, optional class weights: the sum
    of w[y] * nll over the sum of w[y]), taken in float32.  The weights
    (a list, an array) enter as scalars: a tensor copied from the host
    would make the host wait for the card.  Under a mesh, the global
    batch's loss on every rank (both sums all-reduced over ``data``)."""
    logp = torch.log_softmax(outputs.float(), dim=-1)
    targets = targets.long()
    nll = -logp.gather(-1, targets[:, None])[:, 0]
    if weight is None:
        return _S.global_mean(nll)
    w = torch.zeros_like(nll)
    for c, wc in enumerate(weight):
        w = torch.where(targets == c, float(wc), w)
    return (_S.all_reduce((w * nll).sum(), ("data",))
            / _S.all_reduce(w.sum(), ("data",)))


def _class_step(state: TrainState, x, y, rng, train: bool):
    """One train (forward, backward, optimizer step; BatchNorm on batch
    statistics) or eval step.  `rng`: the torch.Generator of the model's
    Dropout, or None.  Returns (state, loss, softmax probabilities), both
    detached.  Under a mesh (`parallel.use_mesh`) the batch is this
    rank's rows: BatchNorm and the loss are the global batch's, the
    gradients are summed over the ranks, the probabilities are the rank's
    rows."""
    model = state.model
    model.train(train)
    with torch.set_grad_enabled(train):
        outputs = model(x, generator=rng)
        loss = cross_entropy(outputs, y)
    if train:
        state.optimizer.zero_grad(set_to_none=True)
        _S.backward(loss)
        _S.sync_gradients(model.parameters())
        state.optimizer.step()
        state.step += 1
    return (state, loss.detach(),
            torch.softmax(outputs.detach().float(), dim=-1))


def run_one_epoch(state: TrainState, loader, train: bool, rng_stream=None,
                  scheduler: Optional[ReduceLROnPlateau] = None,
                  experiment=None, epoch: int = 0, prefetch: int = 2,
                  input_dtype=None):
    """One pass over `loader`; returns (state, losses, probs, targets).

    Dropout draws from `rng_stream` (a torch.Generator) or, if None, from
    a generator seeded with `epoch`, so that masks differ from epoch to
    epoch and runs repeat.  Batches are staged on the model's device
    `prefetch` batches ahead (0: one at a time).  In train mode the
    plateau scheduler steps on each batch's loss."""
    gen = rng_stream if rng_stream is not None else \
        torch.Generator().manual_seed(epoch)
    losses, probs, targets = [], [], []
    for x, y in _device_batches(loader, prefetch, state.device):
        if input_dtype is not None:
            x = x.to(input_dtype)
        state, loss, p = _class_step(state, x, y, gen, train)
        loss_val = float(loss)
        if train and scheduler is not None:
            scheduler.step(loss_val)
        losses.append(loss_val)
        probs.extend(p[:, 1].cpu().tolist())
        targets.extend(y.cpu().tolist())
        if experiment:
            experiment.log_metric("train_loss" if train else "val_loss",
                                  loss_val)
    return state, losses, probs, targets


def train(state: TrainState, train_dataloader, val_dataloader, metric,
          scheduler: Optional[ReduceLROnPlateau] = None, verbose: int = 0,
          model_save_path: Optional[str] = None, max_epoch: int = 20,
          eps: float = 3e-3, max_patience: int = 10, experiment=None,
          dashboard=None, input_dtype=None):
    """The epoch loop; returns (state, last_train_loss, last_train_metric,
    last_val_loss, last_val_metric) of the best epoch.  `input_dtype` as
    in `run_one_epoch`; `dashboard` gets `update(train_loss=, train_metric=,
    val_loss=, val_metric=)` once per epoch (the validation values None
    without a validation loader)."""
    patience = 0
    best_metric = 0.0
    etl, etm, evl, evm = [], [], [], []
    last = dict(tl=None, tm=None, vl=None, vm=None)

    for epoch in range(max_epoch):
        t0 = time.time()
        state, tr_losses, tr_probs, tr_targets = run_one_epoch(
            state, train_dataloader, True, scheduler=scheduler,
            experiment=experiment, epoch=epoch, input_dtype=input_dtype)
        if val_dataloader is not None:
            state, v_losses, v_probs, v_targets = run_one_epoch(
                state, val_dataloader, False, experiment=experiment,
                epoch=epoch, input_dtype=input_dtype)

        etl.append(float(np.mean(tr_losses)))
        etm.append(metric(tr_targets, tr_probs))
        if experiment:
            experiment.log_metrics({"mean_train_loss": etl[-1],
                                    "train_metric": etm[-1]}, epoch=epoch)
        if val_dataloader is not None:
            evl.append(float(np.mean(v_losses)))
            evm.append(metric(v_targets, v_probs))
            if experiment:
                experiment.log_metrics({"mean_val_loss": evl[-1],
                                        "val_metric": evm[-1]}, epoch=epoch)
        if verbose:
            print(f"Epoch {epoch + 1} of {max_epoch} took "
                  f"{time.time() - t0:.3f}s")
            print(f"  training loss: {etl[-1]:.6f}  metric: {etm[-1]:.4f}")
            if val_dataloader is not None:
                print(f"  validation loss: {evl[-1]:.6f}  "
                      f"metric: {evm[-1]:.4f}")
        if dashboard is not None and _S.is_writer():
            dashboard.update(
                train_loss=etl[-1], train_metric=etm[-1],
                val_loss=evl[-1] if val_dataloader is not None else None,
                val_metric=evm[-1] if val_dataloader is not None else None)

        improved = ((val_dataloader is not None and evm[-1] > best_metric)
                    or (val_dataloader is None and etm[-1] >= best_metric))
        if improved:
            patience = 0
            best_metric = evm[-1] if val_dataloader is not None else etm[-1]
            last = dict(tl=etl[-1], tm=etm[-1],
                        vl=evl[-1] if val_dataloader is not None else None,
                        vm=evm[-1] if val_dataloader is not None else None)
            if model_save_path is not None:
                save_checkpoint(model_save_path, state, metric=best_metric)
        else:
            patience += 1

        if patience >= max_patience:
            print("Early stopping! Patience is out.")
            break
        if etl[-1] < eps:
            print("Early stopping! Train loss < eps.")
            break

    return state, last["tl"], last["tm"], last["vl"], last["vm"]


def stratified_batch_indices(indices, labels):
    """Deterministic interleave of the minority class into sequential
    batches (reference `utils/routine.py:127-145`)."""
    indices = np.asarray(indices)
    labels = np.asarray(labels)
    dominating_label = np.atleast_1d(stats.mode(labels, keepdims=True)[0])[0]
    idx0 = indices[labels == dominating_label]
    idx1 = indices[labels != dominating_label]
    step = np.ceil(len(idx0) / len(idx1)) + 1
    assert step >= 1.0
    result = []
    j0 = j1 = 0
    for i in range(len(indices)):
        if (i % step == 0 or j0 == len(idx0)) and j1 < len(idx1):
            result.append(idx1[j1])
            j1 += 1
        else:
            result.append(idx0[j0])
            j0 += 1
    result = np.array(result)
    assert len(result) == len(indices)
    return result


def seeded_state_dict(model: nn.Module, seed: int):
    """The state dict of `model` with every parameter and buffer drawn
    anew by its module's `reset_parameters` from torch's generator seeded
    with `seed`, on a host copy: the same values on any device, and
    torch's global generator left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        host = copy.deepcopy(model).to("cpu")
        for m in host.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters()
    return host.state_dict()


def create_model_opt(model: nn.Module, sample_input,
                     model_load_path: Optional[str] = None,
                     transfer: bool = False, lr: float = 1e-5,
                     weight_decay: float = 0.01, patience: int = 2,
                     head_name: str = "model__fully_conn_2", seed: int = 0,
                     *, device=None):
    """Train state and scheduler for `model` (an nn.Module, whose
    parameters are drawn anew from `seed` and which is moved to `device`)
    (`classification/routine.py:253-279` semantics): Adam with L2 weight
    decay, `ReduceLROnPlateau` (mode min, factor 0.5, relative threshold
    1e-3).  `model_load_path`: torch `.pth` weights (strict=False) or a
    checkpoint of either package.  `transfer`: every parameter outside
    `head_name` (JAX's `model__fully_conn_2` or torch's
    `model.fully_conn_2`) is frozen, and the head is drawn anew from
    `seed + 1`.  `sample_input` only shapes the JAX package's init and is
    ignored.  Returns (state, scheduler)."""
    del sample_input
    model.requires_grad_(True)
    model.load_state_dict(seeded_state_dict(model, seed))
    model.to(resolve_device(device))
    state = TrainState(model=model, optimizer=torch_adam(
        lr, weight_decay=weight_decay)(model.parameters()))
    if model_load_path is not None:
        if model_load_path.endswith(".pth"):
            sd = torch.load(model_load_path, map_location="cpu",
                            weights_only=True)
            model.load_state_dict(sd, strict=False)
        else:
            state = load_checkpoint(model_load_path, state)
    if transfer:
        head = head_name.replace("__", ".") + "."
        fresh = seeded_state_dict(model, seed + 1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.startswith(head):
                    p.copy_(fresh[name])
                p.requires_grad_(name.startswith(head))
        trainable = [p for p in model.parameters() if p.requires_grad]
        if not trainable:
            raise ValueError(f"no parameter under head {head_name!r}")
        state = TrainState(model=model, optimizer=torch_adam(
            lr, weight_decay=weight_decay)(trainable), step=state.step)
    scheduler = ReduceLROnPlateau(state.optimizer, mode="min", factor=0.5,
                                  patience=patience, threshold=1e-3)
    return state, scheduler


class StratifiedKFold:
    """sklearn's `StratifiedKFold(n_splits)` without shuffling: classes are
    numbered in order of first appearance, each fold's share of every class
    comes from a round robin over the sorted labels, and each class's
    samples go to the folds in blocks, in data order."""

    def __init__(self, n_splits: int = 5):
        if n_splits < 2:
            raise ValueError(f"n_splits must be at least 2, got {n_splits}")
        self.n_splits = n_splits

    def get_n_splits(self, X=None, y=None, groups=None) -> int:
        return self.n_splits

    def _test_folds(self, y) -> np.ndarray:
        y = np.asarray(y).ravel()
        if self.n_splits > len(y):
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} "
                f"greater than the number of samples: n_samples={len(y)}.")
        _, first, inverse = np.unique(y, return_index=True,
                                      return_inverse=True)
        y_encoded = np.argsort(np.argsort(first))[inverse.ravel()]
        n_classes = len(first)
        if np.all(self.n_splits > np.bincount(y_encoded)):
            raise ValueError(f"n_splits={self.n_splits} cannot be greater "
                             "than the number of members in each class.")
        y_order = np.sort(y_encoded)
        allocation = np.asarray([
            np.bincount(y_order[i::self.n_splits], minlength=n_classes)
            for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype=np.int64)
        for k in range(n_classes):
            test_folds[y_encoded == k] = np.arange(self.n_splits).repeat(
                allocation[:, k])
        return test_folds

    def split(self, X, y, groups=None):
        """(train indices, test indices) of each fold."""
        del groups
        folds = self._test_folds(y)
        if len(folds) != len(X):
            raise ValueError("X and y have different lengths")
        index = np.arange(len(folds))
        for i in range(self.n_splits):
            yield index[folds != i], index[folds == i]


def cross_val_score(model, train_dataset, cv, metric, sample_input,
                    holdout_idx=None, model_load_path: Optional[str] = None,
                    batch_size: int = 10, val_dataset=None,
                    transfer: bool = False, finetune: bool = False,
                    experiment=None, max_epoch: int = 20, lr: float = 1e-5,
                    verbose: int = 0, *, device=None):
    """k-fold cross validation (`classification/routine.py:182-251`
    semantics); every fold starts from `create_model_opt`'s seeded draw of
    `model`.  Returns the per-fold validation metrics."""
    assert not (transfer and finetune)
    assert (not transfer) or (model_load_path is not None)

    use_rest = val_dataset is not None
    if val_dataset is None:
        val_dataset = train_dataset

    y_all = np.asarray(train_dataset.target)
    if holdout_idx is not None:
        cv_splits = list(cv.split(X=np.arange(len(holdout_idx)),
                                  y=y_all[np.asarray(holdout_idx)]))
    else:
        cv_splits = list(cv.split(X=np.arange(len(train_dataset)), y=y_all))

    val_metrics = []
    for train_idx, val_idx in cv_splits:
        do_train = model_load_path is None or transfer or finetune
        if do_train:
            train_idx = stratified_batch_indices(train_idx, y_all[train_idx])
            train_loader = DataLoader(Subset(train_dataset, train_idx),
                                      shuffle=False, batch_size=batch_size)
        if use_rest:
            val_mask = ~np.isin(np.asarray(val_dataset.pids),
                                np.asarray(train_dataset.pids)[train_idx])
            val_idx = np.arange(len(val_dataset))[val_mask]
        val_loader = DataLoader(Subset(val_dataset, val_idx), shuffle=False,
                                batch_size=batch_size)

        eps = 1e-2 if use_rest else 3e-3
        if do_train:
            state, scheduler = create_model_opt(
                model, sample_input,
                model_load_path if (transfer or finetune) else None,
                transfer=transfer, lr=lr, device=device)
            _, _, _, _, last_val_metric = train(
                state, train_loader, val_loader, metric, scheduler=scheduler,
                verbose=verbose, max_epoch=max_epoch, eps=eps,
                experiment=experiment)
            val_metrics.append(last_val_metric)
        else:
            state, _ = create_model_opt(model, sample_input, model_load_path,
                                        lr=lr, device=device)
            _, _, v_probs, v_targets = run_one_epoch(state, val_loader, False)
            if getattr(metric, "__name__", "") == "accuracy_score":
                val_metrics.append(metric(
                    v_targets, np.where(np.array(v_probs) <= 0.5, 0, 1)))
            else:
                val_metrics.append(metric(v_targets, v_probs))
    return val_metrics
