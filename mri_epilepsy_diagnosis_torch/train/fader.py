"""Fader-network adversarial training: a domain discriminator alternates
with the encoder and its classifier (or its decoder) (counterpart of the
JAX package's `train/fader.py`, after the reference's `train_AE.ipynb`
cells 6-7 and `train_ENC_CLF.ipynb` cells 14/16/18).

- `disc_step`: cross entropy over the scanner domains on the latent of the
  encoder, which runs in eval mode under `torch.no_grad()` (the
  reference's `ae.eval()` during discriminator updates); `train_fader`
  repeats it `disc_loop` times a batch while epoch < 5, then once;
- `enc_clf_step`: `main + lambda(t) * adv`, where adv pushes the frozen
  discriminator toward the wrong domains (the mean of reversed one-hot
  times log-softmax) and main is the weighted cross entropy of the
  classifier; `ae_step` takes the MSE reconstruction as main.  Lambda
  ramps linearly by `lambda_step` a step for `max_step` steps.

The JAX package freezes a network by differentiating only the other
parameter subtree.  Here the discriminator of `enc_clf_step` and
`ae_step` runs in eval mode with `requires_grad` off for the step: its
parameters get no `.grad`, its BatchNorm statistics do not move, and B3's
backward (`ops/cuda_kernels.py::SeparableConv3dFn`) passes the gradient
through its convs to the latent without their weight gradients.  Each
step leaves the gradients of the networks it trained at None.

Dropout draws from the `torch.Generator` passed as `rng` (JAX draws other
bits from its keys; ROADMAP §C).  `input_dtype=torch.bfloat16` trains in
mixed precision: bf16 activations, float32 master weights and Adam
moments.

`disc_step` and `enc_clf_step` run data-parallel under
`parallel.use_mesh`: train-mode BatchNorm (BatchNorm1d too) and the
losses are the global batch's, Dropout masks are drawn at the global
shape, and each optimizer's gradients are summed over the ranks.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..data.pipeline import DevicePrefetcher
from ..metrics.classification import accuracy_score, roc_auc_score
from ..parallel import sharding as _S
from .classification import cross_entropy
from .state import TrainState


def adv_loss(domains: torch.Tensor, pred_logits: torch.Tensor,
             n_domains: int) -> torch.Tensor:
    """-mean over the (batch, n_domains) matrix of reversed one-hot times
    log-softmax (the reference's `adv_loss`, train_ENC_CLF.ipynb cell 14),
    in float32."""
    onehot = torch.nn.functional.one_hot(domains.long(), n_domains)
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    return -_S.global_mean((1.0 - onehot) * logp)


def fader_main_loss(clf_logits, y, disc_logits, domains, lambda_t,
                    n_domains: int, class_weight=None):
    """(weighted cross entropy + lambda_t * adv, adv)."""
    loss_clf = cross_entropy(clf_logits, y, weight=class_weight)
    loss_adv = adv_loss(domains, disc_logits, n_domains)
    return loss_clf + lambda_t * loss_adv, loss_adv


@dataclass
class FaderState:
    encoder: TrainState
    clf: Optional[TrainState]
    disc: TrainState
    decoder: Optional[TrainState] = None


@contextlib.contextmanager
def _frozen(model: torch.nn.Module):
    """`model` in eval mode with every parameter's `requires_grad` off,
    restored on exit."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    model.eval()
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield model
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _step(states, loss: torch.Tensor):
    """Backward of `loss` into the states' models, one optimizer step each;
    their gradients are None before and after.  Under a mesh the loss is
    the global batch's and the gradients are summed over the ranks."""
    for st in states:
        st.optimizer.zero_grad(set_to_none=True)
    _S.backward(loss)
    for st in states:
        _S.sync_gradients(st.model.parameters())
        st.optimizer.step()
        st.optimizer.zero_grad(set_to_none=True)
        st.step += 1


def disc_step(fstate: FaderState, x, domains, rng, n_domains: int,
              domain_weight=None):
    """Train the discriminator (train mode, Dropout from `rng`) on the
    latent of the encoder in eval mode.  Returns (fstate, loss, logits),
    detached."""
    del n_domains  # the JAX step's static argument
    encoder, disc = fstate.encoder.model, fstate.disc.model
    encoder.eval()
    with torch.no_grad():
        latent, _ = encoder(x)
    disc.train()
    logits = disc(latent, generator=rng)
    loss = cross_entropy(logits, domains, weight=domain_weight)
    _step((fstate.disc,), loss)
    return fstate, loss.detach(), logits.detach()


def enc_clf_step(fstate: FaderState, x, y, domains, lambda_t, rng,
                 n_domains: int, class_weight=None):
    """Train the encoder and the classifier (train mode) against the
    frozen discriminator.  Returns (fstate, loss, loss_adv, clf_logits),
    detached."""
    encoder, clf = fstate.encoder.model, fstate.clf.model
    encoder.train()
    clf.train()
    with _frozen(fstate.disc.model) as disc:
        latent, _ = encoder(x)
        clf_logits = clf(latent, generator=rng)
        loss, loss_adv = fader_main_loss(clf_logits, y, disc(latent),
                                         domains, lambda_t, n_domains,
                                         class_weight)
        _step((fstate.encoder, fstate.clf), loss)
    return fstate, loss.detach(), loss_adv.detach(), clf_logits.detach()


def ae_step(fstate: FaderState, x, domains, lambda_t, rng):
    """The AE variant (train_AE.ipynb): MSE reconstruction + lambda_t * adv,
    training the encoder and the decoder against the frozen
    discriminator.  Returns (fstate, loss), detached."""
    del rng  # the encoder and decoder have no Dropout
    encoder, decoder = fstate.encoder.model, fstate.decoder.model
    encoder.train()
    decoder.train()
    with _frozen(fstate.disc.model) as disc:
        latent, sizes = encoder(x)
        rec = decoder(latent, sizes)
        disc_logits = disc(latent)
        loss = (torch.mean(torch.square(rec.float() - x.float()))
                + lambda_t * adv_loss(domains, disc_logits,
                                      disc_logits.shape[-1]))
        _step((fstate.encoder, fstate.decoder), loss)
    return fstate, loss.detach()


def _fader_batches(loader, device):
    """(x, y, domains) of each batch as tensors on `device`, staged one
    batch ahead."""
    staged = DevicePrefetcher((tuple(b[:3]) for b in loader), size=2,
                              device=device)
    while (batch := staged.get()) is not None:
        yield batch


def _score(metric, gt, pred) -> float:
    try:
        return metric(gt, pred)
    except ValueError:   # one class only: AUC undefined
        return float("nan")


def train_fader(fstate: FaderState, train_loader, val_loader, epochs: int,
                lambda_initial: float, lambda_step: float, max_step: int,
                n_domains: int, disc_loop: int = 1, class_weight=None,
                domain_weight=None, experiment=None, verbose: bool = True,
                rng_seed: int = 0, dashboard=None, input_dtype=None):
    """The ENC_CLF epoch loop (train_ENC_CLF.ipynb cell 16 semantics).
    Per batch: `disc_loop` discriminator steps while epoch < 5 (then 1),
    one encoder + classifier step; lambda grows by `lambda_step` per step
    while step < max_step.  Dropout draws from a torch.Generator seeded
    with `rng_seed`.  Returns (fstate, history dict of per-step losses and
    per-epoch accuracy / ROC AUC / domain accuracy, the JAX package's
    keys).  `dashboard` (an `obs.FaderDashboard`) gets `update(hist)` after
    each epoch (rank 0 alone under a mesh)."""
    gen = torch.Generator().manual_seed(rng_seed)
    device = fstate.encoder.device
    step = 0
    lambda_t = lambda_initial
    hist = {k: [] for k in ["train_loss", "train_loss_disc", "train_loss_adv",
                            "val_loss", "val_loss_disc", "acc_train",
                            "roc_train", "acc_domain_train", "acc", "roc",
                            "acc_domain"]}

    for epoch in range(epochs):
        t0 = time.time()
        n_d = disc_loop if epoch < 5 else 1
        pred_tr, gt_tr, pred_dom, gt_dom = [], [], [], []

        for x, y, dom in _fader_batches(train_loader, device):
            if input_dtype is not None:
                x = x.to(input_dtype)
            for _ in range(n_d):
                fstate, loss_disc, disc_logits = disc_step(
                    fstate, x, dom, gen, n_domains, domain_weight)
            pred_dom.extend(disc_logits.argmax(-1).cpu().tolist())
            gt_dom.extend(dom.cpu().tolist())

            fstate, loss, loss_adv, clf_logits = enc_clf_step(
                fstate, x, y, dom, lambda_t, gen, n_domains, class_weight)
            pred_tr.extend(clf_logits.argmax(-1).cpu().tolist())
            gt_tr.extend(y.cpu().tolist())

            step += 1
            if step < max_step:
                lambda_t += lambda_step

            hist["train_loss"].append(float(loss))
            hist["train_loss_disc"].append(float(loss_disc))
            hist["train_loss_adv"].append(float(loss_adv))
            if experiment:
                experiment.log_metrics({"train_loss": float(loss),
                                        "train_loss_disc": float(loss_disc),
                                        "lambda": lambda_t}, step=step)

        hist["acc_train"].append(accuracy_score(gt_tr, pred_tr))
        hist["acc_domain_train"].append(accuracy_score(gt_dom, pred_dom))
        hist["roc_train"].append(_score(roc_auc_score, gt_tr, pred_tr))

        if val_loader is not None:
            pred, gt, pred_d, gt_d = [], [], [], []
            encoder, clf, disc = (fstate.encoder.model, fstate.clf.model,
                                  fstate.disc.model)
            for m in (encoder, clf, disc):
                m.eval()
            with torch.no_grad():
                for x, y, dom in _fader_batches(val_loader, device):
                    if input_dtype is not None:
                        x = x.to(input_dtype)
                    latent, _ = encoder(x)
                    pred.extend(clf(latent).argmax(-1).cpu().tolist())
                    pred_d.extend(disc(latent).argmax(-1).cpu().tolist())
                    gt.extend(y.cpu().tolist())
                    gt_d.extend(dom.cpu().tolist())
            hist["acc"].append(accuracy_score(gt, pred))
            hist["acc_domain"].append(accuracy_score(gt_d, pred_d))
            hist["roc"].append(_score(roc_auc_score, gt, pred))

        if dashboard is not None and _S.is_writer():
            dashboard.update(hist)
        if verbose:
            print(f"epoch {epoch}: {time.time() - t0:.1f}s "
                  f"train acc {hist['acc_train'][-1]:.3f} "
                  f"domain acc {hist['acc_domain_train'][-1]:.3f}"
                  + (f" val acc {hist['acc'][-1]:.3f}" if val_loader
                     else ""))
    return fstate, hist
