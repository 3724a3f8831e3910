"""Latent-space analysis: t-SNE and PCA of fader embeddings (counterpart of
the JAX package's `obs/analysis.py`).

Capability parity with `train_ENC_CLF.ipynb` cells 15 and 30-32: collect
the encoder's latents and the discriminator's and classifier's hidden
embeddings over a loader, then t-SNE them coloured by scanner domain.

The JAX package calls sklearn, which the card's machine lacks, so both
embeddings are written here in torch, float64, on the card unless the
caller passes `device="cpu"`:

- `pca_embed`: a centred SVD with sklearn's sign convention (each
  component's largest loading positive).
- `tsne_embed`: the *exact* t-SNE of sklearn's `TSNE(method="exact")`, step
  for step: squared euclidean distances rounded to float32, the per-point
  binary search for the Gaussian's precision (perplexity 30, 100 steps,
  entropy tolerance 1e-5), symmetric joint probabilities, Student-t
  similarities with one degree of freedom, early exaggeration 12 for 250
  iterations at momentum 0.5, then momentum 0.8, gains +0.2 / x0.8 with a
  floor of 0.01, a convergence check every 50 iterations, and the PCA
  initialisation scaled to a first-component std of 1e-4.  The JAX
  package's sklearn default is Barnes-Hut, an approximation of the same
  objective.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device

MACHINE_EPSILON = float(np.finfo(np.float64).eps)
_PERPLEXITY_TOLERANCE = 1e-5     # sklearn's _utils._binary_search_perplexity
_BINARY_SEARCH_STEPS = 100
_EXPLORATION_ITERS = 250         # sklearn's TSNE._EXPLORATION_MAX_ITER
_ITER_CHECK = 50                 # TSNE._N_ITER_CHECK
_EARLY_EXAGGERATION = 12.0
_MIN_GAIN = 0.01
_MIN_GRAD_NORM = 1e-7
_ITERS_WITHOUT_PROGRESS = 300


@contextlib.contextmanager
def _eval_mode(*modules):
    """Run `modules` (None entries skipped) in eval mode, and give each its
    own mode back afterwards."""
    modules = [m for m in modules if m is not None]
    modes = [m.training for m in modules]
    try:
        for m in modules:
            m.eval()
        yield
    finally:
        for m, mode in zip(modules, modes):
            m.train(mode)


def collect_latents(encoder, loader, disc=None, clf=None, *, device=None):
    """Run `encoder` (the port's fader `Encoder`) and, when given, `disc` and
    `clf` (its `Discriminator` and `Classificator`) in eval mode over the
    (x, target, domain) batches of `loader`.  Returns numpy arrays:
    'encoder' (the flattened latents), 'disc' and 'clf' (the heads' hidden
    embeddings, when the heads are given), 'targets' and 'domains'."""
    device = resolve_device(device)
    lat_e, lat_d, lat_c, doms, ys = [], [], [], [], []
    with _eval_mode(encoder, disc, clf), torch.inference_mode():
        for batch in loader:
            x = torch.as_tensor(batch[0]).to(device)
            latent, _sizes = encoder(x)
            lat_e.append(latent.reshape(latent.shape[0], -1))
            if disc is not None:
                lat_d.append(disc(latent, return_hidden=True)[1])
            if clf is not None:
                lat_c.append(clf(latent, return_hidden=True)[1])
            ys.append(np.asarray(batch[1]))
            doms.append(np.asarray(batch[2]))

    def host(parts):
        return torch.cat(parts).float().cpu().numpy()

    out = {"encoder": host(lat_e), "targets": np.concatenate(ys),
           "domains": np.concatenate(doms)}
    if lat_d:
        out["disc"] = host(lat_d)
    if lat_c:
        out["clf"] = host(lat_c)
    return out


def _features(features, device) -> torch.Tensor:
    if isinstance(features, torch.Tensor):
        return features.detach().to(device, torch.float64)
    return torch.as_tensor(np.asarray(features, np.float64), device=device)


def _pca(x: torch.Tensor, n_components: int) -> torch.Tensor:
    """Projections of float64 rows `x` on their first principal axes."""
    x = x - x.mean(0)
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    # sklearn's svd_flip(u_based_decision=False): each axis's largest
    # loading positive
    rows = torch.arange(vt.shape[0], device=x.device)
    signs = torch.sign(vt[rows, vt.abs().argmax(1)])
    return (u[:, :n_components] * s[:n_components]
            * signs[:n_components])


def pca_embed(features, n_components: int = 2, *, device=None):
    """PCA projections (float64 numpy) of the rows of `features`."""
    return _pca(_features(features, resolve_device(device)),
                n_components).cpu().numpy()


def _squared_distances(x: torch.Tensor) -> torch.Tensor:
    """sklearn's `euclidean_distances(x, squared=True)`: |a|^2 - 2 a.b +
    |b|^2, clipped at 0, with a zero diagonal."""
    sq = (x * x).sum(1)
    d = (sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]).clamp_min(0.0)
    return d.fill_diagonal_(0.0)


def joint_probabilities(features, perplexity: float = 30.0, *,
                        device=None) -> torch.Tensor:
    """The symmetric joint probabilities P of t-SNE's input space as a full
    (n, n) float64 matrix with a zero diagonal (sklearn's
    `_joint_probabilities` on `pairwise_distances(squared=True)`, which
    returns the off-diagonal entries in condensed form)."""
    x = _features(features, resolve_device(device))
    d = _squared_distances(x).float().double()   # sklearn rounds to f32
    n = d.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=d.device)
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    beta_min = torch.full_like(beta, -math.inf)
    beta_max = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=d.device)
    p = torch.zeros_like(d)
    target = math.log(perplexity)
    for _ in range(_BINARY_SEARCH_STEPS):
        pi = torch.exp(-d * beta[:, None]) * off
        s = pi.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        pi = pi / s[:, None]
        p = torch.where(active[:, None], pi, p)
        diff = torch.log(s) + beta * (d * pi).sum(1) - target
        active = active & (diff.abs() > _PERPLEXITY_TOLERANCE)
        if not bool(active.any()):
            break
        up, down = active & (diff > 0), active & (diff <= 0)
        beta_min = torch.where(up, beta, beta_min)
        beta_max = torch.where(down, beta, beta_max)
        beta = torch.where(
            up, torch.where(torch.isinf(beta_max), beta * 2.0,
                            (beta + beta_max) / 2.0),
            torch.where(down, torch.where(torch.isinf(beta_min), beta / 2.0,
                                          (beta + beta_min) / 2.0), beta))
    p = p + p.T
    p = (p / torch.clamp_min(p.sum(), MACHINE_EPSILON)).clamp_min(
        MACHINE_EPSILON)
    return p * off


def kl_divergence(embedding, p: torch.Tensor):
    """t-SNE's objective at `embedding` (n, c) for joint probabilities `p`
    (`joint_probabilities`): (KL(P || Q), its gradient), as sklearn's
    `_kl_divergence` with max(c - 1, 1) degrees of freedom."""
    y = _features(embedding, p.device)
    dof = max(y.shape[1] - 1, 1)
    off = p > 0
    d = ((y[:, None, :] - y[None, :, :]) ** 2).sum(-1)     # as pdist
    w = (1.0 + d / dof) ** ((dof + 1.0) / -2.0) * off
    q = (w / w.sum()).clamp_min(MACHINE_EPSILON)
    kl = (p * torch.log(p.clamp_min(MACHINE_EPSILON) / q) * off).sum()
    pqd = (p - q) * w
    grad = (pqd.sum(1)[:, None] * y - pqd @ y) * (2.0 * (dof + 1.0) / dof)
    return kl, grad


def _gradient_descent(y, p, it, max_iter, momentum, learning_rate,
                      n_iter_without_progress):
    """sklearn's `_gradient_descent` on the exact objective; returns (y,
    the last iteration)."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        kl, grad = kl_divergence(y, p)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min(
            _MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if (i + 1) % _ITER_CHECK == 0:
            error = float(kl)
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if float(torch.linalg.norm(grad)) <= _MIN_GRAD_NORM:
                break
    return y, i


def tsne_embed(features, n_components: int = 2, random_state: int = 42,
               learning_rate: float = 50.0, n_iter: int = 2000, *,
               perplexity: float = 30.0, device=None):
    """Exact t-SNE (see the module docstring) with the reference's
    hyperparameters; returns the (n, n_components) float64 embedding.
    `random_state` is kept for the JAX signature: the PCA initialisation
    draws no random numbers.  `perplexity` must be below the number of
    rows, as sklearn requires."""
    del random_state
    device = resolve_device(device)
    x = _features(features, device)
    if perplexity >= x.shape[0]:
        raise ValueError("perplexity must be less than n_samples")
    p = joint_probabilities(x, perplexity, device=device)
    y = _pca(x, n_components)
    y = y / y[:, 0].std(correction=0) * 1e-4
    y, it = _gradient_descent(y, p * _EARLY_EXAGGERATION, 0,
                              _EXPLORATION_ITERS, 0.5, learning_rate,
                              _EXPLORATION_ITERS)
    if it < _EXPLORATION_ITERS or n_iter > _EXPLORATION_ITERS:
        y, _ = _gradient_descent(y, p, it + 1, n_iter, 0.8, learning_rate,
                                 _ITERS_WITHOUT_PROGRESS)
    return y.cpu().numpy()


def trustworthiness(features, embedding, n_neighbors: int = 5, *,
                    device=None) -> float:
    """sklearn's `manifold.trustworthiness` (euclidean): how far the
    `n_neighbors` nearest neighbours in the embedding are from being the
    nearest in the input space, 1.0 when they all are."""
    device = resolve_device(device)
    x, y = _features(features, device), _features(embedding, device)
    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=device)
    rank_x = _squared_distances(x).masked_fill(eye, math.inf).argsort(1)
    inverted = torch.empty((n, n), dtype=torch.long, device=device)
    inverted.scatter_(1, rank_x, torch.arange(1, n + 1, device=device)
                      .expand(n, n).contiguous())
    nn_y = _squared_distances(y).masked_fill(eye, math.inf).argsort(1)[
        :, :n_neighbors]
    ranks = inverted.gather(1, nn_y) - n_neighbors
    t = float(ranks[ranks > 0].sum())
    return 1.0 - t * (2.0 / (n * n_neighbors
                             * (2.0 * n - 3.0 * n_neighbors - 1.0)))


def tsne_plot(latents: dict, keys=None, save_path: Optional[str] = None, *,
              device=None):
    """Triptych of encoder / disc / clf t-SNEs coloured by scanner domain
    (the reference's `tsne_plot`); returns the embeddings by panel."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib import cm

    panels = [k for k in ("encoder", "disc", "clf") if k in latents]
    embeds = {k: tsne_embed(latents[k], device=device) for k in panels}
    z = latents["domains"]
    fig, axes = plt.subplots(1, len(panels), figsize=(8 * len(panels), 8),
                             constrained_layout=True, squeeze=False)
    for ax, k in zip(axes[0], panels):
        ax.set_title(f"{k} TSNE")
        for ci, c in enumerate(sorted(set(z.tolist()))):
            idx = np.where(z == c)[0]
            label = keys[c] if keys is not None else str(c)
            ax.scatter(embeds[k][idx, 0], embeds[k][idx, 1], s=10,
                       edgecolor="none", label=label,
                       color=cm.tab20(int(ci)))
    axes[0][-1].legend(loc=2, bbox_to_anchor=(1, 1), markerscale=5)
    if save_path:
        fig.savefig(save_path, dpi=50)
    plt.close(fig)
    return embeds
