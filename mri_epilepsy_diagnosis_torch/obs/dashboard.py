"""Live per-epoch training dashboards (counterpart of the JAX package's
`obs/dashboard.py`, panel for panel).

- `TrainingDashboard`: the 1x2 loss / metric figure the reference redraws
  every epoch (`utils/routine.py:80-97`).
- `FaderDashboard`: the 4x3 adversarial-training panel of
  `train_ENC_CLF.ipynb` cell 13: classifier, discriminator and adversarial
  losses on a log scale for train and validation, accuracy, domain
  accuracy and ROC-AUC curves, moving-averaged.

Each update redraws the figure and writes it to ``out_path``; with an
interactive backend the same figure is also shown.  The training loops
take one through their ``dashboard=`` argument.  matplotlib is imported
only when a figure is drawn.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def moving_average(x: Sequence[float], w: int = 20) -> np.ndarray:
    """The notebook's `mov_ave` smoothing (window mean, short-start safe)."""
    x = np.asarray(x, np.float64)
    if len(x) == 0:
        return x
    w = max(1, min(w, len(x)))
    c = np.cumsum(np.insert(x, 0, 0.0))
    out = (c[w:] - c[:-w]) / w
    head = c[1:w] / np.arange(1, w)
    return np.concatenate([head, out])


class TrainingDashboard:
    """Loss and metric curves, train against validation, redrawn per epoch
    (`utils/routine.py:82-97`)."""

    def __init__(self, metric_name: str = "metric",
                 out_path: Optional[str] = "training_dashboard.png",
                 show: bool = False):
        self.metric_name = metric_name
        self.out_path = out_path
        self.show = show
        self.train_loss: list = []
        self.val_loss: list = []
        self.train_metric: list = []
        self.val_metric: list = []

    def update(self, train_loss=None, val_loss=None, train_metric=None,
               val_metric=None):
        for seq, v in ((self.train_loss, train_loss),
                       (self.val_loss, val_loss),
                       (self.train_metric, train_metric),
                       (self.val_metric, val_metric)):
            if v is not None:
                seq.append(float(v))
        self._draw()

    def _draw(self):
        plt = _plt()
        fig, axes = plt.subplots(1, 2, figsize=(10, 5))
        axes[0].plot(self.train_loss, label="train")
        if self.val_loss:
            axes[0].plot(self.val_loss, label="val")
        axes[0].set_xlabel("epoch")
        axes[0].set_ylabel("loss")
        axes[0].legend()
        if self.train_metric:
            axes[1].plot(self.train_metric, label="train")
        if self.val_metric:
            axes[1].plot(self.val_metric, label="val")
        axes[1].set_ylim([0, 1.05])
        axes[1].set_xlabel("epoch")
        axes[1].set_ylabel(self.metric_name)
        axes[1].legend()
        fig.tight_layout()
        if self.out_path:
            fig.savefig(self.out_path)
        if self.show:
            plt.show()
        plt.close(fig)


class FaderDashboard:
    """The 12-panel adversarial dashboard (train_ENC_CLF.ipynb cell 13),
    fed with the `train_fader` history dict after each epoch."""

    _PANELS = [
        ("train_loss", "Training loss, log scale", True),
        ("train_loss_disc", "Training discriminator loss, log scale", True),
        ("train_loss_adv", "Train adversarial loss, log scale", True),
        ("val_loss", "Validation loss, log scale", True),
        ("val_loss_disc", "Validation discriminator loss, log scale", True),
        ("roc_train", "Train ROC-AUC", False),
        ("acc_train", "Train accuracy", False),
        ("acc_domain_train", "Train domain accuracy", False),
        ("roc", "Validation ROC-AUC", False),
        ("acc", "Validation accuracy", False),
        ("acc_domain", "Validation domain accuracy", False),
    ]

    def __init__(self, out_path: Optional[str] = "fader_dashboard.png",
                 show: bool = False, smooth: int = 20):
        self.out_path = out_path
        self.show = show
        self.smooth = smooth

    def update(self, hist: dict):
        plt = _plt()
        fig, ax = plt.subplots(4, 3, figsize=(21, 21),
                               constrained_layout=True)
        for i, (key, title, log) in enumerate(self._PANELS):
            a = ax[i // 3, i % 3]
            series = [v for v in hist.get(key, []) if v == v]  # drop NaN
            if series:
                a.plot(moving_average(series, self.smooth), color="red")
            if log and series and min(series) > 0:
                a.set_yscale("log")
            a.set_title(title, fontsize=10)
            a.set_xlabel("batches" if "loss" in key else "epochs")
        ax[3, 2].axis("off")
        if self.out_path:
            fig.savefig(self.out_path)
        if self.show:
            plt.show()
        plt.close(fig)
