"""Classification metrics of the training loops, in numpy: the port's own
`accuracy_score` and binary `roc_auc_score` in place of sklearn's, which
the card's machine does not have (the JAX package's `train/fader.py` and
`train/classification.py` call sklearn's).  Their results are sklearn's
for the arguments the loops pass (`tests/test_torch_classification.py`).
"""
from __future__ import annotations

import numpy as np
from scipy.stats import rankdata


def accuracy_score(y_true, y_pred) -> float:
    """Share of positions where the labels agree (sklearn's
    `accuracy_score` without weights or `normalize`)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.shape != y_pred.shape:
        raise ValueError(f"y_true {y_true.shape} and y_pred {y_pred.shape} "
                         "differ in shape")
    if y_true.size == 0:
        raise ValueError("accuracy of no samples")
    return float(np.mean(y_true == y_pred))


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve of a binary problem: the Mann-Whitney
    statistic, with tied scores averaged (half a pair each), as sklearn's
    `roc_auc_score` gives.  The positive class is the larger of the two
    labels; a ValueError where y_true holds one class only, as in sklearn."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    if y_true.shape != y_score.shape:
        raise ValueError(f"y_true {y_true.shape} and y_score "
                         f"{y_score.shape} differ in shape")
    classes = np.unique(y_true)
    if len(classes) != 2:
        raise ValueError("Only one class present in y_true. ROC AUC score "
                         "is not defined in that case." if len(classes) < 2
                         else f"roc_auc_score takes a binary y_true, got "
                              f"classes {classes.tolist()}")
    pos = y_true == classes[1]
    n_pos = int(pos.sum())
    n_neg = y_true.size - n_pos
    ranks = rankdata(y_score)   # ties get their average rank
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))
