"""Collate functions (counterpart of the JAX package's
`data/collate.py`).

`fader_collate(landmarks)` reproduces the reference's `default_collate`
(`train_ENC_CLF.ipynb` cells 9-10): per-sample Nyul histogram
standardization with the trained 13-landmark mapping at batch assembly,
plus int labels and domains.  The standardization runs on the device, as
the JAX package runs it in its device graph, and the batch stays there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..transforms.intensity import histogram_standardization


def fader_collate(landmarks, device=None):
    """A collate of (volume (1, D, H, W), label, domain) items into
    `(x, y, dom)`: x the standardized channels-last float32 batch
    (N, D, H, W, 1) on `resolve_device(device)` (the card unless
    `device="cpu"`), y and dom int32 numpy vectors."""
    landmarks = np.asarray(landmarks, np.float32)
    dev = resolve_device(device)

    def collate(batch):
        vols = np.stack([np.moveaxis(np.asarray(item[0]), 0, -1)
                         for item in batch])
        x = torch.from_numpy(np.ascontiguousarray(vols)).to(dev)
        x = torch.stack([histogram_standardization(v, landmarks) for v in x])
        y = np.asarray([item[1] for item in batch], np.int32)
        dom = np.asarray([item[2] for item in batch], np.int32)
        return x, y, dom

    return collate
