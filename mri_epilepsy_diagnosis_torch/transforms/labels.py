"""Label preparation: ground-truth binarization on the device (counterpart
of the JAX package's `transforms/labels.py`).

Reference semantics (`segmentation/routine.py:185-196` `prepare_batch`):
subcortical FreeSurfer ids in LIST_FCD -> 1, cortical labels >= 1000 -> 1,
and values already equal to 1 stay 1 (the reference zeroes only
`targets != 1` at the end, so binary masks pass through unchanged);
everything else -> 0.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# FreeSurfer subcortical ids binarized into the segmentation target
# (reference `segmentation/routine.py:70-71`)
LIST_FCD = [8, 10, 11, 12, 13, 16, 17, 18, 26, 47, 49, 50,
            51, 52, 53, 54, 58, 85, 251, 252, 253, 254, 255]


def binarize_segmentation(labels: torch.Tensor,
                          list_fcd: Optional[Sequence[int]] = None
                          ) -> torch.Tensor:
    """labels: any-shape tensor of FreeSurfer aseg+aparc ids (float or
    int) -> float32 0/1 of the same shape, on the same device.  Float ids
    are truncated toward zero first."""
    ids = torch.as_tensor(LIST_FCD if list_fcd is None else list(list_fcd),
                          dtype=torch.int32, device=labels.device)
    li = labels.to(torch.int32)
    return (torch.isin(li, ids) | (li >= 1000) | (li == 1)).to(torch.float32)
