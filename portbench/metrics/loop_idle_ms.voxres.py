"""loop_idle_ms.voxres: device-idle ms per step of the stack-less
stretch in which the classification loop's thread is in
`cls::next_batch`, `cls::cast`, `cls::loss_sync`, `cls::collect` or
`cls::log`, or in no leaf span of the step: the bubble the loop makes
around each step (the loss readback, the probabilities' host copies, the
plateau scheduler, logging, the batch hand-off)."""
from portbench.metrics._cls_spans import idle_split


def read(view):
    split = idle_split(view)
    return None if split is None else split[0] / 1e3 / view.steps
