"""Shared arithmetic of the readers of the classification loop's spans
(not a metric itself): the `cls::` ranges that the program's
`train/classification.py::run_one_epoch` and its steps record on the
loop's thread, and the stretch's device-idle time split by them, as
`_spans.py` splits it by the segmentation loop's `seg::` ranges.  A
program that records no such range gives None."""
from __future__ import annotations

from portbench.lib import trace as T
from portbench.metrics._spans import spans, union

# the leaves of a step in which the host issues the step's own launches
LAUNCH = ("cls::forward", "cls::backward", "cls::optimizer", "cls::stats")
# the leaves of the loop around the step
LOOP = ("cls::next_batch", "cls::cast", "cls::loss_sync", "cls::collect",
        "cls::log")


def idle_split(view):
    """(loop us, launch us): the stretch's device-idle time while the
    loop's thread is in a `LAUNCH` leaf, and the rest of it (in a `LOOP`
    leaf or in none).  None without device events or without the loop's
    spans."""
    if view.span[1] <= view.span[0] or not view.devs:
        return None
    if not spans(view, LAUNCH + LOOP):
        return None
    idle = sum(b - a for a, b in T.idle_gaps(view.devs, view.span))
    launch = sum((b - a) - T.busy_us(view.devs, (a, b))
                 for a, b in union(spans(view, LAUNCH)))
    return idle - launch, launch
