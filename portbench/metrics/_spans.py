"""Shared arithmetic of the readers of the loop's spans (not a metric
itself): the `seg::` ranges that the program's `train/seg.py::run_epoch`
records on the loop's thread, clipped to the stack-less stretch, and the
stretch's device-idle time split by them.  A program that records no such
range gives None."""
from __future__ import annotations

from portbench.lib import trace as T

# the leaves of a step in which the host issues the step's own launches
LAUNCH = ("seg::forward", "seg::backward", "seg::optimizer", "seg::stats")
# the leaves of the loop around the step
LOOP = ("seg::next_batch", "seg::cast", "seg::loss_sync", "seg::log")


def spans(view, names):
    """(start, end) of the loop thread's ranges named in `names`, clipped
    to the stretch, sorted."""
    tid = T.main_thread(view.plain)
    lo, hi = view.span
    out = []
    for e in view.plain:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("tid") == tid and e.get("name") in names):
            a = max(float(e["ts"]), lo)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
            if b > a:
                out.append((a, b))
    return sorted(out)


def union(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_split(view):
    """(loop us, launch us): the stretch's device-idle time while the
    loop's thread is in a `LAUNCH` leaf, and the rest of it (in a `LOOP`
    leaf or in none).  Each idle gap is split by its overlap with the
    spans.  None without device events or without the loop's spans."""
    if view.span[1] <= view.span[0] or not view.devs:
        return None
    if not spans(view, LAUNCH + LOOP):
        return None
    idle = sum(b - a for a, b in T.idle_gaps(view.devs, view.span))
    launch = sum((b - a) - T.busy_us(view.devs, (a, b))
                 for a, b in union(spans(view, LAUNCH)))
    return idle - launch, launch
