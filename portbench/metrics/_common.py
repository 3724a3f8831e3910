"""Shared arithmetic of the metric readers (not a metric itself)."""
from __future__ import annotations

from portbench.lib import trace as T


def kernel_us(devs, names) -> float:
    """Device microseconds of the kernels whose name (without namespaces,
    templates and parameters) is in `names`."""
    return sum(float(e.get("dur", 0.0)) for e in devs
               if e.get("cat") == "kernel"
               and T.op_kind(e.get("name", "")).split("::")[-1] in names)


def idle_pct(view):
    span = view.span[1] - view.span[0]
    if span <= 0 or not view.devs:
        return None
    return 100.0 * (1.0 - T.busy_us(view.devs, view.span) / span)


def mfu(view, kind):
    """Model FLOPs a step times the steps of the stack-less profiled
    stretch, over its wall time and the dtype's peak, in %."""
    from portbench.lib.work import PEAK_FLOPS
    w = view.work
    span_s = (view.span[1] - view.span[0]) / 1e6
    if w["kind"] != kind or span_s <= 0 or not view.devs:
        return None
    return (100.0 * w["step_flops"]() * view.steps / span_s
            / PEAK_FLOPS[w["dtype"]])


def roofline_pct(view, sites_key, names):
    """Sum of the sites' bounds over the device time of their kernels, per
    step."""
    from portbench.lib.work import bound_s
    w = view.work
    if sites_key not in w:
        return None
    us = kernel_us(view.devs, names)
    if us <= 0:
        return None
    return 100.0 * bound_s(w[sites_key](), w["dtype"]) / (us / 1e6
                                                          / view.steps)

