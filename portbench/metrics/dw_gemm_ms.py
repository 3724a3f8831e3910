"""dw_gemm_ms: device ms per training step of the kernels launched
inside `ops/packed.py::_dw_packed_qgroup` (the packed convs' weight
gradients as GEMMs), tied to that Python frame through the trace's
correlation ids; read from the stretch profiled with Python stacks."""
from portbench.lib import trace as T

FRAME = "): _dw_packed_qgroup"


def read(view):
    if view.work["kind"] != "train" or not view.stack:
        return None
    inside = T.launched_within(view.stack, FRAME)
    if not inside:
        return None
    devs = T.device_events(view.stack, view.stack_span)
    us = sum(float(e.get("dur", 0.0)) for e in devs
             if e.get("args", {}).get("correlation") in inside)
    return us / 1e3 / view.steps
