"""launch_idle_ms.voxres: device-idle ms per step of the stack-less
stretch in which the classification loop's thread is in `cls::forward`,
`cls::backward`, `cls::optimizer` or `cls::stats`: the host (autograd's
thread included) issuing the step's launches slower than the card runs
them.  With `loop_idle_ms.voxres` it adds up to the stretch's idle time
over its steps."""
from portbench.metrics._cls_spans import idle_split


def read(view):
    split = idle_split(view)
    return None if split is None else split[1] / 1e3 / view.steps
