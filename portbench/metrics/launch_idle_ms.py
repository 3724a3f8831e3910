"""launch_idle_ms: device-idle ms per step of the stack-less stretch in
which the loop's thread is in `seg::forward`, `seg::backward`,
`seg::optimizer` or `seg::stats`: the host (autograd's thread included)
issuing the step's launches slower than the card runs them.  With
`loop_idle_ms` it adds up to the stretch's idle time over its steps."""
from portbench.metrics._spans import idle_split


def read(view):
    split = idle_split(view)
    return None if split is None else split[1] / 1e3 / view.steps
