"""loop_idle_ms: device-idle ms per step of the stack-less stretch in
which the loop's thread is in `seg::next_batch`, `seg::cast`,
`seg::loss_sync` or `seg::log`, or in no leaf span of the step: the
bubble the loop makes around each step (the loss readback, logging, the
batch hand-off)."""
from portbench.metrics._spans import idle_split


def read(view):
    split = idle_split(view)
    return None if split is None else split[0] / 1e3 / view.steps
