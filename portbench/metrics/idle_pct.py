"""idle_pct: the share of the profiled stretch in which no kernel, copy
or memset ran on the card, in %."""
from portbench.metrics._common import idle_pct


def read(view):
    if view.work["kind"] != "train":
        return None
    return idle_pct(view)
