"""batch_wait_ms: host ms per step of the stack-less stretch that the
loop's thread spends in `seg::next_batch`, taking the next staged batch
from the prefetcher: input starvation when the prefetcher falls
behind."""
from portbench.metrics._spans import LAUNCH, LOOP, spans


def read(view):
    if not spans(view, LAUNCH + LOOP):
        return None
    return sum(b - a for a, b in spans(view, ("seg::next_batch",))) \
        / 1e3 / view.steps
