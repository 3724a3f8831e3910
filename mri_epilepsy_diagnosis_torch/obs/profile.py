"""Profiling hooks: `torch.profiler` traces and per-step wall timing
(counterpart of the JAX package's `obs/profile.py`).

`profile_trace` records host ops (with their input shapes and the Python
stack) on every thread and, on the card, CUDA kernels and copies, and
writes one gzipped Chrome trace,
`<logdir>/<host>_<pid>.<ts>.pt.trace.json.gz`, that `obs/trace_summary.py`
reads.  `span(name)` names a stretch of host time in such a trace (the
segmentation loop's `seg::`, the classification loop's `cls::` and the
prefetcher's `data::` spans) and costs one flag check when no profiler
records.  `StepTimer` waits for the card before reading the clock, so its
times are step latencies, not enqueue times.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from ..core.device import resolve_device


@contextlib.contextmanager
def profile_trace(logdir: str, device=None):
    """Profile the enclosed block into a trace under `logdir`; yields the
    `torch.profiler.profile` object (its `key_averages()` cover the same
    window).  Every thread is recorded, those started before the block
    too (the prefetcher's producer).  `device` as
    `core.device.resolve_device`: None is the card (CUDA activity recorded
    beside the host's), `device="cpu"` traces the host alone."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA]
        if resolve_device(device).type == "cuda" else [])
    with profile(activities=activities, record_shapes=True, with_stack=True,
                 experimental_config=torch._C._profiler._ExperimentalConfig(
                     profile_all_threads=True),
                 on_trace_ready=tensorboard_trace_handler(
                     logdir, use_gzip=True)) as prof:
        yield prof


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """`with span("seg::forward"): ...` records the block as a
    `user_annotation` range named `name` in the trace of a torch profiler
    recording when the block starts (`profile_trace`, or another
    `torch.profiler.profile`), on the thread that runs it and on the
    kernels' clock; otherwise it does nothing but check whether one
    records.  A range it entered ends with the block, or at the
    profiler's stop if that comes first; a profiler started inside the
    block records no range for it."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StepTimer:
    """Accumulates per-step wall times.  `stop(*tensors)` synchronizes the
    CUDA device of every CUDA tensor it is given (the counterpart of
    `jax.block_until_ready`) before it reads the clock."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *sync_tensors):
        for device in {t.device for t in sync_tensors
                       if isinstance(t, torch.Tensor) and t.is_cuda}:
            torch.cuda.synchronize(device)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self):
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def total(self):
        return float(np.sum(self.times))
