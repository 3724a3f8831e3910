"""Profiling hooks: `torch.profiler` traces and per-step wall timing
(counterpart of the JAX package's `obs/profile.py`).

`profile_trace` records host ops (with their input shapes and the Python
stack) and, on the card, CUDA kernels and copies, and writes one gzipped
Chrome trace, `<logdir>/<host>_<pid>.<ts>.pt.trace.json.gz`, that
`obs/trace_summary.py` reads.  `StepTimer` waits for the card before
reading the clock, so its times are step latencies, not enqueue times.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..core.device import resolve_device


@contextlib.contextmanager
def profile_trace(logdir: str, device=None):
    """Profile the enclosed block into a trace under `logdir`; yields the
    `torch.profiler.profile` object (its `key_averages()` cover the same
    window).  `device` as `core.device.resolve_device`: None is the card
    (CUDA activity recorded beside the host's), `device="cpu"` traces the
    host alone."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA]
        if resolve_device(device).type == "cuda" else [])
    with profile(activities=activities, record_shapes=True, with_stack=True,
                 on_trace_ready=tensorboard_trace_handler(
                     logdir, use_gzip=True)) as prof:
        yield prof


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
