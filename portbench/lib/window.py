"""The measured window of a run, driven by the program's own per-step
logging call, and the profiled stretches inside it.

The loop under test calls its `experiment` logger once per completed
step (`run_epoch` after `float(loss)`, so the card has finished the
step).  `StepLogger` is that logger:
each call is a step boundary on the host clock.  The window opens at the
end of the last warm-up step and closes at the first boundary past
`seconds` later; the feeds stop drawing when it has closed.  Callbacks
keyed by step number let a driver read the program's state at set-up
steps (the steps the reference follows).
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from .trace import STRETCH


class Window:
    def __init__(self, seconds: float, warmup_steps: int,
                 profiler: Optional["Stretches"] = None):
        self.seconds = float(seconds)
        self.warmup_steps = int(warmup_steps)
        self.profiler = profiler
        self.callbacks: Dict[int, Callable[[], None]] = {}
        self.steps = 0
        self.t0: Optional[float] = None
        self.deadline: Optional[float] = None
        self.t_last: Optional[float] = None
        self.step_s: List[float] = []
        self._t_prev: Optional[float] = None

    def closed(self) -> bool:
        """True once the window has run its length (the feeds stop)."""
        return (self.deadline is not None
                and time.perf_counter() >= self.deadline)

    def tick(self) -> None:
        t = time.perf_counter()
        self.steps += 1
        # the window's steps run up to the first boundary past its length,
        # so a run always times at least one whole step
        if self.t0 is not None and (self.t_last is None
                                    or self.t_last < self.deadline):
            self.step_s.append(t - self._t_prev)
            self.t_last = t
        self._t_prev = t
        cb = self.callbacks.pop(self.steps, None)
        if cb is not None:
            cb()
        if self.steps == self.warmup_steps:
            self.t0 = self._t_prev = time.perf_counter()
            self.deadline = self.t0 + self.seconds
        if self.profiler is not None and self.t0 is not None:
            self.profiler.tick(self.steps - self.warmup_steps,
                               not self.closed())

    @property
    def n_steps(self) -> int:
        return len(self.step_s)

    @property
    def wall_s(self) -> float:
        """From the window's opening to the end of its last step."""
        return 0.0 if self.t_last is None else self.t_last - self.t0


class StepLogger:
    """The comet-style `experiment` the loops call once per step."""

    def __init__(self, window: Window):
        self.window = window
        self.values: List[dict] = []

    def log_metric(self, name, value, step=None):
        self.values.append({name: float(value)})
        self.window.tick()

    def log_metrics(self, metrics, epoch=None, step=None):
        self.values.append({k: float(v) for k, v in metrics.items()})
        self.window.tick()

    def log_epoch_end(self, epoch):
        pass

    def set_name(self, name):
        pass


class Stretches:
    """Profiles short stretches of `steps` steps inside the window: first
    at window step `start` without Python stacks, then with them, and the
    same pair again, so that a stretch whose kernel records the profiler
    dropped has a second chance.  Each trace goes to a temporary file and
    is read after the window."""

    KINDS = ("plain", "stack", "plain", "stack")

    def __init__(self, start: int, steps: int, gap: int = 2):
        self.steps = steps
        self.starts = [start + i * (steps + gap) for i in range(4)]
        self.dir = tempfile.mkdtemp(prefix="portbench_trace_")
        self.files: List[tuple] = []
        self._prof = None
        self._mark = None
        self._i = 0

    def tick(self, window_step: int, open_: bool) -> None:
        if self._prof is not None and window_step == (
                self.starts[self._i] + self.steps):
            self._stop()
        if (self._prof is None and self._i < len(self.starts) and open_
                and window_step == self.starts[self._i]):
            self._start()

    def _start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts,
                             with_stack=self.KINDS[self._i] == "stack")
        self._prof.start()
        self._mark = torch.profiler.record_function(STRETCH)
        self._mark.__enter__()

    def _stop(self):
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        path = os.path.join(self.dir, f"{self._i}.json")
        self._prof.export_chrome_trace(path)
        self.files.append((self.KINDS[self._i], path))
        self._prof = self._mark = None
        self._i += 1

    def close(self):
        if self._prof is not None:
            self._mark.__exit__(None, None, None)
            self._prof.stop()
            self._prof = self._mark = None

    def cleanup(self):
        for _, path in self.files:
            if os.path.exists(path):
                os.remove(path)
        os.rmdir(self.dir)
