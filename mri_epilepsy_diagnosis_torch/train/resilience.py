"""Failure detection and elastic recovery for long training runs
(counterpart of the JAX package's `train/resilience.py`), around the one
epoch loop `train/seg.py::_train_loop`:

- **atomic rolling checkpoints** (`CheckpointManager`): write-then-rename,
  so a kill mid-save never corrupts the newest checkpoint; keep-last-k
  pruning; newest-checkpoint discovery for restarts; the scheduler's state
  rides in the checkpoint's extras.  It also finds and reads checkpoints
  that the JAX package's manager wrote (`train/checkpoint.py`).
- **auto-resume**: rerunning the same call after a kill continues the run,
  with the epoch, model, optimizer state and the LR scheduler's state.
- **failure detection and rollback**: a non-finite train or validation
  epoch loss rolls the state back to the last good checkpoint; repeated
  failures abort.
- **graceful preemption**: SIGTERM/SIGINT latch a stop flag; the loop
  checkpoints and returns at the next epoch boundary.
"""
from __future__ import annotations

import glob
import os
import re
import signal
from typing import Optional

from .checkpoint import load_checkpoint, load_checkpoint_extra, save_checkpoint
from .state import TrainState


class CheckpointManager:
    """Rolling, atomically written checkpoints `{stem}_epoch_{N}.ckpt`."""

    def __init__(self, directory: str, stem: str = "run", keep: int = 3):
        self.directory = directory
        self.stem = stem
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{self.stem}_epoch_{epoch}.ckpt")

    def _epochs(self):
        pat = re.compile(rf"{re.escape(self.stem)}_epoch_(\d+)\.ckpt$")
        out = []
        for p in glob.glob(os.path.join(
                glob.escape(self.directory),
                f"{glob.escape(self.stem)}_epoch_*.ckpt")):
            m = pat.search(os.path.basename(p))
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, state: TrainState, epoch: int, **extra) -> str:
        """Atomic: serialize to `.tmp`, then `os.replace` into place."""
        path = self._path(epoch)
        tmp = path + ".tmp"
        save_checkpoint(tmp, state, epoch=epoch, **extra)
        os.replace(tmp, path)
        for old in self._epochs()[:-self.keep]:
            try:
                os.remove(self._path(old))
            except OSError:
                pass
        return path

    def latest_epoch(self) -> Optional[int]:
        eps = self._epochs()
        return eps[-1] if eps else None

    def load_extra(self, epoch: int) -> dict:
        """The extra payload (e.g. {'scheduler': ...}) of epoch's ckpt."""
        return load_checkpoint_extra(self._path(epoch))

    def restore_latest(self, state: TrainState):
        """-> (state, epoch) from the newest checkpoint, or (state, 0)."""
        epoch = self.latest_epoch()
        if epoch is None:
            return state, 0
        return load_checkpoint(self._path(epoch), state), epoch


class _PreemptionGuard:
    """Latches SIGTERM/SIGINT; the training loop polls `stop_requested` at
    epoch boundaries and checkpoints before returning."""

    def __init__(self):
        self.stop_requested = False
        self._old = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread: poll-only mode
                pass
        return self

    def _handler(self, signum, frame):
        self.stop_requested = True

    def __exit__(self, *exc):
        for sig, old in self._old.items():
            signal.signal(sig, old)
        return False


def train_segmentation_resilient(
        num_epochs: int, training_loader, validation_loader,
        state: TrainState, scheduler, manager: CheckpointManager,
        experiment=None, verbose: bool = True, sharding=None,
        packed=False, max_failures: int = 3, dashboard=None,
        input_dtype=None):
    """`train_segmentation` in elastic mode (see the module docstring).

    Returns (state, train losses, val losses, completed_epoch); rerun the
    same call to continue after a kill.  `sharding` and `dashboard` are
    not ported yet and must be None (ROADMAP A11, A12)."""
    from .seg import _train_loop  # seg imports this module

    return _train_loop(
        num_epochs, training_loader, validation_loader, state, scheduler,
        weights_stem="", save_epoch=1, experiment=experiment, verbose=verbose,
        weights_dir="", sharding=sharding, dashboard=dashboard, packed=packed,
        manager=manager, max_failures=max_failures, input_dtype=input_dtype)
