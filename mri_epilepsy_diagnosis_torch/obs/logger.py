"""Metric logging with a comet-compatible interface (counterpart of the JAX
package's `obs/logger.py`, record for record).

The reference logs through comet.ml `Experiment` objects
(`classification/routine.py:42-48`, `segmentation/routine.py:283-287`).
Here the same call surface (`log_metric`, `log_metrics`, `log_epoch_end`,
`set_name`) writes JSONL locally, with no credentials in code.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class NullLogger:
    def log_metric(self, name, value, step=None):
        pass

    def log_metrics(self, metrics, epoch=None, step=None):
        pass

    def log_epoch_end(self, epoch):
        pass

    def set_name(self, name):
        pass


class JsonlLogger(NullLogger):
    """One JSON record a line, appended to `path`; every record carries
    `ts` (the host clock) and, once `set_name` was called, `experiment`."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._name = None
        self._step = 0

    def _write(self, record: dict):
        record.setdefault("ts", time.time())
        if self._name:
            record.setdefault("experiment", self._name)
        self._f.write(json.dumps(record) + "\n")

    def log_metric(self, name, value, step=None):
        self._step += 1
        self._write({"metric": name, "value": float(value),
                     "step": step if step is not None else self._step})

    def log_metrics(self, metrics, epoch=None, step=None):
        self._write({"metrics": {k: float(v) for k, v in metrics.items()},
                     "epoch": epoch, "step": step})

    def log_epoch_end(self, epoch):
        self._write({"event": "epoch_end", "epoch": epoch})

    def set_name(self, name):
        self._name = name

    def close(self):
        self._f.close()


def Experiment(project_name: Optional[str] = None,
               workspace: Optional[str] = None,
               api_key: Optional[str] = None, log_dir: str = "logs"):
    """comet_ml.Experiment-compatible constructor returning a local logger
    that writes `<log_dir>/<project_name>-<unix time>.jsonl`."""
    del workspace, api_key
    fname = f"{project_name or 'experiment'}-{int(time.time())}.jsonl"
    return JsonlLogger(os.path.join(log_dir, fname))
