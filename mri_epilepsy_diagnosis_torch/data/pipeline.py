"""Host -> device staging of batches (counterpart of the JAX package's
`data/pipeline.py::DevicePrefetcher`)."""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device


def _to_tensor(item):
    if isinstance(item, tuple):
        return tuple(_to_tensor(i) for i in item)
    return item if isinstance(item, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(item))


def _map(item, fn):
    if isinstance(item, tuple):
        return tuple(_map(i, fn) for i in item)
    return fn(item)


class DevicePrefetcher:
    """Background-thread staging of host batches (numpy arrays, tensors, or
    tuples of them) as tensors on `device`.

    ``get()`` blocks for the next staged batch and returns ``None`` once the
    input iterator is exhausted.  ``get(block=False)`` also returns ``None``
    when the producer has not staged a batch yet; ``exhausted`` tells the
    two apart.  Producer-side exceptions re-raise in the consumer.

    On CUDA each batch is copied from pinned host memory with a
    non-blocking copy on a side stream; the consumer's current stream waits
    on the copy's event before it may use the batch, so uploads overlap the
    consumer's kernels.  On the CPU the batch is used as it is.
    """

    _END = object()
    _ERR = object()

    def __init__(self, iterator: Iterable, size: int = 2,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self.exhausted = False
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        t = threading.Thread(target=self._produce, args=(iterator,),
                             daemon=True)
        t.start()

    def _stage(self, batch):
        batch = _to_tensor(batch)
        if self._stream is None:
            return _map(batch, lambda t: t.to(self.device)), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            staged = _map(batch, lambda t: t.pin_memory().to(
                self.device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(self._stream)
        return staged, done

    def _produce(self, iterator):
        try:
            for batch in iterator:
                self._q.put(self._stage(batch))
            self._q.put(self._END)
        except BaseException as e:  # propagate host-side failures to consumer
            self._q.put((self._ERR, e))

    def get(self, block: bool = True):
        if self.exhausted:
            return None
        try:
            item = self._q.get(block=block)
        except queue.Empty:
            return None
        if item is self._END:
            self.exhausted = True
            return None
        if item[0] is self._ERR:
            self.exhausted = True
            raise item[1]
        batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            # the side stream allocated these tensors: tell the caching
            # allocator the consumer's stream uses them too
            _map(batch, lambda t: t.record_stream(consumer))
        return batch
