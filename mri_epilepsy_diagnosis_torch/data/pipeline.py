"""Host-side input pipeline: batching, the patch queue, and host ->
device staging (counterpart of the JAX package's `data/pipeline.py`).

Replaces torch `DataLoader`/`Subset` and the torchio patch `Queue`
(`segmentation/routine.py:97-183`) with the JAX package's host-side numpy
versions, so that the port yields the same arrays in the same order for
the same seed: the heavy math runs on the device (see `transforms/`), and
the host keeps to NIfTI decode and collate, overlapped with device compute
by `PatchQueue`'s background thread and `DevicePrefetcher`.

Volumes arrive from datasets as channel-first numpy `(C, D, H, W)` (the
reference's layout); collate produces channels-last `(N, D, H, W, C)`
batches, the device layout.
"""
from __future__ import annotations

import collections
import concurrent.futures
import queue
import threading
from typing import Callable, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..obs import span
from ..parallel.sharding import local_shard


def _to_channels_last(vol: np.ndarray) -> np.ndarray:
    return np.moveaxis(vol, 0, -1)


def default_collate(batch):
    """list of tuples -> tuple of stacked arrays; volumes (C, D, H, W)
    become channels-last; integer labels become int32 vectors."""
    first = batch[0]
    if isinstance(first, np.ndarray):
        if first.ndim == 4:
            return np.stack([_to_channels_last(b) for b in batch])
        return np.stack(batch)
    if isinstance(first, (tuple, list)):
        return tuple(default_collate([b[i] for b in batch])
                     for i in range(len(first)))
    return np.asarray(batch, dtype=np.int32 if isinstance(
        first, (int, np.integer)) else None)


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        # surface labels for stratification helpers
        if hasattr(dataset, "target"):
            self.target = np.asarray(dataset.target)[self.indices]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]


class DataLoader:
    """Minimal torch-DataLoader equivalent: batch, optional shuffle (numpy
    `default_rng(seed)`, one permutation per pass), drop_last, custom
    collate, per-sample transform."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False,
                 collate_fn: Callable = default_collate,
                 transform: Optional[Callable] = None, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.transform = transform
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        for start in range(0, len(idx), self.batch_size):
            sel = idx[start:start + self.batch_size]
            if self.drop_last and len(sel) < self.batch_size:
                break
            items = [self.dataset[int(i)] for i in sel]
            if self.transform is not None:
                items = [self.transform(it) for it in items]
            yield self.collate_fn(items)


class PatchQueue:
    """torchio.Queue-equivalent random-patch sampler.

    Loads whole subjects (optionally transformed), samples
    `samples_per_volume` random patches of `patch_size` per subject
    (uniform locations, torchio's ImageSampler), keeps up to `max_length`
    patches buffered, optionally shuffling subjects and patches
    (`segmentation/routine.py:150-178` semantics).  A background thread
    keeps the buffer full so that the device does not wait on NIfTI
    decode; `num_workers > 1` also overlaps that many subject loads.  One
    numpy generator drives every draw in one order, whatever
    `num_workers` is, so the patches are those of the JAX package.
    """

    def __init__(self, subjects_dataset, max_length: int = 180,
                 samples_per_volume: int = 6, patch_size: int = 64,
                 shuffle_subjects: bool = True, shuffle_patches: bool = True,
                 transform: Optional[Callable] = None, seed: int = 0,
                 num_workers: int = 1):
        self.dataset = subjects_dataset
        self.max_length = max_length
        self.samples_per_volume = samples_per_volume
        self.patch_size = (patch_size if isinstance(patch_size, tuple)
                           else (patch_size,) * 3)
        self.shuffle_subjects = shuffle_subjects
        self.shuffle_patches = shuffle_patches
        self.transform = transform
        self.num_workers = num_workers
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.dataset) * self.samples_per_volume

    def _sample_patches(self, img, seg):
        """img/seg: (C, D, H, W) -> list of (patch_img, patch_seg)."""
        _, d, h, w = img.shape
        pd, ph, pw = self.patch_size
        out = []
        for _ in range(self.samples_per_volume):
            i = self.rng.integers(0, max(d - pd, 0) + 1)
            j = self.rng.integers(0, max(h - ph, 0) + 1)
            k = self.rng.integers(0, max(w - pw, 0) + 1)
            out.append((img[:, i:i + pd, j:j + ph, k:k + pw],
                        seg[:, i:i + pd, j:j + ph, k:k + pw]))
        return out

    def _load(self, si: int):
        item = self.dataset[int(si)]
        if self.transform is not None:
            item = self.transform(item)
        img, seg = item
        return np.asarray(img), np.asarray(seg)

    def _produce(self):
        """Generator of patches in the order of the synchronous loop (one
        RNG, one consumer order: deterministic)."""
        order = np.arange(len(self.dataset))
        if self.shuffle_subjects:
            self.rng.shuffle(order)
        order_it = iter(order)
        pool = None
        if self.num_workers > 1:
            # subject decode is the slow host step: overlap several loads
            # while sampling stays in this thread (deterministic RNG
            # order), with the loads in flight bounded so that a slow
            # consumer does not pull the whole dataset into memory
            pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.num_workers)
            pending: collections.deque = collections.deque()

            def get():
                while len(pending) < self.num_workers + 1:
                    try:
                        pending.append(pool.submit(self._load,
                                                   next(order_it)))
                    except StopIteration:
                        break
                return pending.popleft().result()
        else:
            def get():
                return self._load(next(order_it))

        try:
            buffer = []
            for _ in range(len(order)):
                img, seg = get()
                buffer.extend(self._sample_patches(img, seg))
                while len(buffer) >= self.max_length:
                    if self.shuffle_patches:
                        self.rng.shuffle(buffer)
                    while buffer:
                        yield buffer.pop()
            if self.shuffle_patches:
                self.rng.shuffle(buffer)
            while buffer:
                yield buffer.pop()
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self):
        """Patches come from a background thread through a bounded queue,
        so that subject decode and patch sampling overlap the consumer's
        device steps (the torchio `Queue(num_workers=cpu_count())` role,
        `segmentation/routine.py:158,169`).  `num_workers=0` keeps the
        synchronous in-thread path."""
        if self.num_workers <= 0:
            yield from self._produce()
            return

        q: queue.Queue = queue.Queue(maxsize=max(2 * self.max_length, 16))
        end, err = object(), object()

        def producer():
            try:
                for patch in self._produce():
                    q.put(patch)
                q.put(end)
            except BaseException as e:  # surface load errors to the consumer
                q.put((err, e))

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] is err:
                raise item[1]
            yield item


class batched:
    """Batch a streaming iterable (a PatchQueue) without materializing it:
    the torch `DataLoader(queue, batch_size=...)` role for iterables.
    Re-iterable as long as the underlying iterable is (PatchQueue starts
    a fresh producer pass per `__iter__`, so epoch loops just work)."""

    def __init__(self, iterable: Iterable, batch_size: int,
                 collate_fn: Callable = default_collate,
                 drop_last: bool = False):
        self.iterable = iterable
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.drop_last = drop_last

    def __iter__(self):
        buf = []
        for item in self.iterable:
            buf.append(item)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)


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

    On CUDA each host tensor of a batch is copied from pinned host memory
    with a non-blocking copy on a side stream; the consumer's current
    stream waits on the copy's event before it may use the batch, so
    uploads overlap the consumer's kernels.  A tensor already on the
    target device (a collate that standardizes on the card) passes
    through as it is.  On the CPU the batch is used as it is.

    `sharding` (a `core.mesh.Sharding`) stages only this rank's shard of
    each global batch: its rows, and its D slab of 5-D volumes.

    Under `obs.profile_trace` the producer's thread shows `data::draw`
    (the host iterator's `next`), `data::stage` (pinning and enqueueing
    the copies) and `data::queue_full` (waiting for room in the queue).
    """

    _END = object()
    _ERR = object()

    def __init__(self, iterator: Iterable, size: int = 2,
                 device: Optional[Union[str, torch.device]] = None,
                 sharding=None):
        self.device = (sharding.mesh.device
                       if sharding is not None and device is None
                       else resolve_device(device))
        self._sharding = sharding
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self.exhausted = False
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        t = threading.Thread(target=self._produce, args=(iterator,),
                             daemon=True)
        t.start()

    def _stage(self, batch):
        batch = _to_tensor(batch)
        if self._sharding is not None:
            batch = _map(batch, lambda t: local_shard(
                t, self._sharding).contiguous())
        if self._stream is None:
            return _map(batch, lambda t: t.to(self.device)), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            staged = _map(batch, self._upload)
            done = torch.cuda.Event()
            done.record(self._stream)
        return staged, done

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        if t.device == self.device:
            return t
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _produce(self, iterator):
        try:
            iterator = iter(iterator)
            while True:
                with span("data::draw"):
                    batch = next(iterator, self._END)
                if batch is self._END:
                    break
                with span("data::stage"):
                    item = self._stage(batch)
                try:
                    self._q.put_nowait(item)
                except queue.Full:
                    with span("data::queue_full"):
                        self._q.put(item)
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


def prefetch_to_device(iterator: Iterable, size: int = 2, sharding=None,
                       device: Optional[Union[str, torch.device]] = None):
    """Overlap host batch preparation with device compute: a generator of
    the batches of `iterator` staged `size` ahead on `device` by a worker
    thread (`DevicePrefetcher`), or this rank's shards of them under
    `sharding` (on the mesh's device)."""
    pf = DevicePrefetcher(iterator, size=size, device=device,
                          sharding=sharding)
    while True:
        item = pf.get()
        if item is None:
            return
        yield item
