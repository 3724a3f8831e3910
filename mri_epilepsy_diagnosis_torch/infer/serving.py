"""Continuously batched whole-brain inference: the serving path
(counterpart of the JAX package's `infer/serving.py`).

Volumes stream from the host through `DevicePrefetcher` (pinned memory, a
side-stream upload) into a per-batch step on the device; masks stream
back.  The step is a plain function under `torch.inference_mode()`.

With `sharding` (a `core.mesh.Sharding` of a process mesh) every batch is
split over the ``data`` axis: each rank stages and runs its rows, and the
masks (bit-packed or not) and probabilities are all-gathered, so every
rank yields the whole ordered stream, as one process does.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.mesh import Sharding
from ..data.pipeline import DevicePrefetcher
from ..parallel import sharding as _S


def _packbits_device(mask: torch.Tensor) -> torch.Tensor:
    """Binary (B, D, H, W) mask -> (B, D//8, H, W) uint8: bit i of byte j
    along D is voxel 8j+i (little-endian), so np.unpackbits(axis=1,
    bitorder='little') inverts it on the host.  Cuts the mask download
    8x."""
    m = mask.to(torch.uint8)
    out = None
    for i in range(8):
        part = m[:, i::8] << i
        out = part if out is None else out | part
    return out


def _unpackbits_host(packed: np.ndarray, d: int) -> np.ndarray:
    bits = np.unpackbits(np.asarray(packed), axis=1, bitorder="little")
    return bits[:, :d]


def _quantize_u8(v):
    """Host-side per-volume affine uint8 quantization: returns
    (uint8 volume, float32 [offset, scale]) with v ~ q * scale + offset.
    8 bits keep mask agreement >= 0.999 on T1w intensities."""
    v32 = np.asarray(v, np.float32)
    if v32 is v:                      # don't mutate the caller's buffer
        v32 = v32.copy()
    mn = float(v32.min())
    scale = (float(v32.max()) - mn) / 255.0
    if scale <= 0.0:
        scale = 1.0
    np.multiply(v32, 1.0 / scale, out=v32)
    v32 -= mn / scale
    np.rint(v32, out=v32)
    np.clip(v32, 0, 255, out=v32)
    return v32.astype(np.uint8), np.asarray([mn, scale], np.float32)


def _serving_step(apply_fn, classify_fn, dtype, device_preprocess, mask_fn,
                  pack_masks, transfer_quant):
    def step(params, batch):
        if transfer_quant == "uint8":
            # device-side dequant of the 8-bit transfer: per-volume affine
            # params ride alongside the batch (2 floats per volume)
            q, qp = batch
            aff = qp.reshape(qp.shape[0], 1, 1, 1, 1, 2)
            batch = q.float() * aff[..., 1] + aff[..., 0]
        if device_preprocess is not None:
            batch = device_preprocess(batch)
        x = batch.to(dtype)
        if mask_fn is not None:
            # mask_fn's output range is opaque here; pack_masks' binary
            # contract is the caller's to honour (packed_unet_mask_v2
            # enforces out_classes == 2 itself)
            mask = mask_fn(params, x).to(torch.uint8)
        else:
            logits = apply_fn(params, x)
            if pack_masks and logits.shape[-1] > 2:
                # >= 2 class ids would OR bits of different classes together
                # in the packed download: corrupt, so refuse
                raise ValueError(
                    f"pack_masks=True needs a binary mask, but apply_fn "
                    f"emits {logits.shape[-1]} classes; pass a binary "
                    f"mask_fn or pack_masks=False")
            mask = torch.argmax(logits, dim=-1).to(torch.uint8)
        out = {"mask": _packbits_device(mask) if pack_masks else mask}
        if classify_fn is not None:
            out["probs"] = torch.softmax(classify_fn(params, x).float(),
                                         dim=-1)
        return out

    return step


def _batched(iterator: Iterable, batch_size: int):
    """Batch volumes (or (volume, aux) tuples, the quantized-transfer form)
    into fixed-size stacks, zero-padding the final partial batch."""

    def stack(items, pad):
        if isinstance(items[0], tuple):
            return tuple(stack([it[i] for it in items], pad)
                         for i in range(len(items[0])))
        out = np.stack(items)
        if pad:
            out = np.concatenate(
                [out, np.zeros((pad,) + out.shape[1:], out.dtype)])
        return out

    buf = []
    for item in iterator:
        buf.append(item)
        if len(buf) == batch_size:
            yield stack(buf, 0), len(buf)
            buf = []
    if buf:
        yield stack(buf, batch_size - len(buf)), len(buf)


def segment_volumes(apply_fn: Optional[Callable], params, volumes: Iterable,
                    batch_size: int = 4, dtype=torch.bfloat16,
                    preprocess: Optional[Callable] = None,
                    classify_fn: Optional[Callable] = None,
                    device: Optional[Union[str, torch.device]] = None,
                    device_preprocess: Optional[Callable] = None,
                    transfer_dtype=None,
                    mask_fn: Optional[Callable] = None,
                    pack_masks: bool = False,
                    transfer_quant: Optional[str] = None,
                    sharding: Optional[Sharding] = None) -> Iterator[dict]:
    """Stream (D,H,W) or (D,H,W,1) volumes -> dicts with 'mask' (uint8
    numpy, (D,H,W)) and optionally 'probs' from a classifier head.

    apply_fn(params, batch) -> logits (B, D, H, W, classes).  With
    `mask_fn` given (e.g. `models.unet_packed.packed_unet_mask_v2`), the
    step calls mask_fn(params, batch) -> int mask instead of
    argmax(apply_fn(...)).  For eval-only serving pass
    `params = models.unet_packed.fold_bn_inference(state_dict)`.
    `params` must already live on `device`.

    `preprocess` runs per volume on the host before batching.
    `transfer_dtype` (e.g. np.int16) uploads volumes in their raw storage
    dtype; `device_preprocess(batch) -> float batch` (e.g. a per-volume
    `transforms.znormalization`) then normalizes on the device.  The two are
    exclusive: host preprocessing would re-widen the upload.

    `pack_masks=True` (binary masks only) packs 8 voxels per byte along D
    on the device and unpacks on the host; needs D % 8 == 0.

    `transfer_quant="uint8"` affine-quantizes each volume to 8 bits on the
    host (per-volume offset and scale ride along) and dequantizes on the
    device before `device_preprocess`.

    `device`: None is the current CUDA device (raises without one);
    "cpu" runs the whole path on the CPU.

    `sharding` (data-parallel serving) splits every batch over the mesh's
    ``data`` axis; `batch_size` must divide by that axis, `device`
    defaults to the mesh's, and `params` must be the same on every rank.
    Every rank yields every volume's result.
    """
    if transfer_dtype is not None and preprocess is not None:
        raise ValueError(
            "transfer_dtype and (host) preprocess are mutually exclusive: "
            "host preprocessing reverts the batch to float before transfer; "
            "use device_preprocess instead")
    if transfer_quant is not None:
        if transfer_quant != "uint8":
            raise ValueError(f"unknown transfer_quant {transfer_quant!r} "
                             "(supported: 'uint8')")
        if transfer_dtype is not None or preprocess is not None:
            raise ValueError(
                "transfer_quant replaces transfer_dtype and is incompatible "
                "with host preprocess (use device_preprocess)")
    rows = None
    if sharding is not None:
        mesh = sharding.mesh
        _S.check_shard_divisibility((batch_size,), mesh, "data")
        rows = Sharding(mesh, ("data",))
        if device is None:
            device = mesh.device
    device = resolve_device(device)

    def prepare(vol):
        if transfer_quant == "uint8":
            v = np.asarray(vol)
            if v.ndim == 3:
                v = v[..., None]
            return _quantize_u8(v)
        if transfer_dtype is not None:
            v = np.asarray(vol, transfer_dtype)
        else:
            v = np.asarray(vol, np.float32)
        if preprocess is not None:
            v = np.asarray(preprocess(v))
        if v.ndim == 3:
            v = v[..., None]
        return v

    step = _serving_step(apply_fn, classify_fn, dtype, device_preprocess,
                         mask_fn, pack_masks, transfer_quant)

    counts: list = []
    mask_w: list = []

    def producer():
        for arr, n in _batched((prepare(v) for v in volumes), batch_size):
            vol_arr = arr[0] if isinstance(arr, tuple) else arr
            if pack_masks and vol_arr.shape[1] % 8:
                raise ValueError(
                    f"pack_masks needs the D dim divisible by 8, got "
                    f"{vol_arr.shape[1]} (binary masks only, e.g. the "
                    f"2-class segmenter)")
            counts.append(n)
            mask_w.append(vol_arr.shape[1])
            yield arr

    def drain(out, n, w):
        mask = out["mask"].cpu().numpy()
        masks = _unpackbits_host(mask, w)[:n] if pack_masks else mask[:n]
        probs = (out["probs"].cpu().numpy()[:n]
                 if classify_fn is not None else None)
        for i in range(n):
            yield {"mask": masks[i],
                   **({"probs": probs[i]} if probs is not None else {})}

    # One-deep result pipeline: when the next batch is already staged,
    # launch its step (asynchronous on CUDA) BEFORE the previous step's
    # host readback, so the mask download overlaps the next batch's
    # compute.  When the producer has NOT staged the next batch yet, flush
    # the finished results at once instead of withholding them until more
    # traffic arrives.
    staged = DevicePrefetcher(producer(), size=2, device=device,
                              sharding=rows)
    pending = None
    try:
        while True:
            batch = staged.get(block=False)
            if batch is None and not staged.exhausted:
                if pending is not None:
                    yield from drain(*pending)
                    pending = None
                batch = staged.get()
            if batch is None:
                break
            n, w = counts.pop(0), mask_w.pop(0)
            with torch.inference_mode():
                out = step(params, batch)
                if rows is not None:
                    out = {k: _S.gather(v, rows) for k, v in out.items()}
            if pending is not None:
                yield from drain(*pending)
            pending = (out, n, w)
    except Exception:
        # a producer-side error (bad volume, preprocess failure) must not
        # discard the already-computed batch parked in `pending`
        if pending is not None:
            out, n, w = pending
            pending = None
            yield from drain(out, n, w)
        raise
    if pending is not None:
        yield from drain(*pending)
