"""Native (C++) host-side components, built on demand with g++ and loaded
through ctypes (counterpart of the JAX package's `native/`).

- `edt3d`: exact anisotropic euclidean distance transform, the hot host
  op of the surface-distance metrics (`metrics/surface.py`).  Falls back
  to `scipy.ndimage.distance_transform_edt` when no compiler is available.

`edt.cc` is compiled at first use into `build/native/<hash of the
source, the flags and the host CPU>/` beside the CUDA kernels'
`build/torch_kernels/`; nothing is built at import time.  The CPU is in
the key because `-march=native` builds for the CPU at hand, and a copied
checkout may land on another.  `edt3d.native_calls` counts the calls
that ran the native transform, so a run can show that it was built and
used.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "edt.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LIB_NAME = "libmri_native.so"


def _cpu_id() -> bytes:
    """The host CPU's architecture and feature flags (Linux), the part of
    the build key that `-march=native` depends on."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            flags = next((line for line in f if line.startswith(b"flags")),
                         b"")
    except OSError:
        flags = b""
    return platform.machine().encode() + flags


def build() -> Path:
    """Compile `edt.cc` (if this version has not been built yet) and return
    the shared library's path.  Concurrent builds each write a temporary
    file and rename it into place."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_id())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)], check=True,
                       capture_output=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once; None when g++ is missing or
    fails."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    lib.edt3d.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.edt3d.restype = None
    return lib


def native_available() -> bool:
    return _load() is not None


def edt3d(mask, spacing=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Euclidean distance (physical units) from every voxel to the nearest
    nonzero voxel of a 3-D mask, i.e.
    `scipy.ndimage.distance_transform_edt(mask == 0, sampling=spacing)`;
    inf everywhere for an empty mask."""
    mask = np.ascontiguousarray(np.asarray(mask, dtype=np.uint8))
    if mask.ndim != 3:
        raise ValueError(f"edt3d expects a 3-D mask, got shape {mask.shape}")
    lib = _load()
    if lib is None:
        from scipy import ndimage
        if not mask.any():
            return np.full(mask.shape, np.inf)
        return ndimage.distance_transform_edt(mask == 0, sampling=spacing)
    d, h, w = mask.shape
    out = np.empty((d, h, w), np.float64)
    sp = np.ascontiguousarray(np.asarray(spacing, np.float64))
    if sp.shape != (3,):
        raise ValueError(f"edt3d expects 3 spacings, got {sp.shape}")
    lib.edt3d(mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
              d, h, w, sp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
              out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    edt3d.native_calls += 1
    return out


edt3d.native_calls = 0
