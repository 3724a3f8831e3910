"""The port's hand-written Hopper kernels, their plain PyTorch versions,
launch counters and build.

| kernel              | source                    | replaces (JAX package)                    |
|---------------------|---------------------------|-------------------------------------------|
| `conv2_packed`      | `csrc/conv2_packed.cu`    | `ops/pallas_kernels.py::conv2_packed_pallas` |
| `bn_act_zero_pads`  | `csrc/bn_act_zero_pads.cu`| `ops/pallas_kernels.py::bn_act_zero_pads` |
| `conv_axis`         | `csrc/conv_axis.cu`       | `ops/pallas_kernels.py::conv_axis_last`   |

`conv_one_axis` and `separable_conv3d` keep the signatures of their JAX
namesakes (without the Mosaic workarounds `interpret` and `max_taps`) and
run every one-axis conv through `conv_axis`.

Each wrapper takes a CPU tensor through the kernel's plain version and a
CUDA tensor through the kernel, or raises: there is no fallback from one
to the other.  `<wrapper>.launches` counts kernel launches, so a run can
show that its main path went through the kernels.

The kernels are CUDA C++ for `sm_90a` with a plain C interface, compiled
by `nvcc` at first use (one process per source, all started together) and
linked into one shared library under `build/torch_kernels/<hash of the
sources>/`, which is loaded with `ctypes`.  Nothing is built or loaded at
import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.nn.functional as TF

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("conv2_packed.cu", "bn_act_zero_pads.cu", "conv_axis.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libmri_torch_kernels.so"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc")
    return found


def _source_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this version of the sources has not been
    built yet) and return the shared library's path.  The compiler's
    output, register and shared-memory use included, is kept beside it in
    `build.log`."""
    out_dir = BUILD_ROOT / _source_digest()
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs = [tmp / (Path(src).stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(SRC_DIR / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
        failed = [src for src, p in zip(SOURCES, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for o in objs], "-o",
             str(tmp / _LIB_NAME)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        logs.append(link.stdout.decode(errors="replace"))
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        (out_dir / "build.log").write_text("\n".join(logs))
        os.replace(tmp / _LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, once."""
    lib = ctypes.CDLL(str(build()))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mri_conv2_packed.argtypes = [vp, vp, vp, vp, i, ll, i, i, i, i, i, i,
                                     i, i, i, vp]
    lib.mri_conv2_packed.restype = i
    lib.mri_bn_act_zero_pads.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i,
                                         ll, i, i, i, i, vp]
    lib.mri_bn_act_zero_pads.restype = i
    lib.mri_conv_axis.argtypes = [vp, vp, vp, vp, i, ll, i, i, ll, i, i, i,
                                  i, i, vp]
    lib.mri_conv_axis.restype = i
    return lib


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {rc}")


# ---------------------------------------------------------------------------
# B1: k=2 packed conv
# ---------------------------------------------------------------------------


def conv2_packed_plain(x: torch.Tensor, wp: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       pad: int = 0) -> torch.Tensor:
    """Plain version of `conv2_packed`: the sum of the 8 shifted-slice
    products, accumulated in float32, bias added, one cast to x.dtype."""
    if pad:
        x = TF.pad(x, (0, 0) + (1, 1) * 3)
    d, h, w = (s - 1 for s in x.shape[1:4])
    wf = wp.float()
    out = None
    for qd in range(2):
        for qh in range(2):
            for qw in range(2):
                part = torch.matmul(
                    x[:, qd:qd + d, qh:qh + h, qw:qw + w].float(),
                    wf[qd, qh, qw])
                out = part if out is None else out.add_(part)
    if bias is not None:
        out.add_(bias.float())
    return out.to(x.dtype)


def conv2_packed(x: torch.Tensor, wp: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 pad: int = 0) -> torch.Tensor:
    """k=2 packed conv: `out[n,z,y,x] = bias + Σ_q xin[n,z+qd-pad,y+qh-pad,
    x+qw-pad] @ wp[q]`, xin zero outside its extent.

    x: (N, Di, Hi, Wi, 8Ci) float32 or bfloat16; wp: (2, 2, 2, 8Ci, 8Co) in
    x's dtype; bias: (8Co,) or None, added in float32 before the one
    rounding to x's dtype.  pad=0: shifted -> aligned, output
    (N, Di-1, Hi-1, Wi-1, 8Co); pad=1: aligned -> shifted, output
    (N, Di+1, Hi+1, Wi+1, 8Co)."""
    if x.ndim != 5 or wp.ndim != 5 or tuple(wp.shape[:3]) != (2, 2, 2):
        raise ValueError(f"conv2_packed needs x (N,D,H,W,C8i) and wp "
                         f"(2,2,2,C8i,C8o); got {tuple(x.shape)}, "
                         f"{tuple(wp.shape)}")
    n, di, hi, wi, c8i = x.shape
    c8o = wp.shape[4]
    if wp.shape[3] != c8i:
        raise ValueError(f"wp has {wp.shape[3]} input channels, x {c8i}")
    if pad not in (0, 1):
        raise ValueError(f"pad must be 0 or 1, got {pad}")
    if bias is not None and tuple(bias.shape) != (c8o,):
        raise ValueError(f"bias must have shape ({c8o},)")
    if x.device.type == "cpu":
        return conv2_packed_plain(x, wp, bias, pad=pad)
    if x.device.type != "cuda":
        raise ValueError(f"conv2_packed runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv2_packed takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if c8i % 8 or c8o % 4:
        raise ValueError(f"conv2_packed needs 8Ci % 8 == 0 and 8Co % 4 == 0; "
                         f"got {c8i}, {c8o}")
    _check_cuda("x", x, x.dtype, x.device)
    _check_cuda("wp", wp, x.dtype, x.device)
    step = 1 if pad else -1
    do, ho, wo = di + step, hi + step, wi + step
    out = torch.empty((n, do, ho, wo, c8o), dtype=x.dtype, device=x.device)
    bias_ptr = None
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
        _check_cuda("bias", bias, torch.float32, x.device)
        bias_ptr = bias.data_ptr()
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.mri_conv2_packed(
            x.data_ptr(), wp.data_ptr(), bias_ptr, out.data_ptr(),
            _DTYPE_CODE[x.dtype], n, di, hi, wi, do, ho, wo, c8i, c8o, pad,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "conv2_packed")
    conv2_packed.launches += 1
    return out


conv2_packed.launches = 0


# ---------------------------------------------------------------------------
# B2: fused BN affine + PReLU + shifted pad zeroing
# ---------------------------------------------------------------------------


def bn_act_zero_pads_plain(xs: torch.Tensor, scale, shift, alpha,
                           masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of `bn_act_zero_pads`: `zero_shifted_pads(prelu(
    xs * scale + shift))` in float32, cast to xs.dtype."""
    md, mh, mw = (m.float() for m in masks)
    y = xs.float() * scale.float() + shift.float()
    y = torch.where(y >= 0, y, y * alpha.float())
    y = y * md[:, None, None, :] * mh[None, :, None, :] * mw[None, None, :, :]
    return y.to(xs.dtype)


def bn_act_zero_pads(xs: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, alpha: torch.Tensor,
                     masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fused `prelu(xs * scale + shift) * md[d] * mh[h] * mw[w]` on a
    shifted packed tensor xs (N, D, H, W, C8), computed in float32 and
    stored in xs.dtype.  scale, shift, alpha: (C8,) per packed channel;
    masks: the three (D, C8), (H, C8), (W, C8) planes of
    `ops.packed._shifted_pad_axis_mask`."""
    if xs.ndim != 5:
        raise ValueError(f"bn_act_zero_pads needs (N,D,H,W,C8), got "
                         f"{tuple(xs.shape)}")
    n, d, h, w, c8 = xs.shape
    for name, t in (("scale", scale), ("shift", shift), ("alpha", alpha)):
        if tuple(t.shape) != (c8,):
            raise ValueError(f"{name} must have shape ({c8},), got "
                             f"{tuple(t.shape)}")
    if len(masks) != 3:
        raise ValueError("masks must be the three (D|H|W, C8) planes")
    for m, cells in zip(masks, (d, h, w)):
        if tuple(m.shape) != (cells, c8):
            raise ValueError(f"mask shape {tuple(m.shape)} != "
                             f"{(cells, c8)}")
    if xs.device.type == "cpu":
        return bn_act_zero_pads_plain(xs, scale, shift, alpha, masks)
    if xs.device.type != "cuda":
        raise ValueError(f"bn_act_zero_pads runs on cpu or cuda, not "
                         f"{xs.device}")
    if xs.dtype not in _DTYPE_CODE:
        raise TypeError(f"bn_act_zero_pads takes float32 or bfloat16, not "
                        f"{xs.dtype}")
    if c8 % 8:
        raise ValueError(f"bn_act_zero_pads needs C8 % 8 == 0, got {c8}")
    _check_cuda("xs", xs, xs.dtype, xs.device)
    vecs = [t.to(device=xs.device, dtype=torch.float32).contiguous()
            for t in (scale, shift, alpha, *masks)]
    for name, t in zip(("scale", "shift", "alpha", "md", "mh", "mw"), vecs):
        _check_cuda(name, t, torch.float32, xs.device)
    out = torch.empty_like(xs)
    lib = load()
    with torch.cuda.device(xs.device):
        rc = lib.mri_bn_act_zero_pads(
            xs.data_ptr(), *[t.data_ptr() for t in vecs], out.data_ptr(),
            _DTYPE_CODE[xs.dtype], n, d, h, w, c8,
            torch.cuda.current_stream(xs.device).cuda_stream)
    _raise_on(rc, "bn_act_zero_pads")
    bn_act_zero_pads.launches += 1
    return out


bn_act_zero_pads.launches = 0


# ---------------------------------------------------------------------------
# B3: zero-padded strided conv along one spatial axis
# ---------------------------------------------------------------------------

# the most float32 weights one block can hold in shared memory (227 KB)
_AXIS_MAX_WEIGHTS = 232448 // 4


def _axis_out_len(length: int, k: int, stride: int, pad: int) -> int:
    return (length + 2 * pad - k) // stride + 1


def conv_axis_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *, axis: int,
                    stride: int = 1, pad: int = 0) -> torch.Tensor:
    """Plain version of `conv_axis`: the sum over the k taps of the
    zero-padded input's strided slice along `axis` times w[t], in float32,
    bias added, one cast to x.dtype."""
    k = w.shape[0]
    lo = _axis_out_len(x.shape[axis], k, stride, pad)
    if pad:
        spec = [0] * (2 * (x.ndim - axis))
        spec[-2:] = (pad, pad)
        x = TF.pad(x, spec)
    wf = w.float()
    out = None
    for t in range(k):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(t, t + (lo - 1) * stride + 1, stride)
        part = torch.matmul(x[tuple(idx)].float(), wf[t])
        out = part if out is None else out.add_(part)
    if bias is not None:
        out.add_(bias.float())
    return out.to(x.dtype)


def conv_axis(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, axis: int,
              stride: int = 1, pad: int = 0) -> torch.Tensor:
    """Conv along spatial `axis` (1, 2 or 3) of channels-last x
    (N, D, H, W, Ci) with w (k, Ci, Co):

        out[..., j, ..., co] = bias[co]
            + sum_{t, ci} x[..., j * stride + t - pad, ..., ci] w[t, ci, co]

    with x zero outside its extent, so the axis has length
    (L + 2 pad - k) // stride + 1 in the output.  Computed in float32 (w and
    bias are read as float32) and rounded once to x's dtype, float32 or
    bfloat16."""
    if x.ndim != 5 or w.ndim != 3:
        raise ValueError(f"conv_axis needs x (N,D,H,W,Ci) and w (k,Ci,Co); "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    if axis not in (1, 2, 3):
        raise ValueError(f"axis must be 1, 2 or 3, got {axis}")
    k, ci, co = w.shape
    if ci != x.shape[4]:
        raise ValueError(f"w has {ci} input channels, x {x.shape[4]}")
    if stride < 1 or pad < 0:
        raise ValueError(f"need stride >= 1 and pad >= 0, got {stride}, "
                         f"{pad}")
    length = x.shape[axis]
    lo = _axis_out_len(length, k, stride, pad)
    if lo < 1:
        raise ValueError(f"axis of length {length} is too short for k={k}, "
                         f"pad={pad}")
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"bias must have shape ({co},)")
    if x.device.type == "cpu":
        return conv_axis_plain(x, w, bias, axis=axis, stride=stride, pad=pad)
    if x.device.type != "cuda":
        raise ValueError(f"conv_axis runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv_axis takes float32 or bfloat16, not {x.dtype}")
    if k * ci * co > _AXIS_MAX_WEIGHTS:
        raise ValueError(f"w {tuple(w.shape)} does not fit in one block's "
                         f"shared memory")
    _check_cuda("x", x, x.dtype, x.device)
    wf = w.to(device=x.device, dtype=torch.float32).contiguous()
    _check_cuda("w", wf, torch.float32, x.device)
    bias_ptr = None
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
        _check_cuda("bias", bias, torch.float32, x.device)
        bias_ptr = bias.data_ptr()
    shape = list(x.shape)
    shape[axis], shape[4] = lo, co
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    # x as (A, L, B, Ci): the dims before the conv axis, the axis, and the
    # spatial dims after it
    a = int(x.shape[:axis].numel())
    b = int(x.shape[axis + 1:4].numel())
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.mri_conv_axis(
            x.data_ptr(), wf.data_ptr(), bias_ptr, out.data_ptr(),
            _DTYPE_CODE[x.dtype], a, length, lo, b, ci, co, k, stride, pad,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "conv_axis")
    conv_axis.launches += 1
    return out


conv_axis.launches = 0


def conv_one_axis(x: torch.Tensor, w: torch.Tensor, axis: int, *,
                  stride: int = 1, pad: int = 0,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-axis conv on channels-last (N, D, H, W, C) along spatial `axis`
    (1, 2 or 3); w: (k, Ci, Co).  One `conv_axis` launch, bias fused."""
    return conv_axis(x.contiguous(), w, bias, axis=axis, stride=stride,
                     pad=pad)


def separable_conv3d(x: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
                     wz: torch.Tensor, *, stride=(1, 1, 1), pad=(0, 0, 0),
                     biases=(None, None, None)) -> torch.Tensor:
    """The fader conv stack: (k,1,1), then (1,k,1), then (1,1,k), each with
    its own stride, pad and bias, as three `conv_axis` launches.

    wx: (k, Ci, C), wy: (k, C, C), wz: (k, C, C): torch (O, I, k, 1, 1)-style
    weights viewed as (k, I, O)."""
    for axis, w in zip((1, 2, 3), (wx, wy, wz)):
        x = conv_one_axis(x, w, axis, stride=stride[axis - 1],
                          pad=pad[axis - 1], bias=biases[axis - 1])
    return x


KERNELS = (conv2_packed, bn_act_zero_pads, conv_axis)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
