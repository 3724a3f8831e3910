"""The port's hand-written Hopper kernels, their plain PyTorch versions,
launch counters and build.

| kernel              | source                    | replaces (JAX package)                    |
|---------------------|---------------------------|-------------------------------------------|
| `conv2_packed`      | `csrc/conv2_packed_tc.cu` (bf16, 8Ci and 8Co multiples of 64: wgmma + TMA), `csrc/conv2_packed.cu` (the rest: CUDA cores) | `ops/pallas_kernels.py::conv2_packed_pallas` |
| `conv2_packed_as_bn_act` | the same two kernels, with B2 as the epilogue of an aligned->shifted launch | `conv2_packed_pallas` + `bn_act_zero_pads` |
| `conv2_packed_dx`   | the same two kernels, in the other parity with flipped, io-swapped weights: B1's input gradient | the dx of `ops/packed.py::_conv3_packed_bwd` / `_conv3_packed_as_bwd` |
| `bn_act_zero_pads`  | `csrc/bn_act_zero_pads.cu`| `ops/pallas_kernels.py::bn_act_zero_pads` |
| `conv_axis`         | `csrc/conv_axis_tc.cu` (bf16 x and w: mma.sync), `csrc/conv_axis.cu` (the rest: CUDA cores) | `ops/pallas_kernels.py::conv_axis_last`   |
| `separable_conv3d`  | `csrc/separable_conv3d.cu` (the three axes in one launch) | `ops/pallas_kernels.py::separable_conv3d` |
| `conv_axis_dx`      | `csrc/conv_axis_bwd_tc.cu` (bf16: mma.sync), `csrc/conv_axis_bwd.cu` (f32: CUDA cores) | the input gradient of `conv_axis_last` (XLA's in JAX) |
| `conv_axis_dw`      | the same two sources (two passes each, no atomics) | the weight and bias gradients of `conv_axis_last` |
| `conv2_packed_s8` (K1) | `csrc/conv2_packed_s8_tc.cu` (8Ci and 8Co multiples of 64: int8 wgmma + TMA, `s8_wgmma.cuh`), `csrc/conv2_packed_s8.cu` (the rest, the 8Ci = 8 stem: int8 mma.sync, `s8_igemm.cuh`); int32 out, or JAX's `_epilogue` fused to int8 | `models/unet_packed_q.py::conv_int8` (XLA in JAX) |
| `upconv_packed_s8` (K2) | `csrc/upconv_packed_s8.cu` (the wgmma GEMM of `s8_wgmma.cuh` per output parity class, one persistent launch) | `models/unet_packed_q.py::upconv_int8` (XLA in JAX) |
| `bn_train_stats`, `bn_train_apply`, `bn_train_reduce`, `bn_train_dx` | `csrc/bn_train_packed.cu` (the four passes of the train-mode BatchNorm + PReLU + pad-zero tail, `ops/packed.py::BnActTrainPacked`) | `models/unet_packed.py::_block_train` and its autograd (XLA in JAX) |
| `dw_packed`         | `csrc/dw_packed_tc.cu` (bf16: split-K wgmma fed by TMA, and its fold); float32 and the CPU take `dw_packed_plain`'s GEMMs | `ops/packed.py::_dw_packed_qgroup` (an einsum, XLA's in JAX) |

`conv_one_axis` and `separable_conv3d` keep the signatures of their JAX
namesakes (without the Mosaic workarounds `interpret` and `max_taps`).
`separable_conv3d` runs a stack as one fused launch where
`_separable_route` says so (every stack the fader serves and trains on),
else as three `conv_axis` launches (the depth-6 AE's bf16 stacks of 64
channels and more, and its one-channel output stack).  The served UNet calls `conv2_packed_as_bn_act`
at its aligned->shifted sites; the standalone `bn_act_zero_pads` is the
counterpart of the JAX function and is no longer on that path.
`SeparableConv3dFn` is the stack's autograd Function: the fused forward,
and a backward of `conv_axis` recomputes, `conv_axis_dw` and
`conv_axis_dx` launches, axis by axis in reverse.

Each wrapper takes a CPU tensor through the kernel's plain version and a
CUDA tensor through the kernel, or raises: there is no fallback from one
to the other.  `<wrapper>.launches` counts kernel launches, so a run can
show that its main path went through the kernels; `conv2_packed.launches`
counts every B1 launch, fused or not, `conv2_packed.tc_launches` those on
the tensor-core route; `conv2_packed_as_bn_act.launches` (and
`.tc_launches`) the B1 launches that ran B2 as their epilogue,
`conv2_packed_dx.launches` (and `.tc_launches`) those that computed an
input gradient; `conv_axis.tc_launches` the one-axis launches on the
tensor-core route (`_axis_fwd_route`), `conv_axis_dx.tc_launches` and
`conv_axis_dw.tc_launches` the backward launches on theirs
(`_axis_bwd_route`); `conv2_packed_s8.launches` the int8 packed convs
(`.fused_launches` those with the epilogue, `.wgmma_launches` those on
the wgmma route of `_conv2_s8_route`), `upconv_packed_s8.launches` the
int8 composed up-convs, `bn_train_stats.launches`, `bn_train_apply.launches`,
`bn_train_reduce.launches` and `bn_train_dx.launches` the passes of the
train-mode tail (the statistics and backward reduction passes count one
each for their two launches), `dw_packed.launches` and
`dw_packed.fold_launches` the packed convs' weight gradients and their
folds.

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
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as TF

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("conv2_packed.cu", "conv2_packed_tc.cu", "bn_act_zero_pads.cu",
           "conv_axis.cu", "separable_conv3d.cu", "conv_axis_bwd.cu",
           "conv_axis_bwd_tc.cu", "conv_axis_tc.cu", "conv2_packed_s8.cu",
           "conv2_packed_s8_tc.cu", "upconv_packed_s8.cu",
           "bn_train_packed.cu", "dw_packed_tc.cu")
HEADERS = ("common.cuh", "tc_common.cuh", "hopper_tma.cuh", "s8_igemm.cuh",
           "s8_wgmma.cuh")
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
                                     i, i, i, vp, vp, vp, vp, vp]
    lib.mri_conv2_packed.restype = i
    lib.mri_conv2_packed_tc.argtypes = ([vp, vp, vp, vp, ll] + [i] * 16
                                        + [vp] * 5)
    lib.mri_conv2_packed_tc.restype = i
    lib.mri_bn_act_zero_pads.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i,
                                         ll, i, i, i, i, vp]
    lib.mri_bn_act_zero_pads.restype = i
    lib.mri_conv_axis.argtypes = [vp, vp, vp, vp, i, ll, i, i, ll, i, i, i,
                                  i, i, vp]
    lib.mri_conv_axis.restype = i
    lib.mri_separable_conv3d.argtypes = [vp] * 8 + [i, ll, vp, i, vp]
    lib.mri_separable_conv3d.restype = i
    lib.mri_conv_axis_dx.argtypes = [vp, vp, vp, i, ll, i, i, ll, i, i, i, i,
                                     i, vp]
    lib.mri_conv_axis_dx.restype = i
    lib.mri_conv_axis_dw.argtypes = [vp, vp, vp, vp, vp, i, ll, i, i, ll, i,
                                     i, i, i, i, vp, vp]
    lib.mri_conv_axis_dw.restype = i
    lib.mri_conv_axis_dw_tc.argtypes = [vp] * 6 + [i, vp]
    lib.mri_conv_axis_dw_tc.restype = i
    lib.mri_conv_axis_dx_tc.argtypes = [vp] * 4 + [i, vp]
    lib.mri_conv_axis_dx_tc.restype = i
    lib.mri_conv_axis_tc.argtypes = [vp] * 5 + [i, vp]
    lib.mri_conv_axis_tc.restype = i
    lib.mri_conv2_packed_s8.argtypes = [vp, vp, vp, ll, i, i, i, i, i, i,
                                        vp, vp, vp, vp, vp, vp]
    lib.mri_conv2_packed_s8.restype = i
    lib.mri_conv2_packed_s8_tc.argtypes = [vp, vp, vp, ll] + [i] * 11 + [vp] * 6
    lib.mri_conv2_packed_s8_tc.restype = i
    lib.mri_upconv_packed_s8.argtypes = [vp, vp, vp, ll] + [i] * 10 + [vp]
    lib.mri_upconv_packed_s8.restype = i
    lib.mri_bn_train_stats.argtypes = [vp] * 3 + [i, ll] + [i] * 9 + [vp]
    lib.mri_bn_train_stats.restype = i
    lib.mri_bn_train_apply.argtypes = [vp] * 3 + [i, ll] + [i] * 8 + [vp]
    lib.mri_bn_train_apply.restype = i
    lib.mri_bn_train_reduce.argtypes = [vp] * 5 + [i, ll] + [i] * 8 + [vp]
    lib.mri_bn_train_reduce.restype = i
    lib.mri_bn_train_dx.argtypes = [vp] * 4 + [i, ll] + [i] * 9 + [vp]
    lib.mri_bn_train_dx.restype = i
    lib.mri_dw_packed_tc.argtypes = [vp] * 4 + [ll] + [i] * 13 + [vp]
    lib.mri_dw_packed_tc.restype = i
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


# refusals of the wgmma kernels' host code (`hopper_tma.cuh`; negative
# return codes)
_HOST_ERRORS = {-1: "cuTensorMapEncodeTiled is not available",
                -2: "a TMA tensor map was refused",
                -3: "the kernel was not compiled to 168 registers per "
                    "thread, which its setmaxnreg split needs",
                -4: "the tile plan or shape is not served"}


def _raise_on(rc: int, what: str):
    if rc < 0:
        raise RuntimeError(f"{what} launch refused: {_HOST_ERRORS[rc]}")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {rc}")


# ---------------------------------------------------------------------------
# B1: k=2 packed conv
# ---------------------------------------------------------------------------


def _conv2_sum(x: torch.Tensor, wp: torch.Tensor, pad: int) -> torch.Tensor:
    """The float32 sum of the 8 shifted-slice products of the k=2 packed
    conv, before any rounding."""
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
    return out


def conv2_packed_plain(x: torch.Tensor, wp: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       pad: int = 0) -> torch.Tensor:
    """Plain version of `conv2_packed`: the sum of the 8 shifted-slice
    products, accumulated in float32, bias added, one cast to x.dtype."""
    out = _conv2_sum(x, wp, pad)
    if bias is not None:
        out.add_(bias.float())
    return out.to(x.dtype)


# the tensor-core kernel's tile: 128 output cells (two 64-row wgmma
# halves) by BN output channels, K steps of 64 input channels of one tap
_TC_ROWS = 128
_TC_K = 64
_TAPS = tuple((qd, qh, qw) for qd in range(2) for qh in range(2)
              for qw in range(2))


def _conv2_route(dtype: torch.dtype, c8i: int, c8o: int) -> str:
    """The kernel that serves a `conv2_packed` call on the card: "tc"
    (`conv2_packed_tc.cu`: wgmma fed by TMA) for bfloat16 with 8Ci and 8Co
    multiples of 64, "cuda_core" (`conv2_packed.cu`) for everything else:
    float32, which is held to float32 references that TF32 would miss, and
    the 8Ci = 8 stem."""
    if dtype == torch.bfloat16 and c8i % _TC_K == 0 and c8o % 64 == 0:
        return "tc"
    return "cuda_core"


class TcPlan(NamedTuple):
    """Tile plan of one tensor-core `conv2_packed` launch."""
    box: Tuple[int, int, int]     # (bw, bh, bd) output cells per tile
    tiles: Tuple[int, int, int]   # boxes along (W, H, D)
    bn: int                       # output channels per tile
    grid: int                     # tiles: N x boxes x 8Co / bn
    waste: float                  # share of the tiles' 128 rows not stored
    tap_offsets: Tuple[Tuple[int, int, int], ...]  # (dz, dy, dx) per tap


@functools.lru_cache(maxsize=None)
def _tc_box(do: int, ho: int, wo: int) -> Tuple[int, int, int]:
    """The box of at most 128 output cells that covers (do, ho, wo) with
    the fewest boxes, then the widest along W (longest contiguous runs)."""
    best = None
    for bd in range(1, min(do, _TC_ROWS) + 1):
        for bh in range(1, min(ho, _TC_ROWS // bd) + 1):
            bw = min(wo, _TC_ROWS // (bd * bh))
            n = -(-wo // bw) * -(-ho // bh) * -(-do // bd)
            key = (n, -bw, -bh)
            if best is None or key < best[0]:
                best = (key, (bw, bh, bd))
    return best[1]


def _tc_n_tile(c8o: int) -> int:
    """Output channels per tile of the wgmma kernels: the whole 8Co up to
    256, else the widest of 256, 128, 64 that divides it."""
    return 256 if c8o % 256 == 0 else 128 if c8o % 128 == 0 else 64


def conv2_tc_plan(n: int, do: int, ho: int, wo: int, c8o: int,
                  pad: int) -> TcPlan:
    """Box, tile counts, N tile and per-tap input offsets of the
    tensor-core kernel for an (n, do, ho, wo, c8o) output.  Tile (b, tz,
    ty, tx) covers output cells [tz*bd, +bd) x [ty*bh, +bh) x [tx*bw, +bw)
    of item b; its tap (qd, qh, qw) reads the input box shifted by
    (qd - pad, qh - pad, qw - pad), zero outside the input."""
    bw, bh, bd = _tc_box(do, ho, wo)
    tiles = (-(-wo // bw), -(-ho // bh), -(-do // bd))
    bn = _tc_n_tile(c8o)
    boxes = tiles[0] * tiles[1] * tiles[2]
    return TcPlan(box=(bw, bh, bd), tiles=tiles, bn=bn,
                  grid=n * boxes * (c8o // bn),
                  waste=1.0 - do * ho * wo / (boxes * _TC_ROWS),
                  tap_offsets=tuple((qd - pad, qh - pad, qw - pad)
                                    for qd, qh, qw in _TAPS))


def kmajor_weights(wp: torch.Tensor) -> torch.Tensor:
    """(2, 2, 2, 8Ci, 8Co) packed weights -> (8 taps, 8Co, 8Ci), the
    K-major B operand of the tensor-core kernel (tap = 4 qd + 2 qh + qw)."""
    c8i, c8o = wp.shape[3:]
    return wp.permute(0, 1, 2, 4, 3).reshape(8, c8o, c8i).contiguous()


def _check_conv2_args(x: torch.Tensor, wp: torch.Tensor, pad: int):
    if x.ndim != 5 or wp.ndim != 5 or tuple(wp.shape[:3]) != (2, 2, 2):
        raise ValueError(f"conv2_packed needs x (N,D,H,W,C8i) and wp "
                         f"(2,2,2,C8i,C8o); got {tuple(x.shape)}, "
                         f"{tuple(wp.shape)}")
    if wp.shape[3] != x.shape[4]:
        raise ValueError(f"wp has {wp.shape[3]} input channels, x "
                         f"{x.shape[4]}")
    if pad not in (0, 1):
        raise ValueError(f"pad must be 0 or 1, got {pad}")


def _check_conv2_cuda(x: torch.Tensor, wp: torch.Tensor, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    c8i, c8o = wp.shape[3:]
    if c8i % 8 or c8o % 4:
        raise ValueError(f"{name} needs 8Ci % 8 == 0 and 8Co % 4 == 0; "
                         f"got {c8i}, {c8o}")
    _check_cuda("x", x, x.dtype, x.device)
    _check_cuda("wp", wp, x.dtype, x.device)


def conv2_packed(x: torch.Tensor, wp: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 pad: int = 0) -> torch.Tensor:
    """k=2 packed conv: `out[n,z,y,x] = bias + Σ_q xin[n,z+qd-pad,y+qh-pad,
    x+qw-pad] @ wp[q]`, xin zero outside its extent.

    x: (N, Di, Hi, Wi, 8Ci) float32 or bfloat16; wp: (2, 2, 2, 8Ci, 8Co) in
    x's dtype; bias: (8Co,) or None, added in float32 before the one
    rounding to x's dtype.  pad=0: shifted -> aligned, output
    (N, Di-1, Hi-1, Wi-1, 8Co); pad=1: aligned -> shifted, output
    (N, Di+1, Hi+1, Wi+1, 8Co).  On the card `_conv2_route` picks the
    tensor-core or the CUDA-core kernel; either failing raises."""
    _check_conv2_args(x, wp, pad)
    c8i, c8o = wp.shape[3:]
    if bias is not None and tuple(bias.shape) != (c8o,):
        raise ValueError(f"bias must have shape ({c8o},)")
    if x.device.type == "cpu":
        return conv2_packed_plain(x, wp, bias, pad=pad)
    _check_conv2_cuda(x, wp, "conv2_packed")
    tc = _conv2_route(x.dtype, c8i, c8o) == "tc"
    out = _conv2_launch(x, wp, bias, pad, tc)
    if out.numel():
        conv2_packed.launches += 1
        conv2_packed.tc_launches += tc
    return out


def _conv2_launch(x: torch.Tensor, wp: torch.Tensor,
                  bias: Optional[torch.Tensor], pad: int, tc: bool,
                  epi: Optional[Sequence[Optional[torch.Tensor]]] = None
                  ) -> torch.Tensor:
    """One launch of B1's tensor-core kernel (`tc`) or CUDA-core kernel on
    checked CUDA tensors; with `epi` = (scale, shift, alpha, addend), float32
    (8Co,) vectors and an addend like the output or None, the launch runs
    the B2 epilogue (pad 1, no bias).  Raises if it fails.  Counts nothing:
    the wrappers count their own launches."""
    n, di, hi, wi, c8i = x.shape
    c8o = wp.shape[4]
    step = 1 if pad else -1
    do, ho, wo = di + step, hi + step, wi + step
    out = torch.empty((n, do, ho, wo, c8o), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    bias_ptr = None
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
        _check_cuda("bias", bias, torch.float32, x.device)
        bias_ptr = bias.data_ptr()
    epi_ptrs = [None] * 4
    if epi is not None:
        for j, (name, t) in enumerate(zip(("scale", "shift", "alpha"),
                                          epi[:3])):
            epi_ptrs[j] = t.data_ptr()
            _check_cuda(name, t, torch.float32, x.device)
        if epi[3] is not None:
            _check_cuda("addend", epi[3], x.dtype, x.device)
            epi_ptrs[3] = epi[3].data_ptr()
    lib = load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if tc:
            plan = conv2_tc_plan(n, do, ho, wo, c8o, pad)
            wk = kmajor_weights(wp)
            rc = lib.mri_conv2_packed_tc(
                x.data_ptr(), wk.data_ptr(), bias_ptr, out.data_ptr(), n, di,
                hi, wi, do, ho, wo, c8i, c8o, pad, *plan.box, *plan.tiles,
                plan.bn, *epi_ptrs, stream)
        else:
            rc = lib.mri_conv2_packed(
                x.data_ptr(), wp.data_ptr(), bias_ptr, out.data_ptr(),
                _DTYPE_CODE[x.dtype], n, di, hi, wi, do, ho, wo, c8i, c8o,
                pad, *epi_ptrs, stream)
    _raise_on(rc, "conv2_packed_tc" if tc else "conv2_packed")
    return out


conv2_packed.launches = 0
conv2_packed.tc_launches = 0


# ---------------------------------------------------------------------------
# B1 as the input gradient of B1
# ---------------------------------------------------------------------------


def flipped_weights(wp: torch.Tensor) -> torch.Tensor:
    """(2, 2, 2, 8Ci, 8Co) packed weights -> the spatially flipped,
    io-swapped (2, 2, 2, 8Co, 8Ci) weights of the conv's transpose."""
    return torch.flip(wp, (0, 1, 2)).transpose(3, 4).contiguous()


def conv2_packed_dx_plain(g: torch.Tensor, wp: torch.Tensor, *,
                          pad: int) -> torch.Tensor:
    """Plain version of `conv2_packed_dx`."""
    return conv2_packed_plain(g, flipped_weights(wp), pad=1 - pad)


def conv2_packed_dx(g: torch.Tensor, wp: torch.Tensor, *,
                    pad: int) -> torch.Tensor:
    """Input gradient of `y = conv2_packed(x, wp, pad=pad)`: with y's
    cotangent g (N, Do, Ho, Wo, 8Co),

        dx[n, i] = sum_q g[n, i - q + pad] @ wp[q]^T
                 = conv2_packed(g, flipped_weights(wp), pad=1 - pad)[n, i],

    one B1 launch in the other parity (the JAX package's
    `ops/packed.py::_conv3_packed_bwd` and `_conv3_packed_as_bwd`): the dx
    of a shifted->aligned conv is an aligned->shifted one and the other way
    round.  Summed in float32, rounded once to g's dtype; wp in g's dtype.
    `conv2_packed_dx.launches` (and `.tc_launches`) count these launches,
    which `conv2_packed.launches` counts too."""
    if pad not in (0, 1) or wp.ndim != 5:
        raise ValueError(f"conv2_packed_dx needs pad 0 or 1 and wp "
                         f"(2,2,2,C8i,C8o); got {pad}, {tuple(wp.shape)}")
    wt = flipped_weights(wp)
    _check_conv2_args(g, wt, 1 - pad)
    if g.device.type == "cpu":
        return conv2_packed_plain(g, wt, pad=1 - pad)
    _check_conv2_cuda(g, wt, "conv2_packed_dx")
    tc = _conv2_route(g.dtype, wt.shape[3], wt.shape[4]) == "tc"
    out = _conv2_launch(g, wt, None, 1 - pad, tc)
    if out.numel():
        conv2_packed.launches += 1
        conv2_packed.tc_launches += tc
        conv2_packed_dx.launches += 1
        conv2_packed_dx.tc_launches += tc
    return out


conv2_packed_dx.launches = 0
conv2_packed_dx.tc_launches = 0


# ---------------------------------------------------------------------------
# dw: the weight gradient of B1
# ---------------------------------------------------------------------------


def dw_pad(x_cells: Sequence[int], g_cells: Sequence[int]) -> int:
    """The pad of a packed k=2 conv, read from the cell extents of its
    input x and its output gradient g: x one cell longer than g on every
    axis is pad 0 (shifted -> aligned, the stride-2 convs' low-padded
    input, a pre-padded input), one cell shorter is pad 1 (aligned ->
    shifted); anything else raises."""
    steps = {int(a) - int(b) for a, b in zip(x_cells, g_cells)}
    if len(x_cells) == len(g_cells) == 3 and steps in ({1}, {-1}):
        return 0 if steps == {1} else 1
    raise ValueError(f"dw of a packed k=2 conv needs x's cells one more or "
                     f"one fewer than g's on every axis; got "
                     f"{tuple(x_cells)} and {tuple(g_cells)}")


def dw_packed_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of `dw_packed`: x padded by one zero cell per side
    where `dw_pad` reads pad 1, then 8 per-offset contractions
    `x[:, q + cells].T @ g`, each one float32 GEMM of K = N x cells over
    a copy of the window.  The operands are upcast to float32, which
    keeps bfloat16 products exact (TF32 stays as `torch.backends.cuda.
    matmul.allow_tf32` has it, off by default); dw is float32, as in
    JAX."""
    if dw_pad(x.shape[1:4], g.shape[1:4]):
        x = TF.pad(x, (0, 0) + (1, 1) * 3)
    od, oh, ow, c8o = g.shape[1:]
    c8i = x.shape[-1]
    g2 = g.reshape(-1, c8o).float()
    rows = []
    for qd in range(2):
        for qh in range(2):
            for qw in range(2):
                sl = x[:, qd:qd + od, qh:qh + oh, qw:qw + ow].reshape(-1, c8i)
                rows.append(torch.mm(sl.float().t(), g2))
    return torch.stack(rows).reshape(2, 2, 2, c8i, c8o)


def dw_packed_route(dtype: torch.dtype, device: torch.device) -> str:
    """The version that serves a `dw_packed` call: "tc" (`csrc/
    dw_packed_tc.cu`, wgmma fed by TMA) for bfloat16 on the card, "plain"
    (`dw_packed_plain`) for float32 on the card, which is held to float32
    references, and for anything on the CPU.  Other dtypes on the card
    raise."""
    if device.type == "cpu" or (device.type == "cuda"
                                and dtype == torch.float32):
        return "plain"
    if device.type == "cuda" and dtype == torch.bfloat16:
        return "tc"
    raise TypeError(f"dw_packed takes float32 or bfloat16 on the card, not "
                    f"{dtype} on {device}")


_DWP_M = 64                  # 8Co channels a tile: one wgmma M
_DWP_ROW = 128               # bytes of a swizzled tile row
_DWP_MAX_ROWS = 128          # output cells a K step at most
_DWP_RING = 224 * 1024       # shared memory for the ring of stages
_DWP_MAX_STAGES = 8
_DWP_MIN_STAGES = 3          # a load in flight while two steps compute
# the plan's cost model, per SM of the H100: dense bf16 rate, L2 fill rate
# (about 5.5 TB/s over 132 SMs), fixed costs of a step and of a block, and
# the fold's rate and launch
_DWP_SM_FLOPS = 989e12 / 132
_DWP_SM_FILL = 5.5e12 / 132
_DWP_STEP_S = 0.2e-6
_DWP_BLOCK_S = 2e-6
_DWP_FOLD_BYTES_S = 2.5e12
_DWP_FOLD_S = 3e-6


class DwPackedPlan(NamedTuple):
    """Tile plan of one `dw_packed` kernel launch (`dw_packed_plan`)."""
    box: Tuple[int, int]          # (bw, bh) output cells a K step
    tiles: Tuple[int, int]        # boxes along (W, H)
    bn: int                       # 8Ci channels a tile: 8 at the stem, 64
    tiles_mn: Tuple[int, int]     # tiles along 8Co (64 each) and 8Ci (bn)
    steps: int                    # K steps a tile: N x Do x boxes
    splits: int                   # split-K partials, summed by the fold
    stages: int                   # ring stages
    stage_bytes: int              # a stage: g's tile and two x tiles
    smem: int                     # dynamic shared memory of a block
    grid: int                     # blocks: tiles_m x tiles_n x splits
    ws_floats: int                # workspace: splits x 8 x 64 tiles_m x
                                  # bn tiles_n
    waste: float                  # share of the steps' cells outside g


def _dwp_stage_bytes(bw: int, bh: int, bn: int) -> int:
    x_row = 16 if bn == 8 else _DWP_ROW
    x_tile = -(-2 * (bh + 1) * bw * x_row // 1024) * 1024
    return bw * bh * _DWP_ROW + 2 * x_tile


def _dwp_boxes(wo: int, ho: int):
    """(bw, bh) K-step boxes: bw a multiple of 8 (so every x window starts
    on an 8-row swizzle group), bw x bh a multiple of 16 (wgmma's K) and
    at most 128 cells."""
    for bw in range(8, min(-(-wo // 8) * 8, _DWP_MAX_ROWS) + 1, 8):
        for bh in range(1, min(ho + 1, _DWP_MAX_ROWS // bw) + 1):
            if (bw * bh) % 16 == 0:
                yield bw, bh


def dw_packed_plan(n: int, do: int, ho: int, wo: int, c8i: int, c8o: int,
                   sms: int = 132) -> DwPackedPlan:
    """The box, splits and stages of the dw kernel for an output gradient
    (n, do, ho, wo, c8o) and an input of c8i channels, at `sms` SMs.

    Block (m tile, n tile, split s) walks K steps [s T / S, (s + 1) T /
    S) of the T = n x do x tiles_h x tiles_w boxes, W fastest: box (b, z,
    ty, tx) covers output cells [ty bh, +bh) x [tx bw, +bw) of plane z of
    item b.  The box and S minimise a cost model: a block runs one per
    SM, a step takes the longer of its tensor-core time and its L2 fill
    (g's tile, and x's two haloed tiles of 2 (bh + 1) bw rows), and the
    fold reads the S partials once."""
    bn = 8 if c8i == 8 else 64
    tiles_m, tiles_n = -(-c8o // _DWP_M), -(-c8i // bn)
    tiles = tiles_m * tiles_n
    x_row = 16 if bn == 8 else _DWP_ROW
    tile_bytes = 8 * tiles_m * _DWP_M * tiles_n * bn * 4
    best = None
    for bw, bh in _dwp_boxes(wo, ho):
        stage_bytes = _dwp_stage_bytes(bw, bh, bn)
        stages = min(_DWP_MAX_STAGES, _DWP_RING // stage_bytes)
        if stages < _DWP_MIN_STAGES:
            continue
        tw, th = -(-wo // bw), -(-ho // bh)
        steps = n * do * tw * th
        rows = bw * bh
        fill = rows * _DWP_ROW + 4 * (bh + 1) * bw * x_row
        step_s = max(16 * _DWP_M * bn * rows / _DWP_SM_FLOPS,
                     fill / _DWP_SM_FILL) + _DWP_STEP_S
        for k in range(1, 5):
            splits = max(1, min(steps, -(-k * sms // tiles)))
            waves = -(-tiles * splits // sms)
            cost = (waves * (-(-steps // splits) * step_s + _DWP_BLOCK_S)
                    + splits * tile_bytes / _DWP_FOLD_BYTES_S + _DWP_FOLD_S)
            key = (cost, -rows, bw)
            if best is None or key < best[0]:
                best = (key, bw, bh, tw, th, steps, splits, stages,
                        stage_bytes)
    _, bw, bh, tw, th, steps, splits, stages, stage_bytes = best
    return DwPackedPlan(
        box=(bw, bh), tiles=(tw, th), bn=bn, tiles_mn=(tiles_m, tiles_n),
        steps=steps, splits=splits, stages=stages, stage_bytes=stage_bytes,
        smem=stages * stage_bytes + 1024 + 16 * stages,
        grid=tiles * splits, ws_floats=splits * tile_bytes // 4,
        waste=1.0 - n * do * ho * wo / (steps * bw * bh))


def dw_packed(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Dense packed weight gradient of `y = conv2_packed(x, wp, pad=p)`
    with y's cotangent g (N, Do, Ho, Wo, 8Co):

        dw[q] = sum over n and cells c of x[n, c + q - p]^T g[n, c],

    x zero outside its extent, as (2, 2, 2, 8Ci, 8Co) float32 whatever
    the operands' dtype.  x is the conv's input as the forward took it,
    without its pad: `dw_pad` reads p from the extents.  `dw_packed_route`
    picks the version: on the card bfloat16 runs `csrc/dw_packed_tc.cu`
    (a split-K wgmma launch and its fold, bf16 products summed in float32
    in a fixed order: the same bits every call), float32 the plain GEMMs.
    `dw_packed.launches` counts the kernel's launches,
    `dw_packed.fold_launches` its folds."""
    if x.ndim != 5 or g.ndim != 5 or x.shape[0] != g.shape[0]:
        raise ValueError(f"dw_packed needs x (N,Di,Hi,Wi,8Ci) and g "
                         f"(N,Do,Ho,Wo,8Co); got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    pad = dw_pad(x.shape[1:4], g.shape[1:4])
    if x.dtype != g.dtype or x.device != g.device:
        raise TypeError(f"dw_packed needs x and g of one dtype on one "
                        f"device; got {x.dtype} on {x.device}, {g.dtype} "
                        f"on {g.device}")
    if dw_packed_route(g.dtype, g.device) == "plain":
        return dw_packed_plain(x, g)
    n, di, hi, wi, c8i = x.shape
    do, ho, wo, c8o = g.shape[1:]
    if c8i % 8 or c8o % 8:
        raise ValueError(f"dw_packed's kernel needs 8Ci and 8Co multiples "
                         f"of 8; got {c8i}, {c8o}")
    _check_cuda("x", x, torch.bfloat16, g.device)
    _check_cuda("g", g, torch.bfloat16, g.device)
    out = torch.empty((2, 2, 2, c8i, c8o), dtype=torch.float32,
                      device=g.device)
    if g.numel() == 0 or x.numel() == 0:
        return out.zero_()
    plan = _cached_plan(dw_packed_plan, n, do, ho, wo, c8i, c8o,
                        _sm_count(g.device))
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=g.device)
    lib = load()
    with torch.cuda.device(g.device):
        rc = lib.mri_dw_packed_tc(
            x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(), n, di,
            hi, wi, do, ho, wo, c8i, c8o, pad, *plan.box, plan.splits,
            plan.stages, torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(rc, "dw_packed_tc")
    dw_packed.launches += 1
    dw_packed.fold_launches += 1
    return out


dw_packed.launches = 0
dw_packed.fold_launches = 0


# ---------------------------------------------------------------------------
# B1 + B2: aligned->shifted conv with the BN/PReLU/pad-mask epilogue
# ---------------------------------------------------------------------------


def shifted_pad_keep(axis: int, cells: int, c8: int, device=None,
                     first: bool = True, last: bool = True) -> torch.Tensor:
    """(cells, c8) bool: False at the pad voxels of a shifted packed tensor
    along `axis` (0 = D, 1 = H, 2 = W), from the index arithmetic of the
    fused epilogue and `csrc/bn_train_packed.cu`: with sub = channel //
    (c8 // 8) and bit = (sub >> (2 - axis)) & 1, the last cell drops the
    subs with the bit set, the first cell (if it is not also the last)
    those with it clear.  `first` / `last` False keep that cell whole (a
    spatial slab's faces between ranks are real voxels).  The one pad-mask
    rule of the port (`ops.packed.shifted_pad_mask_tensors` takes its
    planes from here)."""
    cell = torch.arange(cells, device=device)[:, None]
    bit = ((torch.arange(c8, device=device) // (c8 // 8)) >> (2 - axis)) & 1
    drop_last = (cell == cells - 1) & last
    drop_first = (cell == 0) & first & ~drop_last
    return torch.where(drop_last, bit == 0,
                       torch.where(drop_first, bit == 1, True))


def conv2_packed_as_bn_act_plain(x: torch.Tensor, wp: torch.Tensor, scale,
                                 shift, alpha,
                                 addend: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain version of `conv2_packed_as_bn_act`: the float32 tap sum of
    the aligned->shifted conv, plus the addend in float32, then `* scale +
    shift`, PReLU and the shifted pad mask, one cast to x.dtype."""
    y = _conv2_sum(x, wp, 1)
    if addend is not None:
        y.add_(addend.float())
    y = y * scale.float() + shift.float()
    y = torch.where(y >= 0, y, y * alpha.float())
    kd, kh, kw = (shifted_pad_keep(a, y.shape[1 + a], y.shape[4], y.device)
                  for a in range(3))
    keep = kd[:, None, None, :] & kh[None, :, None, :] & kw[None, None, :, :]
    return torch.where(keep, y, 0.0).to(x.dtype)


def conv2_packed_as_bn_act(x: torch.Tensor, wp: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor,
                           alpha: torch.Tensor, *,
                           addend: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The aligned->shifted k=2 packed conv (`conv2_packed(x, wp, pad=1)`)
    with kernel B2 as its epilogue, in one launch:

        y = sum_q xin[...] @ wp[q] (+ addend), in float32
        out = mask(prelu(y * scale + shift, alpha)), rounded once

    x: (N, D, H, W, 8Ci) float32 or bfloat16; wp (2, 2, 2, 8Ci, 8Co) in its
    dtype; scale, shift, alpha: packed (8Co,) (read as float32); addend:
    None or the (N, D+1, H+1, W+1, 8Co) partial sum of another conv in x's
    dtype (the decoder's skip half).  The pad mask zeroes the pad voxels
    of the shifted output (`shifted_pad_keep`).  On the card
    `_conv2_route` picks the kernel as for `conv2_packed`; a failure
    raises."""
    _check_conv2_args(x, wp, 1)
    n, d, h, w, c8i = x.shape
    c8o = wp.shape[4]
    for name, t in (("scale", scale), ("shift", shift), ("alpha", alpha)):
        if tuple(t.shape) != (c8o,):
            raise ValueError(f"{name} must have shape ({c8o},), got "
                             f"{tuple(t.shape)}")
    if c8o % 8:
        raise ValueError(f"conv2_packed_as_bn_act needs 8Co % 8 == 0, got "
                         f"{c8o}")
    out_shape = (n, d + 1, h + 1, w + 1, c8o)
    if addend is not None and (tuple(addend.shape) != out_shape
                               or addend.dtype != x.dtype):
        raise ValueError(f"addend must be {x.dtype} of shape {out_shape}, "
                         f"got {addend.dtype} {tuple(addend.shape)}")
    if x.device.type == "cpu":
        return conv2_packed_as_bn_act_plain(x, wp, scale, shift, alpha,
                                            addend)
    _check_conv2_cuda(x, wp, "conv2_packed_as_bn_act")
    vecs = [t.to(device=x.device, dtype=torch.float32).contiguous()
            for t in (scale, shift, alpha)]
    tc = _conv2_route(x.dtype, c8i, c8o) == "tc"
    out = _conv2_launch(x, wp, None, 1, tc, (*vecs, addend))
    if out.numel():
        conv2_packed.launches += 1
        conv2_packed.tc_launches += tc
        conv2_packed_as_bn_act.launches += 1
        conv2_packed_as_bn_act.tc_launches += tc
    return out


conv2_packed_as_bn_act.launches = 0
conv2_packed_as_bn_act.tc_launches = 0


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
    `shifted_pad_keep` as float32 (`ops.packed.shifted_pad_mask_tensors`)."""
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
# train-mode BatchNorm + PReLU + shifted pad zeroing: the four passes of
# `ops/packed.py::BnActTrainPacked`
# ---------------------------------------------------------------------------

# The passes take their per-fine-channel float32 parameters as the rows
# of one (rows, C) tensor: mean, rstd, gamma, beta, alpha (the apply and
# reduction passes: 5 rows), then for the dx pass p = gamma * rstd and the
# statistics term's k2, k3 (8 rows).
_BN_MAX_C = 256        # fine channels a block of 256 threads can cover


def _bn_keep_plain(y: torch.Tensor, shifted: bool,
                   d_faces: Tuple[bool, bool]) -> torch.Tensor:
    """The kernels' pad mask as a float32 multiplier broadcast over y: the
    product of the three `shifted_pad_keep` planes of a shifted y (on D
    only at the faces in `d_faces`), 1 everywhere in an aligned y."""
    if not shifted:
        return torch.ones((), device=y.device)
    md, mh, mw = (shifted_pad_keep(a, y.shape[1 + a], y.shape[-1], y.device,
                                   *(d_faces if a == 0 else (True, True)))
                  .float() for a in range(3))
    return md[:, None, None, :] * mh[None, :, None, :] * mw[None, None, :, :]


def _bn_z(yf: torch.Tensor, prm: torch.Tensor):
    """yh = (y - mean) * rstd and z = gamma * yh + beta, float32."""
    mean, rstd, gamma, beta = (prm[i].repeat(8) for i in range(4))
    yh = (yf - mean) * rstd
    return yh, yh * gamma + beta


def _bn_fold(sums: torch.Tensor) -> torch.Tensor:
    """(S, N, D, H, W, 8C) -> (S, C): every axis but the channels summed,
    then the 8 sub-positions."""
    s = sums.sum(dim=(1, 2, 3, 4))
    return s.reshape(s.shape[0], 8, -1).sum(1)


def bn_train_stats_plain(y: torch.Tensor, *, shifted: bool,
                         d_faces: Tuple[bool, bool],
                         owned_d: int) -> torch.Tensor:
    """Plain version of `bn_train_stats`."""
    yf = (y.float() * _bn_keep_plain(y, shifted, d_faces)).narrow(
        1, 0, owned_d)
    return _bn_fold(torch.stack([yf, yf.square()]))


def bn_train_apply_plain(y: torch.Tensor, prm: torch.Tensor, *,
                         shifted: bool,
                         d_faces: Tuple[bool, bool]) -> torch.Tensor:
    """Plain version of `bn_train_apply`."""
    _, z = _bn_z(y.float(), prm)
    alpha = prm[4].repeat(8)
    out = torch.where(z >= 0, z, z * alpha)
    return (out * _bn_keep_plain(y, shifted, d_faces)).to(y.dtype)


def _bn_gz(y, g, prm, shifted, d_faces):
    yh, z = _bn_z(y.float(), prm)
    gk = g.float() * _bn_keep_plain(y, shifted, d_faces)
    return yh, z, gk, torch.where(z >= 0, gk, gk * prm[4].repeat(8))


def _bn_reduce_terms(y, g, prm, shifted, d_faces):
    """The three terms per entry that `bn_train_reduce` sums."""
    yh, z, gk, gz = _bn_gz(y, g, prm, shifted, d_faces)
    return torch.stack([gz, gz * yh, torch.where(z < 0, gk * z, 0.0)])


def bn_train_reduce_plain(y: torch.Tensor, g: torch.Tensor,
                          prm: torch.Tensor, *, shifted: bool,
                          d_faces: Tuple[bool, bool]) -> torch.Tensor:
    """Plain version of `bn_train_reduce`."""
    return _bn_fold(_bn_reduce_terms(y, g, prm, shifted, d_faces))


def bn_train_dx_plain(y: torch.Tensor, g: torch.Tensor, prm: torch.Tensor,
                      *, shifted: bool, d_faces: Tuple[bool, bool],
                      owned_d: int) -> torch.Tensor:
    """Plain version of `bn_train_dx`."""
    yh, _, _, gz = _bn_gz(y, g, prm, shifted, d_faces)
    p, k2, k3 = (prm[i].repeat(8) for i in (5, 6, 7))
    owned = (torch.arange(y.shape[1], device=y.device) < owned_d).float()
    stat = (k2 + yh * k3) * owned[:, None, None, None]
    dy = (p * gz - stat) * _bn_keep_plain(y, shifted, d_faces)
    return dy.to(y.dtype)


def bn_train_sum_scale(y: torch.Tensor, g: Optional[torch.Tensor] = None,
                       prm: Optional[torch.Tensor] = None, *, shifted: bool,
                       d_faces: Tuple[bool, bool] = (True, True),
                       owned_d: Optional[int] = None) -> torch.Tensor:
    """The sums of the magnitudes of the terms that `bn_train_stats` (g
    None) or `bn_train_reduce` adds up, by their plain versions'
    arithmetic: the scale of their float32 summation error, to which the
    checks of the kernels against the plain versions hold them."""
    if g is None:
        return bn_train_stats_plain(
            y.abs(), shifted=shifted, d_faces=d_faces,
            owned_d=y.shape[1] if owned_d is None else owned_d)
    return _bn_fold(_bn_reduce_terms(y, g, prm, shifted, d_faces).abs())


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bn_launch_args(name: str, y: torch.Tensor, prm, rows: int,
                    tensors=()):
    """Checks shared by the four passes (`tensors`: (name, tensor) pairs
    shaped like y, in its dtype); returns (n, d, h, w, c, grid): a block
    per 256 // c cells, at most 8 blocks per SM."""
    if y.ndim != 5 or y.shape[-1] % 8:
        raise ValueError(f"{name} needs a packed (N,D,H,W,8C) tensor, got "
                         f"{tuple(y.shape)}")
    n, d, h, w, c8 = y.shape
    c = c8 // 8
    if prm is not None and tuple(prm.shape) != (rows, c):
        raise ValueError(f"{name} needs ({rows}, {c}) parameters, got "
                         f"{tuple(prm.shape)}")
    if y.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {y.device}")
    if y.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16, not {y.dtype}")
    if c > _BN_MAX_C:
        raise ValueError(f"{name} serves at most {_BN_MAX_C} fine channels, "
                         f"got {c}")
    cells = n * d * h * w
    if cells >= 2 ** 31:
        raise ValueError(f"{name} serves fewer than 2^31 cells, got {cells}")
    _check_cuda("y", y, y.dtype, y.device)
    for tname, t in tensors:
        if t.shape != y.shape:
            raise ValueError(f"{tname} {tuple(t.shape)} != y "
                             f"{tuple(y.shape)}")
        _check_cuda(tname, t, y.dtype, y.device)
    if prm is not None:
        _check_cuda("prm", prm, torch.float32, y.device)
    cpb = 256 // c
    grid = max(1, min(-(-cells // cpb), 8 * _sm_count(y.device)))
    return n, d, h, w, c, grid


def bn_train_stats(y: torch.Tensor, *, shifted: bool,
                   d_faces: Tuple[bool, bool] = (True, True),
                   owned_d: Optional[int] = None) -> torch.Tensor:
    """(2, C) float32 (Σy, Σy²) per fine channel of packed y (N, D, H, W,
    8C), over the cells d < owned_d (default all), the pad sub-positions
    of a shifted y left out: the statistics pass of `BnActTrainPacked`
    (`csrc/bn_train_packed.cu`: per-block partials, then a launch that
    sums them in a fixed order)."""
    owned_d = y.shape[1] if owned_d is None else owned_d
    if y.device.type == "cpu":
        return bn_train_stats_plain(y, shifted=shifted, d_faces=d_faces,
                                    owned_d=owned_d)
    n, d, h, w, c, grid = _bn_launch_args("bn_train_stats", y, None, 0)
    partial = torch.empty((grid, 2, 8 * c), device=y.device)
    out = torch.empty((2, c), device=y.device)
    with torch.cuda.device(y.device):
        rc = load().mri_bn_train_stats(
            y.data_ptr(), partial.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[y.dtype], n, d, h, w, c, int(shifted),
            int(d_faces[0]), int(d_faces[1]), owned_d, grid,
            torch.cuda.current_stream(y.device).cuda_stream)
    _raise_on(rc, "bn_train_stats")
    bn_train_stats.launches += 1
    return out


bn_train_stats.launches = 0


def bn_train_apply(y: torch.Tensor, prm: torch.Tensor, *, shifted: bool,
                   d_faces: Tuple[bool, bool] = (True, True)) -> torch.Tensor:
    """keep * prelu(gamma * (y - mean) * rstd + beta, alpha) in float32,
    one rounding to y's dtype; prm: (5, C) float32 rows mean, rstd, gamma,
    beta, alpha.  The apply pass of `BnActTrainPacked`."""
    if y.device.type == "cpu":
        return bn_train_apply_plain(y, prm, shifted=shifted, d_faces=d_faces)
    n, d, h, w, c, grid = _bn_launch_args("bn_train_apply", y, prm, 5)
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        rc = load().mri_bn_train_apply(
            y.data_ptr(), prm.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[y.dtype], n, d, h, w, c, int(shifted),
            int(d_faces[0]), int(d_faces[1]), grid,
            torch.cuda.current_stream(y.device).cuda_stream)
    _raise_on(rc, "bn_train_apply")
    bn_train_apply.launches += 1
    return out


bn_train_apply.launches = 0


def bn_train_reduce(y: torch.Tensor, g: torch.Tensor, prm: torch.Tensor, *,
                    shifted: bool,
                    d_faces: Tuple[bool, bool] = (True, True)
                    ) -> torch.Tensor:
    """(3, C) float32 per fine channel: Σgz, Σgz·yh and Σ keep·g·z·[z < 0],
    with gz = keep * g * (z >= 0 ? 1 : alpha), over every cell of y; g is
    the output's cotangent, in y's dtype; prm as for `bn_train_apply`.
    The backward reduction pass of `BnActTrainPacked`."""
    if y.device.type == "cpu":
        return bn_train_reduce_plain(y, g, prm, shifted=shifted,
                                     d_faces=d_faces)
    n, d, h, w, c, grid = _bn_launch_args("bn_train_reduce", y, prm, 5,
                                          (("g", g),))
    partial = torch.empty((grid, 3, 8 * c), device=y.device)
    out = torch.empty((3, c), device=y.device)
    with torch.cuda.device(y.device):
        rc = load().mri_bn_train_reduce(
            y.data_ptr(), g.data_ptr(), prm.data_ptr(), partial.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[y.dtype], n, d, h, w, c,
            int(shifted), int(d_faces[0]), int(d_faces[1]), grid,
            torch.cuda.current_stream(y.device).cuda_stream)
    _raise_on(rc, "bn_train_reduce")
    bn_train_reduce.launches += 1
    return out


bn_train_reduce.launches = 0


def bn_train_dx(y: torch.Tensor, g: torch.Tensor, prm: torch.Tensor, *,
                shifted: bool, d_faces: Tuple[bool, bool] = (True, True),
                owned_d: Optional[int] = None) -> torch.Tensor:
    """dy = keep * (p * gz - [d < owned_d] * (k2 + k3 * yh)) in y's dtype;
    prm: (8, C) float32, `bn_train_apply`'s rows, then p, k2, k3.  The
    backward dx pass of `BnActTrainPacked`."""
    owned_d = y.shape[1] if owned_d is None else owned_d
    if y.device.type == "cpu":
        return bn_train_dx_plain(y, g, prm, shifted=shifted,
                                 d_faces=d_faces, owned_d=owned_d)
    n, d, h, w, c, grid = _bn_launch_args("bn_train_dx", y, prm, 8,
                                          (("g", g),))
    dy = torch.empty_like(y)
    with torch.cuda.device(y.device):
        rc = load().mri_bn_train_dx(
            y.data_ptr(), g.data_ptr(), prm.data_ptr(), dy.data_ptr(),
            _DTYPE_CODE[y.dtype], n, d, h, w, c, int(shifted),
            int(d_faces[0]), int(d_faces[1]), owned_d, grid,
            torch.cuda.current_stream(y.device).cuda_stream)
    _raise_on(rc, "bn_train_dx")
    bn_train_dx.launches += 1
    return dy


bn_train_dx.launches = 0


# ---------------------------------------------------------------------------
# B3: zero-padded strided conv along one spatial axis
# ---------------------------------------------------------------------------

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
    (L + 2 pad - k) // stride + 1 in the output.  Computed in float32 and
    rounded once to x's dtype, float32 or bfloat16.  One launch on the
    card: with x and w both bfloat16 (`_axis_fwd_route`) the tensor-core
    kernel of `conv_axis_tc.cu` (`conv_axis_tc_plan`), counted in
    `.tc_launches` too; else `conv_axis.cu`'s, which reads w and bias as
    float32 and keeps w in shared memory, or reads it from global memory
    where it exceeds one block's 227 KB."""
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
    _check_cuda("x", x, x.dtype, x.device)
    tc = _axis_fwd_route(x.dtype, w.dtype) == "tc"
    # the tensor-core kernel reads w (k, Ci, Co) in bf16 as it comes, the
    # CUDA-core one in float32
    wt = w.to(device=x.device, dtype=torch.bfloat16 if tc
              else torch.float32).contiguous()
    _check_cuda("w", wt, wt.dtype, x.device)
    bias_ptr = None
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
        _check_cuda("bias", bias, torch.float32, x.device)
        bias_ptr = bias.data_ptr()
    shape = list(x.shape)
    shape[axis], shape[4] = lo, co
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # x as (A, L, B, Ci): the dims before the conv axis, the axis, and the
    # spatial dims after it
    a = int(x.shape[:axis].numel())
    b = int(x.shape[axis + 1:4].numel())
    lib = load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if tc:
            plan = _cached_plan(conv_axis_tc_plan, a, length, lo, b, ci, co,
                                k, stride, pad)
            geo = (ctypes.c_longlong * len(plan))(*plan)
            rc = lib.mri_conv_axis_tc(
                x.data_ptr(), wt.data_ptr(), bias_ptr, out.data_ptr(),
                ctypes.cast(geo, ctypes.c_void_p), len(plan), stream)
        else:
            rc = lib.mri_conv_axis(
                x.data_ptr(), wt.data_ptr(), bias_ptr, out.data_ptr(),
                _DTYPE_CODE[x.dtype], a, length, lo, b, ci, co, k, stride,
                pad, stream)
    _raise_on(rc, "conv_axis")
    conv_axis.launches += 1
    conv_axis.tc_launches += tc
    return out


conv_axis.launches = 0
conv_axis.tc_launches = 0


def conv_one_axis(x: torch.Tensor, w: torch.Tensor, axis: int, *,
                  stride: int = 1, pad: int = 0,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-axis conv on channels-last (N, D, H, W, C) along spatial `axis`
    (1, 2 or 3); w: (k, Ci, Co).  One `conv_axis` launch, bias fused."""
    return conv_axis(x.contiguous(), w, bias, axis=axis, stride=stride,
                     pad=pad)


# ---------------------------------------------------------------------------
# B3 fused: the three one-axis convs of a separable stack in one launch
# ---------------------------------------------------------------------------

# output cells of the largest tile (D, H, W); the plan halves it until its
# shared memory fits _SEP_SMEM_TARGET (two blocks per SM), and refuses a
# stack whose 1x1x1 tile needs more than one block's 227 KB
_SEP_TILE = (4, 8, 16)
_SEP_SMEM_TARGET = 112 * 1024
_SMEM_MAX = 232448
_SEP_MMA_MAX_K = 512          # k x Cin of a tensor-core stage (its K table)
_SEP_PER_AXIS_MIN_CIN = 64    # bf16 stacks this wide take three conv_axis


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


class SepPlan(NamedTuple):
    """Tile plan of one fused `separable_conv3d` launch."""
    out: Tuple[int, int, int]     # output extents (Do, Ho, Wo)
    tile: Tuple[int, int, int]    # output cells per tile (TD, TH, TW)
    halo: Tuple[int, int, int]    # input cells per tile (LD, LH, LW)
    tiles: Tuple[int, int, int]   # tiles along (D, H, W)
    mma: Tuple[bool, bool, bool]  # stage on tensor cores (D, H, W)
    off_y1: int                   # shared-memory layout, bytes: input / y2
    off_w: int                    # at 0, y1 at off_y1, weights at off_w
    smem: int
    grid: int                     # blocks: N x tiles
    cin: int                      # the stack's input channels
    cout: int                     # and its output channels


def _sep_smem(tile, halo, chans, ks, mma, esize):
    """(off_y1, off_w, total) bytes of the kernel's shared memory.  Input
    rows whose cells are narrower than the kernel's 16-byte copy units are
    padded to whole units, with a lead of up to one unit less one cell."""
    (td, th, tw), (ld, lh, lw) = tile, halo
    ci, c1, c2, _ = chans
    cell = ci * esize
    per = 16 // cell if cell < 16 and 16 % cell == 0 else 1
    pitch = -(-(lw + per - 1) // per) * per
    region_a = _align16(max(ld * lh * pitch * ci, td * th * lw * c2) * esize)
    y1 = _align16(td * lh * lw * c1 * esize)
    wbytes = 0
    for k, cin, cout, on_tc in zip(ks, chans[:3], chans[1:], mma):
        kpad = -(-k * cin // 16) * 16
        wbytes = max(wbytes, cout * (kpad + 8) * 2 if on_tc
                     else k * cin * cout * 4)
    return region_a, region_a + y1, region_a + y1 + _align16(wbytes)


def separable_plan(n: int, spatial: Sequence[int], chans: Sequence[int],
                   ks: Sequence[int], strides: Sequence[int],
                   pads: Sequence[int],
                   dtype: torch.dtype) -> Optional[SepPlan]:
    """The fused kernel's plan for x (n, *spatial, chans[0]) through stages
    of chans[1], chans[2], chans[3] output channels, or None where even a
    1x1x1 tile does not fit one block's shared memory.  The tile starts at
    `_SEP_TILE` (clipped to the output) and its longest axis (D first on
    ties) is halved until the shared memory fits `_SEP_SMEM_TARGET`.
    Tensor cores take the bf16 stages whose Cin and Cout are multiples of
    8 and whose k x Cin is at most 512.  Plans are cached."""
    return _separable_plan(int(n), *(tuple(int(v) for v in a) for a in
                                     (spatial, chans, ks, strides, pads)),
                           dtype)


@functools.lru_cache(maxsize=None)
def _separable_plan(n, spatial, chans, ks, strides, pads, dtype):
    out = tuple(_axis_out_len(length, k, s, p)
                for length, k, s, p in zip(spatial, ks, strides, pads))
    esize = 2 if dtype == torch.bfloat16 else 4
    mma = tuple(dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0
                and k * cin <= _SEP_MMA_MAX_K
                for k, cin, cout in zip(ks, chans[:3], chans[1:]))
    tile = [min(t, o) for t, o in zip(_SEP_TILE, out)]
    while True:
        halo = tuple((t - 1) * s + k for t, s, k in zip(tile, strides, ks))
        off_y1, off_w, smem = _sep_smem(tile, halo, chans, ks, mma, esize)
        if smem <= _SEP_SMEM_TARGET or tile == [1, 1, 1]:
            break
        a = max(range(3), key=lambda i: (tile[i], -i))
        tile[a] = -(-tile[a] // 2)
    if smem > _SMEM_MAX:
        return None
    tiles = tuple(-(-o // t) for o, t in zip(out, tile))
    return SepPlan(out=out, tile=tuple(tile), halo=halo, tiles=tiles,
                   mma=mma, off_y1=off_y1, off_w=off_w, smem=smem,
                   grid=n * tiles[0] * tiles[1] * tiles[2], cin=chans[0],
                   cout=chans[3])


def _separable_route(dtype: torch.dtype, plan: Optional[SepPlan]) -> str:
    """The kernel that serves a `separable_conv3d` call on the card:
    "fused" (`separable_conv3d.cu`, one launch) for float32 and bfloat16
    stacks whose tile plan fits shared memory, "per_axis" (three
    `conv_axis` launches) otherwise, and for two kinds of bfloat16 stack
    where three `conv_axis` launches measured far faster on the H100
    (PERF.md): those of at least `_SEP_PER_AXIS_MIN_CIN` input channels,
    where the fused tile shrinks to a few cells and recomputes its halo
    many times over (the depth-6 AE's 24^3 x 64 -> 128 stack at batch 3:
    0.18-0.30 against 5.11 ms), and those with one output channel, which
    `conv_axis` takes on its dense path (the AE's 192^3 x 16 -> 1 output
    stack: 0.82 against 1.72 ms).  It depends on dtype and shape only,
    never on whether a build or launch failed."""
    if dtype not in _DTYPE_CODE or plan is None:
        return "per_axis"
    if dtype == torch.bfloat16 and (plan.cin >= _SEP_PER_AXIS_MIN_CIN
                                    or plan.cout == 1):
        return "per_axis"
    return "fused"


def separable_conv3d_plain(x: torch.Tensor, wx: torch.Tensor,
                           wy: torch.Tensor, wz: torch.Tensor, *,
                           stride=(1, 1, 1), pad=(0, 0, 0),
                           biases=(None, None, None)) -> torch.Tensor:
    """Plain version of `separable_conv3d`: `conv_axis_plain` along D, H
    and W in turn, each rounded to x.dtype."""
    for axis, w in zip((1, 2, 3), (wx, wy, wz)):
        x = conv_axis_plain(x, w, biases[axis - 1], axis=axis,
                            stride=stride[axis - 1], pad=pad[axis - 1])
    return x


def separable_conv3d(x: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
                     wz: torch.Tensor, *, stride=(1, 1, 1), pad=(0, 0, 0),
                     biases=(None, None, None)) -> torch.Tensor:
    """The fader conv stack: (k,1,1), then (1,k,1), then (1,1,k), each with
    its own stride, pad and bias, each summed in float32 and rounded to
    x.dtype.  On the card `_separable_route` sends it to the fused kernel
    (one launch, intermediates in shared memory) or to three `conv_axis`
    launches; a failure raises.

    wx: (k, Ci, C1), wy: (k, C1, C2), wz: (k, C2, C3): torch (O, I, k, 1,
    1)-style weights viewed as (k, I, O)."""
    if x.ndim != 5 or any(w.ndim != 3 for w in (wx, wy, wz)):
        raise ValueError("separable_conv3d needs x (N,D,H,W,Ci) and three "
                         "(k,Ci,Co) weights")
    chans = (x.shape[4], wx.shape[2], wy.shape[2], wz.shape[2])
    if (wx.shape[1], wy.shape[1], wz.shape[1]) != chans[:3]:
        raise ValueError(f"channel chain {chans[:3]} does not match the "
                         f"weights {tuple(wx.shape)}, {tuple(wy.shape)}, "
                         f"{tuple(wz.shape)}")
    ks = (wx.shape[0], wy.shape[0], wz.shape[0])
    for axis, (k, s, p) in enumerate(zip(ks, stride, pad), start=1):
        if s < 1 or p < 0 or _axis_out_len(x.shape[axis], k, s, p) < 1:
            raise ValueError(f"axis {axis} of length {x.shape[axis]} does "
                             f"not take k={k}, stride={s}, pad={p}")
    for b, c in zip(biases, chans[1:]):
        if b is not None and tuple(b.shape) != (c,):
            raise ValueError(f"bias must have shape ({c},)")
    if x.device.type == "cpu":
        return separable_conv3d_plain(x, wx, wy, wz, stride=stride, pad=pad,
                                      biases=biases)
    if x.device.type != "cuda":
        raise ValueError(f"separable_conv3d runs on cpu or cuda, not "
                         f"{x.device}")
    plan = separable_plan(x.shape[0], x.shape[1:4], chans, ks, stride, pad,
                          x.dtype)
    if _separable_route(x.dtype, plan) == "per_axis":
        for axis, w in zip((1, 2, 3), (wx, wy, wz)):
            x = conv_one_axis(x, w, axis, stride=stride[axis - 1],
                              pad=pad[axis - 1], bias=biases[axis - 1])
        return x
    x = x.contiguous()
    _check_cuda("x", x, x.dtype, x.device)
    # the kernel reads the weights in x's dtype in torch's (O, I, k)
    # layout: the fader's (k, I, O) views of its conv weights need no copy
    ws = [w.to(device=x.device, dtype=x.dtype).permute(2, 1, 0).contiguous()
          for w in (wx, wy, wz)]
    bs = [None if b is None else
          b.to(device=x.device, dtype=torch.float32).contiguous()
          for b in biases]
    for name, t in zip(("wx", "wy", "wz", "bx", "by", "bz"), ws + bs):
        if t is not None:
            _check_cuda(name, t, x.dtype if name[0] == "w" else torch.float32,
                        x.device)
    out = torch.empty((x.shape[0], *plan.out, chans[3]), dtype=x.dtype,
                      device=x.device)
    geo = (*x.shape[1:4], *plan.out, *plan.tile, *plan.halo, *plan.tiles,
           *chans, *ks, *stride, *pad, *map(int, plan.mma), plan.off_y1,
           plan.off_w, plan.smem)
    geo_arr = (ctypes.c_int * len(geo))(*geo)
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.mri_separable_conv3d(
            x.data_ptr(), *[t.data_ptr() for t in ws],
            *[None if t is None else t.data_ptr() for t in bs],
            out.data_ptr(), _DTYPE_CODE[x.dtype], x.shape[0],
            ctypes.cast(geo_arr, ctypes.c_void_p), len(geo),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "separable_conv3d")
    if out.numel():
        separable_conv3d.launches += 1
    return out


separable_conv3d.launches = 0


# ---------------------------------------------------------------------------
# B3's backward: input, weight and bias gradients of the one-axis conv
# ---------------------------------------------------------------------------


def _axis_slice(ndim: int, axis: int, sl: slice) -> tuple:
    idx = [slice(None)] * ndim
    idx[axis] = sl
    return tuple(idx)


def conv_axis_dx_taps(i: int, lo: int, k: int, stride: int,
                      pad: int) -> list:
    """The (tap t, output index j) pairs that `conv_axis_dx` sums at input
    index i, in the kernel's order: t = (i + pad) % stride, then every
    stride-th tap, j = (i + pad - t) / stride, kept while 0 <= j < lo."""
    taps = []
    for t in range((i + pad) % stride, k, stride):
        j = (i + pad - t) // stride
        if j < 0:
            break
        if j < lo:
            taps.append((t, j))
    return taps


def conv_axis_dx_plain(g: torch.Tensor, w: torch.Tensor, *, length: int,
                       axis: int, stride: int = 1,
                       pad: int = 0) -> torch.Tensor:
    """Plain version of `conv_axis_dx`: each tap's `g @ w[t]^T` added at
    the input positions j * stride + t - pad of a float32 buffer, which is
    then cropped to the input's extent and rounded once to g.dtype."""
    k, ci, _ = w.shape
    lo = g.shape[axis]
    shape = list(g.shape)
    shape[axis] = max(length + 2 * pad, (lo - 1) * stride + k)
    shape[-1] = ci
    out = torch.zeros(shape, dtype=torch.float32, device=g.device)
    gf, wf = g.float(), w.float()
    for t in range(k):
        out[_axis_slice(g.ndim, axis,
                        slice(t, t + (lo - 1) * stride + 1, stride))] += (
            torch.matmul(gf, wf[t].t()))
    return out[_axis_slice(g.ndim, axis, slice(pad, pad + length))].to(
        g.dtype)


def conv_axis_dx(g: torch.Tensor, w: torch.Tensor, *, length: int,
                 axis: int, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """Input gradient of `y = conv_axis(x, w, axis=axis, stride=stride,
    pad=pad)` for x of `length` along `axis`: with y's cotangent g (N, D,
    H, W, Co) and w (k, Ci, Co),

        dx[..., i, ..., ci] = sum over (t, j) of conv_axis_dx_taps(i, ...)
                              sum_co g[..., j, ..., co] w[t, ci, co],

    a gather with no zero-stuffed cotangent, summed in float32 (w read as
    float32) and rounded once to g's dtype, float32 or bfloat16.  One
    launch on the card: with g and w in bfloat16 (`_axis_bwd_route`) the
    tensor-core kernel of `conv_axis_bwd_tc.cu` (`conv_axis_dx_tc_plan`),
    counted in `.tc_launches` too, else `conv_axis_bwd.cu`'s."""
    if g.ndim != 5 or w.ndim != 3:
        raise ValueError(f"conv_axis_dx needs g (N,D,H,W,Co) and w "
                         f"(k,Ci,Co); got {tuple(g.shape)}, {tuple(w.shape)}")
    if axis not in (1, 2, 3):
        raise ValueError(f"axis must be 1, 2 or 3, got {axis}")
    k, ci, co = w.shape
    if co != g.shape[4]:
        raise ValueError(f"w has {co} output channels, g {g.shape[4]}")
    if stride < 1 or pad < 0 or _axis_out_len(length, k, stride, pad) \
            != g.shape[axis]:
        raise ValueError(f"an input of length {length} with k={k}, "
                         f"stride={stride}, pad={pad} does not give g's "
                         f"length {g.shape[axis]}")
    if g.device.type == "cpu":
        return conv_axis_dx_plain(g, w, length=length, axis=axis,
                                  stride=stride, pad=pad)
    if g.device.type != "cuda":
        raise ValueError(f"conv_axis_dx runs on cpu or cuda, not {g.device}")
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv_axis_dx takes float32 or bfloat16, not "
                        f"{g.dtype}")
    g = g.contiguous()
    _check_cuda("g", g, g.dtype, g.device)
    tc = _axis_bwd_route(g.dtype, w.dtype) == "tc"
    if tc:
        # (k, Ci, Co) bf16 as it comes: a row of Co per (t, ci)
        wt = w.to(device=g.device).contiguous()
        _check_cuda("w", wt, torch.bfloat16, g.device)
    else:
        # the kernel reads the weights as (k, Co, Ci): a row of Ci per
        # (t, co)
        wt = w.to(device=g.device, dtype=torch.float32).permute(0, 2, 1) \
            .contiguous()
        _check_cuda("wt", wt, torch.float32, g.device)
    shape = list(g.shape)
    shape[axis], shape[4] = length, ci
    dx = torch.empty(shape, dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    a = int(g.shape[:axis].numel())
    b = int(g.shape[axis + 1:4].numel())
    lib = load()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        if tc:
            plan = _cached_plan(conv_axis_dx_tc_plan, a, length,
                                g.shape[axis], b, ci, co, k, stride, pad)
            geo = (ctypes.c_longlong * len(plan))(*plan)
            rc = lib.mri_conv_axis_dx_tc(
                g.data_ptr(), wt.data_ptr(), dx.data_ptr(),
                ctypes.cast(geo, ctypes.c_void_p), len(plan), stream)
        else:
            rc = lib.mri_conv_axis_dx(
                g.data_ptr(), wt.data_ptr(), dx.data_ptr(),
                _DTYPE_CODE[g.dtype], a, length, g.shape[axis], b, ci, co, k,
                stride, pad, stream)
    _raise_on(rc, "conv_axis_dx")
    conv_axis_dx.launches += 1
    conv_axis_dx.tc_launches += tc
    return dx


conv_axis_dx.launches = 0
conv_axis_dx.tc_launches = 0

# dw's split plan: a block holds _DW_THREADS threads; the rows are split
# into enough chunks for about _DW_BLOCKS blocks in all (8 per SM of the
# H100's 132), each thread taking at least _DW_MIN_ROWS rows of its chunk,
# and the partial sums held to _DW_MAX_PARTIALS floats of scratch
_DW_THREADS = 256
_DW_BLOCKS = 132 * 8
_DW_MIN_ROWS = 16
_DW_MAX_PARTIALS = 1 << 24


class DwPlan(NamedTuple):
    """Split plan of one `conv_axis_dw` call over `rows` = A x Lo x B
    cotangent rows and k x Ci x Co (+ Co) outputs."""
    cot: int             # output channels per thread (a channel group)
    og_total: int        # output groups: k x Ci x Co / cot
    og_block: int        # output groups per block (its tile)
    lanes: int           # threads per output group; a block is og_block x lanes
    tiles: int           # output tiles (grid y)
    chunks: int          # row chunks (grid x)
    rows_per_chunk: int
    nout: int            # partial sums per chunk: k x Ci x Co + Co


def conv_axis_dw_plan(rows: int, k: int, ci: int, co: int) -> DwPlan:
    """The plan of `conv_axis_dw` for `rows` >= 1.  Thread (lane, g) of
    block (chunk, tile) owns output group og = tile * og_block + g, that
    is (t, ci, channel group) = divmod(og // (Co / cot), Ci), group og %
    (Co / cot), and sums rows chunk * rows_per_chunk + lane, + lanes, ...
    of its chunk; the db sums ride with the (t, ci) = (0, 0) groups, all
    in tile 0."""
    cot = next(c for c in (8, 4, 2, 1) if co % c == 0)
    groups = co // cot
    og_total = k * ci * groups
    og_block = min(og_total, _DW_THREADS)
    if groups > og_block:
        raise ValueError(f"conv_axis_dw takes at most {_DW_THREADS * 8} "
                         f"output channels, got {co}")
    lanes = _DW_THREADS // og_block
    tiles = -(-og_total // og_block)
    nout = k * ci * co + co
    chunks = max(1, min(-(-_DW_BLOCKS // tiles),
                        rows // (lanes * _DW_MIN_ROWS),
                        _DW_MAX_PARTIALS // nout))
    rows_per_chunk = -(-rows // chunks)
    chunks = -(-rows // rows_per_chunk)
    return DwPlan(cot, og_total, og_block, lanes, tiles, chunks,
                  rows_per_chunk, nout)


def conv_axis_dw_plain(x: torch.Tensor, g: torch.Tensor, *, k: int,
                       axis: int, stride: int = 1, pad: int = 0,
                       bias: bool = True):
    """Plain version of `conv_axis_dw`: per tap, the float32 product of
    the zero-padded input's strided slice and g over every other index;
    db the float32 sum of g.  Returns (dw, db or None)."""
    lo, ci, co = g.shape[axis], x.shape[-1], g.shape[-1]
    if pad:
        spec = [0] * (2 * (x.ndim - axis))
        spec[-2:] = (pad, pad)
        x = TF.pad(x, spec)
    g2 = g.reshape(-1, co).float()
    dw = torch.stack([
        torch.matmul(x[_axis_slice(x.ndim, axis, slice(
            t, t + (lo - 1) * stride + 1, stride))].reshape(-1, ci)
            .float().t(), g2) for t in range(k)])
    return dw, (g2.sum(0) if bias else None)


def conv_axis_dw(x: torch.Tensor, g: torch.Tensor, *, k: int, axis: int,
                 stride: int = 1, pad: int = 0, bias: bool = True):
    """Weight and bias gradients of `y = conv_axis(x, w, axis=axis,
    stride=stride, pad=pad)` with w (k, Ci, Co), given x (N, D, H, W, Ci)
    and y's cotangent g (N, D', H', W', Co) in one dtype:

        dw[t, ci, co] = sum x[..., j * stride + t - pad, ..., ci]
                            * g[..., j, ..., co]   (x zero outside)
        db[co]        = sum g[..., co]             (with `bias`)

    float32 results (k, Ci, Co) and (Co,) or None.  On the card, two
    launches counted as one call: partial sums per row chunk, then the
    chunks summed in order, so with no float atomics a run repeats bit for
    bit.  bfloat16 takes the tensor-core kernels of `conv_axis_bwd_tc.cu`
    (`conv_axis_dw_tc_plan`; counted in `.tc_launches` too), float32 the
    CUDA-core ones of `conv_axis_bwd.cu` (`conv_axis_dw_plan`):
    `_axis_bwd_route`."""
    if x.ndim != 5 or g.ndim != 5:
        raise ValueError(f"conv_axis_dw needs x and g (N,D,H,W,C); got "
                         f"{tuple(x.shape)}, {tuple(g.shape)}")
    if axis not in (1, 2, 3):
        raise ValueError(f"axis must be 1, 2 or 3, got {axis}")
    if x.dtype != g.dtype:
        raise TypeError(f"x is {x.dtype}, g {g.dtype}")
    lo = _axis_out_len(x.shape[axis], k, stride, pad)
    other = [d for d in range(4) if d != axis]
    if stride < 1 or pad < 0 or lo != g.shape[axis] or [
            x.shape[d] for d in other] != [g.shape[d] for d in other]:
        raise ValueError(f"g {tuple(g.shape)} is not the output of x "
                         f"{tuple(x.shape)} with k={k}, stride={stride}, "
                         f"pad={pad} along axis {axis}")
    if x.device.type == "cpu":
        return conv_axis_dw_plain(x, g, k=k, axis=axis, stride=stride,
                                  pad=pad, bias=bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv_axis_dw runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv_axis_dw takes float32 or bfloat16, not "
                        f"{x.dtype}")
    x, g = x.contiguous(), g.contiguous()
    _check_cuda("x", x, x.dtype, x.device)
    _check_cuda("g", g, x.dtype, x.device)
    ci, co = x.shape[4], g.shape[4]
    dw = torch.zeros((k, ci, co), dtype=torch.float32, device=x.device)
    db = (torch.zeros(co, dtype=torch.float32, device=x.device) if bias
          else None)
    a = int(x.shape[:axis].numel())
    b = int(x.shape[axis + 1:4].numel())
    rows = a * lo * b
    if rows == 0:
        return dw, db
    tc = _axis_bwd_route(x.dtype) == "tc"
    lib = load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    db_ptr = None if db is None else db.data_ptr()
    with torch.cuda.device(x.device):
        if tc:
            plan = _cached_plan(conv_axis_dw_tc_plan, a, x.shape[axis], lo,
                                b, ci, co, k, stride, pad)
            partials = torch.empty(plan.slots * plan.nout,
                                   dtype=torch.float32, device=x.device)
            geo = (ctypes.c_longlong * len(plan))(*plan)
            rc = lib.mri_conv_axis_dw_tc(
                x.data_ptr(), g.data_ptr(), dw.data_ptr(), db_ptr,
                partials.data_ptr(), ctypes.cast(geo, ctypes.c_void_p),
                len(plan), stream)
        else:
            plan = conv_axis_dw_plan(rows, k, ci, co)
            partials = torch.empty(plan.chunks * plan.nout,
                                   dtype=torch.float32, device=x.device)
            plan_arr = (ctypes.c_int * 7)(plan.cot, plan.og_total,
                                          plan.og_block, plan.lanes,
                                          plan.tiles, plan.chunks,
                                          plan.rows_per_chunk)
            rc = lib.mri_conv_axis_dw(
                x.data_ptr(), g.data_ptr(), dw.data_ptr(), db_ptr,
                partials.data_ptr(), _DTYPE_CODE[x.dtype], a, x.shape[axis],
                lo, b, ci, co, k, stride, pad,
                ctypes.cast(plan_arr, ctypes.c_void_p), stream)
    _raise_on(rc, "conv_axis_dw")
    conv_axis_dw.launches += 1
    conv_axis_dw.tc_launches += tc
    return dw, db


conv_axis_dw.launches = 0
conv_axis_dw.tc_launches = 0


# ---------------------------------------------------------------------------
# B3's backward on tensor cores (bf16): plans and route
# ---------------------------------------------------------------------------

_TC_SMEM = 232448              # shared memory one block may use on the H100
_TC_BLOCKS = 132 * 8           # dx blocks to aim for: 8 per SM of the 132
_TC_DW_BLOCKS = 132 * 2        # dw blocks: one wave of 2 an SM (a block
                               # walks many row tiles; fewer slots to sum)
_TC_STAGE_BYTES = 32 * 1024    # bytes a ring stage aims to stage
_TC_STAGES = 3                 # ring stages, where shared memory allows
_TC_RING_BYTES = 110 * 1024    # a ring of small stages grows to this (2
                               # blocks an SM), up to 5 stages


def _axis_bwd_route(dtype: torch.dtype, w_dtype: Optional[torch.dtype] = None
                    ) -> str:
    """The kernels that serve a `conv_axis_dw` (x and g in `dtype`) or a
    `conv_axis_dx` (g in `dtype`, w in `w_dtype`) call on the card: "tc"
    (`conv_axis_bwd_tc.cu`: mma.sync on the tensor cores) when every
    operand is bfloat16, "cuda_core" (`conv_axis_bwd.cu`) otherwise.
    float32 stays off the tensor cores: TF32 would not hold dw to 2e-4 x
    max|ref| nor the f32 fader steps to their parity gates."""
    if dtype == torch.bfloat16 and w_dtype in (None, torch.bfloat16):
        return "tc"
    return "cuda_core"


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _warp_split(mt: int, nt: int, fms: Sequence[int]):
    """(wm, wn, fm, fn): the 8 warps of a block as wm x wn warp tiles of fm
    m16 tiles (of mt) by fn n8 tiles (of nt, a power of two), fm the least
    of `fms` that covers mt; the rest of the warps (8 / (wm wn)) split the
    K steps.  None if no split fits."""
    wn = max(1, nt // 4)
    for wm in (1, 2, 4, 8):
        if wm * wn > 8:
            break
        fm = next((f for f in fms if f * wm >= mt), None)
        if fm is not None:
            return wm, wn, fm, nt // wn
    return None


class DwTcPlan(NamedTuple):
    """Tile plan of one tensor-core `conv_axis_dw` call: the shape, x as
    (a, l, B, Ci) and g as (a, lo, B, Co), then the plan, in the order of
    the kernel's geometry array."""
    a: int
    l: int
    lo: int
    b: int
    ci: int
    co: int
    k: int
    s: int
    p: int
    cit: int         # input channels per M tile (1 when Ci = 1)
    cot: int         # output channels per N tile
    wm: int          # warps along M, along N, over k-steps
    wn: int
    wk: int
    fm: int          # m16 tiles and n8 tiles per warp
    fn: int
    bt: int          # a row tile: jn positions j x bt positions b of one a
    jn: int
    nl: int          # staged x positions along L: (jn - 1) s + k
    nlc: int         # staged x positions per parity class: ceil(nl / s)
    xpitch: int      # Ci = 1: elements per staged x row (bt rounded to 8)
    jtiles: int
    btiles: int
    tiles: int       # row tiles: a x jtiles x btiles
    tpc: int         # row tiles per chunk
    chunks: int      # grid x
    mtiles: int      # grid y: ceil(Ci / cit)
    ntiles: int      # grid z: ceil(Co / cot)
    stages: int
    smem: int        # bytes of shared memory per block
    ci1: int
    swap: int        # 1: the caller's (A, L, 1, Ci) as (1, L, A, Ci)

    @property
    def mt(self) -> int:
        """m16 tiles of a block's M (Ci = 1: taps; else pairs of 8-row
        groups (tap, 8 channels))."""
        if self.ci1:
            return _ceil(self.k, 16)
        return _ceil(self.k * self.cit // 8, 2)

    @property
    def nout(self) -> int:
        return self.k * self.ci * self.co + self.co

    @property
    def slots(self) -> int:
        """Slots of partial sums: one per (chunk, warp group over K)."""
        return self.chunks * self.wk


@functools.lru_cache(maxsize=1024)
def _cached_plan(plan_fn, *shape):
    """plan_fn(*shape), computed once per shape: a training step makes the
    same calls every step, and the plans' Python search costs tens of
    microseconds of host time per call."""
    return plan_fn(*shape)


def _dw_stage_bytes(jn, bt, k, s, cit, cot, ci1):
    nlc = _ceil((jn - 1) * s + k, s)
    x_row = _ceil(bt, 8) * 8 if ci1 else bt * cit
    return 2 * (s * nlc * x_row + jn * bt * cot)


def conv_axis_dw_tc_plan(a: int, l: int, lo: int, b: int, ci: int, co: int,
                         k: int, s: int, p: int) -> DwTcPlan:
    """The plan of a tensor-core `conv_axis_dw` call, x viewed as (a, l, b,
    ci), g as (a, lo, b, co), a x lo x b >= 1.  Block (chunk, mt, nt) sums
    row tiles chunk * tpc ... of the (a, j tile, b tile) order, b tiles
    fastest, into the M tile of all k taps x cit channels from mt * cit and
    the N tile of cot channels from nt * cot; warp (wmi, wni, kg), warp =
    wmi + wm (wni + wn kg), takes m16 tiles wmi * fm .., n8 tiles wni * fn
    .. and k-steps kg, kg + wk, .. of each row tile, into slot chunk * wk +
    kg.  A row tile stages nl x positions from j0 s - p and jn x bt g rows
    in a ring of `stages` buffers.  Along the last axis (b = 1, a > 1,
    Ci > 1) the plan swaps a and b: a row tile then takes bt consecutive
    a, each a row of l, which the kernel reads at l + b l (x) and j + b lo
    (g), so that a tile is not one short row."""
    swap = int(b == 1 and a > 1 and ci > 1)
    if swap:
        a, b = 1, a
    ci1 = ci == 1
    cit = 1 if ci1 else min(64, _pow2_at_least(max(ci, 8)))
    cot = min(64, _pow2_at_least(max(co, 8)))
    while True:
        mt = _ceil(k, 16) if ci1 else _ceil(k * cit // 8, 2)
        split = _warp_split(mt, cot // 8, (1,) if ci1 else (1, 2, 3, 4))
        if split is not None:
            break
        if not ci1 and cit > 8:
            cit //= 2
        elif cot > 8:
            cot //= 2
        else:
            raise ValueError(f"conv_axis_dw on tensor cores takes k <= 128, "
                             f"got k={k}")
    wm, wn, fm, fn = split
    wk = 8 // (wm * wn)
    stages = _TC_STAGES
    bt = min(b, 64)
    while True:
        jq = 16 // math.gcd(bt, 16)
        jmax = _ceil(lo, jq) * jq
        jn = jq
        # grow the tile to the stage target, and past it while the halo
        # (k - s rows) costs more than a quarter of the slab
        while jn + jq <= jmax:
            grown = _dw_stage_bytes(jn + jq, bt, k, s, cit, cot, ci1)
            if not (grown <= _TC_STAGE_BYTES or (
                    4 * (k - s) > jn * s and stages * grown <= _TC_SMEM)):
                break
            jn += jq
        # the same number of j tiles with the least padding
        jn = _ceil(_ceil(lo, _ceil(lo, jn)), jq) * jq
        stage = _dw_stage_bytes(jn, bt, k, s, cit, cot, ci1)
        fits = stages * stage <= _TC_SMEM
        if fits and (4 * (k - s) <= jn * s or jn >= lo or bt <= 16):
            break
        if bt > 16:      # narrower b tiles: a longer j range in the budget
            bt = 16 * _ceil(bt // 2, 16)
        elif fits:
            break
        elif stages > 2:
            stages -= 1
        else:
            raise ValueError(f"no conv_axis_dw tile fits shared memory at "
                             f"k={k}, s={s}, Ci={ci}, Co={co}")
    stages = max(stages, min(5, _TC_RING_BYTES // stage))
    nl = (jn - 1) * s + k
    jtiles, btiles = _ceil(lo, jn), _ceil(b, bt)
    tiles = a * jtiles * btiles
    mtiles, ntiles = (1 if ci1 else _ceil(ci, cit)), _ceil(co, cot)
    nout = k * ci * co + co
    chunks = max(1, min(tiles, _ceil(_TC_DW_BLOCKS, mtiles * ntiles),
                        _DW_MAX_PARTIALS // (nout * wk)))
    tpc = _ceil(tiles, chunks)
    chunks = _ceil(tiles, tpc)
    return DwTcPlan(a, l, lo, b, ci, co, k, s, p, cit, cot, wm, wn, wk, fm,
                    fn, bt, jn, nl, _ceil(nl, s), _ceil(bt, 8) * 8, jtiles,
                    btiles, tiles, tpc, chunks, mtiles, ntiles, stages,
                    stages * stage, int(ci1), swap)


class DxTcPlan(NamedTuple):
    """Tile plan of one tensor-core `conv_axis_dx` call: the shape, g as
    (a, lo, B, Co) and dx as (a, l, B, Ci), then the plan, in the order of
    the kernel's geometry array."""
    a: int
    l: int
    lo: int
    b: int
    ci: int
    co: int
    k: int
    s: int
    p: int
    cit: int         # input channels per block (N tile)
    cok: int         # output channels per K chunk (a ring unit)
    kst: int         # K chunks: ceil(Co / cok)
    wm: int          # warps along M and N (wm x wn = 8)
    wn: int
    fm: int          # m16 and n8 tiles per warp
    fn: int
    bt: int          # a tile: in_ positions i x bt positions b of one a
    in_: int         # s x u
    u: int           # positions i per parity class
    jb: int          # first staged g row: j = i0 / s + jb
    ng: int          # staged g positions along Lo
    itiles: int
    btiles: int
    tiles: int       # a x itiles x btiles
    tpb: int         # tiles per block
    blocks: int      # grid x
    ctiles: int      # grid y: ceil(Ci / cit)
    stages: int
    swap: int        # 1: the caller's (A, Lo, 1, Co) as (1, Lo, A, Co)

    @property
    def mt(self) -> int:
        """m16 tiles of a tile's M rows (class, u, bb)."""
        return self.in_ * self.bt // 16

    @property
    def smem(self) -> int:
        """Bytes of shared memory (`_dx_smem`)."""
        return _dx_smem(self.ng * self.bt, self.k * self.cit, self.cok,
                        self.kst, self.stages, self.in_ * self.bt * self.cit)


def _dx_smem(g_rows: int, w_rows: int, cok: int, kst: int, stages: int,
             out_elems: int) -> int:
    """Bytes of shared memory of a `conv_axis_dx` block: the ring of g rows
    (with the weights, several co-chunks; else the weights once,
    resident), the output tile and one zero row."""
    ring = (w_rows + stages * g_rows if kst == 1
            else stages * (g_rows + w_rows))
    return 2 * (cok * ring + out_elems) + 16


def conv_axis_dx_classes(k: int, s: int, p: int) -> list:
    """(tc, cp, nv) of each parity class c = i mod s of the input: its
    first tap tc = (c + p) mod s, cp = (c + p) // s, and nv taps tc, tc +
    s, ... < k; tap tc + s v reads g at j = i0 / s + u + cp - v for i = i0
    + c + s u."""
    out = []
    for c in range(s):
        tc = (c + p) % s
        out.append((tc, (c + p) // s, _ceil(k - tc, s) if tc < k else 0))
    return out


def conv_axis_dx_tc_plan(a: int, l: int, lo: int, b: int, ci: int, co: int,
                         k: int, s: int, p: int) -> DxTcPlan:
    """The plan of a tensor-core `conv_axis_dx` call, g viewed as (a, lo,
    b, co), dx as (a, l, b, ci), a x l x b >= 1.  Block (x, y) takes tiles x
    * tpb .. of the (a, i tile, b tile) order, b tiles fastest, and the cit
    input channels from y * cit; a tile's M rows are (class c, u, bb) for i
    = i0 + c + s u, b = b0 + bb; warp (wmi, wni), warp = wmi + wm wni,
    holds m16 tiles wmi * fm .. and n8 tiles wni * fn ..  Each (tile,
    co-chunk) unit stages ng g positions from j = i0 / s + jb, bt wide, and
    the weights (k, cit, cok) in a ring of `stages` buffers.  Along the
    last axis (b = 1, a > 1) a and b swap, as in `conv_axis_dw_tc_plan`."""
    swap = int(b == 1 and a > 1)
    if swap:
        a, b = 1, a
    classes = conv_axis_dx_classes(k, s, p)
    live = [(cp - nv + 1, cp) for _, cp, nv in classes if nv]
    jb = min(j for j, _ in live) if live else 0
    top = max(cp for _, cp in live) if live else 0
    cok = min(128, _pow2_at_least(max(co, 8)))
    umax_l = _ceil(l, s)

    def split_of(u, bt, cit):
        """The warp split (wm, wn, fm, fn) of a tile of u x bt rows per
        class over the 8 warps, fn <= 4 and fm x fn <= 8 accumulator
        tiles (fm up to 8): preferably with a warp's fm
        m16 tiles all of one class (one tap list, the kernel's faster
        path), then the fewest accumulator tiles a warp, then the most
        warps along M."""
        mpc, nt = u * bt // 16, cit // 8
        best, best_key = None, None
        for wn in (1, 2, 4, 8):
            fm = _pow2_at_least(_ceil(s * mpc, 8 // wn))
            if nt % wn or nt // wn > 4 or fm > 8 or fm * (nt // wn) > 8:
                continue
            key = (s > 1 and mpc % fm != 0, fm * (nt // wn))
            if best is None or key < best_key:
                best, best_key = (8 // wn, wn, fm, nt // wn), key
        return best

    cit = min(64, _pow2_at_least(max(ci, 8)))
    bts = sorted({min(b, 64), 32, 16} - {x for x in (32, 16) if x > b},
                 reverse=True)
    while True:
        bt = next((t for t in bts
                   if split_of(16 // math.gcd(t, 16), t, cit)), None)
        if bt is not None:
            break
        if cit == 8:
            raise ValueError(f"no conv_axis_dx tile at stride {s}")
        cit //= 2
    uq = 16 // math.gcd(bt, 16)

    def stage_bytes(u, cok):
        """A ring stage's bytes: g rows, and the weights with several
        co-chunks."""
        return 2 * cok * ((top + u - jb) * bt
                          + (k * cit if co > cok else 0))

    def smem(u, cok, stages):
        return _dx_smem((top + u - jb) * bt, k * cit, cok, _ceil(co, cok),
                        stages, s * u * bt * cit)

    # the longest i range per class in the stage target, among those whose
    # warps each see one class where any does
    us = [uq]
    while (us[-1] + uq <= _ceil(umax_l, uq) * uq
           and split_of(us[-1] + uq, bt, cit)
           and stage_bytes(us[-1] + uq, cok) <= _TC_STAGE_BYTES):
        us.append(us[-1] + uq)

    def uniform(u):
        return s == 1 or (u * bt // 16) % split_of(u, bt, cit)[2] == 0

    u = max(us, key=lambda u: (uniform(u), u))
    wm, wn, fm, fn = split_of(u, bt, cit)
    stages = _TC_STAGES
    while smem(u, cok, stages) > _TC_SMEM:
        if stages > 2:
            stages -= 1
        elif cok > 8:
            cok //= 2
        else:
            raise ValueError(f"no conv_axis_dx tile fits shared memory at "
                             f"k={k}, s={s}, Ci={ci}, Co={co}")
    while stages < 5 and smem(u, cok, stages + 1) <= _TC_RING_BYTES:
        stages += 1
    in_ = s * u
    itiles, btiles = _ceil(l, in_), _ceil(b, bt)
    tiles = a * itiles * btiles
    ctiles = _ceil(ci, cit)
    tpb = _ceil(tiles, max(1, _TC_BLOCKS // ctiles))
    return DxTcPlan(a, l, lo, b, ci, co, k, s, p, cit, cok, _ceil(co, cok),
                    wm, wn, fm, fn, bt, in_, u, jb, top + u - jb, itiles,
                    btiles, tiles, tpb, _ceil(tiles, tpb), ctiles, stages,
                    swap)


# ---------------------------------------------------------------------------
# B3's one-axis conv on tensor cores (bf16): plan and route
# ---------------------------------------------------------------------------

_FWD_CIK = 64                  # input channels per K chunk at most
_FWD_COT = 64                  # output channels per N tile at most
_FWD_MROWS = 1024              # output cells per tile (M) at most
_FWD_CI1_MAX_K = 16            # Ci = 1 takes the taps as one k16 step


def _axis_fwd_route(dtype: torch.dtype, w_dtype: torch.dtype) -> str:
    """The kernel that serves a `conv_axis` call on the card: "tc"
    (`conv_axis_tc.cu`: mma.sync on the tensor cores) when x (`dtype`) and
    w are both bfloat16, "cuda_core" (`conv_axis.cu`) otherwise.  float32
    stays off the tensor cores (TF32 would not hold the f32 parity gates),
    and so does bf16 x with float32 w, whose weights would otherwise be
    rounded to bf16 unasked.  It depends on dtype only, never on whether a
    build or launch failed."""
    if dtype == torch.bfloat16 and w_dtype == torch.bfloat16:
        return "tc"
    return "cuda_core"


class AxisTcPlan(NamedTuple):
    """Tile plan of one tensor-core `conv_axis` call: the shape, x as (a,
    l, B, Ci) and out as (a, lo, B, Co), then the plan, in the order of
    the kernel's geometry array."""
    a: int
    l: int
    lo: int
    b: int
    ci: int
    co: int
    k: int
    s: int
    p: int
    cik: int         # input channels per K chunk (1 when Ci = 1)
    cot: int         # output channels per N tile
    kst: int         # K chunks: ceil(Ci / cik)
    wm: int          # warps along M and N (wm x wn = 8)
    wn: int
    fm: int          # m16 and n8 tiles per warp
    fn: int
    bt: int          # a tile: jn positions j x bt positions b of one a
    jn: int
    nl: int          # staged x positions along l: (jn - 1) s + k
    nlc: int         # staged x positions per parity class: ceil(nl / s)
    xpitch: int      # Ci = 1: elements per staged x row (else 0)
    jtiles: int
    btiles: int
    tiles: int       # a x jtiles x btiles
    tpb: int         # tiles per block
    blocks: int      # grid x
    ntiles: int      # grid y: ceil(Co / cot)
    stages: int
    smem: int        # bytes of shared memory per block
    ci1: int
    swap: int        # 1: the caller's (A, L, 1, Ci) as (1, L, A, Ci)
    tma: int         # 1: x slabs by tensor-map box copies, else cp.async
    bulk: int        # 1: output rows by bulk copies, else 16-byte stores
    dense: int       # 1 (Co = 1): the dense path, no MMA tiles

    @property
    def mt(self) -> int:
        """m16 tiles of a tile's M rows (jj, bb)."""
        return self.jn * self.bt // 16


def _fwd_x_bytes(jn: int, bt: int, k: int, s: int, cik: int,
                 xpitch: int) -> int:
    """Bytes of one staged x slab: s parity classes of nlc rows (x bt with
    Ci > 1; with Ci = 1 each class's rows padded to 128 bytes)."""
    nlc = _ceil((jn - 1) * s + k, s)
    if xpitch:
        return 2 * s * _ceil(nlc * xpitch, 64) * 64
    return 2 * s * nlc * bt * cik


def _fwd_smem(x_bytes: int, w_bytes: int, kst: int, stages: int,
              out_bytes: int, k: int, tma: int) -> int:
    """Bytes of shared memory of a `conv_axis` tensor-core block: the
    ring of x slabs (with the weights, several K chunks), its stages
    1024-byte aligned with TMA; the weights once, resident (one K chunk);
    the output tile, one zero row, the tap table and, with TMA, an
    mbarrier a stage."""
    stage = x_bytes + (w_bytes if kst > 1 else 0)
    if tma:
        stage = _ceil(stage, 1024) * 1024
    return ((1024 + 8 * stages if tma else 0) + stages * stage
            + (w_bytes if kst == 1 else 0) + out_bytes + 16
            + _ceil(4 * k, 8) * 8)


def _ci1_pitch(bt: int) -> int:
    """Elements per staged Ci = 1 row: bt rounded up to 16-byte chunks,
    plus one chunk where rows would be a multiple of 128 bytes apart (the
    A gathers read four tap rows at once: keep them off one bank)."""
    pitch = _ceil(bt, 8) * 8
    return pitch + 8 if pitch % 64 == 0 else pitch


def conv_axis_tc_plan(a: int, l: int, lo: int, b: int, ci: int, co: int,
                      k: int, s: int, p: int) -> AxisTcPlan:
    """The plan of a tensor-core `conv_axis` call, x viewed as (a, l, b,
    ci), out as (a, lo, b, co), a x lo x b >= 1.  Block (x, y) takes tiles
    x * tpb .. of the (a, j tile, b tile) order, b tiles fastest, and the
    cot output channels from y * cot; a tile's M rows are m = jj bt + bb
    for j = j0 + jj, b = b0 + bb; warp (wmi, wni), warp = wmi + wm wni,
    holds m16 tiles wmi * fm .. and n8 tiles wni * fn ..  Each (tile, K
    chunk) unit stages nl x positions from j0 s - p, bt wide, cik
    channels, by parity class, and with several K chunks the chunk's
    weights (k, cik, cot), in a ring of `stages` buffers.  The b tile is
    up to 64 positions (b tiles of equal width); the j range grows to the
    M limit and the stage target, and b tiles narrow (to 16) while the
    halo (k - s rows) costs more than a quarter of the slab.  Along the
    last axis (b = 1, a > 1, Ci > 1) a and b swap, as in
    `conv_axis_dw_tc_plan`.  With Co = 1 (`dense`) the kernel takes no
    tiles: thread (a, j, b group) sums its cells with float32 FMAs, a
    group being 8 consecutive b with Ci = 1 and one cell otherwise."""
    swap = int(b == 1 and a > 1 and ci > 1)
    if swap:
        a, b = 1, a
    ci1 = ci == 1
    if ci1 and k > _FWD_CI1_MAX_K:
        raise ValueError(f"conv_axis on tensor cores takes k <= "
                         f"{_FWD_CI1_MAX_K} at Ci = 1, got k={k}")
    cik = 1 if ci1 else min(_FWD_CIK, _pow2_at_least(max(ci, 8)))
    cot = min(_FWD_COT, _pow2_at_least(max(co, 8)))
    kst = _ceil(ci, cik)
    fn = min(cot // 8, 4)
    wn = cot // 8 // fn
    wm = 8 // wn
    mmax = min(_FWD_MROWS, wm * (8 // fn) * 16)
    w_bytes = 2 * k * cik * cot
    bt = b if b <= 64 else _ceil(_ceil(b, _ceil(b, 64)), 8) * 8
    while True:
        jq = 16 // math.gcd(bt, 16)
        xpitch = _ci1_pitch(bt) if ci1 else 0
        if bt * jq <= mmax:
            jn = max(jq, min(_ceil(lo, jq), mmax // bt // jq) * jq)
            while jn > jq and _fwd_x_bytes(jn, bt, k, s, cik,
                                           xpitch) > _TC_STAGE_BYTES:
                jn -= jq
            # the same number of j tiles with the least padding
            jn = _ceil(_ceil(lo, _ceil(lo, jn)), jq) * jq
            if 4 * (k - s) <= jn * s or jn >= lo or bt <= 16:
                break
        if bt > 16:
            bt = 16 * _ceil(bt // 2, 16)
        elif bt > 1:
            bt = 8 if bt > 8 else bt // 2
        else:
            raise ValueError(f"no conv_axis tile at k={k}, s={s}, Ci={ci}, "
                             f"Co={co}")
    fm = next(f for f in (1, 2, 4, 8) if wm * f * 16 >= jn * bt)
    nl = (jn - 1) * s + k
    nlc = _ceil(nl, s)
    # TMA where the map takes the slab: 16-byte strides, boxes of at most
    # 256 a dimension, class boxes at multiples of their swizzle span
    tma = int(nlc * s <= 256 and (b % 8 == 0 if ci1 else
                                  ci % 8 == 0 and bt % 8 == 0))
    # bulk stores where an output row of the tile is one contiguous run of
    # whole 16-byte pieces: all Co channels (8 or 16); Co = 1 takes the
    # dense path, which stages nothing
    dense = int(co == 1)
    tma *= 1 - dense
    bulk = int(not swap and co == cot <= 16)
    x_bytes = _fwd_x_bytes(jn, bt, k, s, cik, xpitch)
    out_bytes = 2 * jn * bt * cot

    def smem(stages):
        return _fwd_smem(x_bytes, w_bytes, kst, stages, out_bytes, k, tma)

    stages = _TC_STAGES
    while smem(stages) > _TC_SMEM:
        if stages == 2:
            raise ValueError(f"no conv_axis tile fits shared memory at "
                             f"k={k}, s={s}, Ci={ci}, Co={co}")
        stages -= 1
    while stages < 5 and smem(stages + 1) <= _TC_RING_BYTES:
        stages += 1
    jtiles, btiles = _ceil(lo, jn), _ceil(b, bt)
    tiles = a * jtiles * btiles
    ntiles = _ceil(co, cot)
    tpb = _ceil(tiles, max(1, _TC_BLOCKS // ntiles))
    return AxisTcPlan(a, l, lo, b, ci, co, k, s, p, cik, cot, kst, wm, wn,
                      fm, fn, bt, jn, nl, nlc, xpitch, jtiles, btiles, tiles,
                      tpb, _ceil(tiles, tpb), ntiles, stages, smem(stages),
                      int(ci1), swap, tma, bulk, dense)


class SeparableConv3dFn(torch.autograd.Function):
    """`separable_conv3d` (x, wx, wy, wz, bx, by, bz, stride, pad) with B3's
    backward.  The forward is the fused kernel, which keeps the stack's
    intermediates y1 (after D) and y2 (after H) in shared memory; the
    backward recomputes those it needs with `conv_axis` and then, axis by
    axis in reverse, takes dw and db from (y2, g3), g2 = dx(g3), dw and db
    from (y1, g2), g1 = dx(g2), dw and db from (x, g1), gx = dx(g1).
    `ctx.needs_input_grad` prunes it: no dx of the input where x takes no
    gradient (the image), no dw, db or recompute where the weights take
    none (a frozen head, which only passes its gradient to its input).
    Weight gradients come back in the weights' dtype, bias gradients in
    the biases'; dx is rounded to the cotangent's dtype at each axis."""

    @staticmethod
    def forward(ctx, x, wx, wy, wz, bx, by, bz, stride, pad):
        stride, pad = tuple(stride), tuple(pad)
        out = separable_conv3d(x, wx, wy, wz, stride=stride, pad=pad,
                               biases=(bx, by, bz))
        ctx.save_for_backward(x, wx, wy, wz, bx, by)
        ctx.stride, ctx.pad = stride, pad
        ctx.bias_dtypes = tuple(None if b is None else b.dtype
                                for b in (bx, by, bz))
        return out

    @staticmethod
    def backward(ctx, g3):
        x, wx, wy, wz, bx, by = ctx.saved_tensors
        s, p = ctx.stride, ctx.pad
        need = ctx.needs_input_grad
        ws = (wx, wy, wz)
        # params[a]: whether axis a's weight or bias takes a gradient
        params = [need[1 + a] or need[4 + a] for a in range(3)]
        y1 = y2 = None
        if params[1] or params[2]:
            y1 = conv_axis(x, wx, bx, axis=1, stride=s[0], pad=p[0])
        if params[2]:
            y2 = conv_axis(y1, wy, by, axis=2, stride=s[1], pad=p[1])
        inputs = (x, y1, y2)
        grads = [None] * 9
        g = g3.contiguous()
        for a in (2, 1, 0):
            if params[a]:
                dw, db = conv_axis_dw(inputs[a], g, k=ws[a].shape[0],
                                      axis=a + 1, stride=s[a], pad=p[a],
                                      bias=need[4 + a])
                if need[1 + a]:
                    grads[1 + a] = dw.to(ws[a].dtype)
                if need[4 + a]:
                    grads[4 + a] = db.to(ctx.bias_dtypes[a])
            if need[0] or any(params[:a]):
                g = conv_axis_dx(g, ws[a], length=x.shape[1 + a],
                                 axis=a + 1, stride=s[a], pad=p[a])
            else:
                break
        if need[0]:
            grads[0] = g
        return tuple(grads)


# ---------------------------------------------------------------------------
# K1 and K2: the int8 packed conv and the int8 composed up-conv of the int8
# serving path (`models/unet_packed_q.py`)
# ---------------------------------------------------------------------------

S8_QMAX = 127.0
# K1's mma.sync route (`s8_igemm.cuh`): 32-byte K steps staged in 8-byte
# groups
_S8_K_STEP = 32
_S8_GROUP = 8
# the wgmma route (`s8_wgmma.cuh`) takes 8Ci and 8Co multiples of this
_S8_TC_ALIGN = 64


def _conv2_s8_route(c8i: int, c8o: int) -> str:
    """The kernel that serves a `conv2_packed_s8` call on the card:
    "wgmma" (`conv2_packed_s8_tc.cu`: wgmma fed by TMA) for 8Ci and 8Co
    multiples of 64, "mma_sync" (`conv2_packed_s8.cu`) for everything
    else, which on the served path is the 8Ci = 8 stem."""
    if c8i % _S8_TC_ALIGN == 0 and c8o % _S8_TC_ALIGN == 0:
        return "wgmma"
    return "mma_sync"


def s8_k_step(c8i: int) -> int:
    """Bytes of K per step of the wgmma route: 128 channels of one tap
    (one row with the 128-byte swizzle) where 8Ci % 128 == 0, else 64 with
    the 64-byte swizzle (8Ci = 64: e0c2)."""
    return 128 if c8i % 128 == 0 else 64


def s8_kmajor_weights(wp8: torch.Tensor) -> torch.Tensor:
    """(2, 2, 2, 8Ci, 8Co) int8 packed weights -> the mma.sync route's
    (8Co, 8 x 8Ci) K-major B operand, k = (4 qd + 2 qh + qw) x 8Ci + ci.
    (The wgmma route takes `kmajor_weights`' (8 taps, 8Co, 8Ci).)"""
    c8o = wp8.shape[4]
    return wp8.permute(4, 0, 1, 2, 3).reshape(c8o, -1).contiguous()


class S8Class(NamedTuple):
    """One output parity class of a K2 launch (`upconv_s8_plan`)."""
    r: Tuple[int, int, int]       # output cell = 2 p + r per axis
    cells: Tuple[int, int, int]   # rows p per axis (per item)
    taps: Tuple[int, int, int]    # taps j per axis: input cell p + j
    kernel_index: Tuple[Tuple[int, int, int], ...]  # composed tap per j
    k: int                        # taps x 8Ci
    tap0: int                     # the class's first weight tap
    w_offset: int                 # int8 entries before this class's weights


def upconv_s8_plan(padded_cells: Sequence[int], c8i: int,
                   c8o: int) -> Tuple[S8Class, ...]:
    """K2's split of the lhs-dilated 5^3 conv over (Dp, Hp, Wp) edge-padded
    cells into the 8 output parity classes c = 4 rd + 2 rh + rw: an even
    output cell 2p meets the kernel taps 1 + 2j (j = 0, 1), an odd one
    2p + 1 the taps 2j (j = 0, 1, 2), each reading input cell p + j.
    Class weights are concatenated in class order, each (taps, 8Co, 8Ci)
    with tap t = (jd th + jh) tw + jw."""
    classes, tap0 = [], 0
    for c in range(8):
        r = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
        taps = tuple(2 + ri for ri in r)
        cells = tuple(n - 1 - ri for n, ri in zip(padded_cells, r))
        kidx = tuple((2 * jd + 1 - r[0], 2 * jh + 1 - r[1], 2 * jw + 1 - r[2])
                     for jd in range(taps[0]) for jh in range(taps[1])
                     for jw in range(taps[2]))
        classes.append(S8Class(r, cells, taps, kidx, len(kidx) * c8i, tap0,
                               tap0 * c8o * c8i))
        tap0 += len(kidx)
    return tuple(classes)


def upconv_s8_weights(wk8: torch.Tensor,
                      plan: Sequence[S8Class]) -> torch.Tensor:
    """(5, 5, 5, 8Ci, 8Co) composed int8 kernel -> K2's weights: each
    class's taps gathered as (taps, 8Co, 8Ci), K-major, the classes
    concatenated (one flat int8 tensor; viewed as (125 x 8Co, 8Ci), class
    c's tap t is the row block (tap0 + t) x 8Co)."""
    parts = []
    for cls in plan:
        idx = torch.as_tensor(cls.kernel_index, device=wk8.device)
        taps = wk8[idx[:, 0], idx[:, 1], idx[:, 2]]       # (t, 8Ci, 8Co)
        parts.append(taps.permute(0, 2, 1).reshape(-1))
    return torch.cat(parts).contiguous()


class S8UpPlan(NamedTuple):
    """Tile plan of one K2 launch (`upconv_s8_tc_plan`)."""
    classes: Tuple[S8Class, ...]  # `upconv_s8_plan`, in class order
    box: Tuple[int, int, int]     # (bw, bh, bd) rows per tile, every class
    bn: int                       # output channels per tile
    kb: int                       # bytes of K per step
    order: Tuple[int, ...]        # classes in work order, heaviest first
    tiles: Tuple[Tuple[int, int, int], ...]  # boxes along (W, H, D), per class
    items: Tuple[int, ...]        # work items per class


def upconv_s8_tc_plan(n: int, padded_cells: Sequence[int], c8i: int,
                      c8o: int) -> S8UpPlan:
    """K2's work: the 8 parity classes of `upconv_s8_plan`, each tiled by
    one box of at most 128 rows (B1's `_tc_box` for the largest class grid,
    (Dp - 1, Hp - 1, Wp - 1); rows past a smaller class's grid are
    computed and never stored) and by N tiles of `_tc_n_tile(8Co)`.  Work
    items (class, batch item, box, N tile) are numbered class by class,
    heaviest class (most taps) first, then by class index."""
    classes = upconv_s8_plan(padded_cells, c8i, c8o)
    bw, bh, bd = _tc_box(*classes[0].cells)
    bn = _tc_n_tile(c8o)
    tiles = tuple((-(-c.cells[2] // bw), -(-c.cells[1] // bh),
                   -(-c.cells[0] // bd)) for c in classes)
    order = tuple(sorted(range(8), key=lambda c: (-math.prod(
        classes[c].taps), c)))
    items = tuple(n * math.prod(t) * (c8o // bn) for t in tiles)
    return S8UpPlan(classes, (bw, bh, bd), bn, s8_k_step(c8i), order, tiles,
                    items)


def upconv_s8_work(plan: S8UpPlan, n: int):
    """K2's work items in the kernel's numbering: (class, batch item,
    (tz, ty, tx) box, first output channel), class by class in
    `plan.order`; within a class the N tile varies fastest, then the box
    along W, H, D, then the batch item."""
    for c in plan.order:
        tw, th, td = plan.tiles[c]
        n_tiles = plan.items[c] // (n * tw * th * td)
        for b in range(n):
            for tz in range(td):
                for ty in range(th):
                    for tx in range(tw):
                        for nt in range(n_tiles):
                            yield c, b, (tz, ty, tx), nt * plan.bn


def _conv2_s8_sum(x8: torch.Tensor, wp8: torch.Tensor,
                  pad: int) -> torch.Tensor:
    """The int32 sums of the k=2 packed conv of int8 x and w, through the
    8 shifted-slice products in float64."""
    x = x8.double()
    if pad:
        x = TF.pad(x, (0, 0) + (1, 1) * 3)
    d, h, w = (s - 1 for s in x.shape[1:4])
    wd = wp8.double()
    out = None
    for qd, qh, qw in _TAPS:
        part = torch.matmul(x[:, qd:qd + d, qh:qh + h, qw:qw + w],
                            wd[qd, qh, qw])
        out = part if out is None else out.add_(part)
    # exact: every partial sum is an integer below 127^2 x 8 x 8Ci < 2^53
    return out.to(torch.int32)


def s8_epilogue_plain(y32: torch.Tensor, dq: torch.Tensor,
                      bias: Optional[torch.Tensor],
                      alpha: Optional[torch.Tensor], rq: torch.Tensor,
                      addend: Optional[torch.Tensor] = None, *,
                      zero_pads: bool) -> torch.Tensor:
    """JAX's `models/unet_packed_q.py::_epilogue` (with the decoder's
    float32 addend) on int32 sums: `(y32 * dq (+ addend)) + bias`, PReLU,
    the shifted pad voxels zeroed, then `clip(round(y * rq), -127, 127)`
    as int8 (round half to even, the clip before the cast)."""
    y = y32.float() * dq.float()
    if addend is not None:
        y = y + addend.float()
    if bias is not None:
        y = y + bias.float()
    if alpha is not None:
        y = torch.where(y >= 0, y, y * alpha.float())
    if zero_pads:
        kd, kh, kw = (shifted_pad_keep(a, y.shape[1 + a], y.shape[4],
                                       y.device) for a in range(3))
        keep = (kd[:, None, None, :] & kh[None, :, None, :]
                & kw[None, None, :, :])
        y = torch.where(keep, y, 0.0)
    return torch.clamp(torch.round(y * rq.float()), -S8_QMAX,
                       S8_QMAX).to(torch.int8)


def conv2_packed_s8_plain(x8: torch.Tensor, wp8: torch.Tensor, *, pad: int,
                          dq=None, bias=None, alpha=None, rq=None,
                          addend=None) -> torch.Tensor:
    """Plain version of `conv2_packed_s8`: the int32 sums from float64
    products (exact), then, with `dq`, `s8_epilogue_plain` to int8."""
    y32 = _conv2_s8_sum(x8, wp8, pad)
    if dq is None:
        return y32
    return s8_epilogue_plain(y32, dq, bias, alpha, rq, addend,
                             zero_pads=pad == 1)


def _epilogue_vector(name: str, t, c8o: int, device) -> Optional[torch.Tensor]:
    if t is None:
        return None
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    if t.numel() == 1:
        t = t.reshape(1).expand(c8o)
    if tuple(t.shape) != (c8o,):
        raise ValueError(f"{name} must have shape ({c8o},), got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def conv2_packed_s8(x8: torch.Tensor, wp8: torch.Tensor, *, pad: int,
                    dq=None, bias=None, alpha=None, rq=None,
                    addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: the k=2 packed conv in int8 (B1's function), int32 sums:

        y32[n, z, y, x] = sum_q xin[n, z+qd-pad, y+qh-pad, x+qw-pad] @ wp8[q]

    x8: (N, Di, Hi, Wi, 8Ci) int8; wp8: (2, 2, 2, 8Ci, 8Co) int8; pad 0:
    shifted -> aligned, pad 1: aligned -> shifted.  Returns y32 (int32),
    or with `dq` given, JAX's `_epilogue` fused: `(y32 * dq (+ addend)) +
    bias`, PReLU(alpha), the pad voxels of a shifted (pad 1) output
    zeroed, requantized by `rq` to int8.  dq, bias, alpha, rq: packed
    (8Co,) float32 (alpha may be one shared slope); addend: None or a
    float32 tensor shaped like the output (the decoder's dequantized,
    face-fixed up branch).  A CPU tensor takes `conv2_packed_s8_plain`;
    on the card `_conv2_s8_route` picks the kernel of
    `csrc/conv2_packed_s8_tc.cu` (wgmma, 8Ci and 8Co multiples of 64) or
    of `csrc/conv2_packed_s8.cu` (mma.sync), which runs, or the call
    raises; x8 and the addend must be contiguous and 16-byte aligned.
    `conv2_packed_s8.launches` counts its launches, `.fused_launches`
    those with the epilogue, `.wgmma_launches` those on the wgmma
    route."""
    _check_conv2_args(x8, wp8, pad)
    n, di, hi, wi, c8i = x8.shape
    c8o = wp8.shape[4]
    if x8.dtype != torch.int8 or wp8.dtype != torch.int8:
        raise TypeError(f"conv2_packed_s8 takes int8 x and w, got "
                        f"{x8.dtype}, {wp8.dtype}")
    if dq is not None and rq is None:
        raise ValueError("the fused epilogue needs rq")
    step = 1 if pad else -1
    out_shape = (n, di + step, hi + step, wi + step, c8o)
    if addend is not None and (tuple(addend.shape) != out_shape
                               or addend.dtype != torch.float32):
        raise ValueError(f"addend must be float32 of shape {out_shape}, "
                         f"got {addend.dtype} {tuple(addend.shape)}")
    vecs = [_epilogue_vector(nm, t, c8o, x8.device) for nm, t in
            (("dq", dq), ("bias", bias), ("alpha", alpha), ("rq", rq))]
    if x8.device.type == "cpu":
        return conv2_packed_s8_plain(x8, wp8, pad=pad, dq=vecs[0],
                                     bias=vecs[1], alpha=vecs[2],
                                     rq=vecs[3], addend=addend)
    if x8.device.type != "cuda":
        raise ValueError(f"conv2_packed_s8 runs on cpu or cuda, not "
                         f"{x8.device}")
    if c8i % 8 or c8o % 8:
        raise ValueError(f"conv2_packed_s8 needs 8Ci % 8 == 0 and 8Co % 8 "
                         f"== 0; got {c8i}, {c8o}")
    _check_cuda("x8", x8, torch.int8, x8.device)
    if addend is not None:
        _check_cuda("addend", addend, torch.float32, x8.device)
    wgmma = _conv2_s8_route(c8i, c8o) == "wgmma"
    wp8 = wp8.to(x8.device)
    wk = kmajor_weights(wp8) if wgmma else s8_kmajor_weights(wp8)
    _check_cuda("w", wk, torch.int8, x8.device)
    fused = vecs[0] is not None
    out = torch.empty(out_shape, device=x8.device,
                      dtype=torch.int8 if fused else torch.int32)
    if out.numel() == 0:
        return out
    ptrs = [None if t is None else t.data_ptr() for t in vecs + [addend]]
    lib = load()
    stream = torch.cuda.current_stream(x8.device).cuda_stream
    with torch.cuda.device(x8.device):
        if wgmma:
            plan = conv2_tc_plan(n, *out_shape[1:4], c8o, pad)
            rc = lib.mri_conv2_packed_s8_tc(
                x8.data_ptr(), wk.data_ptr(), out.data_ptr(), n, di, hi, wi,
                c8i, c8o, pad, *plan.box, plan.bn, s8_k_step(c8i), *ptrs,
                stream)
        else:
            rc = lib.mri_conv2_packed_s8(
                x8.data_ptr(), wk.data_ptr(), out.data_ptr(), n, di, hi, wi,
                c8i, c8o, pad, *ptrs, stream)
    _raise_on(rc, "conv2_packed_s8_tc" if wgmma else "conv2_packed_s8")
    conv2_packed_s8.launches += 1
    conv2_packed_s8.fused_launches += fused
    conv2_packed_s8.wgmma_launches += wgmma
    return out


conv2_packed_s8.launches = 0
conv2_packed_s8.fused_launches = 0
conv2_packed_s8.wgmma_launches = 0


def upconv_packed_s8_plain(xe8: torch.Tensor,
                           wk8: torch.Tensor) -> torch.Tensor:
    """Plain version of `upconv_packed_s8`: per output parity class
    (rd, rh, rw), the float64 products of the input slices at offsets j
    with the composed taps 2j + 1 - r, summed exactly and cast to int32,
    written to the output cells 2p + r."""
    n, dp, hp, wp = xe8.shape[:4]
    c8o = wk8.shape[4]
    out = torch.empty((n, 2 * dp - 3, 2 * hp - 3, 2 * wp - 3, c8o),
                      dtype=torch.int32, device=xe8.device)
    x = xe8.double()
    wd = wk8.double()
    for rd in range(2):
        for rh in range(2):
            for rw in range(2):
                cd, ch, cw = dp - 1 - rd, hp - 1 - rh, wp - 1 - rw
                acc = None
                for jd in range(2 + rd):
                    for jh in range(2 + rh):
                        for jw in range(2 + rw):
                            part = torch.matmul(
                                x[:, jd:jd + cd, jh:jh + ch, jw:jw + cw],
                                wd[2 * jd + 1 - rd, 2 * jh + 1 - rh,
                                   2 * jw + 1 - rw])
                            acc = part if acc is None else acc.add_(part)
                # exact: partial sums below 127^2 x 27 x 8Ci < 2^53
                out[:, rd::2, rh::2, rw::2] = acc.to(torch.int32)
    return out


def upconv_packed_s8(xe8: torch.Tensor, wk8: torch.Tensor) -> torch.Tensor:
    """K2: the composed lhs-dilated 5^3 up-conv in int8 (JAX's
    `upconv_int8` over `edge_pad_cells`), int32 sums:

        out[o] = sum_k [o + k - 1 even] xe8[(o + k - 1) / 2] @ wk8[k]

    per axis, o in [0, 2Dp - 4].  xe8: the edge-padded coarse cells (N,
    Dp, Hp, Wp, 8Ci) int8 (`ops.packed.edge_pad_cells`); wk8: (5, 5, 5,
    8Ci, 8Co) int8.  Returns (N, 2Dp-3, 2Hp-3, 2Wp-3, 8Co) int32.  A CPU
    tensor takes `upconv_packed_s8_plain`; on the card (8Ci and 8Co
    multiples of 64; xe8 contiguous and 16-byte aligned) the kernel of
    `csrc/upconv_packed_s8.cu` runs all 8 parity classes in one
    persistent launch (`upconv_s8_tc_plan`), or the call raises.
    `upconv_packed_s8.launches` counts its launches."""
    if xe8.ndim != 5 or tuple(wk8.shape[:3]) != (5, 5, 5) \
            or wk8.shape[3] != xe8.shape[4]:
        raise ValueError(f"upconv_packed_s8 needs xe8 (N,Dp,Hp,Wp,C8i) and "
                         f"wk8 (5,5,5,C8i,C8o); got {tuple(xe8.shape)}, "
                         f"{tuple(wk8.shape)}")
    if xe8.dtype != torch.int8 or wk8.dtype != torch.int8:
        raise TypeError(f"upconv_packed_s8 takes int8 x and w, got "
                        f"{xe8.dtype}, {wk8.dtype}")
    if min(xe8.shape[1:4]) < 3:
        raise ValueError("upconv_packed_s8 needs at least 3 padded cells "
                         "per axis")
    if xe8.device.type == "cpu":
        return upconv_packed_s8_plain(xe8, wk8)
    if xe8.device.type != "cuda":
        raise ValueError(f"upconv_packed_s8 runs on cpu or cuda, not "
                         f"{xe8.device}")
    n, dp, hp, wp, c8i = xe8.shape
    c8o = wk8.shape[4]
    if c8i % _S8_TC_ALIGN or c8o % _S8_TC_ALIGN:
        raise ValueError(f"upconv_packed_s8 needs 8Ci and 8Co multiples of "
                         f"{_S8_TC_ALIGN} on the card; got {c8i}, {c8o}")
    _check_cuda("xe8", xe8, torch.int8, xe8.device)
    plan = upconv_s8_tc_plan(n, (dp, hp, wp), c8i, c8o)
    w = upconv_s8_weights(wk8.to(xe8.device), plan.classes)
    _check_cuda("w", w, torch.int8, xe8.device)
    out = torch.empty((n, 2 * dp - 3, 2 * hp - 3, 2 * wp - 3, c8o),
                      dtype=torch.int32, device=xe8.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(xe8.device):
        rc = load().mri_upconv_packed_s8(
            xe8.data_ptr(), w.data_ptr(), out.data_ptr(), n, dp, hp, wp,
            c8i, c8o, *plan.box, plan.bn, plan.kb,
            torch.cuda.current_stream(xe8.device).cuda_stream)
    _raise_on(rc, "upconv_packed_s8")
    upconv_packed_s8.launches += 1
    return out


upconv_packed_s8.launches = 0


KERNELS = (conv2_packed, bn_act_zero_pads, conv_axis, conv2_packed_as_bn_act,
           conv2_packed_dx, separable_conv3d, conv_axis_dx, conv_axis_dw,
           conv2_packed_s8, upconv_packed_s8, bn_train_stats, bn_train_apply,
           bn_train_reduce, bn_train_dx, dw_packed)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
    dw_packed.fold_launches = 0
    conv2_packed.tc_launches = 0
    conv2_packed_as_bn_act.tc_launches = 0
    conv2_packed_dx.tc_launches = 0
    conv_axis.tc_launches = 0
    conv_axis_dx.tc_launches = 0
    conv_axis_dw.tc_launches = 0
    conv2_packed_s8.fused_launches = 0
    conv2_packed_s8.wgmma_launches = 0
