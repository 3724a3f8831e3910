"""The port's hand-written Hopper kernels, their plain PyTorch versions,
launch counters and build.

| kernel              | source                    | replaces (JAX package)                    |
|---------------------|---------------------------|-------------------------------------------|
| `conv2_packed`      | `csrc/conv2_packed_tc.cu` (bf16, 8Ci and 8Co multiples of 64: wgmma + TMA), `csrc/conv2_packed.cu` (the rest: CUDA cores) | `ops/pallas_kernels.py::conv2_packed_pallas` |
| `conv2_packed_as_bn_act` | the same two kernels, with B2 as the epilogue of an aligned->shifted launch | `conv2_packed_pallas` + `bn_act_zero_pads` |
| `conv2_packed_dx`   | the same two kernels, in the other parity with flipped, io-swapped weights: B1's input gradient | the dx of `ops/packed.py::_conv3_packed_bwd` / `_conv3_packed_as_bwd` |
| `bn_act_zero_pads`  | `csrc/bn_act_zero_pads.cu`| `ops/pallas_kernels.py::bn_act_zero_pads` |
| `conv_axis`         | `csrc/conv_axis.cu`       | `ops/pallas_kernels.py::conv_axis_last`   |
| `separable_conv3d`  | `csrc/separable_conv3d.cu` (the three axes in one launch) | `ops/pallas_kernels.py::separable_conv3d` |
| `conv_axis_dx`      | `csrc/conv_axis_bwd.cu`   | the input gradient of `conv_axis_last` (XLA's in JAX) |
| `conv_axis_dw`      | `csrc/conv_axis_bwd.cu` (two passes, no atomics) | the weight and bias gradients of `conv_axis_last` |

`conv_one_axis` and `separable_conv3d` keep the signatures of their JAX
namesakes (without the Mosaic workarounds `interpret` and `max_taps`).
`separable_conv3d` runs a stack as one fused launch where
`_separable_route` says so (every stack the fader serves), else as three
`conv_axis` launches.  The served UNet calls `conv2_packed_as_bn_act`
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
input gradient.

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
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as TF

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("conv2_packed.cu", "conv2_packed_tc.cu", "bn_act_zero_pads.cu",
           "conv_axis.cu", "separable_conv3d.cu", "conv_axis_bwd.cu")
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


# refusals of conv2_packed_tc.cu's host code (negative return codes)
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


def conv2_tc_plan(n: int, do: int, ho: int, wo: int, c8o: int,
                  pad: int) -> TcPlan:
    """Box, tile counts, N tile and per-tap input offsets of the
    tensor-core kernel for an (n, do, ho, wo, c8o) output.  Tile (b, tz,
    ty, tx) covers output cells [tz*bd, +bd) x [ty*bh, +bh) x [tx*bw, +bw)
    of item b; its tap (qd, qh, qw) reads the input box shifted by
    (qd - pad, qh - pad, qw - pad), zero outside the input."""
    bw, bh, bd = _tc_box(do, ho, wo)
    tiles = (-(-wo // bw), -(-ho // bh), -(-do // bd))
    bn = 256 if c8o % 256 == 0 else 128 if c8o % 128 == 0 else 64
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
# B1 + B2: aligned->shifted conv with the BN/PReLU/pad-mask epilogue
# ---------------------------------------------------------------------------


def shifted_pad_keep(axis: int, cells: int, c8: int,
                     device=None) -> torch.Tensor:
    """(cells, c8) bool: False at the pad voxels of a shifted packed tensor
    along `axis` (0 = D, 1 = H, 2 = W), from the index arithmetic of the
    fused epilogue: with sub = channel // (c8 // 8) and bit = (sub >> (2 -
    axis)) & 1, the last cell drops the subs with the bit set, the first
    cell (if it is not also the last) those with it clear.  The same planes
    as `ops.packed._shifted_pad_axis_mask`."""
    cell = torch.arange(cells, device=device)[:, None]
    bit = ((torch.arange(c8, device=device) // (c8 // 8)) >> (2 - axis)) & 1
    return torch.where(cell == cells - 1, bit == 0, (cell != 0) | (bit == 1))


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
    bfloat16.  The kernel keeps w in shared memory, or reads it from
    global memory where it exceeds one block's 227 KB."""
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
                   grid=n * tiles[0] * tiles[1] * tiles[2])


def _separable_route(dtype: torch.dtype, plan: Optional[SepPlan]) -> str:
    """The kernel that serves a `separable_conv3d` call on the card:
    "fused" (`separable_conv3d.cu`, one launch) for float32 and bfloat16
    stacks whose tile plan fits shared memory, "per_axis" (three
    `conv_axis` launches) otherwise.  It depends on dtype and shape only,
    never on whether a build or launch failed."""
    return "fused" if dtype in _DTYPE_CODE and plan is not None \
        else "per_axis"


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
    launch of `conv_axis_bwd.cu`'s dx kernel on the card."""
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
    # the kernel reads the weights as (k, Co, Ci): a row of Ci per (t, co)
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
    with torch.cuda.device(g.device):
        rc = lib.mri_conv_axis_dx(
            g.data_ptr(), wt.data_ptr(), dx.data_ptr(), _DTYPE_CODE[g.dtype],
            a, length, g.shape[axis], b, ci, co, k, stride, pad,
            torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(rc, "conv_axis_dx")
    conv_axis_dx.launches += 1
    return dx


conv_axis_dx.launches = 0

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
    launches of `conv_axis_bwd.cu` (partial sums per row chunk, then the
    chunks summed in order; `conv_axis_dw_plan`), counted as one call: no
    float atomics, so a run repeats bit for bit."""
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
    plan = conv_axis_dw_plan(rows, k, ci, co)
    partials = torch.empty(plan.chunks * plan.nout, dtype=torch.float32,
                           device=x.device)
    plan_arr = (ctypes.c_int * 7)(plan.cot, plan.og_total, plan.og_block,
                                  plan.lanes, plan.tiles, plan.chunks,
                                  plan.rows_per_chunk)
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.mri_conv_axis_dw(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(),
            None if db is None else db.data_ptr(), partials.data_ptr(),
            _DTYPE_CODE[x.dtype], a, x.shape[axis], lo, b, ci, co, k, stride,
            pad, ctypes.cast(plan_arr, ctypes.c_void_p),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "conv_axis_dw")
    conv_axis_dw.launches += 1
    return dw, db


conv_axis_dw.launches = 0


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


KERNELS = (conv2_packed, bn_act_zero_pads, conv_axis, conv2_packed_as_bn_act,
           conv2_packed_dx, separable_conv3d, conv_axis_dx, conv_axis_dw)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
    conv2_packed.tc_launches = 0
    conv2_packed_as_bn_act.tc_launches = 0
    conv2_packed_dx.tc_launches = 0
