"""Precision of the plain references: float32 with TF32 off, and the
float8 rounding of the control."""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls and cuDNN convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """e4m3 rounding of a value, e5m2 rounding of its gradient, each
    scaled per tensor (the usual float8 training recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def quantizer(quant: Optional[str]) -> Callable[[torch.Tensor],
                                                torch.Tensor]:
    """The identity for None, the float8 rounding for "fp8"."""
    if quant is None:
        return lambda t: t
    if quant != "fp8":
        raise ValueError(f"unknown quant {quant!r}")
    return _Fp8.apply
