"""int8-quantized packed inference of the flagship UNet3D (counterpart of
the JAX package's `models/unet_packed_q.py`).

Post-training static quantization: symmetric per-output-channel int8
weights and per-site, per-fine-channel int8 activations calibrated on
representative volumes, running the packed dataflow of
`unet_packed._trunk_v2` with int8 convs to int32 and fused
dequant -> bias -> PReLU -> requant epilogues.  The convs are the port's
hand-written kernels: every k=2 packed conv is K1
(`ops/cuda_kernels.py::conv2_packed_s8`, its epilogue fused; 10 launches a
forward at 3 encoding blocks), and the decoder's up branch is JAX's
composed form, `upconv_int8` over `edge_pad_cells`, as K2
(`upconv_packed_s8`, 2 launches), corrected by `upconv_fix_faces` in
float32 on its dequantized output, which K1 adds to the skip conv's
dequantized sum before the bias.  The head's block-diagonal int8 product
is `torch._int_mm` on the card (an exact float64 product on the CPU).

Usage:
    q = quantize_inference(state_dict, calib)     # calib: (N, S, S, S, 1)
    mask = packed_unet_mask_v2_int8(q, x)         # ~= packed_unet_mask_v2

`quantize_inference` takes a `UNet3D` state dict with live BatchNorm or
folded by `fold_bn_inference`; calibration observes the port's explicit
decoder forward (`_trunk_v2`'s `tap`), whose site maxima equal those of
JAX's composed forward up to float rounding.  The quantized dict mirrors
JAX's pytree (`interop.jax_bridge.quantized_to_torch` converts one):
per site `w8` (packed int8), `dq`, `b`, `alpha`, `rq`; at each decoder
conv1 also `w8_u` (the composed (5, 5, 5, 8Ci, 8Co) int8 kernel), `dq_u`
and `w_u_fine` (the fine (Co, Ci, 3, 3, 3) kernel with the input scales
folded in, for the face fixes); then `in_rq`, `head` and `nb`.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..ops import cuda_kernels as K
from ..ops import packed as P
from .unet_packed import StateDict, _trunk_v2, fold_bn_inference

QMAX = K.S8_QMAX


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _requant(y: torch.Tensor, rq) -> torch.Tensor:
    """float -> int8 by the reciprocal scale `rq` (x ~= q / rq): round half
    to even, clipped to +-127 before the cast."""
    return torch.clamp(torch.round(y * rq), -QMAX, QMAX).to(torch.int8)


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """float -> int8 with a symmetric scale (x ~= q * scale)."""
    return _requant(x.float(), 1.0 / scale)


def quantize_weight_per_oc(w: torch.Tensor):
    """float kernel (..., Co) -> (int8 kernel, float32 dequant scale (Co,)):
    w ~= w8 * scale[co], symmetric per output channel (the last axis)."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)))
    scale = torch.clamp_min(amax, 1e-12) / QMAX
    w8 = torch.clamp(torch.round(w / scale), -QMAX, QMAX).to(torch.int8)
    return w8, scale


def conv_int8(x8: torch.Tensor, w8: torch.Tensor, pad: int) -> torch.Tensor:
    """int8 x int8 -> int32 packed conv (pad 0: shifted -> aligned, JAX's
    "VALID"; pad 1: aligned -> shifted): kernel K1's raw mode."""
    return K.conv2_packed_s8(x8, w8, pad=pad)


def upconv_int8(x8: torch.Tensor, wk8: torch.Tensor) -> torch.Tensor:
    """The int8 composed upsample + conv (`ops.packed.upconv_packed`) ->
    int32: kernel K2 over `edge_pad_cells(x8)`, the edge replication done
    in int8."""
    return K.upconv_packed_s8(P.edge_pad_cells(x8), wk8)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def site_names(num_encoding_blocks: int = 3):
    names = ["in"]
    for i in range(num_encoding_blocks - 1):
        names += [f"e{i}c1", f"e{i}c2"]
    names += ["bc1", "bc2"]
    for i in range(num_encoding_blocks - 1):
        names += [f"d{i}c1", f"d{i}c2"]
    return names


@torch.no_grad()
def calibrate(state_dict: StateDict, calib_x: torch.Tensor,
              num_encoding_blocks: int = 3) -> Dict[str, torch.Tensor]:
    """Run the float packed forward on `calib_x` and record each conv-input
    site's per-fine-channel absolute maximum: {site: float32 (C,)}.  Per
    channel, because the folded-BatchNorm convs leave channel magnitudes
    an order of magnitude apart (JAX's docstring)."""
    rec = {}

    def tap(name, t):
        a = t.float().abs().amax(dim=(0, 1, 2, 3))
        rec[name] = a.reshape(8, -1).amax(dim=0)
        return t

    _trunk_v2(state_dict, calib_x, num_encoding_blocks, tap=tap)
    return rec


# ---------------------------------------------------------------------------
# quantization of a trained model
# ---------------------------------------------------------------------------


def _has_norm(state_dict: StateDict) -> bool:
    return any(".norm_layer." in k for k in state_dict)


def _skip_channels(state_dict: StateDict, nb: int, i: int) -> int:
    """Fine channel count of the skip consumed by decoder block i (the out
    channels of encoder block nb-2-i's conv2)."""
    return state_dict[f"encoder.encoding_blocks.{nb - 2 - i}.conv2."
                      "conv_layer.weight"].shape[0]


def _fold_in(w: torch.Tensor, s_in: torch.Tensor) -> torch.Tensor:
    """Fold the producer's per-channel activation scales into the fine
    kernel's input axis (w: (Co, Ci, ...))."""
    return w.float() * s_in.reshape(1, -1, *([1] * (w.ndim - 2)))


@torch.no_grad()
def quantize_inference(state_dict: StateDict, calib_x: torch.Tensor,
                       num_encoding_blocks: int = 3,
                       act_margin: float = 1.0) -> Dict[str, object]:
    """BN-folded (or live-BN, folded here) UNet3D state dict + calibration
    volumes -> the int8 inference dict of `packed_unet_*_int8`.

    Activations get PER-FINE-CHANNEL scales: each producer's epilogue
    requantizes by a per-channel vector, and the consumer conv folds the
    producer's scales into its weight's input-channel axis before the
    per-output-channel weight quantization, which keeps each int8 conv
    per-tensor.  `act_margin` scales the calibrated maxima (values beyond
    saturate).  The decoder's up branch folds the coarse input's scales
    into w_u, then composes it (`pack_upconv_weights`) and quantizes the
    composed kernel; the face fixes reuse the folded fine kernel on the
    raw int8 planes."""
    if _has_norm(state_dict):
        state_dict = fold_bn_inference(state_dict)
    sd = state_dict
    nb = num_encoding_blocks
    scales = {k: torch.clamp_min(v * act_margin, 1e-12) / QMAX
              for k, v in calibrate(sd, calib_x, nb).items()}

    def tiled_inv(site):
        return P.tile_channel_param(1.0 / scales[site])

    def entry(site_out, block, w_fine, s_in, pack):
        w8, wscale = quantize_weight_per_oc(pack(_fold_in(w_fine, s_in)))
        bias = sd.get(f"{block}.conv_layer.bias")
        alpha = sd.get(f"{block}.activation_layer.weight")
        return {"w8": w8, "dq": wscale,
                "b": None if bias is None else
                P.tile_channel_param(bias.float()),
                "alpha": None if alpha is None else alpha.float(),
                "rq": tiled_inv(site_out)}

    q: Dict[str, object] = {"nb": nb, "in_rq": tiled_inv("in")}
    prev = "in"
    for i in range(nb - 1):
        blk = f"encoder.encoding_blocks.{i}"
        q[f"e{i}c1"] = entry(f"e{i}c1", f"{blk}.conv1",
                             sd[f"{blk}.conv1.conv_layer.weight"],
                             scales[prev], P.pack_weights2_as)
        q[f"e{i}c2"] = entry(f"e{i}c2", f"{blk}.conv2",
                             sd[f"{blk}.conv2.conv_layer.weight"],
                             scales[f"e{i}c1"], P.pack_weights2)
        prev = f"e{i}c2"      # the max pool keeps per-channel scales
    q["bc1"] = entry("bc1", "bottom_block.conv1",
                     sd["bottom_block.conv1.conv_layer.weight"],
                     scales[prev], P.pack_weights2_as)
    q["bc2"] = entry("bc2", "bottom_block.conv2",
                     sd["bottom_block.conv2.conv_layer.weight"],
                     scales["bc1"], P.pack_weights2)
    prev = "bc2"
    for i in range(nb - 1):
        blk = f"decoder.decoding_blocks.{i}"
        w1 = sd[f"{blk}.conv1.conv_layer.weight"]
        c_skip = _skip_channels(sd, nb, i)
        e = entry(f"d{i}c1", f"{blk}.conv1", w1[:, :c_skip],
                  scales[f"e{nb - 2 - i}c2"], P.pack_weights2_as)
        w_u_eff = _fold_in(w1[:, c_skip:], scales[prev])
        e["w8_u"], e["dq_u"] = quantize_weight_per_oc(
            P.pack_upconv_weights(w_u_eff))
        e["w_u_fine"] = w_u_eff
        q[f"d{i}c1"] = e
        q[f"d{i}c2"] = entry(f"d{i}c2", f"{blk}.conv2",
                             sd[f"{blk}.conv2.conv_layer.weight"],
                             scales[f"d{i}c1"], P.pack_weights2)
        prev = f"d{i}c2"

    wh = sd["classifier.conv_layer.weight"]
    wh = wh.reshape(wh.shape[0], wh.shape[1]).t()          # (Ci, Co)
    w8h, wsh = quantize_weight_per_oc(wh * scales[prev][:, None])
    bh = sd.get("classifier.conv_layer.bias")
    q["head"] = {"w8": torch.block_diag(*[w8h] * 8),
                 "dq": P.tile_channel_param(wsh),
                 "b": None if bh is None else
                 P.tile_channel_param(bh.float())}
    return q


# ---------------------------------------------------------------------------
# quantized forward
# ---------------------------------------------------------------------------


def _epilogue(y32: torch.Tensor, e: Mapping, *,
              zero_pads: bool) -> torch.Tensor:
    """int32 conv output -> dequant + bias + PReLU (+ shifted-pad zeroing)
    -> int8 requant, in float32 (JAX's `_epilogue`; K1 runs it fused)."""
    return K.s8_epilogue_plain(y32, e["dq"], e.get("b"), e.get("alpha"),
                               e["rq"], zero_pads=zero_pads)


def _conv_epilogue(x8, e: Mapping, pad: int, addend=None) -> torch.Tensor:
    """K1 with `_epilogue` fused: int8 in, int8 out."""
    return K.conv2_packed_s8(x8, e["w8"], pad=pad, dq=e["dq"],
                             bias=e.get("b"), alpha=e.get("alpha"),
                             rq=e["rq"], addend=addend)


def _head_int8(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The head's block-diagonal int8 product, int32: `torch._int_mm` on
    the card; on the CPU an exact float64 product (|sum| < 2^53)."""
    flat = x8.reshape(-1, x8.shape[-1])
    if x8.device.type == "cuda":
        y = torch._int_mm(flat.contiguous(), w8.contiguous())
    else:
        y = (flat.double() @ w8.double()).to(torch.int32)
    return y.reshape(*x8.shape[:-1], w8.shape[-1])


def _trunk_q(q: Mapping, x: torch.Tensor) -> torch.Tensor:
    """Fine float input -> ALIGNED packed float32 head logits, every conv
    in int8; mirrors `unet_packed._trunk_v2` site for site."""
    nb = 1 + sum(1 for k in q if k.startswith("e") and k.endswith("c1"))
    x8 = _requant(P.pack2(x).float(), q["in_rq"])
    skips = []
    for i in range(nb - 1):
        xs = _conv_epilogue(x8, q[f"e{i}c1"], 1)
        x8 = _conv_epilogue(xs, q[f"e{i}c2"], 0)
        skips.append(x8)
        x8 = P.maxpool2_packed(x8)   # max commutes with the positive scale
    xs = _conv_epilogue(x8, q["bc1"], 1)
    x8 = _conv_epilogue(xs, q["bc2"], 0)
    for i in range(nb - 1):
        e = q[f"d{i}c1"]
        y_u = upconv_int8(x8, e["w8_u"]).float() * e["dq_u"]
        y_u = P.upconv_fix_faces(y_u, x8, e["w_u_fine"], dequant_scale=1.0)
        xs = _conv_epilogue(skips[-(i + 1)], e, 1, addend=y_u)
        del y_u
        x8 = _conv_epilogue(xs, q[f"d{i}c2"], 0)
    h = q["head"]
    y = _head_int8(x8, h["w8"]).float() * h["dq"]
    if h.get("b") is not None:
        y = y + h["b"]
    return y


def packed_unet_apply_v2_int8(q: Mapping, x: torch.Tensor) -> torch.Tensor:
    """Fine (N, S, S, S, 1) float -> fine float32 logits (N, S, S, S,
    out_classes), the int8 counterpart of `packed_unet_apply_v2`."""
    return P.unpack2(_trunk_q(q, x))


def packed_unet_mask_v2_int8(q: Mapping, x: torch.Tensor) -> torch.Tensor:
    """Fine (N, S, S, S, 1) float -> int32 mask (N, S, S, S), the int8
    counterpart of `packed_unet_mask_v2` (binary models only): the class
    channels compared in packed space (l1 > l0), the 1-channel mask
    unpacked."""
    yp = _trunk_q(q, x)
    if yp.shape[-1] != 16:
        raise ValueError("packed_unet_mask_v2_int8 needs out_classes == 2; "
                         f"got {yp.shape[-1] // 8} classes")
    mask = yp[..., 1::2] > yp[..., 0::2]
    return P.unpack2(mask)[..., 0].to(torch.int32)
