#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mri_epilepsy_diagnosis_torch`) on
one NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits nonzero):
1. environment: the card's name and power limit; TF32 off for f32 checks;
2. build: compiles the CUDA kernels from `mri_epilepsy_diagnosis_torch/
   csrc/` with nvcc for sm_90a into `build/torch_kernels/`;
3. kernel checks: every B1 (`conv2_packed`) site and every B2
   (`bn_act_zero_pads`) site of the 192^3, out_channels_first_layer=8
   UNet3D, and every B3 (`conv_axis`) site of the fader encoder and
   Classificator of the seg+clf ensemble, at batch 1 and 8, in float32
   and bfloat16, against the plain PyTorch versions, plus the stride-1 B3
   sites of one fader AE forward at batch 1; CUDA-event times of kernel,
   plain version and (B1, B3) `F.conv3d` as a yardstick at the batch-8
   bf16 shapes;
4. end-to-end serving: a BN-folded random UNet3D serves 16 int16 192^3
   T1w-like volumes at batch 8 in bf16 through `segment_volumes` (device
   z-normalisation, `packed_unet_mask_v2`, bit-packed masks), then again
   with uint8 transfers; launch counters prove every conv site went
   through the kernels; masks are held against the unfolded fine UNet3D in
   float32, and float32 packed logits against the fine logits.  One batch
   of bench.py's i.i.d. noise volumes records the uint8 agreement there.
   Then the seg+clf ensemble serves the same volumes: the packed UNet's
   masks plus FCD probabilities of the fader encoder and Classificator
   (the reference's kwargs, random weights calibrated to non-degenerate
   probabilities), with exact launch counts of all three kernels; the
   served bf16 probabilities are held against float32 probabilities of
   the port on the CPU (plain versions), and float32 ones on the card;
5. profile: torch.profiler over one served UNet batch and one served
   ensemble batch (device time by kernel, the device's idle share),
   recorded, not gated.

It prints one line per check, then `{"kernels": [...]}`, the card's
`nvidia-smi` name and power limit, and last
`{"ok": true, "device": {...}}`.  Per-site numbers also go to
`chiprun_out/chip_smoke.json`.  Exits nonzero without printing a result
when no CUDA device is available or the port's package is missing.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM bandwidth and its operations
# over the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}

SIZE = 192
BATCH = 8
N_VOLUMES = 16
OCFL = 8
BLOCKS = 3
SEED = 0

# tolerances of kernel vs plain version, as a fraction of max|plain|:
# f32 differs only by summation order over K <= 4096 products (~sqrt(K)
# * 2^-24 relative); bf16 outputs may differ by one bf16 rounding step
# (2^-7 relative) where the two float32 sums straddle a rounding boundary
TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
# served masks: FG_SHARE of the voxels foreground by construction (the
# classifier bias is set from the first volume), gated to FG_GATE so that a
# degenerate all-one-class mask cannot pass the agreement gates vacuously.
# The gates count agreeing voxels, so they tighten as the share grows: a
# random-weight net has no margin away from its decision boundary, and the
# 8-bit transfer's input noise flips about 2% of its foreground voxels
# wherever the threshold sits (a trained segmenter's margins are wide away
# from the boundary).  The flips as a share of the foreground are printed.
FG_SHARE = 0.02
FG_GATE = (0.005, 0.5)
MASK_AGREEMENT_BF16 = 0.99     # bf16 vs f32 fine masks (ties of random nets)
MASK_AGREEMENT_UINT8 = 0.999   # the gate of tests/test_serving_quant.py
F32_LOGIT_TOL = 1e-4           # f32 packed vs fine logits, x max|logit|

B1_SITES = ("e0c1", "e0c2", "e1c1", "e1c2", "bc1", "bc2", "d0c1.skip",
            "d0c1.up", "d0c2", "d1c1.skip", "d1c1.up", "d1c2")
B2_SITES = ("e0c1", "e1c1", "bc1", "d0c1", "d1c1")
B3_SITES = tuple(f"{blk}{ax}" for blk in ("e0", "e1", "e2", "clf.")
                 for ax in "xyz")
AE_B3_SITES = tuple(f"ae.d{i}{ax}" for i in range(3) for ax in "xyz")

# the fader classifier of the ensemble: the reference's kwargs
# (train_ENC_CLF.ipynb cells 17-18; bench.py FADER_*_KWARGS), whose
# geometry needs the 192^3 crop: 192 -> 96 -> 48 -> 24 -> 12 -> 6 -> 3, a
# 3^3 x 32 latent that the head's 3^3 conv turns into l_in = 64 features
FADER_DOWN_BLOCK_KWARGS = dict(conv_k=6, conv_pad=2, conv_s=2, maxpool_k=2,
                               maxpool_s=2, batch_norm=True, act="l_relu")
FADER_AE_KWARGS = dict(c_in=1, is_skip=False, deapth=3, c_base=8,
                       inc_size=2, reduce_size=False,
                       down_block_kwargs=FADER_DOWN_BLOCK_KWARGS)
FADER_UP_BLOCK_KWARGS = dict(up="upsample", scale=4, scale_mode="nearest",
                             conv_k=5, conv_pad=2, conv_s=1, batch_norm=True,
                             act="l_relu")
FADER_HEAD_KWARGS = dict(c_in=32, c_out=64, conv_k=3, conv_s=1, conv_pad=0,
                         l_in=64, l_out=32, batch_norm=True, act="relu",
                         p_drop=0.5)
# served bf16 probabilities vs the port's float32 ones on the CPU.  The
# random encoder's bf16 output carries about 1-2% error relative to its
# largest value (8 significant bits, ~20 rounded layers), and the features
# of a random net differ between volumes by only a few times that, so that
# the calibrated BatchNorm1d (`calibrate_fader`), which divides by their
# spread over the volumes, turns it into about 0.1-0.2 of error in a logit
# difference whose spread is 1; the softmax moves a probability by at most
# 1/4 of that.  Runs of the plain versions in bf16 on the CPU at 192^3 gave
# 0.018 to 0.052 over 4 volumes; the gate is 0.1.
PROBS_TOL_BF16 = 0.1
PROBS_TOL_F32 = 1e-4           # float32 kernels vs plain versions on the CPU
PROBS_SPREAD_GATE = 0.1        # max - min of P(FCD) over the 16 volumes
N_CPU_PROBS = 4                # volumes classified on the CPU


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch

    fn()                                   # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_state_dict(model, gen):
    """Seeded random weights with non-trivial BN statistics, so that the
    BN fold is exercised.  Conv weights are He-scaled for PReLU (std
    sqrt(2 / ((1 + a^2) fan_in)), a = 0.25): with torch's default uniform
    init the activations shrink layer by layer until the biases alone
    decide every voxel and the mask is one class everywhere."""
    import torch

    sd = {}
    for k, v in model.state_dict().items():
        dev = v.device
        fan_in = v[0].numel() if v.ndim == 5 else None
        if k.endswith("num_batches_tracked"):
            sd[k] = v.clone()
        elif k.endswith("conv_layer.weight"):
            std = float(np.sqrt(2.0 / ((1 + 0.25 ** 2) * fan_in)))
            sd[k] = torch.randn(v.shape, generator=gen, device=dev) * std
        elif k.endswith("conv_layer.bias"):
            w = sd[k.rsplit(".", 1)[0] + ".weight"]
            bound = 1.0 / float(np.sqrt(w[0].numel()))
            sd[k] = (torch.rand(v.shape, generator=gen, device=dev) * 2 - 1
                     ) * bound
        elif k.endswith("norm_layer.weight"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=gen, device=dev)
        elif k.endswith("norm_layer.running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=gen, device=dev)
        elif k.endswith("norm_layer.bias") or k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=gen, device=dev)
        elif k.endswith("activation_layer.weight"):
            sd[k] = 0.1 + 0.3 * torch.rand(v.shape, generator=gen, device=dev)
        else:
            raise KeyError(f"unexpected state_dict entry {k}")
    model.load_state_dict(sd)
    return sd


def t1_like_volumes(gen, n):
    """int16 volumes like tests/test_serving_quant.py's T1w stand-ins at
    SIZE^3: N(600, 40) noise plus six smooth bright blobs (amplitude 400,
    radius SIZE/24..SIZE/10), made on the card from `gen`."""
    import torch

    ax = torch.arange(SIZE, device="cuda", dtype=torch.float32)
    out = []
    for _ in range(n):
        v = 600 + 40 * torch.randn((SIZE,) * 3, generator=gen, device="cuda")
        for _ in range(6):
            c = SIZE / 8 + torch.rand(3, generator=gen, device="cuda") * (
                SIZE * 3 / 4)
            r = SIZE / 24 + torch.rand((), generator=gen, device="cuda") * (
                SIZE / 10 - SIZE / 24)
            g = [((ax - c[i]) ** 2) for i in range(3)]
            v += 400 * torch.exp(-(g[0][:, None, None] + g[1][None, :, None]
                                   + g[2][None, None, :]) / (2 * r * r))
        out.append(v.to(torch.int16).cpu().numpy())
    return out


def record_sites(K, P, fn):
    """Shapes of every kernel call the served forward `fn()` makes."""
    import types

    sites = {"conv2_packed": [], "bn_act_zero_pads": []}
    conv, epi = K.conv2_packed, K.bn_act_zero_pads

    def rec_conv(x, wp, bias=None, *, pad=0):
        sites["conv2_packed"].append(
            {"x": tuple(x.shape), "wp": tuple(wp.shape), "pad": pad,
             "bias": bias is not None})
        return conv(x, wp, bias, pad=pad)

    def rec_epi(xs, scale, shift, alpha, masks):
        sites["bn_act_zero_pads"].append({"x": tuple(xs.shape)})
        return epi(xs, scale, shift, alpha, masks)

    # the packed ops reach the kernels through their module's `K`
    P.K = types.SimpleNamespace(conv2_packed=rec_conv,
                                bn_act_zero_pads=rec_epi)
    try:
        fn()
    finally:
        P.K = K
    return sites


def check(name, got, ref, dtype_name):
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = err <= TOL[dtype_name] * max(scale, 1e-30)
    log(f"check {name} {dtype_name}: max_abs_err {err:.3e} "
        f"(max|ref| {scale:.3e}, tol {TOL[dtype_name]:.1e} x max|ref|)")
    if not ok:
        raise AssertionError(f"{name} {dtype_name} disagrees with its plain "
                             f"version: {err} > {TOL[dtype_name]} x {scale}")
    return err


def b1_kernel_phase(K, sites, gen):
    import torch
    import torch.nn.functional as TF

    rows, errs = [], {"f32": 0.0, "bf16": 0.0}
    for name, site in zip(B1_SITES, sites):
        _, di, hi, wi, c8i = site["x"]
        c8o, pad = site["wp"][4], site["pad"]
        for batch in (1, BATCH):
            for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                x = torch.randn((batch, di, hi, wi, c8i), generator=gen,
                                device="cuda").to(dt)
                wp = (torch.randn(site["wp"], generator=gen, device="cuda")
                      / np.sqrt(8 * c8i)).to(dt)
                bias = (torch.randn(c8o, generator=gen, device="cuda")
                        if site["bias"] else None)
                got = K.conv2_packed(x, wp, bias, pad=pad)
                torch.cuda.synchronize()
                ref = K.conv2_packed_plain(x, wp, bias, pad=pad)
                err = check(f"conv2_packed {name} b{batch}", got, ref, dn)
                errs[dn] = max(errs[dn], err)
                if batch == BATCH and dn == "bf16":
                    rows.append(b1_time_row(K, TF, name, x, wp, bias, pad,
                                            got))
                del x, wp, got, ref
                torch.cuda.empty_cache()
    return rows, errs


def b1_time_row(K, TF, name, x, wp, bias, pad, out):
    import torch

    n, di, hi, wi, c8i = x.shape
    c8o = wp.shape[4]
    m = out.shape[0] * out.shape[1] * out.shape[2] * out.shape[3]
    flops = 2.0 * m * (8 * c8i) * c8o
    nbytes = (x.numel() + wp.numel() + out.numel()) * x.element_size() + (
        0 if bias is None else 4 * c8o)
    reps = 3
    ms = time_ms(lambda: K.conv2_packed(x, wp, bias, pad=pad), reps)
    plain_ms = time_ms(lambda: K.conv2_packed_plain(x, wp, bias, pad=pad), 1)
    # yardstick only: the same function as one cuDNN call on the packed
    # tensor (NCDHW view of the channels-last data)
    xc = x.permute(0, 4, 1, 2, 3)
    wc = wp.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    library_ms = time_ms(lambda: TF.conv3d(xc, wc, bias.to(x.dtype) if bias
                                           is not None else None,
                                           padding=pad), reps)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S["bf16"] * 1e3
    row = {"site": name, "x": list(x.shape), "c8o": c8o, "pad": pad,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "flops": flops, "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / ms / 1e9}
    log(f"time conv2_packed {name} b{n} bf16: {json.dumps(row)}")
    return row


def b2_kernel_phase(K, P, sites, gen):
    import torch

    rows, errs = [], {"f32": 0.0, "bf16": 0.0}
    for name, site in zip(B2_SITES, sites):
        _, d, h, w, c8 = site["x"]
        for batch in (1, BATCH):
            for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                xs = torch.randn((batch, d, h, w, c8), generator=gen,
                                 device="cuda").to(dt)
                scale = 0.5 + torch.rand(c8, generator=gen, device="cuda")
                shift = torch.randn(c8, generator=gen, device="cuda")
                alpha = torch.rand(c8, generator=gen, device="cuda")
                masks = P.shifted_pad_mask_tensors(xs)
                got = K.bn_act_zero_pads(xs, scale, shift, alpha, masks)
                torch.cuda.synchronize()
                ref = K.bn_act_zero_pads_plain(xs, scale, shift, alpha, masks)
                err = check(f"bn_act_zero_pads {name} b{batch}", got, ref, dn)
                errs[dn] = max(errs[dn], err)
                if batch == BATCH and dn == "bf16":
                    nbytes = 2 * xs.numel() * xs.element_size() + 4 * (
                        3 * c8 + (d + h + w) * c8)
                    ops = 7.0 * xs.numel()    # fma, compare, select, mul, 3 mask muls
                    ms = time_ms(lambda: K.bn_act_zero_pads(
                        xs, scale, shift, alpha, masks), 5)
                    plain_ms = time_ms(lambda: K.bn_act_zero_pads_plain(
                        xs, scale, shift, alpha, masks), 2)
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = ops / PEAK_OPS_PER_S["f32"] * 1e3
                    row = {"site": name, "x": list(xs.shape), "ms": ms,
                           "plain_ms": plain_ms, "library_ms": None,
                           "bytes": nbytes, "ops": ops,
                           "bound_ms": max(t_bytes, t_ops),
                           "bound_by": ("operations" if t_ops >= t_bytes
                                        else "bytes"),
                           "gb_per_s": nbytes / ms / 1e6}
                    log(f"time bn_act_zero_pads {name} b{batch} bf16: "
                        f"{json.dumps(row)}")
                    rows.append(row)
                del xs, got, ref
                torch.cuda.empty_cache()
    return rows, errs


def record_axis_sites(K, fn):
    """Arguments of every B3 call the forward `fn()` makes: the fader
    models reach `conv_axis` through the kernels module's
    `conv_one_axis`."""
    sites = []
    one_axis = K.conv_one_axis

    def rec(x, w, axis, *, stride=1, pad=0, bias=None):
        sites.append({"x": tuple(x.shape), "w": tuple(w.shape), "axis": axis,
                      "stride": stride, "pad": pad, "bias": bias is not None})
        return one_axis(x, w, axis, stride=stride, pad=pad, bias=bias)

    K.conv_one_axis = rec
    try:
        fn()
    finally:
        K.conv_one_axis = one_axis
    return sites


def b3_kernel_phase(K, names, sites, gen, batches):
    """Each B3 site at each batch size, f32 and bf16, against its plain
    version; timed at the last batch size in bf16."""
    import torch
    import torch.nn.functional as TF

    rows, errs = [], {"f32": 0.0, "bf16": 0.0}
    for name, site in zip(names, sites):
        spatial, ci = site["x"][1:4], site["x"][4]
        k, _, co = site["w"]
        kw = dict(axis=site["axis"], stride=site["stride"], pad=site["pad"])
        for batch in batches:
            for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                x = torch.randn((batch, *spatial, ci), generator=gen,
                                device="cuda").to(dt)
                w = (torch.randn((k, ci, co), generator=gen, device="cuda")
                     / np.sqrt(k * ci)).to(dt)
                bias = (torch.randn(co, generator=gen, device="cuda")
                        if site["bias"] else None)
                got = K.conv_axis(x, w, bias, **kw)
                torch.cuda.synchronize()
                ref = K.conv_axis_plain(x, w, bias, **kw)
                err = check(f"conv_axis {name} b{batch}", got, ref, dn)
                errs[dn] = max(errs[dn], err)
                if batch == batches[-1] and dn == "bf16":
                    rows.append(b3_time_row(K, TF, name, x, w, bias, kw,
                                            got))
                del x, w, got, ref
                torch.cuda.empty_cache()
    return rows, errs


def b3_time_row(K, TF, name, x, w, bias, kw, out):
    import torch

    k, ci, co = w.shape
    flops = 2.0 * out.numel() * k * ci
    nbytes = (x.numel() + w.numel() + out.numel()) * x.element_size() + (
        0 if bias is None else 4 * co)
    ms = time_ms(lambda: K.conv_axis(x, w, bias, **kw), 20)
    plain_ms = time_ms(lambda: K.conv_axis_plain(x, w, bias, **kw), 3)
    # yardstick only: torch's conv3d with the (Co, Ci, k, 1, 1)-shaped
    # weight on the NCDHW view of the channels-last data
    axis = kw["axis"]
    shape, stride, pad = [co, ci, 1, 1, 1], [1, 1, 1], [0, 0, 0]
    shape[1 + axis], stride[axis - 1], pad[axis - 1] = (k, kw["stride"],
                                                        kw["pad"])
    wc = w.permute(2, 1, 0).reshape(shape).contiguous(
        memory_format=torch.channels_last_3d)
    bc = None if bias is None else bias.to(x.dtype)
    library_ms = time_ms(lambda: TF.conv3d(x.permute(0, 4, 1, 2, 3), wc, bc,
                                           stride=stride, padding=pad), 20)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S["bf16"] * 1e3
    row = {"site": name, "x": list(x.shape), "axis": axis, "k": k,
           "stride": kw["stride"], "pad": kw["pad"], "co": co, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "flops": flops,
           "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "gb_per_s": nbytes / ms / 1e6, "f32_core_ms": flops
           / PEAK_OPS_PER_S["f32"] * 1e3}
    log(f"time conv_axis {name} b{x.shape[0]} bf16: {json.dumps(row)}")
    return row


def reference_init(module, gen, act):
    """The JAX package's fader init, drawn from `gen`: the separable convs
    take torch's xavier_uniform_ with the gain of `act` and zero biases
    (`models/fader.py::_gain`), the Linear layers torch's default
    (kaiming_uniform_ with a = sqrt(5), bias U(+-1/sqrt(fan_in)));
    BatchNorms keep their defaults until `calibrate_fader`."""
    import math

    import torch

    gain = math.sqrt(2.0 / (1 + 0.01 ** 2)) if act == "l_relu" \
        else math.sqrt(2.0)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Conv3d):
                torch.nn.init.xavier_uniform_(m.weight, gain, generator=gen)
                torch.nn.init.zeros_(m.bias)
            elif isinstance(m, torch.nn.Linear):
                torch.nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                               generator=gen)
                bound = 1 / math.sqrt(m.in_features)
                torch.nn.init.uniform_(m.bias, -bound, bound, generator=gen)


def calibrate_fader(enc, clf, x_few, latents_fn):
    """Seeded random fader weights give probabilities that are all equal or
    all saturated.  Set every BatchNorm's running statistics from data, as
    training would: the DownBlocks' from the float32 pre-norm activations
    of `x_few`, the head's BatchNorm1d from the features of all volumes
    (`latents_fn()`); then scale the last Linear so that the logit
    difference has mean 0 and spread 1 over the volumes."""
    import torch

    with torch.no_grad():
        x = x_few
        for blk in enc.encode:
            y, _ = blk.pre_norm(x)
            bn = blk.block["5_batch_norm"]
            bn.running_mean.copy_(y.mean((0, 1, 2, 3)))
            bn.running_var.copy_(y.var((0, 1, 2, 3)))
            x, _ = blk(x)
        feats = clf.features(latents_fn())
        head = clf.head
        bn = head["6_batch_norm"]
        bn.running_mean.copy_(feats.mean(0))
        bn.running_var.copy_(feats.var(0))
        _, hidden = clf(latents_fn(), return_hidden=True)
        lf = head["9_l_f"]
        z = hidden @ lf.weight.t()
        d = z[:, 1] - z[:, 0]
        lf.weight.div_(d.std())
        lf.bias.copy_(torch.stack([torch.zeros_like(d[0]),
                                   -d.mean() / d.std()]))


def profile_batch(fn, top: int = 12):
    """torch.profiler over one served batch: device time by kernel name,
    the port's three kernels, everything else, and the device's idle share
    of the window (1 - device time / wall time; kernels run on one stream
    at a time here, so their times add).  A first, tiny profiled op
    absorbs the profiler's own start-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): an aten op's row
        # repeats the time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    ours = {k: sum(r[1] for r in rows if k in r[0])
            for k in ("conv2_packed_kernel", "bn_act_zero_pads_kernel",
                      "conv_axis_kernel")}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": (1 - device_ms / wall_ms) if device_ms else None,
            "conv2_packed_ms": ours["conv2_packed_kernel"],
            "bn_act_zero_pads_ms": ours["bn_act_zero_pads_kernel"],
            "conv_axis_ms": ours["conv_axis_kernel"],
            "other_ms": device_ms - sum(ours.values()),
            "top": [{"name": k[:90], "ms": ms, "calls": n}
                    for k, ms, n in rows[:top]]}


def kernel_entry(name, source, replaces, rows, errs, launches, per_batch):
    t_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    t_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    lib = [r["library_ms"] for r in rows]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_per_batch": per_batch,
            "max_abs_err": errs["bf16"], "max_abs_err_f32": errs["f32"],
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": t_ops + t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None if None in lib else sum(lib),
            "shapes": f"sum over the {len(rows)} sites of one batch-{BATCH} "
                      f"bf16 served batch at {SIZE}^3"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mri_epilepsy_diagnosis_torch.infer.serving import segment_volumes
    from mri_epilepsy_diagnosis_torch.models import UNet3D
    from mri_epilepsy_diagnosis_torch.models.fader import (
        AE, Classificator, make_encoder)
    from mri_epilepsy_diagnosis_torch.models.unet_packed import (
        fold_bn_inference, packed_unet_apply_v2, packed_unet_mask_v2)
    from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
    from mri_epilepsy_diagnosis_torch.ops import packed as P
    from mri_epilepsy_diagnosis_torch.transforms import znormalization

    t_start = time.perf_counter()
    # ---- 1. environment
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 2. build
    t0 = time.perf_counter()
    K.load()
    log(f"build: kernels built and loaded in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
                   out_channels_first_layer=OCFL, device="cuda").eval()
    state = random_state_dict(model, gen)
    params = fold_bn_inference(state)
    enc = make_encoder(FADER_AE_KWARGS, device="cuda").eval()
    clf = Classificator(n_class=2, device="cuda", **FADER_HEAD_KWARGS).eval()
    reference_init(enc, gen, "l_relu")
    reference_init(clf, gen, "relu")

    # ---- 3. kernel checks at the served path's own shapes
    probe = torch.randn((1, SIZE, SIZE, SIZE, 1), generator=gen,
                        device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        sites = record_sites(K, P, lambda: packed_unet_mask_v2(params, probe))
    if (len(sites["conv2_packed"]) != len(B1_SITES)
            or len(sites["bn_act_zero_pads"]) != len(B2_SITES)):
        raise AssertionError(f"unexpected site counts: {sites}")
    with torch.inference_mode():
        b3_sites = record_axis_sites(K, lambda: clf(enc(probe)[0]))
        ae = AE(**FADER_AE_KWARGS, up_block_kwargs=FADER_UP_BLOCK_KWARGS,
                device="cuda").eval()
        reference_init(ae, gen, "l_relu")
        recon = []
        ae_sites = [site for site in record_axis_sites(
            K, lambda: recon.append(ae(probe))) if site["stride"] == 1]
        recon = recon[0]
        if (len(b3_sites) != len(B3_SITES) or len(ae_sites) != len(AE_B3_SITES)
                or recon.shape != probe.shape
                or not torch.isfinite(recon).all()):
            raise AssertionError(f"unexpected fader sites {b3_sites}, "
                                 f"{ae_sites} or AE output {recon.shape}")
        del ae, recon
        b1_rows, b1_errs = b1_kernel_phase(K, sites["conv2_packed"], gen)
        b2_rows, b2_errs = b2_kernel_phase(K, P, sites["bn_act_zero_pads"],
                                           gen)
        b3_rows, b3_errs = b3_kernel_phase(K, B3_SITES, b3_sites, gen,
                                           (1, BATCH))
        ae_rows, ae_errs = b3_kernel_phase(K, AE_B3_SITES, ae_sites, gen,
                                           (1,))
    b3_errs = {dn: max(b3_errs[dn], ae_errs[dn]) for dn in b3_errs}

    # ---- 4. end-to-end serving
    vols = t1_like_volumes(gen, N_VOLUMES)
    n_batches = -(-N_VOLUMES // BATCH)

    def normalized(vs):
        return torch.stack([znormalization(torch.from_numpy(v).cuda())
                            for v in vs])[..., None]

    # decision threshold at the FG_SHARE quantile of the first volume's
    # f32 logit margin, so that the masks are neither empty nor full
    with torch.inference_mode():
        logits = model(normalized(vols[:1]))
        margin = (logits[..., 1] - logits[..., 0]).flatten()[::101]
        shift = torch.quantile(margin.float(), 1 - FG_SHARE).item()
    state["classifier.conv_layer.bias"][1] -= shift
    model.load_state_dict(state)
    params = fold_bn_inference(state)

    def znorm_batch(batch):
        return torch.stack([znormalization(v) for v in batch])

    def serve(volumes, **kw):
        t = time.perf_counter()
        outs = list(segment_volumes(
            None, params, volumes, batch_size=BATCH, dtype=torch.bfloat16,
            device="cuda", device_preprocess=znorm_batch,
            mask_fn=packed_unet_mask_v2, pack_masks=True, **kw))
        dt = time.perf_counter() - t
        if (len(outs) != len(volumes)
                or outs[0]["mask"].shape != (SIZE,) * 3):
            raise AssertionError("serving returned wrong masks")
        return dt, np.stack([o["mask"] for o in outs])

    def counted(fn, per_batch):
        """Run fn with every launch count at 0 before it; the counts of
        (B1, B2, B3) after it must be `per_batch` times the batches."""
        K.reset_launch_counts()
        out = fn()
        counts = tuple(k.launches for k in K.KERNELS)
        want = tuple(c * n_batches for c in per_batch)
        log("launches: " + ", ".join(
            f"{k.__name__} {c} (expected {w})"
            for k, c, w in zip(K.KERNELS, counts, want)))
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want}")
        return out, counts

    unet_per_batch = (len(B1_SITES), len(B2_SITES), 0)
    serve(vols, transfer_dtype=np.int16)           # warm-up
    torch.cuda.reset_peak_memory_stats()
    (t_int16, masks_int16), counts = counted(
        lambda: serve(vols, transfer_dtype=np.int16), unet_per_batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (t_u8, masks_u8), _ = counted(lambda: serve(vols, transfer_quant="uint8"),
                                  unet_per_batch)

    # fine-layout f32 reference (unfolded BN) on the same volumes
    fine_masks, fine_logits = [], []
    with torch.inference_mode():
        for i in range(0, N_VOLUMES, 2):
            logits = model(normalized(vols[i:i + 2]))
            fine_masks.append((logits[..., 1] > logits[..., 0]).to(
                torch.uint8).cpu().numpy())
            if i < BATCH:
                fine_logits.append(logits)
        # one float32 batch through the packed kernels
        packed = packed_unet_apply_v2(params, normalized(vols[:BATCH]))
        fine_logits = torch.cat(fine_logits)
        max_logit_err = (packed - fine_logits).abs().max().item()
        max_logit = fine_logits.abs().max().item()
        del packed, fine_logits
    fine_masks = np.concatenate(fine_masks)
    agree_bf16 = float(np.mean(masks_int16 == fine_masks))
    agree_u8 = float(np.mean(masks_u8 == masks_int16))
    fg = float(masks_int16.mean())
    u8_flips_per_fg = float(np.mean(masks_u8 != masks_int16)) / max(fg, 1e-12)

    # the same 8-bit transfer on the benchmark's i.i.d. noise volumes
    # (bench.py's serving volumes): recorded, not gated
    rng = np.random.default_rng(SEED)
    noise = [(rng.normal(size=(SIZE,) * 3) * 200 + 600).astype(np.int16)
             for _ in range(BATCH)]
    _, noise_int16 = serve(noise, transfer_dtype=np.int16)
    _, noise_u8 = serve(noise, transfer_quant="uint8")
    agree_u8_noise = float(np.mean(noise_u8 == noise_int16))
    fg_noise = float(noise_int16.mean())

    log(f"masks: foreground share {fg:.4f} (gate {FG_GATE}); bf16 served "
        f"vs f32 fine agreement {agree_bf16:.6f} (gate "
        f"{MASK_AGREEMENT_BF16}); uint8 vs int16 {agree_u8:.6f} (gate "
        f"{MASK_AGREEMENT_UINT8}; flipped voxels per foreground voxel "
        f"{u8_flips_per_fg:.4f}); on noise volumes uint8 vs int16 "
        f"{agree_u8_noise:.6f} at foreground share {fg_noise:.4f}")
    log(f"f32 packed vs fine logits: max_abs_err {max_logit_err:.3e} "
        f"(max|logit| {max_logit:.3e}, tol {F32_LOGIT_TOL} x max|logit|)")
    if not FG_GATE[0] <= fg <= FG_GATE[1]:
        raise AssertionError(f"degenerate masks: foreground share {fg}")
    if agree_bf16 < MASK_AGREEMENT_BF16:
        raise AssertionError(f"bf16 mask agreement {agree_bf16}")
    if agree_u8 < MASK_AGREEMENT_UINT8:
        raise AssertionError(f"uint8 mask agreement {agree_u8}")
    if max_logit_err > F32_LOGIT_TOL * max_logit:
        raise AssertionError(f"f32 logits differ by {max_logit_err}")

    serving = {"volumes": N_VOLUMES, "batch": BATCH, "size": SIZE,
               "int16_s": t_int16, "int16_vol_per_s": N_VOLUMES / t_int16,
               "int16_ms_per_batch": t_int16 / n_batches * 1e3,
               "uint8_s": t_u8, "uint8_vol_per_s": N_VOLUMES / t_u8,
               "peak_memory_gb": peak_gb, "foreground_share": fg,
               "mask_agreement_bf16_vs_f32": agree_bf16,
               "mask_agreement_uint8_vs_int16": agree_u8,
               "uint8_flips_per_foreground_voxel": u8_flips_per_fg,
               "noise_volumes_uint8_vs_int16": agree_u8_noise,
               "noise_volumes_foreground_share": fg_noise,
               "f32_logit_max_abs_err": max_logit_err,
               "f32_logit_max_abs": max_logit,
               "device": kind, "nvidia_smi": smi}
    log(f"serving: {json.dumps(serving)}")

    # ---- 4b. the seg+clf ensemble: masks plus FCD probabilities
    with torch.inference_mode():
        calibrate_fader(enc, clf, normalized(vols[:2]), lambda: torch.cat([
            enc(normalized(vols[i:i + BATCH]))[0]
            for i in range(0, N_VOLUMES, BATCH)]))
    ens_params = {"seg": params, "enc": enc, "clf": clf}

    def serve_ensemble(volumes):
        t = time.perf_counter()
        outs = list(segment_volumes(
            None, ens_params, volumes, batch_size=BATCH,
            dtype=torch.bfloat16, device="cuda",
            device_preprocess=znorm_batch, transfer_dtype=np.int16,
            mask_fn=lambda p, x: packed_unet_mask_v2(p["seg"], x),
            classify_fn=lambda p, x: p["clf"](p["enc"](x)[0]),
            pack_masks=True))
        dt = time.perf_counter() - t
        if len(outs) != len(volumes) or outs[0]["probs"].shape != (2,):
            raise AssertionError("ensemble serving returned wrong results")
        return dt, (np.stack([o["mask"] for o in outs]),
                    np.stack([o["probs"] for o in outs]))

    ens_per_batch = (len(B1_SITES), len(B2_SITES), len(B3_SITES))
    serve_ensemble(vols)                           # warm-up
    torch.cuda.reset_peak_memory_stats()
    (t_ens, (ens_masks, probs)), ens_counts = counted(
        lambda: serve_ensemble(vols), ens_per_batch)
    ens_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the port's float32 probabilities on the CPU (plain versions) and on
    # the card (kernels) for the first volumes
    import copy

    enc_cpu = copy.deepcopy(enc).to("cpu")
    clf_cpu = copy.deepcopy(clf).to("cpu")
    with torch.inference_mode():
        x = normalized(vols[:N_CPU_PROBS])
        probs_f32 = torch.softmax(clf(enc(x)[0]).float(), -1).cpu().numpy()
        x = x.cpu()
        probs_cpu = torch.softmax(clf_cpu(enc_cpu(x)[0]), -1).numpy()
    err_bf16 = float(np.abs(probs[:N_CPU_PROBS] - probs_cpu).max())
    err_f32 = float(np.abs(probs_f32 - probs_cpu).max())
    p_fcd = probs[:, 1]
    ensemble = {"volumes": N_VOLUMES, "batch": BATCH, "size": SIZE,
                "int16_s": t_ens, "int16_vol_per_s": N_VOLUMES / t_ens,
                "int16_ms_per_batch": t_ens / n_batches * 1e3,
                "peak_memory_gb": ens_peak_gb,
                "masks_equal_unet_only": bool(
                    np.array_equal(ens_masks, masks_int16)),
                "p_fcd_min": float(p_fcd.min()),
                "p_fcd_max": float(p_fcd.max()),
                "p_fcd_std": float(p_fcd.std()),
                "probs_bf16_vs_cpu_f32_max_abs_err": err_bf16,
                "probs_f32_vs_cpu_f32_max_abs_err": err_f32,
                "b3_bytes_per_batch": sum(r["bytes"] for r in b3_rows),
                "b3_gflop_per_batch": sum(r["flops"] for r in b3_rows) / 1e9,
                "device": kind, "nvidia_smi": smi}
    log(f"ensemble: {json.dumps(ensemble)}")
    log(f"probs: P(FCD) over the {N_VOLUMES} volumes "
        f"{np.array2string(p_fcd, precision=4)}; bf16 served vs CPU f32 "
        f"{err_bf16:.3e} (tol {PROBS_TOL_BF16}); f32 card vs CPU f32 "
        f"{err_f32:.3e} (tol {PROBS_TOL_F32})")
    if not ensemble["masks_equal_unet_only"]:
        raise AssertionError("ensemble masks differ from the UNet-only ones")
    if np.ptp(p_fcd) < PROBS_SPREAD_GATE or not np.isfinite(probs).all():
        raise AssertionError(f"degenerate probabilities: {p_fcd}")
    if err_bf16 > PROBS_TOL_BF16:
        raise AssertionError(f"bf16 probs differ by {err_bf16}")
    if err_f32 > PROBS_TOL_F32:
        raise AssertionError(f"f32 probs differ by {err_f32}")

    # ---- 5. where the time of one served batch goes (not gated)
    profile = profile_batch(lambda: serve(vols[:BATCH],
                                          transfer_dtype=np.int16))
    log(f"profile: {json.dumps(profile)}")
    ens_profile = profile_batch(lambda: serve_ensemble(vols[:BATCH]))
    log(f"profile ensemble: {json.dumps(ens_profile)}")

    kernels = [
        kernel_entry("conv2_packed",
                     "mri_epilepsy_diagnosis_torch/csrc/conv2_packed.cu",
                     "mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py:265",
                     b1_rows, b1_errs, ens_counts[0], len(B1_SITES)),
        kernel_entry("bn_act_zero_pads",
                     "mri_epilepsy_diagnosis_torch/csrc/bn_act_zero_pads.cu",
                     "mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py:197",
                     b2_rows, b2_errs, ens_counts[1], len(B2_SITES)),
        kernel_entry("conv_axis",
                     "mri_epilepsy_diagnosis_torch/csrc/conv_axis.cu",
                     "mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py:70",
                     b3_rows, b3_errs, ens_counts[2], len(B3_SITES)),
    ]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "b1_sites": b1_rows,
                   "b2_sites": b2_rows, "b3_sites": b3_rows,
                   "ae_b3_sites": ae_rows, "serving": serving,
                   "ensemble": ensemble, "profile": profile,
                   "profile_ensemble": ens_profile,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
