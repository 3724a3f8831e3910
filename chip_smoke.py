#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mri_epilepsy_diagnosis_torch`) on
one NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits nonzero):
1. environment: the card's name and power limit; TF32 off for f32 checks;
2. build: compiles the CUDA kernels from `mri_epilepsy_diagnosis_torch/
   csrc/` with nvcc for sm_90a into `build/torch_kernels/`;
3. kernel checks, at batch 1 and 8, in float32 and bfloat16, against
   the plain PyTorch versions, with CUDA-event times of kernel, plain
   version and a yardstick at the batch-8 bf16 shapes:
   - every B1 (`conv2_packed`) site of the 192^3, out_channels_first_
     layer=8 UNet3D (`F.conv3d` as the yardstick).  B1 takes one of two
     kernels by dtype and shape (the wrapper's `_conv2_route`): in bf16
     11 sites run the tensor-core kernel (`conv2_packed_tc.cu`), the stem
     and every f32 call the CUDA-core one (`conv2_packed.cu`), which is
     also timed at the tensor-core sites for comparison;
   - the five aligned->shifted sites, where B2 runs as the epilogue of
     the B1 launch (`conv2_packed_as_bn_act`; at the two decoder sites
     with the skip half's partial sum as addend), each timed beside the
     same launch without the epilogue and the B1 + `y +=` + B2 sequence
     it replaces; and B2 standalone (`bn_act_zero_pads`) at those shapes;
   - the four separable stacks of the fader encoder and Classificator of
     the seg+clf ensemble through the fused B3 kernel
     (`separable_conv3d`), timed beside the three per-axis `conv_axis`
     launches it replaces, and every one-axis conv of those stacks
     through `conv_axis` (`F.conv3d` as its yardstick); the stride-1
     stacks of one fader AE forward likewise at batch 1;
4. end-to-end serving: a BN-folded random UNet3D serves 16 int16 192^3
   T1w-like volumes at batch 8 in bf16 through `segment_volumes` (device
   z-normalisation, `packed_unet_mask_v2`, bit-packed masks), then again
   with uint8 transfers; launch counters prove every conv site went
   through the kernels (per bf16 batch: B1 12, 11 of them on tensor
   cores, 5 with B2 fused; standalone B2 0); masks are held against the
   unfolded fine UNet3D in float32, and float32 packed logits against the
   fine logits.  One batch
   of bench.py's i.i.d. noise volumes records the uint8 agreement there.
   Then the seg+clf ensemble serves the same volumes: the packed UNet's
   masks plus FCD probabilities of the fader encoder and Classificator
   (the reference's kwargs, random weights calibrated to non-degenerate
   probabilities), with exact launch counts (as above, plus 4 fused
   separable launches and 0 per-axis `conv_axis` ones per batch); the
   served bf16 probabilities are held against float32 probabilities of
   the port on the CPU (plain versions), and float32 ones on the card;
5. profile: torch.profiler over one served UNet batch and one served
   ensemble batch (device time by kernel, the device's idle share),
   recorded, not gated;
6. training, the packed UNet3D segmentation trainer:
   a. every B1 launch of one 192^3 batch-2 bf16 train step is recorded:
      the 12 forward convs and the 11 input gradients (`conv2_packed_dx`,
      B1 in the other parity with flipped, io-swapped weights; the stem's
      input takes none), and the 12 weight gradients (`_dw_packed_qgroup`,
      8 cuBLAS GEMMs with a float32 result each).  Each site's forward at
      batch 2 and dx at batch 1 and 2, in f32 and bf16, is held against
      the plain version, dw against an f32 einsum, and all three are timed
      beside cuDNN's `convolution_backward` of the same packed conv;
   b. f32 parity at 64^3, batch 1, TF32 off: the packed step's loss,
      gradients and running statistics against the fine UNet3D train
      step (cuDNN);
   c. `train_segmentation` (packed, bf16, one epoch of 3 batches of 2
      T1w-like 192^3 volumes with FreeSurfer-style labels, a validation
      batch, a checkpoint into `chiprun_out/` that is reloaded), then 1
      warm-up and 5 timed `packed_seg_train_step`s: finite and falling
      losses, float32 master weights, exact launch counts per step (B1 23,
      22 on tensor cores, 11 of them input gradients; B2 0), ms per step,
      vol/s, peak memory, and the B1-forward / B1-dx / dw / other split
      of one profiled step;
7. training as users run it:
   a. gradient accumulation (`packed_seg_train_step_accum`): in f32 at
      64^3, batch 2, TF32 off, micro = 2 against the flat packed step and
      the fine cuDNN step, micro = 1 against the fine step's per-volume
      gradients with its running statistics threaded; then an effective
      batch of 8 whole 192^3 volumes in micro-batches of 2, bf16: ms per
      step, vol/s, peak memory, B1 launches per step (asserted: 4 x 23);
   b. resilient training: `train_segmentation` with a `CheckpointManager`
      (packed, bf16, 192^3, batch 2, max_failures 1): two clean epochs; a
      NaN volume rolls the epoch back to the checkpoint bit for bit, and
      a second poisoned epoch raises; a fresh state resumes at the newest
      epoch with the scheduler's state; SIGTERM from inside the loader
      stops the loop at the epoch boundary after a checkpoint;
   c. `validate_dsc_asd(packed=True)` on four 192^3 subjects in f32 (B1
      on CUDA cores, 5 of 12 with B2 fused, each site checked and timed):
      packed masks against the fine cuDNN masks (>= 0.999), DSC / ASD /
      IoU over the native EDT (which must build) against scipy's EDT
      (1e-9), the device ms of the forward and the host ms of the metrics
      per subject; then `sweep_checkpoints` over 7b's directory;
8. segmentation from NIfTI files:
   a. 4 FreeSurfer-style subjects written with `save_nifti` (256^3 int16
      `*_norm` and int32 `*_aparc+aseg`, one subject gzipped) with a
      targets CSV into `chiprun_out/chip_smoke_cohort/` (removed at the
      end of the phase); `MriSegmentation` must return exactly the 192^3
      crops written; host ms per subject load;
   b. Nyul landmarks over the subjects, then `preprocess_volume` of each
      256^3 volume to 192^3 on the card against the CPU, and the
      histogram standardization of a 320x320x192 volume (above
      `torch.quantile`'s 2^24 elements);
   c. each augmentation's core on a 192^3 volume, card against CPU; the
      reference's chain (flip, affine, elastic, noise, motion, bias
      field) timed on a batch of 2;
   d. training from the files: whole volumes (`Subset`, `DataLoader`
      with a collate that preprocesses on the card, one
      `train_segmentation` epoch, `validate_dsc_asd`), then 64^3 patches
      (`PatchQueue` with 2 workers, `batched(16)`) through the same
      trainer; every B1 launch of a batch-16 patch step against its plain
      version; 5 timed steps with exact launch counts (B1 23, 22 on
      tensor cores, 11 dx), the device split of a step, and the device
      idle share of a profiled epoch from files;
   e. `sliding_window_predict` of one 192^3 volume, patch 64, overlap 4
      (64 patches, one batch-64 call of the BN-folded packed UNet), bf16
      and f32, crop and average, with exact launch counts per call (B1
      12, 11 on tensor cores in bf16, 5 with B2 fused); each B1 site at
      N = 64 against its plain version; f32 logits against the fine
      UNet3D's (cuDNN) through the same window; bf16 masks against f32
      masks; the mask written to NIfTI and read back;
9. fader and classification training:
   a. every B3 call of one `enc_clf_step` and one `disc_step` of the
      reference fader (192^3, depth 3, batch 35, bf16): each distinct
      `conv_axis_dx`, `conv_axis_dw`, `conv_axis` (the backward's
      recompute) and fused `separable_conv3d` site in f32 at batch 2 and
      in bf16 at batch 35 against its plain version (dx 2^-7, dw and db
      2e-4, the stacks as in phase 3, x max|ref|), timed beside cuDNN's
      `conv3d_input` / `conv3d_weight` / `conv3d`;
   b. the alternation of `examples/train_fader.py` (3 `disc_step`s and one
      `enc_clf_step` a batch, Adam 7e-4 / 7e-4 / 5e-4, lambda ramp, class
      weight [1, 2]): exact launch counts per batch (fused 17, `conv_axis`
      14, dw 21, dx 20), ms per batch, vol/s, peak memory, finite losses,
      float32 master weights, one profiled batch (host syncs and copies
      counted; its idle share also with the device alone traced); then
      `train_fader` over
      two batches and a validation batch;
   c. f32 parity at 48^3, depth 2: one `enc_clf_step` and one `disc_step`
      with the kernels against the same steps with per-axis cuDNN convs
      (loss 1e-5, gradients 2e-2 x max, running statistics 1e-5);
   d. `ae_step` at 192^3 with `examples/train_ae.py`'s settings (depth 6,
      c_base 16, batch 3, bf16), its B3 sites checked and timed as in
      9a (its stacks in f32 at batch 1), fused or per-axis as the plan
      routes them; ms per step, peak memory;
   e. bf16 `_class_step`s of DilatedCNN (180^3) and VoxResNet (192^3) at
      batch 10, and one `class_train_step_accum` (micro 2): ms per step,
      vol/s, peak memory (cuDNN convs: no kernel of the port launches).

It prints one line per check, then `{"kernels": [...]}` (the kernels of
the served path: B1 on tensor cores, B2 fused into B1 on either route,
fused B3; of the training path: B1's forward on tensor cores, the
stem's forward on CUDA cores, B1 as input gradient; of f32 validation;
of phase 8's sliding window and patch training; of phase 9's fader
training: fused B3, B3's dx and dw and the `conv_axis` recomputes; the
standalone
B2, off every path, goes to the JSON file with its numbers, as does dw
of the packed UNet, which is cuBLAS and no kernel of the port), the card's
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
# the fused separable stack rounds each stage to bf16: a one-step
# difference in an intermediate passes through the later stages
SEP_TOL = {"f32": 1e-5, "bf16": 2.0 ** -6}
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
# B1 sites on the tensor-core route in bf16: all but the 8Ci = 8 stem e0c1
B1_TC_PER_BATCH = len(B1_SITES) - 1
# the aligned->shifted sites, where B2 is fused into the B1 launch
B2_SITES = ("e0c1", "e1c1", "bc1", "d0c1.up", "d1c1.up")
B3_STACKS = ("e0", "e1", "e2", "clf")
B3_SITES = tuple(f"{blk}{ax}" for blk in ("e0", "e1", "e2", "clf.")
                 for ax in "xyz")
AE_B3_STACKS = ("ae.d0", "ae.d1", "ae.d2")
AE_B3_SITES = tuple(f"ae.d{i}{ax}" for i in range(3) for ax in "xyz")
# launches per served bf16 batch, by counter
UNET_PER_BATCH = {"conv2_packed": len(B1_SITES),
                  "conv2_packed_tc": B1_TC_PER_BATCH,
                  "conv2_packed_dx": 0, "conv2_packed_dx_tc": 0,
                  "conv2_packed_as_bn_act": len(B2_SITES),
                  "conv2_packed_as_bn_act_tc": len(B2_SITES) - 1,
                  "bn_act_zero_pads": 0, "conv_axis": 0,
                  "separable_conv3d": 0, "conv_axis_dx": 0,
                  "conv_axis_dw": 0}
ENSEMBLE_PER_BATCH = {**UNET_PER_BATCH, "separable_conv3d": len(B3_STACKS)}

# training (phase 6): a packed train step launches B1 for each of the 12
# convs (none with the B2 epilogue: BN needs the batch statistics of the
# conv's output) and for each input gradient but the stem's input (11).
# In bf16 all but the 8Ci = 8 stem forward take the tensor cores: every
# dx has 8Ci and 8Co multiples of 64.
TRAIN_BATCH = 2
TRAIN_BATCHES = 3              # training loader of train_segmentation
TIMED_STEPS = 5
DX_SITES = B1_SITES[1:]
TRAIN_PER_STEP = {"conv2_packed": len(B1_SITES) + len(DX_SITES),
                  "conv2_packed_tc": len(B1_SITES) - 1 + len(DX_SITES),
                  "conv2_packed_dx": len(DX_SITES),
                  "conv2_packed_dx_tc": len(DX_SITES),
                  "conv2_packed_as_bn_act": 0, "conv2_packed_as_bn_act_tc": 0,
                  "bn_act_zero_pads": 0, "conv_axis": 0,
                  "separable_conv3d": 0, "conv_axis_dx": 0,
                  "conv_axis_dw": 0}
# dw sums K = N x cells ~ 1.8M products per entry in f32 in an order that
# neither side controls; sequential f32 accumulation errs by about
# sqrt(K) 2^-24 ~ 1e-4 of a typical entry, a few times less of the
# largest one: the gate is 2e-4 x max|ref| (runs showed up to 3.3e-5)
DW_TOL = 2e-4
# f32 packed train step (kernels) vs the fine UNet3D's (cuDNN, TF32 off).
# Rounding decides the kinks: where two values of a 2x2x2 max-pool window,
# or a PReLU input and 0, lie within f32 rounding of each other, the two
# paths may route one voxel's gradient differently, which moves a weight
# gradient upstream of it by up to ~1e-2 of its max (the deep BN chain
# cancels most of each leaf's sum), on either path alike: the gate is
# 2e-2, and the f64 fine step is recorded beside the two f32 ones.
PARITY_SIZE = 64
PARITY_LOSS_RTOL = 1e-5
PARITY_GRAD_RTOL = 2e-2        # x max|grad| of the leaf
# conv biases followed by BN have a true gradient of 0 and an f32-noise one
# on both sides: every leaf also gets this floor, x the largest gradient
PARITY_GRAD_FLOOR = 1e-6
PARITY_STATS_TOL = 1e-5        # x max(1, max|running stat|)
# training as users run it (phase 7).  7a: an effective batch of
# ACCUM_BATCH whole volumes in micro-batches of ACCUM_MICRO, each
# micro-batch a full train step's B1 launches
ACCUM_BATCH = 8
ACCUM_MICRO = 2
ACCUM_STEPS = 3
ACCUM_PER_STEP = {k: ACCUM_BATCH // ACCUM_MICRO * v
                  for k, v in TRAIN_PER_STEP.items()}
RESILIENT_BATCHES = 2          # 7b: training batches per epoch
VAL_SUBJECTS = 4               # 7c: validated 192^3 subjects
VAL_BATCH = 2
# 7c runs in f32, as the loaders give the volumes: every B1 launch takes
# the CUDA-core kernel, 5 with B2 fused
VAL_PER_BATCH = {**UNET_PER_BATCH, "conv2_packed_tc": 0,
                 "conv2_packed_as_bn_act_tc": 0}
# f32 packed masks (kernels) vs the fine UNet3D's (cuDNN, TF32 off): only
# voxels whose two logits tie within f32 rounding may differ
VAL_MASK_AGREEMENT = 0.999
# DSC/ASD/IoU over the native EDT vs over scipy's: both exact transforms
# in float64, so only the order of a few float64 operations differs
METRIC_TOL = 1e-9
# segmentation from files (phase 8): COHORT_SUBJECTS FreeSurfer-conformed
# COHORT_SIZE^3 subjects on disk, cropped at COHORT_CROP to SIZE^3 as
# MriSegmentation does by default
COHORT_SUBJECTS = 4
COHORT_SIZE = 256
COHORT_CROP = (30, 30, 30)
# 19.7 M voxels: above torch.quantile's 2^24 elements
QUANTILE_LIMIT_SHAPE = (320, 320, 192)
# preprocessing and augmentation on the card vs on the CPU, x max|ref|:
# the same float32 operations, with the reductions (the z-normalization's
# moments, the bias field's sum of terms, the elastic field's
# interpolation) summed in another order
PREP_TOL = 1e-4
AUG_TOL = 1e-4
# 64^3 patch training (`examples/train_segmentation.py --patches`)
PATCH = 64
PATCH_BATCH = 16
PATCHES_PER_VOLUME = 6
PATCH_QUEUE_LENGTH = 180
PATCH_STEPS = 5
# the profiled epochs from files pass over the subjects this many times:
# 64 loads, 32 whole-volume steps, 384 patches in 24 steps (the queue
# refills past PATCH_QUEUE_LENGTH twice), so that they show the loaders in
# steady state and not only their start-up
PROFILE_PASSES = 16
# sliding-window inference (`pretraining_3d_unet.ipynb` cells 26/35): patch
# 64, overlap 4, so 4 positions per axis of 192 and one batch-64 call
SW_OVERLAP = 4
SW_BATCH = 64
SW_PATCHES = 64
SW_LOGIT_TOL = 1e-4            # f32 sliding window vs the fine UNet3D's
SW_TIMED_CALLS = 7             # per dtype and mode: median and spread
# labels: FreeSurfer ids, cortical ids >= 1000 in a sphere that is also
# brighter in the image, a LIST_FCD subcortical id (17) in a smaller one,
# background ids outside LIST_FCD (2, 41) elsewhere
LABEL_RADII = (SIZE / 5.5, SIZE / 16)

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


# phase 9: fader and classification training.  The fader alternation of
# `examples/train_fader.py` (train_ENC_CLF.ipynb cells 17-18): 192^3, depth
# 3, 18 domains, batch 35, bf16, Adam 7e-4 / 7e-4 / 5e-4 with weight decay
# 1e-4, lambda from 1e-4 to 1e-1 over 300 steps, class weight [1, 2],
# 3 discriminator steps a batch
FADER_N_DOMAINS = 18
FADER_DEPTH = 3
FADER_BATCH = 35
FADER_DISC_LOOP = 3
FADER_LR = (7e-4, 7e-4, 5e-4)             # encoder, classifier, disc
FADER_WD = 1e-4
FADER_LAMBDA = (1e-4, (1e-1 - 1e-4) / 300, 300)   # initial, step, max_step
FADER_CLASS_WEIGHT = [1.0, 2.0]
FADER_TIMED_BATCHES = 3
# launches per step.  Each stack with trainable weights: one fused
# forward, 2 recomputes of its intermediates (`conv_axis`), 3 dw, and dx
# at each axis whose input needs a cotangent: e0 (the image takes none)
# 2, the other encoder blocks and the classifier 3 each, the frozen
# discriminator 3 (dx only, no recompute, no dw).  In disc_step the
# encoder runs under no_grad and the discriminator's stack still takes 2
# dx: the weight gradients of its H and D stages need the cotangents of y2
# and y1.  At depth 3: enc_clf_step 5 fused, 8 conv_axis, 12 dw, 14 dx;
# disc_step 4, 2, 3, 2.


def alternation_per_batch(depth):
    """Launches per alternation batch (FADER_DISC_LOOP disc_steps, one
    enc_clf_step) of a fader of `depth` encoder blocks, every counter."""
    trained = depth + 1                     # encoder blocks and classifier
    enc_clf = {"separable_conv3d": depth + 2, "conv_axis": 2 * trained,
               "conv_axis_dw": 3 * trained,
               "conv_axis_dx": 3 * trained - 1 + 3}
    disc = {"separable_conv3d": depth + 1, "conv_axis": 2,
            "conv_axis_dw": 3, "conv_axis_dx": 2}
    return {**{k: 0 for k in UNET_PER_BATCH}, **{
        k: v + FADER_DISC_LOOP * disc[k] for k, v in enc_clf.items()}}


# 9c: f32 parity of the kernel steps with per-axis cuDNN convs at 48^3,
# depth 2, the heads scaled as `examples/train_fader.py` scales them
FADER_PARITY_SIZE = 48
FADER_PARITY_BATCH = 4
# 9d: `examples/train_ae.py` (train_AE.ipynb cell 8): depth 6, c_base 16,
# stride-1 k=3 DownBlocks and scale-2 UpBlocks, batch 3
AE_KWARGS = dict(c_in=1, is_skip=False, deapth=6, c_base=16, inc_size=2,
                 reduce_size=False,
                 down_block_kwargs=dict(conv_k=3, conv_pad=1, conv_s=1,
                                        maxpool_k=2, maxpool_s=2,
                                        batch_norm=True, act="relu"),
                 up_block_kwargs=dict(up="upsample", scale=2,
                                      scale_mode="nearest", conv_k=3,
                                      conv_pad=1, conv_s=1, batch_norm=True,
                                      act="relu"))
AE_BATCH = 3
AE_N_DOMAINS = 3
AE_STEPS = 3
# 9e: the classification baselines (README "Performance" rows): DilatedCNN
# at 180^3 (`baseline_sample_classification.ipynb`), VoxResNet at 192^3,
# batch 10
CLASS_BATCH = 10
DILATED_SIZE = 180
CLASS_STEPS = 3


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def on_card(t) -> bool:
    return t.device.type == "cuda"


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


def t1_like_volumes(gen, n, size=SIZE):
    """int16 volumes like tests/test_serving_quant.py's T1w stand-ins at
    size^3: N(600, 40) noise plus six smooth bright blobs (amplitude 400,
    radius size/24..size/10), made on the card from `gen`."""
    import torch

    ax = torch.arange(size, device="cuda", dtype=torch.float32)
    out = []
    for _ in range(n):
        v = 600 + 40 * torch.randn((size,) * 3, generator=gen, device="cuda")
        for _ in range(6):
            c = size / 8 + torch.rand(3, generator=gen, device="cuda") * (
                size * 3 / 4)
            r = size / 24 + torch.rand((), generator=gen, device="cuda") * (
                size / 10 - size / 24)
            g = [((ax - c[i]) ** 2) for i in range(3)]
            v += 400 * torch.exp(-(g[0][:, None, None] + g[1][None, :, None]
                                   + g[2][None, None, :]) / (2 * r * r))
        out.append(v.to(torch.int16).cpu().numpy())
    return out


def record_sites(K, P, fn):
    """Every B1 launch the served forward `fn()` makes, in call order, with
    its shapes and whether B2 runs as its epilogue (and with an addend);
    and the standalone B2 calls (none on the served path)."""
    import types

    sites = {"conv2_packed": [], "bn_act_zero_pads": []}
    conv, fused, epi = (K.conv2_packed, K.conv2_packed_as_bn_act,
                        K.bn_act_zero_pads)

    def rec_conv(x, wp, bias=None, *, pad=0):
        sites["conv2_packed"].append(
            {"x": tuple(x.shape), "wp": tuple(wp.shape), "pad": pad,
             "bias": bias is not None, "fused": False, "addend": False})
        return conv(x, wp, bias, pad=pad)

    def rec_fused(x, wp, scale, shift, alpha, *, addend=None):
        sites["conv2_packed"].append(
            {"x": tuple(x.shape), "wp": tuple(wp.shape), "pad": 1,
             "bias": False, "fused": True, "addend": addend is not None})
        return fused(x, wp, scale, shift, alpha, addend=addend)

    def rec_epi(xs, scale, shift, alpha, masks):
        sites["bn_act_zero_pads"].append({"x": tuple(xs.shape)})
        return epi(xs, scale, shift, alpha, masks)

    # the packed ops reach the kernels through their module's `K`
    P.K = types.SimpleNamespace(conv2_packed=rec_conv,
                                conv2_packed_as_bn_act=rec_fused,
                                bn_act_zero_pads=rec_epi,
                                conv2_packed_dx=K.conv2_packed_dx)
    try:
        fn()
    finally:
        P.K = K
    return sites


def check(name, got, ref, dtype_name, tols=TOL):
    tol = tols[dtype_name]
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} != "
                             f"plain {ref.dtype} {tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = err <= tol * max(scale, 1e-30)
    log(f"check {name} {dtype_name}: max_abs_err {err:.3e} "
        f"(max|ref| {scale:.3e}, tol {tol:.1e} x max|ref|)")
    if not ok:
        raise AssertionError(f"{name} {dtype_name} disagrees with its plain "
                             f"version: {err} > {tol} x {scale}")
    return err


def _kernel_kind(route, fused):
    """The kernel instantiation a B1 launch takes: its route, `_bn_act`
    with the B2 epilogue."""
    return route + ("_bn_act" if fused else "")


def forward_site_rows(K, sites, gen, label, checks, timed=None):
    """Each B1 site of a recorded forward (B2 fused at the sites recorded
    as fused) at each (batch, dtype) of `checks`, batch None meaning the
    recorded one, against its plain version.  At the pair `timed` each
    site is also timed beside its plain version, the CUDA-core kernel on
    the same inputs (tensor-core plain-store sites), cuDNN's `F.conv3d`
    (plain-store sites, TF32 off) and the bound at the peak of the dtype.
    Returns the timed rows and the largest error by kernel kind
    (`_kernel_kind`) and dtype."""
    import torch
    import torch.nn.functional as TF

    rows = []
    # None where no check of that kind and dtype ran
    errs = {_kernel_kind(r, f): {"f32": None, "bf16": None}
            for r in ("tc", "cuda_core") for f in (False, True)}
    for name, site in zip(B1_SITES, sites):
        c8i, c8o, pad = site["x"][4], site["wp"][4], site["pad"]
        fused = site.get("fused", False)
        for batch, dn in checks:
            dt = torch.float32 if dn == "f32" else torch.bfloat16
            shape = (batch or site["x"][0], *site["x"][1:])
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            wp = (torch.randn(site["wp"], generator=gen,
                              device="cuda") / np.sqrt(8 * c8i)).to(dt)
            if fused:
                scale = 0.5 + torch.rand(c8o, generator=gen, device="cuda")
                shift = torch.randn(c8o, generator=gen, device="cuda")
                alpha = torch.rand(c8o, generator=gen, device="cuda")
                add = (torch.randn((x.shape[0], *(e + 1 for e in shape[1:4]),
                                    c8o), generator=gen,
                                   device="cuda").to(dt)
                       if site["addend"] else None)

                def run():
                    return K.conv2_packed_as_bn_act(x, wp, scale, shift,
                                                    alpha, addend=add)

                def plain():
                    return K.conv2_packed_as_bn_act_plain(x, wp, scale, shift,
                                                          alpha, add)
                library = cuda_core = None
                extra = ((0 if add is None else add.numel() * x.element_size())
                         + 3 * 4 * c8o)
            else:
                bias = (torch.randn(c8o, generator=gen, device="cuda")
                        if site["bias"] else None)

                def run():
                    return K.conv2_packed(x, wp, bias, pad=pad)

                def plain():
                    return K.conv2_packed_plain(x, wp, bias, pad=pad)

                def cuda_core():
                    return K._conv2_launch(x, wp, bias, pad, False)
                xc = x.permute(0, 4, 1, 2, 3)
                wc = wp.permute(4, 3, 0, 1, 2).contiguous(
                    memory_format=torch.channels_last_3d)
                bc = None if bias is None else bias.to(dt)

                def library():
                    return TF.conv3d(xc, wc, bc, padding=pad)
                extra = 0 if bias is None else 4 * c8o
            route = K._conv2_route(dt, c8i, c8o)
            kind = _kernel_kind(route, fused)
            got = run()
            torch.cuda.synchronize()
            op = "conv2_packed_as_bn_act" if fused else "conv2_packed"
            err = check(f"{label} {op} {name} b{x.shape[0]} ({route})", got,
                        plain(), dn)
            errs[kind][dn] = max(errs[kind][dn] or 0.0, err)
            if (batch, dn) == timed:
                m = got.shape[0] * got.shape[1] * got.shape[2] * got.shape[3]
                flops = 2.0 * m * (8 * c8i) * c8o
                nbytes = ((x.numel() + wp.numel() + got.numel())
                          * x.element_size() + extra)
                bound_ms, bound_by = _bound(flops, nbytes, dn)
                ms = time_ms(run, 10)
                rows.append({
                    "site": name, "x": list(x.shape), "c8o": c8o, "pad": pad,
                    "fused": fused, "route": route, "max_abs_err": err,
                    "ms": ms, "plain_ms": time_ms(plain, 1),
                    # the CUDA-core kernel on the same inputs (uncounted
                    # launches): what the tensor-core route replaced here
                    "cuda_core_ms": (time_ms(cuda_core, 2)
                                     if route == "tc" and cuda_core else
                                     ms if route == "cuda_core" else None),
                    # yardstick only: the same function as one cuDNN call
                    # on the packed tensor (NCDHW view of the data)
                    "library_ms": (None if library is None
                                   else time_ms(library, 10)),
                    "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bound_share": bound_ms / ms,
                    "tflops": flops / ms / 1e9,
                    "tile_waste": (K.conv2_tc_plan(*got.shape[:4], c8o,
                                                   pad).waste
                                   if route == "tc" and not fused else None)})
                log(f"time {label} {kind} {name} b{x.shape[0]} {dn}: "
                    f"{json.dumps(rows[-1])}")
            del x, wp, got
            torch.cuda.empty_cache()
    return rows, errs


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


def fused_kernel_phase(K, P, sites, gen):
    """B2 fused into B1 at each aligned->shifted site, batch 1 and 8, f32
    and bf16, against its plain version; timed at batch 8 in bf16.
    Errors are kept per route."""
    import torch

    rows = []
    errs = {r: {"f32": 0.0, "bf16": 0.0} for r in ("tc", "cuda_core")}
    fused = [(name, site) for name, site in zip(B1_SITES, sites)
             if site["fused"]]
    if [name for name, _ in fused] != list(B2_SITES):
        raise AssertionError(f"fused sites {fused} != {B2_SITES}")
    for name, site in fused:
        _, di, hi, wi, c8i = site["x"]
        c8o = site["wp"][4]
        for batch in (1, BATCH):
            for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                x = torch.randn((batch, di, hi, wi, c8i), generator=gen,
                                device="cuda").to(dt)
                wp = (torch.randn(site["wp"], generator=gen, device="cuda")
                      / np.sqrt(8 * c8i)).to(dt)
                scale = 0.5 + torch.rand(c8o, generator=gen, device="cuda")
                shift = torch.randn(c8o, generator=gen, device="cuda")
                alpha = torch.rand(c8o, generator=gen, device="cuda")
                add = (torch.randn((batch, di + 1, hi + 1, wi + 1, c8o),
                                   generator=gen, device="cuda").to(dt)
                       if site["addend"] else None)
                route = K._conv2_route(dt, c8i, c8o)
                got = K.conv2_packed_as_bn_act(x, wp, scale, shift, alpha,
                                               addend=add)
                torch.cuda.synchronize()
                ref = K.conv2_packed_as_bn_act_plain(x, wp, scale, shift,
                                                     alpha, add)
                err = check(f"conv2_packed_as_bn_act {name} b{batch} "
                            f"({route})", got, ref, dn)
                errs[route][dn] = max(errs[route][dn], err)
                if batch == BATCH and dn == "bf16":
                    rows.append(fused_time_row(K, P, name, x, wp, scale,
                                               shift, alpha, add, got))
                del x, wp, add, got, ref
                torch.cuda.empty_cache()
    return rows, errs


def fused_time_row(K, P, name, x, wp, scale, shift, alpha, add, out):
    """Times of the fused launch, of the same launch storing its f32 sums
    without the epilogue, and of what it replaces: that launch, the
    decoder's `y += partial`, and B2 standalone."""
    n, di, hi, wi, c8i = x.shape
    c8o = wp.shape[4]
    m = out.shape[0] * out.shape[1] * out.shape[2] * out.shape[3]
    flops = 2.0 * m * (8 * c8i) * c8o
    nbytes = (x.numel() + wp.numel() + out.numel()
              + (0 if add is None else add.numel())) * x.element_size() \
        + 3 * 4 * c8o
    route = K._conv2_route(x.dtype, c8i, c8o)
    tc = route == "tc"
    masks = P.shifted_pad_mask_tensors(out)
    ms = time_ms(lambda: K.conv2_packed_as_bn_act(
        x, wp, scale, shift, alpha, addend=add), 10)
    unfused_ms = time_ms(lambda: K._conv2_launch(x, wp, None, 1, tc), 10)

    def replaced():
        y = K._conv2_launch(x, wp, None, 1, tc)
        if add is not None:
            y += add
        K.bn_act_zero_pads(y, scale, shift, alpha, masks)

    replaced_ms = time_ms(replaced, 10)
    plain_ms = time_ms(lambda: K.conv2_packed_as_bn_act_plain(
        x, wp, scale, shift, alpha, add), 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S["bf16"] * 1e3
    bound_ms = max(t_bytes, t_ops)
    row = {"site": name, "x": list(x.shape), "c8o": c8o,
           "addend": add is not None, "route": route, "ms": ms,
           "unfused_ms": unfused_ms, "epilogue_ms": ms - unfused_ms,
           "replaced_ms": replaced_ms, "plain_ms": plain_ms,
           "library_ms": None, "flops": flops, "bytes": nbytes,
           "bound_ms": bound_ms,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_share": bound_ms / ms, "tflops": flops / ms / 1e9}
    log(f"time conv2_packed_as_bn_act {name} b{n} bf16: {json.dumps(row)}")
    return row


def axis_sites(stacks):
    """The one-axis convs of the stacks, with the shapes each receives."""
    sites = []
    for st in stacks:
        shape = list(st["x"])
        for a in range(3):
            k, _, co = st["w"][a]
            s, p = st["stride"][a], st["pad"][a]
            sites.append({"x": tuple(shape), "w": st["w"][a], "axis": a + 1,
                          "stride": s, "pad": p, "bias": st["bias"][a]})
            shape[1 + a] = (shape[1 + a] + 2 * p - k) // s + 1
            shape[4] = co
    return sites


def sep_kernel_phase(K, named, gen, checks, timed, fused_only=True):
    """Each (name, separable stack, calls per step) of `named` through
    `separable_conv3d` at each (batch, dtype) of `checks`, batch None
    meaning the recorded one, against its plain version; timed at the pair
    `timed` where it takes the fused kernel (the row repeated by its
    calls).  `fused_only`: every stack must take the fused kernel; else a
    stack may take the per-axis route, whose `conv_axis` launches
    `b3_bwd_rows` holds."""
    import torch

    rows, errs = [], {"f32": 0.0, "bf16": 0.0}
    for name, st, calls in named:
        spatial, ci = st["x"][1:4], st["x"][4]
        ks = [w[0] for w in st["w"]]
        chans = (ci, *(w[2] for w in st["w"]))
        for batch, dn in checks:
            dt = torch.float32 if dn == "f32" else torch.bfloat16
            n = batch or st["x"][0]
            x = torch.randn((n, *spatial, ci), generator=gen,
                            device="cuda").to(dt)
            ws = [(torch.randn(w, generator=gen, device="cuda")
                   / np.sqrt(w[0] * w[1])).to(dt) for w in st["w"]]
            bs = tuple(torch.randn(w[2], generator=gen, device="cuda")
                       if b else None for w, b in zip(st["w"], st["bias"]))
            kw = dict(stride=st["stride"], pad=st["pad"], biases=bs)
            plan = K.separable_plan(n, spatial, chans, ks, st["stride"],
                                    st["pad"], dt)
            route = K._separable_route(dt, plan)
            if fused_only and route != "fused":
                raise AssertionError(f"{name} takes route {route}")
            got = K.separable_conv3d(x, *ws, **kw)
            torch.cuda.synchronize()
            ref = K.separable_conv3d_plain(x, *ws, **kw)
            how = f"route {route}" + ("" if plan is None else (
                f", tile {plan.tile}, tensor cores {plan.mma}"))
            err = check(f"separable_conv3d {name} {list(x.shape)} ({how})",
                        got, ref, dn, SEP_TOL)
            errs[dn] = max(errs[dn], err)
            if (batch, dn) == timed and route == "fused":
                row = sep_time_row(K, name, x, ws, kw, plan, got)
                row.update(calls_per_step=calls, max_abs_err=err)
                rows += [row] * calls
            del x, ws, got, ref
            torch.cuda.empty_cache()
    return rows, errs


def sep_time_row(K, name, x, ws, kw, plan, out):
    """Times of the fused stack, of the three per-axis `conv_axis`
    launches it replaces, and of three cuDNN one-axis convs (yardstick
    only: no single torch call computes the stack with its three
    roundings)."""
    import torch
    import torch.nn.functional as TF

    bs = kw["biases"]
    # each stage's output elements x k x Cin x 2, at the peak of its unit
    shape, flops, t_ops = list(x.shape), [], 0.0
    for a, w in enumerate(ws):
        k, ci, co = w.shape
        shape[1 + a] = (shape[1 + a] + 2 * kw["pad"][a] - k) \
            // kw["stride"][a] + 1
        shape[4] = co
        flops.append(2.0 * float(np.prod(shape)) * k * ci)
        t_ops += flops[-1] / PEAK_OPS_PER_S[
            "bf16" if plan.mma[a] else "f32"] * 1e3
    nbytes = (x.numel() + out.numel()) * x.element_size() + sum(
        4 * w.numel() for w in ws) + sum(4 * b.numel() for b in bs
                                          if b is not None)

    def per_axis():
        v = x
        for a in range(3):
            v = K.conv_axis(v, ws[a], bs[a], axis=a + 1,
                            stride=kw["stride"][a], pad=kw["pad"][a])

    wcs, conv_kw = [], []
    for a, w in enumerate(ws):
        k, ci, co = w.shape
        wshape, stride, pad = [co, ci, 1, 1, 1], [1, 1, 1], [0, 0, 0]
        wshape[2 + a], stride[a], pad[a] = k, kw["stride"][a], kw["pad"][a]
        wcs.append(w.permute(2, 1, 0).reshape(wshape).contiguous(
            memory_format=torch.channels_last_3d))
        conv_kw.append(dict(stride=stride, padding=pad))

    def cudnn3():
        v = x.permute(0, 4, 1, 2, 3)
        for a in range(3):
            v = TF.conv3d(v, wcs[a], None if bs[a] is None
                          else bs[a].to(x.dtype), **conv_kw[a])

    ms = time_ms(lambda: K.separable_conv3d(x, *ws, **kw), 20)
    per_axis_ms = time_ms(per_axis, 20)
    cudnn3_ms = time_ms(cudnn3, 20)
    plain_ms = time_ms(lambda: K.separable_conv3d_plain(x, *ws, **kw), 3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"site": name, "x": list(x.shape), "w": [list(w.shape) for w in ws],
           "stride": list(kw["stride"]), "pad": list(kw["pad"]),
           "tile": list(plan.tile), "halo": list(plan.halo),
           "tensor_core_stages": list(plan.mma), "smem": plan.smem,
           "blocks": plan.grid, "ms": ms, "per_axis_ms": per_axis_ms,
           "plain_ms": plain_ms, "library_ms": None,
           "cudnn_3calls_ms": cudnn3_ms, "flops": sum(flops),
           "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "gb_per_s": nbytes / ms / 1e6}
    log(f"time separable_conv3d {name} b{x.shape[0]} bf16: "
        f"{json.dumps(row)}")
    return row


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


def profile_batch(fn, top: int = 12, host_ops: bool = True):
    """torch.profiler over one served batch: device time by kernel name,
    the port's kernels (B1 on tensor cores split into its plain-store and
    B2-epilogue instantiations), everything else, and the device's idle share
    of the window (1 - device time / wall time; kernels run on one stream
    at a time here, so their times add).  A first, tiny profiled op
    absorbs the profiler's own start-up.  `host_ops=False` traces the
    device alone: recording every host op slows the host threads, which
    set the pace of an epoch from files."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CPU] if host_ops else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()            # the trace is read from here
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
            for k in ("conv2_packed_tc_kernel", "conv2_packed_kernel",
                      "bn_act_zero_pads_kernel", "conv_axis_kernel",
                      "separable_conv3d_kernel", "conv_axis_dx_kernel",
                      "conv_axis_dw_partial_kernel",
                      "conv_axis_dw_finish_kernel")}
    # the epilogue instantiations carry `true>` in their template arguments
    fused_tc = sum(r[1] for r in rows if "conv2_packed_tc_kernel" in r[0]
                   and "true>" in r[0])
    fused_cc = sum(r[1] for r in rows if "conv2_packed_kernel" in r[0]
                   and "true>" in r[0])
    # copies (host <-> device) run on the copy engines; their time also
    # depends on the host's memory (pageable destinations)
    copy_ms = sum(r[1] for r in rows if r[0].startswith("Memcpy")
                  or r[0].startswith("Memset"))
    # the host's waits on the card (a blocking copy synchronizes its
    # stream; the window's own closing synchronize is one) and the copies
    # from the host, by call
    syncs = {e.key: e.count for e in prof.key_averages()
             if "Synchronize" in e.key}
    h2d = sum(r[2] for r in rows if r[0].startswith("Memcpy HtoD"))
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "host_ops_traced": host_ops,
            "trace_read_s": time.perf_counter() - t0,
            "kernel_ms": device_ms - copy_ms, "copy_ms": copy_ms,
            "host_syncs": syncs, "h2d_copies": h2d,
            "idle_share": (1 - device_ms / wall_ms) if device_ms else None,
            "conv2_packed_tc_ms": ours["conv2_packed_tc_kernel"],
            "conv2_packed_tc_bn_act_ms": fused_tc,
            "conv2_packed_ms": ours["conv2_packed_kernel"],
            "conv2_packed_bn_act_ms": fused_cc,
            "bn_act_zero_pads_ms": ours["bn_act_zero_pads_kernel"],
            "conv_axis_ms": ours["conv_axis_kernel"],
            "separable_conv3d_ms": ours["separable_conv3d_kernel"],
            "conv_axis_dx_ms": ours["conv_axis_dx_kernel"],
            "conv_axis_dw_ms": ours["conv_axis_dw_partial_kernel"]
            + ours["conv_axis_dw_finish_kernel"],
            "other_kernels_ms": device_ms - copy_ms - sum(ours.values()),
            "top": [{"name": k[:90], "ms": ms, "calls": n}
                    for k, ms, n in rows[:top]]}


def record_train_sites(K, P, fn):
    """The B1 launches (forward and input gradient) and the dw
    contractions of one packed train step `fn()`, in call order, with
    their shapes."""
    import types

    sites = {"forward": [], "dx": [], "dw": []}
    conv, dx, dw = K.conv2_packed, K.conv2_packed_dx, P._dw_packed_qgroup

    def rec_conv(x, wp, bias=None, *, pad=0):
        sites["forward"].append({"x": tuple(x.shape), "wp": tuple(wp.shape),
                                 "pad": pad, "bias": bias is not None})
        return conv(x, wp, bias, pad=pad)

    def rec_dx(g, wp, *, pad):
        sites["dx"].append({"g": tuple(g.shape), "wp": tuple(wp.shape),
                            "pad": pad})
        return dx(g, wp, pad=pad)

    def rec_dw(x_padded, g):
        sites["dw"].append({"x": tuple(x_padded.shape), "g": tuple(g.shape)})
        return dw(x_padded, g)

    # the packed convs reach B1 through their module's `K` and dw through
    # the module-level `_dw_packed_qgroup`
    P.K = types.SimpleNamespace(conv2_packed=rec_conv, conv2_packed_dx=rec_dx,
                                conv2_packed_as_bn_act=K.conv2_packed_as_bn_act,
                                bn_act_zero_pads=K.bn_act_zero_pads)
    P._dw_packed_qgroup = rec_dw
    try:
        fn()
    finally:
        P.K = K
        P._dw_packed_qgroup = dw
    return sites


def _out_cells(site):
    step = 1 if site["pad"] else -1
    return tuple(e + step for e in site["x"][1:4])


def name_train_sites(sites):
    """Names of the recorded dx and dw calls: the forward site (B1_SITES
    order) whose weights, parity and output shape each one matches."""
    fwd = sites["forward"]
    if len(fwd) != len(B1_SITES):
        raise AssertionError(f"{len(fwd)} forward B1 launches per step")

    def find(pred):
        hits = [n for n, s in zip(B1_SITES, fwd) if pred(s)]
        if len(hits) != 1:
            raise AssertionError(f"ambiguous or missing site: {hits}")
        return hits[0]

    dx = [find(lambda s, d=d: s["wp"] == d["wp"] and s["pad"] == d["pad"]
               and _out_cells(s) == d["g"][1:4]) for d in sites["dx"]]
    dw = [find(lambda s, d=d: _out_cells(s) == d["g"][1:4]
               and s["wp"][3] == d["x"][4] and s["wp"][4] == d["g"][4]
               and tuple(e + 2 * s["pad"] for e in s["x"][1:4])
               == d["x"][1:4]) for d in sites["dw"]]
    if sorted(dx) != sorted(DX_SITES) or sorted(dw) != sorted(B1_SITES):
        raise AssertionError(f"dx sites {dx}, dw sites {dw}")
    return dx, dw


def _bound(flops, nbytes, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[peak] * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def backward_site_rows(K, P, sites, gen, label, checks, timed, dw_at=()):
    """The backward of each B1 site of a recorded train-step forward, at
    each (batch, dtype) of `checks` (batch None: the recorded one): the
    input gradient (`conv2_packed_dx`, at DX_SITES) against its plain
    version, and at the pairs of `dw_at` dw against an f32 einsum
    (`dw_check`).  At the pair `timed` both are timed beside cuDNN's
    `convolution_backward` of the same packed k=2 conv as yardstick.
    Returns rows {"dx", "dw"} and errors {"dx": by route and dtype, "dw":
    by dtype}."""
    import torch
    import torch.nn.functional as TF

    rows = {"dx": [], "dw": []}
    # None where no check of that kind and dtype ran
    errs = {"dx": {r: {"f32": None, "bf16": None}
                   for r in ("tc", "cuda_core")},
            "dw": {"f32": None, "bf16": None}}
    for name, site in zip(B1_SITES, sites):
        c8i, c8o, pad = site["x"][4], site["wp"][4], site["pad"]
        for batch, dn in checks:
            dt = torch.float32 if dn == "f32" else torch.bfloat16
            n = batch or site["x"][0]
            x = torch.randn((n, *site["x"][1:]), generator=gen,
                            device="cuda").to(dt)
            wp = (torch.randn(site["wp"], generator=gen, device="cuda")
                  / np.sqrt(8 * c8i)).to(dt)
            g = torch.randn((n, *_out_cells(site), c8o), generator=gen,
                            device="cuda").to(dt)
            dx = None
            if name in DX_SITES:
                route = K._conv2_route(dt, c8o, c8i)
                dx = K.conv2_packed_dx(g, wp, pad=pad)
                torch.cuda.synchronize()
                ref = K.conv2_packed_plain(g, K.flipped_weights(wp),
                                           pad=1 - pad)
                dx_err = check(f"{label} conv2_packed_dx {name} b{n} "
                               f"({route})", dx, ref, dn)
                errs["dx"][route][dn] = max(errs["dx"][route][dn] or 0.0,
                                            dx_err)
                del ref
            if (batch, dn) in dw_at:
                dw_err, dw_row = dw_check(P, TF, name, x, g, pad)
                errs["dw"][dn] = max(errs["dw"][dn] or 0.0, dw_err)
            if (batch, dn) == timed:
                yard = cudnn_backward(x, wp, g, pad)
                if (batch, dn) in dw_at:
                    dw_row["library_ms"] = time_ms(
                        lambda: yard((False, True, False)), 5)
                    rows["dw"].append(dw_row)
                if dx is not None:
                    rows["dx"].append(dx_time_row(K, name, g, wp, pad, dx,
                                                  yard))
                    rows["dx"][-1]["max_abs_err"] = dx_err
            del x, wp, g, dx
            torch.cuda.empty_cache()
    return rows, errs


def cudnn_backward(x, wp, g, pad):
    """Yardstick only: cuDNN's gradients of the packed k=2 conv
    `conv2_packed(x, wp, pad=pad)` (NCDHW views of the channels-last data)
    for an output mask (dx, dw, bias)."""
    import torch

    xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
    wc = wp.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    return lambda mask: torch.ops.aten.convolution_backward(
        gc, xc, wc, None, [1, 1, 1], [pad] * 3, [1, 1, 1], False, [0, 0, 0],
        1, list(mask))


def dx_time_row(K, name, g, wp, pad, dx, yard):
    c8i, c8o = wp.shape[3:]
    m = dx.shape[0] * dx.shape[1] * dx.shape[2] * dx.shape[3]
    flops = 2.0 * m * (8 * c8o) * c8i
    nbytes = (g.numel() + wp.numel() + dx.numel()) * g.element_size()
    bound_ms, bound_by = _bound(flops, nbytes, "bf16")
    ms = time_ms(lambda: K.conv2_packed_dx(g, wp, pad=pad), 10)
    row = {"site": name, "g": list(g.shape), "c8i": c8i, "pad": 1 - pad,
           "route": K._conv2_route(g.dtype, c8o, c8i), "ms": ms,
           "plain_ms": time_ms(lambda: K.conv2_packed_dx_plain(
               g, wp, pad=pad), 1),
           "library_ms": time_ms(lambda: yard((True, False, False)), 10),
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / ms,
           "tflops": flops / ms / 1e9}
    log(f"time conv2_packed_dx {name} b{g.shape[0]} bf16: {json.dumps(row)}")
    return row


def dw_check(P, TF, name, x, g, pad):
    """dw of one site (`_dw_packed_qgroup` over the padded input, as the
    backward runs it) against the f32 einsum of the same operands; its
    time and bound.  Returns (error, row)."""
    import torch

    od, oh, ow = g.shape[1:4]
    dt = "f32" if x.dtype == torch.float32 else "bf16"

    def dw():
        xpad = TF.pad(x, (0, 0) + (1, 1) * 3) if pad else x
        return P._dw_packed_qgroup(xpad, g)

    got = dw()
    torch.cuda.synchronize()
    xpad = TF.pad(x, (0, 0) + (1, 1) * 3) if pad else x

    def einsum_f32():
        return torch.stack([torch.einsum(
            "ndhwi,ndhwo->io",
            xpad[:, qd:qd + od, qh:qh + oh, qw:qw + ow].float(), g.float())
            for qd in range(2) for qh in range(2) for qw in range(2)]
        ).reshape(got.shape)

    ref = einsum_f32()
    route = P.dw_gemm_route(x.dtype, x.device)
    err = check(f"dw_packed_qgroup {name} b{x.shape[0]} ({route})", got,
                ref, dt, {dt: DW_TOL})
    c8i, c8o = x.shape[4], g.shape[4]
    m = g.shape[0] * od * oh * ow
    flops = 2.0 * 8 * m * c8i * c8o
    nbytes = (x.numel() + g.numel()) * x.element_size() + 4 * 8 * c8i * c8o
    bound_ms, bound_by = _bound(flops, nbytes, "bf16" if route
                                == "bf16_out_f32" else "f32")
    ms = time_ms(dw, 5)
    row = {"site": name, "x": list(x.shape), "g": list(g.shape),
           "route": route, "ms": ms, "einsum_f32_ms": time_ms(einsum_f32, 1),
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / ms,
           "tflops": flops / ms / 1e9}
    log(f"time dw_packed_qgroup {name} b{x.shape[0]} {dt}: "
        f"{json.dumps(row)}")
    del ref, got
    return err, row


def seg_batches(gen, n_batches, batch, size):
    """(inputs, labels) numpy batches: T1w-like volumes (`t1_like_volumes`
    at `size`^3, z-normalized float32, (batch, S, S, S, 1)) and int16
    FreeSurfer-style labels: background ids outside LIST_FCD (2 and 41 by
    hemisphere), cortical ids 1000-1034 in a sphere of radius
    LABEL_RADII[0] that is also 300 brighter in the image, and the
    subcortical LIST_FCD id 17 in a smaller one."""
    import torch

    from mri_epilepsy_diagnosis_torch.transforms import znormalization

    vols = t1_like_volumes(gen, n_batches * batch, size)
    out = []
    for b in range(n_batches):
        xs, ls = [], []
        for v in vols[b * batch:(b + 1) * batch]:
            v, lab = freesurfer_labels(gen, torch.from_numpy(v).cuda().float())
            xs.append(znormalization(v))
            ls.append(lab)
        out.append((torch.stack(xs)[..., None].cpu().numpy(),
                    torch.stack(ls)[..., None].cpu().numpy()))
    return out


def freesurfer_labels(gen, v):
    """FreeSurfer-style int16 labels for the float T1w-like cube `v` on the
    card (see `seg_batches`), and `v` with the cortical sphere 300
    brighter."""
    import torch

    size = v.shape[0]
    ax = torch.arange(size, device="cuda", dtype=torch.float32)
    lab = torch.full(v.shape, 2, dtype=torch.int16, device="cuda")
    lab[:, :, size // 2:] = 41
    for radius, kind in zip(LABEL_RADII, ("cortex", "fcd")):
        c = size / 4 + torch.rand(3, generator=gen, device="cuda") * (size / 2)
        r2 = ((ax - c[0])[:, None, None] ** 2
              + (ax - c[1])[None, :, None] ** 2
              + (ax - c[2])[None, None, :] ** 2)
        inside = r2 <= (radius * size / SIZE) ** 2
        ids = (1000 + r2.long() % 35 if kind == "cortex"
               else torch.full_like(lab, 17))
        lab = torch.where(inside, ids.to(torch.int16), lab)
        if kind == "cortex":
            v = v + 300 * inside
    return v, lab


def parity_phase(TS, UNet3D, gen):
    """Phase 6b: one f32 step at PARITY_SIZE^3, batch 1: the packed loss,
    gradients and running statistics (B1 forward and dx, f32 dw) against
    the fine UNet3D train step (cuDNN convolutions, TF32 off).  Random
    normal inputs leave the max pools without ties."""
    import copy

    import torch

    from mri_epilepsy_diagnosis_torch.transforms import binarize_segmentation

    model = UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
                   out_channels_first_layer=OCFL, device="cuda")
    random_state_dict(model, gen)
    x = torch.randn((1, PARITY_SIZE, PARITY_SIZE, PARITY_SIZE, 1),
                    generator=gen, device="cuda")
    _, labels = seg_batches(gen, 1, 1, PARITY_SIZE)[0]
    t = binarize_segmentation(torch.from_numpy(labels).cuda())
    packed, fine = copy.deepcopy(model), copy.deepcopy(model)
    fine64 = copy.deepcopy(model).double()
    loss_p, stats = TS.packed_seg_loss(packed, x, t)
    loss_p.backward()
    loss_f = TS.seg_loss(fine, x, t)
    loss_f.backward()
    TS.seg_loss(fine64, x.double(), t.double()).backward()
    lp, lf = loss_p.item(), loss_f.item()
    gp = dict(packed.named_parameters())
    gf = dict(fine.named_parameters())
    g64 = dict(fine64.named_parameters())
    floor = PARITY_GRAD_FLOOR * max(p.grad.abs().max().item()
                                    for p in gf.values())
    leaves = {}
    for k, p in gf.items():
        scale = p.grad.abs().max().item()
        leaves[k] = {
            "max_grad": scale,
            "err": (gp[k].grad - p.grad).abs().max().item(),
            "tol": PARITY_GRAD_RTOL * scale + floor,
            "packed_vs_f64": (gp[k].grad.double() - g64[k].grad).abs()
            .max().item(),
            "fine_vs_f64": (p.grad.double() - g64[k].grad).abs().max()
            .item()}
    buffers = dict(fine.named_buffers())
    stats_err = max((v - buffers[k]).abs().max().item()
                    / max(1.0, buffers[k].abs().max().item())
                    for k, v in stats.items())
    # leaves with a true gradient of 0 (pre-BN biases) left out of the
    # relative errors
    real = [k for k, v in leaves.items() if v["max_grad"] > 1e3 * floor]

    def worst(key):
        return max(leaves[k][key] / leaves[k]["max_grad"] for k in real)

    out = {"size": PARITY_SIZE, "batch": 1, "loss_packed": lp,
           "loss_fine": lf, "loss_rel_err": abs(lp - lf) / abs(lf),
           "foreground_share": t.mean().item(),
           "grad_worst_err_over_tol": max(v["err"] / v["tol"]
                                          for v in leaves.values()),
           "grad_max_rel_err": worst("err"),
           "grad_max_rel_err_packed_vs_f64": worst("packed_vs_f64"),
           "grad_max_rel_err_fine_vs_f64": worst("fine_vs_f64"),
           "running_stats_err": stats_err, "leaves": leaves}
    log(f"f32 parity (packed kernels vs fine cuDNN, {PARITY_SIZE}^3 b1): "
        f"{json.dumps({k: v for k, v in out.items() if k != 'leaves'})}")
    bad = [k for k, v in leaves.items() if v["err"] > v["tol"]]
    if bad:
        raise AssertionError(f"f32 parity: gradients differ: "
                             f"{[(k, leaves[k]) for k in bad]}")
    if out["loss_rel_err"] > PARITY_LOSS_RTOL:
        raise AssertionError(f"f32 parity: loss {lp} vs {lf}")
    if stats_err > PARITY_STATS_TOL:
        raise AssertionError(f"f32 parity: running stats differ by "
                             f"{stats_err}")
    return out


def step_split(K, P, fn):
    """Device time of the B1 forward launches, the B1 input-gradient
    launches and the dw contractions of one call of fn, from CUDA events
    recorded around each call on the stream (the wrappers' own weight
    re-layouts included).  Returns fn's result and a function that reads
    the sums (after a synchronize)."""
    import types

    import torch

    pairs = {"b1_forward": [], "b1_dx": [], "dw": []}

    def bracket(key, f):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = f(*args, **kw)
            end.record()
            pairs[key].append((start, end))
            return out
        return run

    dw = P._dw_packed_qgroup
    P.K = types.SimpleNamespace(
        conv2_packed=bracket("b1_forward", K.conv2_packed),
        conv2_packed_dx=bracket("b1_dx", K.conv2_packed_dx),
        conv2_packed_as_bn_act=K.conv2_packed_as_bn_act,
        bn_act_zero_pads=K.bn_act_zero_pads)
    P._dw_packed_qgroup = bracket("dw", dw)
    try:
        out = fn()
    finally:
        P.K = K
        P._dw_packed_qgroup = dw
    return out, lambda: {f"{k}_ms": sum(s.elapsed_time(e) for s, e in v)
                         for k, v in pairs.items()} | {
        f"{k}_calls": len(v) for k, v in pairs.items()}


def training_phase(K, P, UNet3D, gen, launch_counts):
    """Phase 6c: `train_segmentation` (packed, bf16, 1 epoch) over
    TRAIN_BATCHES batches of TRAIN_BATCH T1w-like volumes with a
    validation batch, its checkpoint reloaded; then 1 warm-up and
    TIMED_STEPS timed `packed_seg_train_step`s on one batch, and one more
    under the profiler with the B1-forward / B1-dx / dw split."""
    import torch

    from mri_epilepsy_diagnosis_torch import train as Tr
    from mri_epilepsy_diagnosis_torch.transforms import binarize_segmentation

    def new_state():
        return Tr.create_train_state(
            UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
                   out_channels_first_layer=OCFL, device="cuda"),
            Tr.torch_adamw())

    state = new_state()
    random_state_dict(state.model, gen)
    sched = Tr.ReduceLROnPlateau(state.optimizer, mode="min", factor=0.1,
                                 patience=3, threshold=0.01)
    batches = seg_batches(gen, TRAIN_BATCHES + 1, TRAIN_BATCH, SIZE)
    train, val = batches[:TRAIN_BATCHES], batches[TRAIN_BATCHES:]
    fg = float(np.mean([binarize_segmentation(torch.from_numpy(lab)).mean()
                        for _, lab in batches]))

    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, tr, va = Tr.train_segmentation(
        1, train, val, state, sched, "chip_smoke_seg",
        weights_dir="chiprun_out", verbose=False, packed=True,
        input_dtype=torch.bfloat16)
    epoch_s = time.perf_counter() - t0
    counts_epoch = launch_counts()
    want = {k: TRAIN_BATCHES * v + 2 * UNET_PER_BATCH[k]
            for k, v in TRAIN_PER_STEP.items()}
    log("launches (train_segmentation, 3 train steps + 2 validation "
        "batches): " + ", ".join(f"{k} {counts_epoch[k]} (expected {w})"
                                 for k, w in want.items()))
    if counts_epoch != want:
        raise AssertionError(f"launch counts {counts_epoch} != {want}")
    ckpt = os.path.join("chiprun_out", "chip_smoke_seg_epoch_1.ckpt")
    restored = Tr.load_checkpoint(ckpt, new_state())
    sd, rd = state.model.state_dict(), restored.model.state_dict()
    if restored.step != state.step or any(not torch.equal(sd[k], rd[k])
                                          for k in sd):
        raise AssertionError("the checkpoint does not restore the state")

    xb = torch.from_numpy(train[0][0]).cuda().to(torch.bfloat16)
    lb = torch.from_numpy(train[0][1]).cuda()
    state, loss = Tr.packed_seg_train_step(state, xb, lb)     # warm-up
    warm_loss = float(loss)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, loss = Tr.packed_seg_train_step(state, xb, lb)
        losses.append(float(loss))
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = launch_counts()
    want = {k: TIMED_STEPS * v for k, v in TRAIN_PER_STEP.items()}
    log(f"launches ({TIMED_STEPS} train steps): " + ", ".join(
        f"{k} {counts[k]} (expected {w})" for k, w in want.items()))
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    master_f32 = (all(p.dtype == torch.float32
                      for p in state.model.parameters())
                  and all(st[k].dtype == torch.float32
                          for st in state.optimizer.state.values()
                          for k in ("exp_avg", "exp_avg_sq"))
                  and all(b.dtype == torch.float32 for n, b in
                          state.model.named_buffers() if "running" in n))

    box = {}

    def profiled_step():
        _, box["read"] = step_split(K, P, lambda: Tr.packed_seg_train_step(
            state, xb, lb))

    prof = profile_batch(profiled_step)
    split = box["read"]()
    split["other_kernels_ms"] = (prof["kernel_ms"] - split["b1_forward_ms"]
                                 - split["b1_dx_ms"] - split["dw_ms"])
    out = {"size": SIZE, "batch": TRAIN_BATCH, "dtype": "bf16",
           "ocfl": OCFL, "dec_up": "explicit", "remat": False,
           "foreground_share": fg,
           "epoch_train_losses": [float(v) for v in tr],
           "epoch_val_losses": [float(v) for v in va],
           "epoch_s": epoch_s, "warmup_loss": warm_loss,
           "timed_losses": losses, "ms_per_step": step_s * 1e3,
           "vol_per_s": TRAIN_BATCH / step_s, "peak_memory_gb": peak_gb,
           "master_weights_f32": master_f32,
           "dw_route": P.dw_gemm_route(torch.bfloat16, xb.device),
           "launches_epoch": counts_epoch, "launches_timed_steps": counts,
           "step_split": split, "profile": prof, "checkpoint": ckpt}
    log(f"training: {json.dumps(out)}")
    if not (np.isfinite(losses + [warm_loss]).all()
            and np.isfinite(out["epoch_train_losses"]
                            + out["epoch_val_losses"]).all()):
        raise AssertionError(f"non-finite training losses: {out}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    if not master_f32:
        raise AssertionError("master weights or AdamW state left float32")
    return out


def _counted_b1(c):
    """B1 launches of a counts dict per kernel instantiation (the entries
    of the kernels line): tensor-core plain store (forward, no dx),
    tensor-core with B2 fused, CUDA-core plain store (the stem and all of
    f32), CUDA-core with B2 fused, tensor-core input gradients."""
    return {"conv2_packed_tc": c["conv2_packed_tc"]
            - c["conv2_packed_as_bn_act_tc"] - c["conv2_packed_dx_tc"],
            "conv2_packed_tc_bn_act": c["conv2_packed_as_bn_act_tc"],
            "conv2_packed": (c["conv2_packed"] - c["conv2_packed_tc"])
            - (c["conv2_packed_as_bn_act"] - c["conv2_packed_as_bn_act_tc"])
            - (c["conv2_packed_dx"] - c["conv2_packed_dx_tc"]),
            "conv2_packed_bn_act": c["conv2_packed_as_bn_act"]
            - c["conv2_packed_as_bn_act_tc"],
            "conv2_packed_tc.dx": c["conv2_packed_dx_tc"],
            "separable_conv3d": c["separable_conv3d"],
            "conv_axis": c["conv_axis"], "conv_axis_dx": c["conv_axis_dx"],
            "conv_axis_dw": c["conv_axis_dw"]}


def _expect_counts(label, counts, want):
    log(f"launches ({label}): " + ", ".join(
        f"{k} {counts[k]} (expected {w})" for k, w in want.items()))
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")


def _grads_and_stats_agree(label, model, ref, loss, ref_loss):
    """The packed model's gradients, running statistics and loss against
    the reference model's, at the tolerances of phase 6b."""
    gp = dict(model.named_parameters())
    gr = dict(ref.named_parameters())
    floor = PARITY_GRAD_FLOOR * max(p.grad.abs().max().item()
                                    for p in gr.values())
    worst = max(((gp[k].grad - p.grad).abs().max().item()
                 / (PARITY_GRAD_RTOL * p.grad.abs().max().item() + floor))
                for k, p in gr.items())
    rb = dict(ref.named_buffers())
    stats_err = max((b - rb[k]).abs().max().item()
                    / max(1.0, rb[k].abs().max().item())
                    for k, b in model.named_buffers() if "running" in k)
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    out = {"loss": loss, "ref_loss": ref_loss, "loss_rel_err": loss_err,
           "grad_worst_err_over_tol": worst, "running_stats_err": stats_err}
    log(f"{label}: {json.dumps(out)}")
    if worst > 1 or loss_err > PARITY_LOSS_RTOL or stats_err > PARITY_STATS_TOL:
        raise AssertionError(f"{label} disagrees: {out}")
    return out


def accumulation_phase(K, UNet3D, gen, launch_counts):
    """Phase 7a: `packed_seg_train_step_accum`.  Gates in f32 at
    PARITY_SIZE^3, batch 2, TF32 off: micro = 2 against the flat
    `packed_seg_train_step` and against the fine UNet3D (cuDNN), micro = 1
    against the fine UNet3D's per-volume gradients at the same parameters
    with its running statistics threaded volume to volume.  Then an
    effective batch of ACCUM_BATCH whole 192^3 volumes in micro-batches of
    ACCUM_MICRO, bf16: 1 warm-up and ACCUM_STEPS timed steps with exact
    launch counts."""
    import copy

    import torch

    from mri_epilepsy_diagnosis_torch import train as Tr
    from mri_epilepsy_diagnosis_torch.train import seg as TS
    from mri_epilepsy_diagnosis_torch.transforms import binarize_segmentation

    model = UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
                   out_channels_first_layer=OCFL, device="cuda")
    random_state_dict(model, gen)
    x = torch.randn((2, PARITY_SIZE, PARITY_SIZE, PARITY_SIZE, 1),
                    generator=gen, device="cuda")
    lab = torch.from_numpy(seg_batches(gen, 1, 2, PARITY_SIZE)[0][1]).cuda()
    t = binarize_segmentation(lab)
    gates = {}
    for micro in (2, 1):
        acc = Tr.create_train_state(copy.deepcopy(model), Tr.torch_adamw())
        acc, loss = Tr.packed_seg_train_step_accum(acc, x, lab, micro=micro)
        fine = copy.deepcopy(model)
        n = 2 // micro
        ref_loss = 0.0
        for i in range(n):
            li = TS.seg_loss(fine, x[i * micro:(i + 1) * micro],
                             t[i * micro:(i + 1) * micro])
            (li / n).backward()
            ref_loss += li.item() / n
        gates[f"micro{micro}_vs_fine_cudnn"] = _grads_and_stats_agree(
            f"accumulation micro={micro} vs fine cuDNN (f32 "
            f"{PARITY_SIZE}^3 b2)", acc.model, fine, loss.item(), ref_loss)
        if micro == 2:
            flat = Tr.create_train_state(copy.deepcopy(model),
                                         Tr.torch_adamw())
            flat, flat_loss = Tr.packed_seg_train_step(flat, x, lab)
            gates["micro2_vs_flat_packed"] = _grads_and_stats_agree(
                f"accumulation micro=2 vs flat packed step (f32 "
                f"{PARITY_SIZE}^3 b2)", acc.model, flat.model, loss.item(),
                flat_loss.item())
    del model, acc, fine, flat, x
    torch.cuda.empty_cache()

    state = Tr.create_train_state(
        UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
               out_channels_first_layer=OCFL, device="cuda"),
        Tr.torch_adamw())
    random_state_dict(state.model, gen)
    xs, ls = seg_batches(gen, 1, ACCUM_BATCH, SIZE)[0]
    xb = torch.from_numpy(xs).cuda().to(torch.bfloat16)
    lb = torch.from_numpy(ls).cuda()
    del xs, ls
    state, loss = Tr.packed_seg_train_step_accum(state, xb, lb,
                                                 micro=ACCUM_MICRO)
    warm_loss = float(loss)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(ACCUM_STEPS):
        state, loss = Tr.packed_seg_train_step_accum(state, xb, lb,
                                                     micro=ACCUM_MICRO)
        losses.append(float(loss))
    step_s = (time.perf_counter() - t0) / ACCUM_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = launch_counts()
    _expect_counts(f"{ACCUM_STEPS} accumulated steps, batch {ACCUM_BATCH} "
                   f"in micro-batches of {ACCUM_MICRO}", counts,
                   {k: ACCUM_STEPS * v for k, v in ACCUM_PER_STEP.items()})
    out = {"size": SIZE, "batch": ACCUM_BATCH, "micro": ACCUM_MICRO,
           "dtype": "bf16", "warmup_loss": warm_loss, "timed_losses": losses,
           "ms_per_step": step_s * 1e3, "vol_per_s": ACCUM_BATCH / step_s,
           "peak_memory_gb": peak_gb,
           "b1_launches_per_step": counts["conv2_packed"] // ACCUM_STEPS,
           "launches": counts, "gates_f32": gates}
    log(f"accumulation: {json.dumps(out)}")
    if not np.isfinite(losses + [warm_loss]).all():
        raise AssertionError(f"non-finite accumulated losses: {losses}")
    return out


def _state_snapshot(state):
    """Every parameter, buffer and optimizer-state tensor of a train state,
    cloned, and its step."""
    return ({k: v.detach().clone() for k, v in
             state.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()} for i, s in
             state.optimizer.state_dict()["state"].items()}, state.step)


def _snapshots_equal(a, b):
    """Bit for bit: every tensor of two `_state_snapshot`s, and the step."""
    import torch

    (ma, oa, sa), (mb, ob, sb) = a, b
    return (sa == sb and ma.keys() == mb.keys() and oa.keys() == ob.keys()
            and all(torch.equal(ma[k], mb[k]) for k in ma)
            and all(oa[i].keys() == ob[i].keys()
                    and all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i])
                    for i in oa))


class _EpochLoader:
    """The batches of a training loader; `poison` serves the first volume
    of the first batch as NaN on every pass, `on_pass` runs at the start
    of every pass."""

    def __init__(self, batches, poison=False, on_pass=None):
        self.batches, self.poison, self.on_pass = batches, poison, on_pass

    def __iter__(self):
        if self.on_pass is not None:
            self.on_pass()
        for i, (x, y) in enumerate(self.batches):
            if self.poison and i == 0:
                x = x.copy()
                x[0] = np.nan
            yield x, y


def resilient_phase(K, UNet3D, gen, launch_counts, ckpt_dir):
    """Phase 7b: `train_segmentation` with a `CheckpointManager`
    (max_failures 1, packed, bf16) at 192^3, batch TRAIN_BATCH, epochs of
    RESILIENT_BATCHES batches: two clean epochs with exact launch counts;
    a poisoned epoch that rolls back to the checkpoint bit for bit and,
    poisoned again, raises; a fresh state that resumes with the
    scheduler's state; SIGTERM from inside the loader, which stops the
    loop at the epoch boundary after a checkpoint."""
    import signal

    import torch

    from mri_epilepsy_diagnosis_torch import train as Tr

    def new_state():
        st = Tr.create_train_state(
            UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
                   out_channels_first_layer=OCFL, device="cuda"),
            Tr.torch_adamw())
        random_state_dict(st.model, gen)
        sched = Tr.ReduceLROnPlateau(st.optimizer, mode="min", factor=0.1,
                                     patience=3, threshold=0.01)
        return st, sched

    batches = seg_batches(gen, RESILIENT_BATCHES + 1, TRAIN_BATCH, SIZE)
    train, val = batches[:RESILIENT_BATCHES], batches[RESILIENT_BATCHES:]
    mgr = Tr.CheckpointManager(ckpt_dir, stem="smoke")
    kw = dict(manager=mgr, max_failures=1, packed=True,
              input_dtype=torch.bfloat16, verbose=False)
    out = {"size": SIZE, "batch": TRAIN_BATCH, "dtype": "bf16",
           "batches_per_epoch": RESILIENT_BATCHES}

    state, sched = new_state()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, tr, va = Tr.train_segmentation(2, train, val, state, sched,
                                          "smoke", **kw)
    out["two_epochs_s"] = time.perf_counter() - t0
    counts = launch_counts()
    steps, val_batches = 2 * RESILIENT_BATCHES, 3 * len(val)
    _expect_counts("resilient train_segmentation, 2 epochs", counts,
                   {k: steps * v + val_batches * UNET_PER_BATCH[k]
                    for k, v in TRAIN_PER_STEP.items()})
    out["launches"] = counts
    if mgr.latest_epoch() != 2 or len(tr) != 2 or not np.isfinite(
            tr + va).all():
        raise AssertionError(f"resilient run: epoch {mgr.latest_epoch()}, "
                             f"losses {tr} {va}")
    out["epoch_train_losses"], out["epoch_val_losses"] = tr, va
    saved, saved_sched = _state_snapshot(state), sched.state_dict()

    passes = []
    poisoned = _EpochLoader(train, poison=True, on_pass=lambda: passes.append(
        _state_snapshot(state)))
    t0 = time.perf_counter()
    try:
        Tr.train_segmentation(3, poisoned, val, state, sched, "smoke", **kw)
        raise AssertionError("two poisoned epochs past max_failures=1 did "
                             "not raise")
    except RuntimeError as e:
        if "non-finite epochs" not in str(e):
            raise
        out["past_max_failures"] = str(e)
    out["poisoned_s"] = time.perf_counter() - t0
    out["rollback_bit_exact"] = (len(passes) == 2
                                 and _snapshots_equal(passes[1], saved))
    log(f"rollback: {len(passes)} passes of the poisoned epoch; the retry "
        f"started from the epoch-2 checkpoint bit for bit: "
        f"{out['rollback_bit_exact']}; then: {out['past_max_failures']}")
    if not out["rollback_bit_exact"]:
        raise AssertionError("the rollback did not restore the checkpoint")

    fresh, fresh_sched = new_state()
    _, tr0, _ = Tr.train_segmentation(2, train, val, fresh, fresh_sched,
                                      "smoke", **kw)
    out["resume_exact"] = (tr0 == [] and _snapshots_equal(
        _state_snapshot(fresh), saved)
        and fresh_sched.state_dict() == saved_sched)
    t0 = time.perf_counter()
    fresh, tr3, _ = Tr.train_segmentation(3, train, val, fresh, fresh_sched,
                                          "smoke", **kw)
    out["resumed_epoch_s"] = time.perf_counter() - t0
    log(f"resume: a fresh state restored epoch 2 exactly (model, AdamW, "
        f"scheduler): {out['resume_exact']}; trained epoch 3: {tr3}")
    if not out["resume_exact"] or len(tr3) != 1 or mgr.latest_epoch() != 3:
        raise AssertionError(f"resume failed: {out}, {tr3}")

    handler = signal.getsignal(signal.SIGTERM)

    def preempt():
        if signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, handler):
            raise AssertionError("no preemption guard is installed")
        os.kill(os.getpid(), signal.SIGTERM)

    fresh, tr4, _ = Tr.train_segmentation(
        5, _EpochLoader(train, on_pass=preempt), val, fresh, fresh_sched,
        "smoke", **kw)
    out["sigterm_stopped_at"] = mgr.latest_epoch()
    log(f"SIGTERM inside the loader of epoch 4: {len(tr4)} epoch trained, "
        f"newest checkpoint epoch {mgr.latest_epoch()}")
    if (len(tr4) != 1 or mgr.latest_epoch() != 4
            or signal.getsignal(signal.SIGTERM) != handler):
        raise AssertionError("SIGTERM did not stop the loop at the epoch "
                             "boundary")
    out["checkpoints"] = sorted(os.listdir(ckpt_dir))
    log(f"resilient training: {json.dumps(out)}")
    return fresh, out


def _scipy_edt(mask, spacing=(1.0, 1.0, 1.0)):
    """`native.edt3d` through scipy's exact EDT."""
    from scipy import ndimage

    mask = np.asarray(mask, bool)
    if not mask.any():
        return np.full(mask.shape, np.inf)
    return ndimage.distance_transform_edt(~mask, sampling=spacing)


def validation_phase(K, P, gen, launch_counts, state, ckpt_dir):
    """Phase 7c: `validate_dsc_asd(packed=True)` on VAL_SUBJECTS 192^3
    subjects in f32 (7b's trained model, its classifier bias set for a
    FG_SHARE foreground as in phase 4) with exact launch counts and the
    native EDT built and used; the packed masks (kernels) against the fine
    UNet3D's (cuDNN, TF32 off); DSC, ASD and IoU against the same metrics
    over scipy's EDT; the device time of the forward and the host time of
    the metrics per subject; then `sweep_checkpoints` over 7b's directory
    on the first batch."""
    import copy

    import torch

    from mri_epilepsy_diagnosis_torch import metrics as M
    from mri_epilepsy_diagnosis_torch import native
    from mri_epilepsy_diagnosis_torch.metrics import surface as MS
    from mri_epilepsy_diagnosis_torch.train import seg as TS
    from mri_epilepsy_diagnosis_torch.transforms import binarize_segmentation

    vstate = copy.deepcopy(state)
    subjects = seg_batches(gen, VAL_SUBJECTS // VAL_BATCH, VAL_BATCH, SIZE)
    with torch.no_grad():
        vstate.model.eval()
        logits = vstate.model(torch.from_numpy(subjects[0][0][:1]).cuda())
        margin = (logits[..., 1] - logits[..., 0]).flatten()[::101]
        vstate.model.classifier.conv_layer.bias[1] -= torch.quantile(
            margin.float(), 1 - FG_SHARE)
        del logits, margin
    x0 = torch.from_numpy(subjects[0][0]).cuda()
    sites = record_sites(K, P, lambda: TS.mask_forward(vstate, True)(x0))
    if (len(sites["conv2_packed"]) != len(B1_SITES)
            or sites["bn_act_zero_pads"]):
        raise AssertionError(f"unexpected validation sites {sites}")
    rows, errs = forward_site_rows(K, sites["conv2_packed"], gen,
                                   "validation", [(None, "f32")],
                                   (None, "f32"))
    del x0

    if not native.native_available():
        raise AssertionError("the native EDT library did not build")
    calls = native.edt3d.native_calls
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dsc, asd_gt, asd_pred, iou = TS.validate_dsc_asd(vstate, subjects,
                                                     packed=True)
    validate_s = time.perf_counter() - t0
    counts = launch_counts()
    _expect_counts(f"validate_dsc_asd, {VAL_SUBJECTS} subjects f32", counts,
                   {k: len(subjects) * v for k, v in VAL_PER_BATCH.items()})
    native_calls = native.edt3d.native_calls - calls
    if native_calls != 2 * VAL_SUBJECTS:
        raise AssertionError(f"native EDT calls {native_calls} != "
                             f"{2 * VAL_SUBJECTS}")

    fwd_packed = TS.mask_forward(vstate, packed=True)
    fwd_fine = TS.mask_forward(vstate, packed=False)
    agree, fg, fwd_ms, host_ms, metric_err, own_err = [], [], [], [], 0.0, 0.0
    j = 0
    for x, labels in subjects:
        xd = torch.from_numpy(x).cuda()
        fwd_packed(xd)                                  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mp = fwd_packed(xd)
        end.record()
        torch.cuda.synchronize()
        fwd_ms.append(start.elapsed_time(end) / len(x))
        mf = fwd_fine(xd)
        agree.append((mp == mf).float().mean().item())
        fg.append(mp.float().mean().item())
        gts = binarize_segmentation(torch.from_numpy(labels).cuda())[
            ..., 0].to(torch.uint8).cpu().numpy()
        preds = mp.cpu().numpy()
        for gt, pred in zip(gts, preds):
            t0 = time.perf_counter()
            sd = M.compute_surface_distances(gt, pred, (1, 1, 1))
            got = (M.compute_dice_coefficient(gt, pred),
                   *M.compute_average_surface_distance(sd),
                   M.get_iou_score(pred, gt))
            host_ms.append((time.perf_counter() - t0) * 1e3)
            own_err = max(own_err, float(np.max(np.abs(np.subtract(
                got, (dsc[j], asd_gt[j], asd_pred[j], iou[j]))))))
            MS.edt3d = _scipy_edt
            try:
                sd = M.compute_surface_distances(gt, pred, (1, 1, 1))
                ref = (M.compute_dice_coefficient(gt, pred),
                       *M.compute_average_surface_distance(sd),
                       M.get_iou_score(pred, gt))
            finally:
                MS.edt3d = native.edt3d
            metric_err = max(metric_err, float(np.max(np.abs(np.subtract(
                got, ref)))))
            j += 1
        del xd, mp, mf
    t0 = time.perf_counter()
    sweep = TS.sweep_checkpoints(ckpt_dir, vstate, subjects[:1])
    sweep_s = time.perf_counter() - t0
    out = {"subjects": VAL_SUBJECTS, "batch": VAL_BATCH, "size": SIZE,
           "dtype": "f32", "dsc": dsc, "asd_gt_to_pred": asd_gt,
           "asd_pred_to_gt": asd_pred, "iou": iou,
           "validate_s": validate_s, "launches": counts,
           "native_edt_calls": native_calls,
           "mask_agreement_packed_vs_fine": min(agree),
           "foreground_share": fg,
           "device_forward_ms_per_subject": float(np.mean(fwd_ms)),
           "host_metrics_ms_per_subject": float(np.mean(host_ms)),
           "host_metrics_ms": host_ms,
           "metrics_native_vs_scipy_max_abs_err": metric_err,
           "validate_vs_recomputed_max_abs_err": own_err,
           "kernel_max_abs_err_f32": max(e["f32"] for e in errs.values()
                                         if e["f32"] is not None),
           "kernel_max_abs_err": errs,
           "sweep": {os.path.basename(k): v for k, v in sweep.items()},
           "sweep_s": sweep_s}
    log(f"validation: {json.dumps(out)}")
    if min(agree) < VAL_MASK_AGREEMENT:
        raise AssertionError(f"packed vs fine masks agree at {agree}")
    if not all(FG_GATE[0] <= f <= FG_GATE[1] for f in fg):
        raise AssertionError(f"degenerate validation masks: {fg}")
    if metric_err > METRIC_TOL:
        raise AssertionError(f"metrics over the native EDT differ from "
                             f"those over scipy's by {metric_err}")
    if not np.isfinite(dsc + asd_gt + asd_pred + iou).all():
        raise AssertionError("non-finite validation metrics")
    if len(sweep) != 3 or not np.isfinite(list(sweep.values())).all():
        raise AssertionError(f"sweep over {os.listdir(ckpt_dir)}: {sweep}")
    return out, rows


def cohort_phase(gen, root):
    """Phase 8a: COHORT_SUBJECTS FreeSurfer-style subjects written as NIfTI
    files into `root` (a COHORT_SIZE^3 int16 `*_norm` T1w-like volume and
    an int32 `*_aparc+aseg` label volume each; the last subject gzipped,
    the rest plain `.nii`) with a targets CSV; `MriSegmentation` must
    return exactly the crops that were written.  Returns the dataset, the
    loaded items, the written T1w volumes and the numbers."""
    import csv

    import torch

    from mri_epilepsy_diagnosis_torch.utils import MriSegmentation, save_nifti

    os.makedirs(root, exist_ok=True)
    volumes, labels, write_ms, rows = [], [], [], []
    for i, v in enumerate(t1_like_volumes(gen, COHORT_SUBJECTS,
                                          COHORT_SIZE)):
        v, lab = freesurfer_labels(gen, torch.from_numpy(v).cuda().float())
        img = v.to(torch.int16).cpu().numpy()
        lab = lab.to(torch.int32).cpu().numpy()
        ext = ".nii.gz" if i == COHORT_SUBJECTS - 1 else ".nii"
        patient = f"sub{i:02d}"
        t0 = time.perf_counter()
        save_nifti(os.path.join(root, f"{patient}_norm{ext}"), img)
        save_nifti(os.path.join(root, f"{patient}_aparc+aseg{ext}"), lab)
        write_ms.append((time.perf_counter() - t0) * 1e3)
        volumes.append(img)
        labels.append(lab)
        rows.append(["hcp", patient, i % 2, ("siemens", "ge")[i % 2], 1, ""])
    targets = os.path.join(root, "targets.csv")
    with open(targets, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["sample", "patient", "fcd", "scan", "detection",
                    "comments"])
        w.writerows(rows)
    ds = MriSegmentation("all", image_path=root, targets_path=targets,
                         coord_min=COHORT_CROP, img_shape=(SIZE,) * 3)
    if len(ds) != COHORT_SUBJECTS:
        raise AssertionError(f"{len(ds)} subjects found of {COHORT_SUBJECTS}")
    crop = tuple(slice(c, c + SIZE) for c in COHORT_CROP)
    items, load_ms = [], []
    for i in range(len(ds)):
        t0 = time.perf_counter()
        img, seg = ds[i]
        load_ms.append((time.perf_counter() - t0) * 1e3)
        want = (volumes[i][crop][None].astype(np.float32),
                MriSegmentation.binarize_cortex(
                    labels[i][crop][None].astype(np.float32)))
        if not (np.array_equal(img, want[0]) and np.array_equal(seg, want[1])):
            raise AssertionError(f"subject {i}: the loaded crop differs from "
                                 "the one written")
        items.append((img, seg))
    out = {"subjects": COHORT_SUBJECTS, "size": COHORT_SIZE,
           "crop": [list(COHORT_CROP), SIZE],
           "files": sorted(os.listdir(root)),
           "bytes_on_disk": sum(os.path.getsize(os.path.join(root, f))
                                for f in os.listdir(root)),
           "write_ms_per_subject": write_ms,
           "load_ms_per_subject": load_ms,
           "load_ms_nii": float(np.mean(load_ms[:-1])),
           "load_ms_nii_gz": load_ms[-1],
           # binarize_cortex leaves the id 1000 as it is: count non-zeros
           "foreground_share": float(np.mean([(s > 0).mean()
                                              for _, s in items]))}
    log(f"cohort: {json.dumps(out)}")
    return ds, items, volumes, out


def preprocessing_phase(items, volumes):
    """Phase 8b: Nyul landmarks trained over the subjects' crops (host
    numpy), then `preprocess_volume(landmarks, (SIZE,)*3)` of each written
    COHORT_SIZE^3 volume on the card against the same function on the
    CPU, and `histogram_standardization` of one QUANTILE_LIMIT_SHAPE
    volume (above `torch.quantile`'s 2^24 elements) likewise.  Returns
    the landmarks, the preprocessed volumes on the card and the numbers."""
    import torch

    from mri_epilepsy_diagnosis_torch.transforms import (
        crop_or_pad, histogram_standardization, preprocess_volume,
        train_histogram_landmarks)

    t0 = time.perf_counter()
    landmarks = train_histogram_landmarks([img[0] for img, _ in items])
    landmarks_ms = (time.perf_counter() - t0) * 1e3
    out_vols, card_ms, errs = [], [], []
    for raw in volumes:
        xd = torch.from_numpy(raw).cuda()
        card_ms.append(time_ms(lambda: preprocess_volume(
            xd, landmarks, (SIZE,) * 3), 3))
        got = preprocess_volume(xd, landmarks, (SIZE,) * 3)
        ref = preprocess_volume(torch.from_numpy(raw), landmarks,
                                (SIZE,) * 3)
        if got.shape != (SIZE,) * 3 or not on_card(got):
            raise AssertionError(f"preprocess_volume gave {got.shape} on "
                                 f"{got.device}")
        errs.append(check("preprocess_volume", got.cpu(), ref, "f32",
                          {"f32": PREP_TOL}))
        out_vols.append(got)
        del xd
    big = crop_or_pad(torch.from_numpy(volumes[0]).cuda().float(),
                      QUANTILE_LIMIT_SHAPE)
    if big.numel() <= 2 ** 24:
        raise AssertionError(f"{big.numel()} voxels do not pass 2^24")
    big_ms = time_ms(lambda: histogram_standardization(big, landmarks), 3)
    got = histogram_standardization(big, landmarks)
    big_err = check(f"histogram_standardization {list(big.shape)}",
                    got.cpu(), histogram_standardization(big.cpu(), landmarks),
                    "f32", {"f32": PREP_TOL})
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite standardized volume")
    del big, got
    out = {"landmarks": landmarks.tolist(), "landmarks_host_ms": landmarks_ms,
           "input_size": COHORT_SIZE, "output_size": SIZE,
           "card_ms_per_volume": card_ms,
           "max_abs_err_vs_cpu": errs,
           "big_volume": {"shape": list(QUANTILE_LIMIT_SHAPE),
                          "voxels": int(np.prod(QUANTILE_LIMIT_SHAPE)),
                          "card_ms": big_ms, "max_abs_err_vs_cpu": big_err}}
    log(f"preprocessing: {json.dumps(out)}")
    return landmarks, out_vols, out


def augmentation_phase(vols):
    """Phase 8c: each transform's deterministic core on a SIZE^3 volume
    with fixed parameters, on the card against the CPU (AUG_TOL x
    max|ref|); then the reference's chain (`baseline_3d_unet.ipynb` cell
    8: flip, affine, elastic, noise, motion, bias field) with parameters
    drawn from a host generator on a batch of 2 volumes, ms per volume per
    transform (host clock around synchronized work)."""
    import torch

    from mri_epilepsy_diagnosis_torch.transforms import augment as A
    from mri_epilepsy_diagnosis_torch.transforms import spatial as S

    v = vols[0]
    g = torch.Generator().manual_seed(SEED)
    field = torch.randn(v.shape, generator=g)
    coeffs = A._uniform(g, (len(A._poly_terms(3)),), -0.5, 0.5)
    cp = A._uniform(g, (3, 7, 7, 7), -7.5, 7.5)
    affine = A._affine_from_params(v.shape, [0.95, 1.05, 1.0],
                                   [5.0, -7.0, 3.0], [2.0, -1.0, 0.5])
    motion = [A._affine_from_params(v.shape, [1.0] * 3, ang, tr)
              for ang, tr in (([4.0, -2.0, 6.0], [3.0, 0.0, -2.0]),
                              ([-5.0, 3.0, 1.0], [-1.5, 2.5, 4.0]))]
    cores = {"flip": lambda x: S.flip(x, (0,)),
             "affine": lambda x: S.affine_resample(x, affine),
             "elastic": lambda x: A._elastic_from_control_points(x, cp),
             "noise": lambda x: A._add_noise(x, 0.0, 0.1, field.to(x.device)),
             "motion": lambda x: A._motion(x, motion),
             "bias_field": lambda x: A._apply_bias_field(x, coeffs, 3)}
    vc = v.cpu()
    errs = {}
    for name, fn in cores.items():
        got = fn(v)
        if not on_card(got):
            raise AssertionError(f"{name} left the card")
        errs[name] = check(f"augment {name}", got.cpu(), fn(vc), "f32",
                           {"f32": AUG_TOL})
    chain = [("flip", A.random_flip), ("affine", A.random_affine),
             ("elastic", A.random_elastic_deformation),
             ("noise", A.random_noise), ("motion", A.random_motion),
             ("bias_field", A.random_bias_field)]
    gen = torch.Generator().manual_seed(SEED)
    batch = vols[:2]

    def per_volume_ms(fn):
        fn(gen, batch[0])                               # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn(gen, x) for x in batch]
        torch.cuda.synchronize()
        if not all(torch.isfinite(o).all() for o in outs):
            raise AssertionError("non-finite augmented volume")
        return (time.perf_counter() - t0) / len(batch) * 1e3

    ms = {name: per_volume_ms(fn) for name, fn in chain}
    ms["chain"] = per_volume_ms(A.Compose([fn for _, fn in chain]))
    out = {"size": SIZE, "max_abs_err_vs_cpu": errs,
           "ms_per_volume": ms, "batch": len(batch)}
    log(f"augmentation: {json.dumps(out)}")
    return out


def _new_train_state(UNet3D, gen):
    from mri_epilepsy_diagnosis_torch import train as Tr

    state = Tr.create_train_state(
        UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
               out_channels_first_layer=OCFL, device="cuda"),
        Tr.torch_adamw())
    random_state_dict(state.model, gen)
    sched = Tr.ReduceLROnPlateau(state.optimizer, mode="min", factor=0.1,
                                 patience=3, threshold=0.01)
    return state, sched


def files_training_phase(K, P, UNet3D, gen, launch_counts, ds, landmarks,
                         ckpt_dir):
    """Phase 8d: training from the files of 8a.
    Whole volumes: a `Subset` split, `DataLoader`s of batches of 2 whose
    collate preprocesses on the card (the batch goes through
    `DevicePrefetcher` as it is), one `train_segmentation` epoch (packed,
    bf16) with exact launch counts, `validate_dsc_asd` over the
    validation loader, and one profiled epoch that passes over the
    subjects PROFILE_PASSES times.
    Patches: `PatchQueue` (the subjects preprocessed on the card at load,
    PATCHES_PER_VOLUME patches of PATCH^3, queue PATCH_QUEUE_LENGTH, 2
    workers) with `batched(PATCH_BATCH)` through the same trainer; every
    B1 launch of a batch-PATCH_BATCH step checked against its plain
    version; PATCH_STEPS timed steps with exact launch counts, the device
    split of one step, and one profiled epoch from files with the same
    repeats."""
    import copy

    import torch

    from mri_epilepsy_diagnosis_torch import train as Tr
    from mri_epilepsy_diagnosis_torch.data import (DataLoader, PatchQueue,
                                                   Subset, batched,
                                                   default_collate)
    from mri_epilepsy_diagnosis_torch.train import seg as TS
    from mri_epilepsy_diagnosis_torch.transforms import preprocess_volume

    def card_collate(items):
        """Channels-last batch, each volume preprocessed on the card."""
        x, y = default_collate(items)
        xd = torch.from_numpy(x).cuda()
        x = torch.stack([preprocess_volume(v[..., 0], landmarks)
                         for v in xd])[..., None]
        return x, y

    def standardized(item):
        """A subject preprocessed on the card at load (the patch queue
        samples its patches on the host)."""
        img, seg = item
        x = preprocess_volume(torch.from_numpy(img[0]).cuda(), landmarks)
        return x.cpu().numpy()[None], seg

    bf16 = dict(packed=True, input_dtype=torch.bfloat16)
    n = len(ds)
    train_set = Subset(ds, range(n // 2))
    val_set = Subset(ds, range(n // 2, n))
    train_loader = DataLoader(train_set, batch_size=2, shuffle=True,
                              seed=SEED, collate_fn=card_collate)
    val_loader = DataLoader(val_set, batch_size=2, collate_fn=card_collate)

    state, sched = _new_train_state(UNet3D, gen)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, tr, va = Tr.train_segmentation(
        1, train_loader, val_loader, state, sched, "chip_smoke_files",
        weights_dir=ckpt_dir, verbose=False, **bf16)
    whole_s = time.perf_counter() - t0
    whole_counts = launch_counts()
    _expect_counts("whole volumes from files, 1 epoch", whole_counts, {
        k: len(train_loader) * v + 2 * len(val_loader) * UNET_PER_BATCH[k]
        for k, v in TRAIN_PER_STEP.items()})
    K.reset_launch_counts()
    dsc, asd_gt, asd_pred, iou = Tr.validate_dsc_asd(state, val_loader,
                                                     packed=True)
    _expect_counts("validate_dsc_asd from files (f32)", launch_counts(),
                   {k: len(val_loader) * v for k, v in VAL_PER_BATCH.items()})
    # an epoch in steady state: every subject PROFILE_PASSES times over, so
    # that the prefetcher's thread loads ahead of the steps as it would
    # over a cohort of that many subjects
    cohort = Subset(ds, np.tile(np.arange(n), PROFILE_PASSES))
    long_loader = DataLoader(cohort, batch_size=2, shuffle=True, seed=SEED,
                             collate_fn=card_collate)
    whole_prof = profile_batch(lambda: TS.run_epoch(
        2, Tr.Action.TRAIN, long_loader, state, **bf16), host_ops=False)

    queue = PatchQueue(ds, max_length=PATCH_QUEUE_LENGTH,
                       samples_per_volume=PATCHES_PER_VOLUME,
                       patch_size=PATCH, transform=standardized, seed=SEED,
                       num_workers=2)
    patch_loader = batched(queue, PATCH_BATCH)
    val1 = DataLoader(val_set, batch_size=1, collate_fn=card_collate)
    pstate, psched = _new_train_state(UNet3D, gen)
    n_steps = -(-len(queue) // PATCH_BATCH)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    pstate, ptr, pva = Tr.train_segmentation(
        1, patch_loader, val1, pstate, psched, "chip_smoke_patches",
        weights_dir=ckpt_dir, verbose=False, **bf16)
    patch_epoch_s = time.perf_counter() - t0
    patch_counts = launch_counts()
    _expect_counts(f"{PATCH}^3 patches from files, 1 epoch", patch_counts, {
        k: n_steps * v + 2 * len(val1) * UNET_PER_BATCH[k]
        for k, v in TRAIN_PER_STEP.items()})

    batches = list(patch_loader)
    if len(batches[0][0]) != PATCH_BATCH:
        raise AssertionError(f"patch batches {[len(b[0]) for b in batches]}")
    xb = torch.from_numpy(batches[0][0]).cuda().to(torch.bfloat16)
    lb = torch.from_numpy(batches[0][1]).cuda()
    del batches
    rec = copy.deepcopy(pstate.model)
    sites = record_train_sites(K, P, lambda: TS.packed_seg_loss(
        rec, xb, lb)[0].backward())
    del rec
    name_train_sites(sites)         # its dx and dw calls match the forward
    fwd_rows, fwd_err = forward_site_rows(K, sites["forward"], gen,
                                          "patch train forward",
                                          [(None, "bf16")], (None, "bf16"))
    bwd_rows, bwd_err = backward_site_rows(K, P, sites["forward"], gen,
                                           "patch train", [(None, "bf16")],
                                           (None, "bf16"))

    pstate, loss = Tr.packed_seg_train_step(pstate, xb, lb)     # warm-up
    warm_loss = float(loss)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(PATCH_STEPS):
        pstate, loss = Tr.packed_seg_train_step(pstate, xb, lb)
        losses.append(float(loss))
    step_s = (time.perf_counter() - t0) / PATCH_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_counts = launch_counts()
    _expect_counts(f"{PATCH_STEPS} patch train steps, batch {PATCH_BATCH}",
                   step_counts, {k: PATCH_STEPS * v
                                 for k, v in TRAIN_PER_STEP.items()})
    box = {}

    def profiled_step():
        _, box["read"] = step_split(K, P, lambda: Tr.packed_seg_train_step(
            pstate, xb, lb))

    step_prof = profile_batch(profiled_step)
    split = box["read"]()
    split["other_kernels_ms"] = (step_prof["kernel_ms"]
                                 - split["b1_forward_ms"]
                                 - split["b1_dx_ms"] - split["dw_ms"])
    # the same steady state for the queue, which fills past max_length
    # several times over the repeated subjects
    long_queue = PatchQueue(cohort, max_length=PATCH_QUEUE_LENGTH,
                            samples_per_volume=PATCHES_PER_VOLUME,
                            patch_size=PATCH, transform=standardized,
                            seed=SEED, num_workers=2)
    patch_prof = profile_batch(lambda: TS.run_epoch(
        2, Tr.Action.TRAIN, batched(long_queue, PATCH_BATCH), pstate, **bf16),
        host_ops=False)
    out = {"whole": {"subjects_train": len(train_set),
                     "subjects_val": len(val_set), "batch": 2,
                     "epoch_s": whole_s, "train_losses": tr,
                     "val_losses": va, "launches": whole_counts,
                     "dsc": dsc, "asd_gt_to_pred": asd_gt,
                     "asd_pred_to_gt": asd_pred, "iou": iou,
                     "profile_epoch": whole_prof,
                     "profile_epoch_loads": len(cohort),
                     "profile_epoch_steps": len(long_loader)},
           "patches": {"patch": PATCH, "batch": PATCH_BATCH,
                       "per_volume": PATCHES_PER_VOLUME,
                       "queue_length": PATCH_QUEUE_LENGTH, "workers": 2,
                       "steps_per_epoch": n_steps, "epoch_s": patch_epoch_s,
                       "train_losses": ptr, "val_losses": pva,
                       "launches_epoch": patch_counts,
                       "ms_per_step": step_s * 1e3,
                       "patches_per_s": PATCH_BATCH / step_s,
                       "peak_memory_gb": peak_gb, "warmup_loss": warm_loss,
                       "timed_losses": losses,
                       "launches_timed_steps": step_counts,
                       "b1_launches_per_step":
                           step_counts["conv2_packed"] // PATCH_STEPS,
                       "step_split": split, "profile_step": step_prof,
                       "profile_epoch": patch_prof,
                       "profile_epoch_loads": len(cohort),
                       "profile_epoch_steps": -(-len(long_queue)
                                                // PATCH_BATCH),
                       "forward_max_abs_err": fwd_err,
                       "dx_max_abs_err": bwd_err["dx"]}}
    log(f"training from files: {json.dumps(out)}")
    if not np.isfinite(tr + va + ptr + pva + losses).all():
        raise AssertionError("non-finite losses from files")
    if not np.isfinite(dsc + asd_gt + asd_pred + iou).all():
        raise AssertionError("non-finite validation metrics from files")
    return pstate, out, fwd_rows, bwd_rows["dx"]


def sliding_window_phase(K, P, UNet3D, state, vol, gen, launch_counts,
                         root):
    """Phase 8e: `sliding_window_predict` of one preprocessed SIZE^3
    volume, patch PATCH, overlap SW_OVERLAP (SW_PATCHES patches, one
    batch-SW_BATCH call of the BN-folded `packed_unet_apply_v2` of 8d's
    patch-trained model, its classifier bias set for a FG_SHARE
    foreground), in bf16 and f32, in the crop and average modes, with
    exact launch counts; each B1 site at N = SW_BATCH against its plain
    version; f32 logits against the fine UNet3D (cuDNN, TF32 off) through
    the same sliding window; bf16 masks against f32 masks; the mask
    written with `save_nifti` and read back."""
    import torch

    from mri_epilepsy_diagnosis_torch.infer import (extract_patches,
                                                    grid_locations,
                                                    sliding_window_predict)
    from mri_epilepsy_diagnosis_torch.models.unet_packed import (
        fold_bn_inference, packed_unet_apply_v2, packed_unet_mask_v2)
    from mri_epilepsy_diagnosis_torch.utils import load_nifti, save_nifti

    x = vol[..., None]
    locs = grid_locations(x.shape[:3], PATCH, SW_OVERLAP)
    if len(locs) != SW_PATCHES:
        raise AssertionError(f"{len(locs)} patches != {SW_PATCHES}")
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}

    def window(params, inputs, mode, apply_fn=packed_unet_apply_v2):
        with torch.inference_mode():
            return sliding_window_predict(apply_fn, params, inputs, PATCH,
                                          SW_OVERLAP, SW_BATCH, mode)

    logits = window(fold_bn_inference(sd), x, "crop")
    margin = (logits[..., 1] - logits[..., 0]).flatten()[::101]
    sd["classifier.conv_layer.bias"][1] -= torch.quantile(margin.float(),
                                                          1 - FG_SHARE)
    params = fold_bn_inference(sd)
    del logits, margin
    with torch.inference_mode():
        patches = extract_patches(x, locs, PATCH)
        sites = record_sites(K, P, lambda: packed_unet_apply_v2(
            params, patches.to(torch.bfloat16)))["conv2_packed"]
    if (len(sites) != len(B1_SITES) or sites[0]["x"][0] != SW_BATCH
            or sum(s["fused"] for s in sites) != len(B2_SITES)):
        raise AssertionError(f"unexpected sliding-window sites {sites}")
    del patches
    rows, errs = forward_site_rows(K, sites, gen, "sliding window",
                                   [(None, "bf16"), (None, "f32")],
                                   (None, "bf16"))

    runs = {}
    for dn, dt, want in (("f32", torch.float32, VAL_PER_BATCH),
                         ("bf16", torch.bfloat16, UNET_PER_BATCH)):
        xi = x.to(dt)
        for mode in ("crop", "average"):
            window(params, xi, mode)                    # warm-up
            torch.cuda.synchronize()
            K.reset_launch_counts()
            out = window(params, xi, mode)
            counts = launch_counts()
            _expect_counts(f"sliding window {dn} {mode}", counts, want)
            # host clock around each synchronized call: what a caller waits
            samples = []
            for _ in range(SW_TIMED_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                window(params, xi, mode)
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) * 1e3)
            runs[(dn, mode)] = (out, samples, counts)
    model = UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
                   out_channels_first_layer=OCFL, device="cuda").eval()
    model.load_state_dict(sd)
    logit_err, agree, fg = {}, {}, {}
    for mode in ("crop", "average"):
        fine = window(None, x, mode, lambda p, t: model(t))
        got = runs[("f32", mode)][0]
        err = (got - fine).abs().max().item()
        scale = fine.abs().max().item()
        logit_err[mode] = err
        log(f"sliding window f32 {mode} vs fine UNet3D (cuDNN): max_abs_err "
            f"{err:.3e} (max|logit| {scale:.3e}, tol {SW_LOGIT_TOL} x "
            f"max|logit|)")
        if err > SW_LOGIT_TOL * scale:
            raise AssertionError(f"sliding window {mode}: f32 logits differ "
                                 f"from the fine UNet3D's by {err}")
        m32 = got.argmax(-1)
        m16 = runs[("bf16", mode)][0].argmax(-1)
        agree[mode] = (m16 == m32).float().mean().item()
        fg[mode] = m16.float().mean().item()
        del fine
    with torch.inference_mode():
        whole = packed_unet_mask_v2(params, x[None].to(torch.bfloat16))[0]
    mask = runs[("bf16", "crop")][0].argmax(-1).to(torch.uint8)
    whole_agree = (whole == mask).float().mean().item()
    path = os.path.join(root, "sub00_mask.nii.gz")
    save_nifti(path, mask.cpu().numpy())
    back = load_nifti(path).data
    roundtrip = bool(back.dtype == np.uint8
                     and np.array_equal(back, mask.cpu().numpy()))
    profile = profile_batch(lambda: window(params, x.to(torch.bfloat16),
                                           "crop"))
    out = {"size": SIZE, "patch": PATCH, "overlap": SW_OVERLAP,
           "patches": len(locs), "batch": SW_BATCH,
           "ms_per_volume": {f"{dn}_{mode}": float(np.median(r[1]))
                             for (dn, mode), r in runs.items()},
           "ms_samples": {f"{dn}_{mode}": r[1]
                          for (dn, mode), r in runs.items()},
           "launches": {f"{dn}_{mode}": r[2]
                        for (dn, mode), r in runs.items()},
           "f32_logits_vs_fine_max_abs_err": logit_err,
           "mask_agreement_bf16_vs_f32": agree, "foreground_share": fg,
           "agreement_with_whole_volume_packed_mask": whole_agree,
           "mask_nifti_roundtrip": roundtrip,
           "kernel_max_abs_err": errs,
           "profile": profile}
    log(f"sliding window: {json.dumps(out)}")
    if min(agree.values()) < MASK_AGREEMENT_BF16:
        raise AssertionError(f"bf16 vs f32 sliding-window masks {agree}")
    if not all(FG_GATE[0] <= f <= FG_GATE[1] for f in fg.values()):
        raise AssertionError(f"degenerate sliding-window masks: {fg}")
    if not roundtrip:
        raise AssertionError("the mask did not come back from its NIfTI file")
    return out, rows


def record_b3(K, fn):
    """Arguments of every `separable_conv3d` (kind "stack"), `conv_axis`,
    `conv_axis_dw` and `conv_axis_dx` call that fn() makes, in call order.
    The fader's stacks reach the kernels through `SeparableConv3dFn`, whose
    forward and backward call them by the kernels module's own names, so
    the recorders take their place there.  The `conv_axis` calls are the
    backward's recomputes and, for stacks that take the per-axis route,
    the forward's."""
    sites = {"stack": [], "axis": [], "dw": [], "dx": []}
    stack_, axis_, dw_, dx_ = (K.separable_conv3d, K.conv_axis,
                               K.conv_axis_dw, K.conv_axis_dx)

    def rec_stack(x, wx, wy, wz, *, stride=(1, 1, 1), pad=(0, 0, 0),
                  biases=(None, None, None)):
        sites["stack"].append({
            "x": tuple(x.shape), "w": [tuple(w.shape) for w in (wx, wy, wz)],
            "stride": tuple(stride), "pad": tuple(pad),
            "bias": [b is not None for b in biases]})
        return stack_(x, wx, wy, wz, stride=stride, pad=pad, biases=biases)

    def rec_axis(x, w, bias=None, *, axis, stride=1, pad=0):
        sites["axis"].append({"x": tuple(x.shape), "w": tuple(w.shape),
                              "axis": axis, "stride": stride, "pad": pad,
                              "bias": bias is not None})
        return axis_(x, w, bias, axis=axis, stride=stride, pad=pad)

    def rec_dw(x, g, *, k, axis, stride=1, pad=0, bias=True):
        sites["dw"].append({"x": tuple(x.shape), "g": tuple(g.shape), "k": k,
                            "axis": axis, "stride": stride, "pad": pad,
                            "bias": bias})
        return dw_(x, g, k=k, axis=axis, stride=stride, pad=pad, bias=bias)

    def rec_dx(g, w, *, length, axis, stride=1, pad=0):
        sites["dx"].append({"g": tuple(g.shape), "w": tuple(w.shape),
                            "length": length, "axis": axis, "stride": stride,
                            "pad": pad})
        return dx_(g, w, length=length, axis=axis, stride=stride, pad=pad)

    # the wrappers count their launches through these module-level names:
    # while they are the recorders, the recorders hold the counts, which
    # the recorded step's launches do not reach
    recs = (rec_stack, rec_axis, rec_dw, rec_dx)
    for rec in recs:
        rec.launches = 0
    (K.separable_conv3d, K.conv_axis, K.conv_axis_dw,
     K.conv_axis_dx) = recs
    try:
        fn()
    finally:
        (K.separable_conv3d, K.conv_axis, K.conv_axis_dw,
         K.conv_axis_dx) = stack_, axis_, dw_, dx_
    return sites


def named_stacks(label, calls):
    """(name, stack, calls) of the distinct stacks of a recorded call
    list."""
    return [(f"{label}.{i}", st, n)
            for i, (st, n) in enumerate(_unique_sites(calls))]


def _unique_sites(calls):
    """(site, calls) pairs of the distinct sites of a recorded call list,
    in first-call order."""
    out = {}
    for s in calls:
        key = json.dumps(s, sort_keys=True)
        out.setdefault(key, [s, 0])[1] += 1
    return list(out.values())


def _axis_conv_weight(w, axis):
    """(k, Ci, Co) one-axis weight -> torch's (Co, Ci, kD, kH, kW) and the
    stride / padding lists of `axis` (1..3), for cuDNN's yardsticks."""
    k, ci, co = w.shape
    shape = [co, ci, 1, 1, 1]
    shape[1 + axis] = k
    return w.permute(2, 1, 0).reshape(shape)


def _axis_valid_taps(length, lo, k, stride, pad):
    """(j, t) pairs whose input index lies inside [0, length): the work
    that these inputs need."""
    return sum(1 for j in range(lo) for t in range(k)
               if 0 <= j * stride + t - pad < length)


def b3_bwd_rows(K, label, sites, gen, checks, timed):
    """Each distinct B3 backward site (dx, dw, and the one-axis conv
    launches) at each (batch, dtype) of `checks` against its plain
    version; at `timed` (batch None: the recorded one) timed beside cuDNN's
    `conv3d_input` / `conv3d_weight` / `conv3d` of the same one-axis conv.
    Returns rows by kind (each repeated by its calls per step) and the
    largest error by kind and dtype."""
    import torch
    import torch.nn.functional as TF
    from torch.nn import grad as tgrad

    rows = {"dx": [], "dw": [], "axis": []}
    errs = {k: {"f32": None, "bf16": None} for k in rows}

    def note(kind, dn, err):
        errs[kind][dn] = max(errs[kind][dn] or 0.0, err)

    for kind in ("dx", "dw", "axis"):
        for site, calls in _unique_sites(sites[kind]):
            axis, s, p = site["axis"], site["stride"], site["pad"]
            for batch, dn in checks:
                dt = torch.float32 if dn == "f32" else torch.bfloat16
                if kind == "dx":
                    gshape = (batch or site["g"][0], *site["g"][1:])
                    k, ci, co = site["w"]
                    g = torch.randn(gshape, generator=gen,
                                    device="cuda").to(dt)
                    w = (torch.randn(site["w"], generator=gen, device="cuda")
                         / np.sqrt(k * co)).to(dt)
                    kw = dict(length=site["length"], axis=axis, stride=s,
                              pad=p)
                    got = K.conv_axis_dx(g, w, **kw)
                    torch.cuda.synchronize()
                    ref = K.conv_axis_dx_plain(g, w, **kw)
                    err = check(f"{label} conv_axis_dx {gshape} axis {axis}",
                                got, ref, dn)
                elif kind == "dw":
                    xshape = (batch or site["x"][0], *site["x"][1:])
                    gshape = (xshape[0], *site["g"][1:])
                    x = torch.randn(xshape, generator=gen,
                                    device="cuda").to(dt)
                    g = torch.randn(gshape, generator=gen,
                                    device="cuda").to(dt)
                    kw = dict(k=site["k"], axis=axis, stride=s, pad=p,
                              bias=site["bias"])
                    got = K.conv_axis_dw(x, g, **kw)
                    torch.cuda.synchronize()
                    ref = K.conv_axis_dw_plain(x, g, **kw)
                    err = check(f"{label} conv_axis_dw {xshape} axis {axis}",
                                got[0], ref[0], dn, {dn: DW_TOL})
                    if site["bias"]:
                        err = max(err, check(f"{label} conv_axis_dw db",
                                             got[1], ref[1], dn,
                                             {dn: DW_TOL}))
                else:
                    xshape = (batch or site["x"][0], *site["x"][1:])
                    k, ci, co = site["w"]
                    x = torch.randn(xshape, generator=gen,
                                    device="cuda").to(dt)
                    w = (torch.randn(site["w"], generator=gen, device="cuda")
                         / np.sqrt(k * ci)).to(dt)
                    bias = (torch.randn(co, generator=gen, device="cuda")
                            if site["bias"] else None)
                    kw = dict(axis=axis, stride=s, pad=p)
                    got = K.conv_axis(x, w, bias, **kw)
                    torch.cuda.synchronize()
                    ref = K.conv_axis_plain(x, w, bias, **kw)
                    err = check(f"{label} conv_axis {xshape} axis {axis}",
                                got, ref, dn)
                note(kind, dn, err)
                del ref
                if (batch, dn) == timed:
                    if kind == "axis":
                        row = b3_time_row(K, TF, f"{label}.{axis}", x, w,
                                          bias, kw, got)
                    elif kind == "dx":
                        row = dx_axis_time_row(K, tgrad, label, g, w, kw,
                                               got)
                    else:
                        row = dw_axis_time_row(K, tgrad, label, x, g, kw)
                    row.update(calls_per_step=calls, max_abs_err=err)
                    rows[kind] += [row] * calls
                del got
                torch.cuda.empty_cache()
    return rows, errs


def dx_axis_time_row(K, tgrad, label, g, w, kw, dx):
    """Times of one `conv_axis_dx` site: kernel, plain version, cuDNN's
    `conv3d_input` of the one-axis conv; its bound from the bytes and the
    operations these inputs need."""
    axis, s, p, length = kw["axis"], kw["stride"], kw["pad"], kw["length"]
    k, ci, co = w.shape
    rows_ab = g.numel() // (g.shape[axis] * co)
    flops = 2.0 * rows_ab * _axis_valid_taps(length, g.shape[axis], k, s,
                                             p) * ci * co
    nbytes = (g.numel() + dx.numel()) * g.element_size() + 4 * w.numel()
    bound_ms, bound_by = _bound(flops, nbytes, "bf16")
    stride, pad = [1, 1, 1], [0, 0, 0]
    stride[axis - 1], pad[axis - 1] = s, p
    wc = _axis_conv_weight(w, axis)
    gc = g.permute(0, 4, 1, 2, 3)
    in_size = list(gc.shape)
    in_size[1], in_size[1 + axis] = ci, length
    ms = time_ms(lambda: K.conv_axis_dx(g, w, **kw), 10)
    row = {"site": label, "g": list(g.shape), "axis": axis, "k": k,
           "stride": s, "pad": p, "ci": ci, "co": co, "ms": ms,
           "plain_ms": time_ms(lambda: K.conv_axis_dx_plain(g, w, **kw), 1),
           "library_ms": time_ms(lambda: tgrad.conv3d_input(
               in_size, wc, gc, stride=stride, padding=pad), 5),
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": bound_by, "gb_per_s": nbytes / ms / 1e6,
           "f32_core_ms": flops / PEAK_OPS_PER_S["f32"] * 1e3}
    log(f"time conv_axis_dx {label} {list(g.shape)} axis {axis}: "
        f"{json.dumps(row)}")
    return row


def dw_axis_time_row(K, tgrad, label, x, g, kw):
    """Times of one `conv_axis_dw` site (dw and db, float32), as
    `dx_axis_time_row`; cuDNN's `conv3d_weight` as the yardstick (dw
    only)."""
    axis, s, p, k = kw["axis"], kw["stride"], kw["pad"], kw["k"]
    ci, co = x.shape[4], g.shape[4]
    rows_ab = g.numel() // (g.shape[axis] * co)
    flops = 2.0 * rows_ab * _axis_valid_taps(x.shape[axis], g.shape[axis], k,
                                             s, p) * ci * co
    nbytes = (x.numel() + g.numel()) * x.element_size() + 4 * (k * ci + 1) * co
    bound_ms, bound_by = _bound(flops, nbytes, "bf16")
    stride, pad = [1, 1, 1], [0, 0, 0]
    stride[axis - 1], pad[axis - 1] = s, p
    wshape = [co, ci, 1, 1, 1]
    wshape[1 + axis] = k
    xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
    ms = time_ms(lambda: K.conv_axis_dw(x, g, **kw), 10)
    row = {"site": label, "x": list(x.shape), "g": list(g.shape),
           "axis": axis, "k": k, "stride": s, "pad": p, "ci": ci, "co": co,
           "chunks": K.conv_axis_dw_plan(rows_ab * g.shape[axis], k, ci,
                                         co).chunks, "ms": ms,
           "plain_ms": time_ms(lambda: K.conv_axis_dw_plain(x, g, **kw), 1),
           "library_ms": time_ms(lambda: tgrad.conv3d_weight(
               xc, wshape, gc, stride=stride, padding=pad), 5),
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": bound_by, "gb_per_s": nbytes / ms / 1e6,
           "f32_core_ms": flops / PEAK_OPS_PER_S["f32"] * 1e3}
    log(f"time conv_axis_dw {label} {list(x.shape)} axis {axis}: "
        f"{json.dumps(row)}")
    return row


def fader_models(Fd, gen, depth):
    """The reference's encoder, Classificator and Discriminator
    (train_ENC_CLF.ipynb cells 17-18) at `depth` (3 takes a 192^3 input),
    the heads scaled to a shallower latent as `examples/train_fader.py`
    does, with the JAX package's init drawn from `gen`."""
    ae_kwargs = dict(FADER_AE_KWARGS, deapth=depth)
    head = dict(FADER_HEAD_KWARGS)
    if depth != 3:
        c = ae_kwargs["c_base"] * 2 ** (depth - 1)
        head.update(c_in=c, c_out=2 * c, l_in=2 * c, l_out=c)
    enc = Fd.make_encoder(ae_kwargs, device="cuda")
    clf = Fd.Classificator(n_class=2, device="cuda", **head)
    disc = Fd.Discriminator(n_domains=FADER_N_DOMAINS, device="cuda", **head)
    for m, act in ((enc, "l_relu"), (clf, "relu"), (disc, "relu")):
        reference_init(m, gen, act)
    return enc, clf, disc


def fader_state(Tr, enc, clf, disc, opt=None):
    """FaderState of `examples/train_fader.py`: Adam 7e-4 / 7e-4 / 5e-4 with
    weight decay 1e-4 (or `opt(model)` for every network)."""
    def st(model, lr):
        return Tr.TrainState(model, opt(model) if opt else Tr.torch_adam(
            lr, weight_decay=FADER_WD)(model.parameters()))
    return Tr.FaderState(encoder=st(enc, FADER_LR[0]),
                         clf=st(clf, FADER_LR[1]),
                         disc=st(disc, FADER_LR[2]))


def fader_batch(gen, batch, size):
    """`batch` z-normalized T1w-like `size`^3 volumes on the card (float32,
    (batch, S, S, S, 1)), labels of both classes and domains of 18."""
    import torch

    from mri_epilepsy_diagnosis_torch.transforms import znormalization

    x = torch.stack([znormalization(torch.from_numpy(v).cuda())
                     for v in t1_like_volumes(gen, batch, size)])[..., None]
    y = torch.arange(batch, device="cuda") % 2
    dom = torch.randint(0, FADER_N_DOMAINS, (batch,), generator=gen,
                        device="cuda")
    return x, y, dom


def fader_alternation(Tr, fstate, x, y, dom, lam, rng):
    """One alternation batch as `train_fader` runs it in its first epochs:
    FADER_DISC_LOOP discriminator steps, one encoder + classifier step."""
    for _ in range(FADER_DISC_LOOP):
        fstate, loss_disc, _ = Tr.disc_step(fstate, x, dom, rng,
                                            FADER_N_DOMAINS)
    fstate, loss, loss_adv, _ = Tr.enc_clf_step(
        fstate, x, y, dom, lam, rng, FADER_N_DOMAINS, FADER_CLASS_WEIGHT)
    return fstate, (loss, loss_adv, loss_disc)


def _b3_counts(c):
    return {k: c[k] for k in ("separable_conv3d", "conv_axis", "conv_axis_dw",
                              "conv_axis_dx")}


def fader_phase(K, Fd, gen, launch_counts):
    """Phase 9a-9b: the B3 sites of the alternation (recorded from one
    enc_clf_step and one disc_step at 192^3, batch 35, bf16): the backward
    kernels and the fused forward stacks against their plain versions, at
    the recorded batch in bf16 and at batch 2 in f32, and timed; then the
    alternation itself: exact
    launch counts per batch, ms per batch, vol/s, peak memory, the split
    and idle share of one profiled batch, and `train_fader` over a loader
    of two batches."""
    import torch

    from mri_epilepsy_diagnosis_torch import train as Tr

    enc, clf, disc = fader_models(Fd, gen, FADER_DEPTH)
    fstate = fader_state(Tr, enc, clf, disc)
    x, y, dom = fader_batch(gen, FADER_BATCH, SIZE)
    xb = x.to(torch.bfloat16)
    rng = torch.Generator().manual_seed(SEED)
    lam = FADER_LAMBDA[0]
    sites = record_b3(K, lambda: Tr.enc_clf_step(
        fstate, xb, y, dom, lam, rng, FADER_N_DOMAINS, FADER_CLASS_WEIGHT))
    disc_sites = record_b3(K, lambda: Tr.disc_step(
        fstate, xb, dom, rng, FADER_N_DOMAINS))
    for kind in sites:
        sites[kind] += disc_sites[kind] * FADER_DISC_LOOP
    per_batch = alternation_per_batch(FADER_DEPTH)
    recorded = {k: len(v) for k, v in sites.items()}
    want = {"stack": per_batch["separable_conv3d"],
            "axis": per_batch["conv_axis"], "dw": per_batch["conv_axis_dw"],
            "dx": per_batch["conv_axis_dx"]}
    if recorded != want:
        raise AssertionError(f"B3 calls per alternation batch "
                             f"{recorded} != {want}")
    checks, timed_at = [(2, "f32"), (None, "bf16")], (None, "bf16")
    rows, errs = b3_bwd_rows(K, "fader", sites, gen, checks, timed_at)
    rows["stack"], errs["stack"] = sep_kernel_phase(
        K, named_stacks("fader", sites["stack"]), gen, checks, timed_at)

    # the alternation, device-resident batch: 1 warm-up, then timed
    fstate, losses = fader_alternation(Tr, fstate, xb, y, dom, lam, rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    timed = []
    for i in range(FADER_TIMED_BATCHES):
        fstate, losses = fader_alternation(
            Tr, fstate, xb, y, dom, lam + (i + 1) * FADER_LAMBDA[1], rng)
        timed.append([float(v) for v in losses])
    torch.cuda.synchronize()
    batch_s = (time.perf_counter() - t0) / FADER_TIMED_BATCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = launch_counts()
    _expect_counts(f"{FADER_TIMED_BATCHES} alternation batches", counts, {
        k: FADER_TIMED_BATCHES * v for k, v in per_batch.items()})
    f32_master = all(p.dtype == torch.float32 for m in (enc, clf, disc)
                     for p in m.parameters())
    finite = all(np.isfinite(v) for t in timed for v in t)
    # where the time of one batch goes
    split = {}
    for name, fn in (("disc_step", lambda: Tr.disc_step(
            fstate, xb, dom, rng, FADER_N_DOMAINS)),
            ("enc_clf_step", lambda: Tr.enc_clf_step(
                fstate, xb, y, dom, lam, rng, FADER_N_DOMAINS,
                FADER_CLASS_WEIGHT))):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        split[f"{name}_ms"] = (time.perf_counter() - t1) / 2 * 1e3
    prof = profile_batch(lambda: fader_alternation(Tr, fstate, xb, y, dom,
                                                   lam, rng))
    # the idle share again with the device alone traced: tracing every
    # host op slows the host, which launches this batch's ~130 kernels
    prof_device = profile_batch(lambda: fader_alternation(
        Tr, fstate, xb, y, dom, lam, rng), host_ops=False)
    # the entry point: train_fader over a host loader of two batches
    # (histories, lambda ramp, disc_loop) and one validation batch
    host = (x.cpu().numpy(), y.cpu().numpy(), dom.cpu().numpy())
    K.reset_launch_counts()
    t0 = time.perf_counter()
    fstate, hist = Tr.train_fader(
        fstate, [host, host], [host], epochs=1,
        lambda_initial=FADER_LAMBDA[0], lambda_step=FADER_LAMBDA[1],
        max_step=FADER_LAMBDA[2], n_domains=FADER_N_DOMAINS,
        disc_loop=FADER_DISC_LOOP, class_weight=FADER_CLASS_WEIGHT,
        verbose=False, input_dtype=torch.bfloat16)
    epoch_s = time.perf_counter() - t0
    _expect_counts("train_fader, 1 epoch of 2 batches + 1 validation batch",
                   launch_counts(), {
                       k: 2 * v + (FADER_DEPTH + 2 if k == "separable_conv3d"
                                   else 0) for k, v in per_batch.items()})
    finite = finite and all(np.isfinite(hist["train_loss"]))
    out = {"size": SIZE, "batch": FADER_BATCH, "depth": FADER_DEPTH,
           "n_domains": FADER_N_DOMAINS, "disc_loop": FADER_DISC_LOOP,
           "dtype": "bf16", "timed_losses": timed,
           "ms_per_alternation_batch": batch_s * 1e3,
           "vol_per_s": FADER_BATCH / batch_s, "peak_memory_gb": peak_gb,
           **split, "launches_per_batch": per_batch,
           "launches_timed_batches": counts, "profile": prof,
           "profile_device_only": prof_device,
           "train_fader_epoch_s": epoch_s, "history": hist,
           "f32_master_weights": f32_master, "finite": finite,
           "b3_bwd_recorded": recorded}
    log(f"fader alternation: {json.dumps(out)}")
    if not (f32_master and finite):
        raise AssertionError(f"fader alternation: f32 master weights "
                             f"{f32_master}, finite losses {finite}")
    return out, rows, errs


def _deltas(model, before):
    """p_before - p_after of every parameter: the gradient under SGD at
    lr 1."""
    return {k: before[k] - p.detach() for k, p in model.named_parameters()}


def fader_parity_phase(K, Fd, gen):
    """Phase 9c: one enc_clf_step and one disc_step in f32 at
    FADER_PARITY_SIZE^3, depth 2, with the kernels, against the same steps
    on a reference fader whose separable stacks are per-axis cuDNN convs
    (autograd), TF32 off; SGD at lr 1, so that each update is the
    gradient; the same Dropout masks on both (one seed)."""
    import copy

    import torch
    import torch.nn.functional as TF

    from mri_epilepsy_diagnosis_torch import train as Tr

    def cudnn_stack(convs, x):
        v = x.permute(0, 4, 1, 2, 3)
        for conv in convs:
            v = TF.conv3d(v, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                          stride=conv.stride, padding=conv.padding)
        return v.permute(0, 2, 3, 4, 1)

    models = fader_models(Fd, gen, 2)
    x, y, dom = fader_batch(gen, FADER_PARITY_BATCH, FADER_PARITY_SIZE)
    def sgd(m):
        return torch.optim.SGD(m.parameters(), lr=1.0)

    results = {}
    for step in ("enc_clf_step", "disc_step"):
        runs = {}
        for path in ("kernels", "cudnn"):
            ms = [copy.deepcopy(m) for m in models]
            fs = fader_state(Tr, *ms, opt=sgd)
            before = [{k: p.detach().clone() for k, p in m.named_parameters()}
                      for m in ms]
            rng = torch.Generator().manual_seed(SEED)
            stack = Fd._separable_conv
            if path == "cudnn":
                Fd._separable_conv = cudnn_stack
            try:
                if step == "enc_clf_step":
                    out = Tr.enc_clf_step(fs, x, y, dom, 0.3, rng,
                                          FADER_N_DOMAINS,
                                          FADER_CLASS_WEIGHT)
                else:
                    out = Tr.disc_step(fs, x, dom, rng, FADER_N_DOMAINS)
            finally:
                Fd._separable_conv = stack
            runs[path] = (float(out[1]), ms, [_deltas(m, b)
                                              for m, b in zip(ms, before)])
        (loss, ms, deltas), (rloss, rms, rdeltas) = (runs["kernels"],
                                                     runs["cudnn"])
        floor = PARITY_GRAD_FLOOR * max(float(v.abs().max()) for d in rdeltas
                                        for v in d.values())
        worst, stats_err = 0.0, 0.0
        for d, rd, m, rm in zip(deltas, rdeltas, ms, rms):
            for k, r in rd.items():
                worst = max(worst, float((d[k] - r).abs().max()) / (
                    PARITY_GRAD_RTOL * float(r.abs().max()) + floor))
            rb = dict(rm.named_buffers())
            for k, b in m.named_buffers():
                if "running" in k:
                    stats_err = max(stats_err, float((b - rb[k]).abs().max())
                                    / max(1.0, float(rb[k].abs().max())))
        res = {"loss": loss, "ref_loss": rloss,
               "loss_rel_err": abs(loss - rloss) / abs(rloss),
               "grad_worst_err_over_tol": worst,
               "running_stats_err": stats_err}
        log(f"f32 parity {step} (kernels vs per-axis cuDNN, "
            f"{FADER_PARITY_SIZE}^3 b{FADER_PARITY_BATCH}): "
            f"{json.dumps(res)}")
        if (worst > 1 or res["loss_rel_err"] > PARITY_LOSS_RTOL
                or stats_err > PARITY_STATS_TOL):
            raise AssertionError(f"f32 fader parity {step}: {res}")
        results[step] = res
    return results


def ae_phase(K, Fd, gen, launch_counts):
    """Phase 9d: `ae_step` at 192^3 with `examples/train_ae.py`'s settings
    (depth 6, c_base 16, batch 3, the 2^3/s2 discriminator on the 3^3 x 512
    latent, Adam 1e-4), bf16: its B3 backward sites recorded, then 1
    warm-up and AE_STEPS timed steps: ms per step, peak memory, launches
    per step (the same each step)."""
    import torch

    from mri_epilepsy_diagnosis_torch import train as Tr

    ae = Fd.AE(device="cuda", **AE_KWARGS)
    latent_c = AE_KWARGS["c_base"] * 2 ** (AE_KWARGS["deapth"] - 1)
    disc = Fd.Discriminator(
        c_in=latent_c, c_out=2 * latent_c, conv_k=2, conv_s=2, conv_pad=0,
        l_in=2 * latent_c, l_out=latent_c, batch_norm=False, act="l_relu",
        p_drop=0.0, n_domains=AE_N_DOMAINS, device="cuda")
    for m, act in ((ae, "relu"), (disc, "l_relu")):
        reference_init(m, gen, act)

    def st(model):
        return Tr.TrainState(model, Tr.torch_adam(1e-4)(model.parameters()))

    fs = Tr.FaderState(encoder=st(ae.enc), clf=None, disc=st(disc),
                       decoder=st(ae.dec))
    x, _, dom = fader_batch(gen, AE_BATCH, SIZE)
    xb, dom = x.to(torch.bfloat16), dom % AE_N_DOMAINS
    sites = record_b3(K, lambda: Tr.ae_step(fs, xb, dom, 0.0,
                                                     None))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, per_step = [], []
    t0 = time.perf_counter()
    for i in range(AE_STEPS):
        K.reset_launch_counts()
        fs, loss = Tr.ae_step(fs, xb, dom, 1e-4 / 500000 * i, None)
        losses.append(float(loss))
        per_step.append(launch_counts())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / AE_STEPS
    out = {"size": SIZE, "batch": AE_BATCH, "depth": AE_KWARGS["deapth"],
           "c_base": AE_KWARGS["c_base"], "dtype": "bf16", "losses": losses,
           "ms_per_step": step_s * 1e3, "vol_per_s": AE_BATCH / step_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": per_step[0],
           "b3_bwd_recorded": {k: len(v) for k, v in sites.items()}}
    log(f"ae_step: {json.dumps(out)}")
    if (not all(np.isfinite(losses)) or any(c != per_step[0]
                                            for c in per_step)
            or min(_b3_counts(per_step[0]).values()) <= 0):
        raise AssertionError(f"ae_step: {out}")
    return out, sites


def classification_phase(K, gen, launch_counts):
    """Phase 9e: the classification baselines in bf16 through
    `_class_step`: DilatedCNN at 180^3 and VoxResNet (defaults: 32
    filters, stride 2, 3 stages) at 192^3, batch 10; one warm-up and
    CLASS_STEPS timed steps each; then one `class_train_step_accum`
    (micro 2) on DilatedCNN.  Their convs are cuDNN's: no kernel of the
    port launches (counts gated at 0)."""
    import torch

    from mri_epilepsy_diagnosis_torch import train as Tr
    from mri_epilepsy_diagnosis_torch.models import cnn
    from mri_epilepsy_diagnosis_torch.train.classification import _class_step

    out = {}
    zero = {k: 0 for k in launch_counts()}
    for name, size, factory in (
            ("dilated_cnn", DILATED_SIZE, lambda: cnn.DilatedCNN(
                input_shape=(DILATED_SIZE,) * 3, device="cuda")),
            ("voxresnet", SIZE, lambda: cnn.VoxResNet(
                input_shape=(SIZE,) * 3, device="cuda"))):
        state, _ = Tr.create_model_opt(factory(), None, lr=1e-5,
                                       device="cuda")
        x = torch.randn((CLASS_BATCH, size, size, size, 1), generator=gen,
                        device="cuda").to(torch.bfloat16)
        y = torch.arange(CLASS_BATCH, device="cuda") % 2
        _class_step(state, x, y, None, True)           # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        losses = []
        t0 = time.perf_counter()
        for _ in range(CLASS_STEPS):
            state, loss, probs = _class_step(state, x, y, None, True)
            losses.append(float(loss))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / CLASS_STEPS
        _expect_counts(f"{name} steps", launch_counts(), zero)
        res = {"size": size, "batch": CLASS_BATCH, "dtype": "bf16",
               "losses": losses, "ms_per_step": step_s * 1e3,
               "vol_per_s": CLASS_BATCH / step_s,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "f32_master_weights": all(
                   p.dtype == torch.float32
                   for p in state.model.parameters())}
        if name == "dilated_cnn":
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, aloss, aprobs = Tr.class_train_step_accum(
                state, x, y, None, micro=2)
            torch.cuda.synchronize()
            res["accum_micro2"] = {
                "loss": float(aloss), "ms": (time.perf_counter() - t0) * 1e3,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "probs_sum_to_one": bool(torch.allclose(
                    aprobs.sum(-1), torch.ones_like(aprobs[:, 0])))}
            losses.append(float(aloss))
        log(f"classification {name}: {json.dumps(res)}")
        if not (all(np.isfinite(losses)) and res["f32_master_weights"]):
            raise AssertionError(f"classification {name}: {res}")
        out[name] = res
        del state, x
        torch.cuda.empty_cache()
    return out


def kernel_entry(name, source, replaces, rows, errs, launches, per_batch,
                 **extra):
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
                      f"bf16 served batch at {SIZE}^3", **extra}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mri_epilepsy_diagnosis_torch.infer.serving import segment_volumes
    from mri_epilepsy_diagnosis_torch.models import UNet3D
    from mri_epilepsy_diagnosis_torch.models import fader as Fd
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
    build_s = time.perf_counter() - t0
    log(f"build: kernels built and loaded in {build_s:.2f} s")

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
    b1_sites = sites["conv2_packed"]
    if (len(b1_sites) != len(B1_SITES) or sites["bn_act_zero_pads"]
            or sum(s["fused"] for s in b1_sites) != len(B2_SITES)):
        raise AssertionError(f"unexpected site counts: {sites}")
    # B2 standalone at the fused sites' output shapes
    b2_sites = [{"x": (1, *(e + 1 for e in s["x"][1:4]), s["wp"][4])}
                for s in b1_sites if s["fused"]]
    with torch.inference_mode():
        b3_stacks = record_b3(K, lambda: clf(enc(probe)[0]))["stack"]
        ae = AE(**FADER_AE_KWARGS, up_block_kwargs=FADER_UP_BLOCK_KWARGS,
                device="cuda").eval()
        reference_init(ae, gen, "l_relu")
        recon = []
        ae_stacks = [st for st in record_b3(
            K, lambda: recon.append(ae(probe)))["stack"]
            if st["stride"] == (1, 1, 1)]
        recon = recon[0]
        if (len(b3_stacks) != len(B3_STACKS)
                or len(ae_stacks) != len(AE_B3_STACKS)
                or recon.shape != probe.shape
                or not torch.isfinite(recon).all()):
            raise AssertionError(f"unexpected fader stacks {b3_stacks}, "
                                 f"{ae_stacks} or AE output {recon.shape}")
        del ae, recon
        # every B1 site at batch 1 and BATCH without its epilogue (the
        # fused sites are held with it by fused_kernel_phase)
        b1_rows, b1_errs = forward_site_rows(
            K, [{**s, "fused": False} for s in b1_sites], gen, "serving",
            [(b, dn) for b in (1, BATCH) for dn in ("f32", "bf16")],
            (BATCH, "bf16"))
        fused_rows, fused_errs = fused_kernel_phase(K, P, b1_sites, gen)
        b2_rows, b2_errs = b2_kernel_phase(K, P, b2_sites, gen)
        sep_rows, sep_errs = sep_kernel_phase(
            K, [(n, st, 1) for n, st in zip(B3_STACKS, b3_stacks)], gen,
            [(b, dn) for b in (1, BATCH) for dn in ("f32", "bf16")],
            (BATCH, "bf16"))
        ae_sep_rows, ae_sep_errs = sep_kernel_phase(
            K, [(n, st, 1) for n, st in zip(AE_B3_STACKS, ae_stacks)], gen,
            [(1, "f32"), (1, "bf16")], (1, "bf16"))
        b3_rows, b3_errs = b3_kernel_phase(K, B3_SITES, axis_sites(b3_stacks),
                                           gen, (1, BATCH))
        ae_rows, ae_errs = b3_kernel_phase(K, AE_B3_SITES,
                                           axis_sites(ae_stacks), gen, (1,))
    b3_errs = {dn: max(b3_errs[dn], ae_errs[dn]) for dn in b3_errs}
    sep_errs = {dn: max(sep_errs[dn], ae_sep_errs[dn]) for dn in sep_errs}

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

    def launch_counts():
        return {"conv2_packed": K.conv2_packed.launches,
                "conv2_packed_tc": K.conv2_packed.tc_launches,
                "conv2_packed_dx": K.conv2_packed_dx.launches,
                "conv2_packed_dx_tc": K.conv2_packed_dx.tc_launches,
                "conv2_packed_as_bn_act": K.conv2_packed_as_bn_act.launches,
                "conv2_packed_as_bn_act_tc":
                    K.conv2_packed_as_bn_act.tc_launches,
                "bn_act_zero_pads": K.bn_act_zero_pads.launches,
                "conv_axis": K.conv_axis.launches,
                "separable_conv3d": K.separable_conv3d.launches,
                "conv_axis_dx": K.conv_axis_dx.launches,
                "conv_axis_dw": K.conv_axis_dw.launches}

    def counted(fn, per_batch):
        """Run fn with every launch count at 0 before it; each count after
        it must be `per_batch` times the batches."""
        K.reset_launch_counts()
        out = fn()
        counts = launch_counts()
        want = {k: c * n_batches for k, c in per_batch.items()}
        log("launches: " + ", ".join(f"{k} {counts[k]} (expected {w})"
                                     for k, w in want.items()))
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want}")
        return out, counts

    unet_per_batch = UNET_PER_BATCH
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

    ens_per_batch = ENSEMBLE_PER_BATCH
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
                "b3_bytes_per_batch": sum(r["bytes"] for r in sep_rows),
                "b3_per_axis_bytes_per_batch": sum(r["bytes"]
                                                   for r in b3_rows),
                "b3_gflop_per_batch": sum(r["flops"] for r in sep_rows) / 1e9,
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

    # ---- 6. training
    from mri_epilepsy_diagnosis_torch.train import seg as TS

    del vols, noise, model, params, ens_params, enc, clf
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    # 6a. every B1 launch and dw of one 192^3 batch-2 bf16 train step
    rec_model = UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
                       out_channels_first_layer=OCFL, device="cuda")
    random_state_dict(rec_model, gen)
    xr = torch.randn((TRAIN_BATCH, SIZE, SIZE, SIZE, 1), generator=gen,
                     device="cuda").to(torch.bfloat16)
    yr = (torch.rand(xr.shape, generator=gen, device="cuda") > 0.97).float()
    train_sites = record_train_sites(
        K, P, lambda: TS.packed_seg_loss(rec_model, xr, yr)[0].backward())
    dx_names, dw_names = name_train_sites(train_sites)
    del rec_model, xr, yr
    torch.cuda.empty_cache()
    # every forward site at TRAIN_BATCH, every dx at batch 1 and
    # TRAIN_BATCH, in f32 and bf16; dw in f32 at batch 1 and in bf16 at
    # TRAIN_BATCH; timed at TRAIN_BATCH in bf16
    train_rows, train_errs = backward_site_rows(
        K, P, train_sites["forward"], gen, "train",
        [(b, dn) for b in (1, TRAIN_BATCH) for dn in ("f32", "bf16")],
        (TRAIN_BATCH, "bf16"), dw_at=((1, "f32"), (TRAIN_BATCH, "bf16")))
    train_rows["forward"], train_errs["forward"] = forward_site_rows(
        K, train_sites["forward"], gen, "train forward",
        [(TRAIN_BATCH, "f32"), (TRAIN_BATCH, "bf16")], (TRAIN_BATCH, "bf16"))
    # 6b. f32 parity of the packed step (kernels) with the fine one (cuDNN)
    parity = parity_phase(TS, UNet3D, gen)
    torch.cuda.empty_cache()
    # 6c. training at full width through the entry points
    training = training_phase(K, P, UNet3D, gen, launch_counts)
    train_s = time.perf_counter() - t_train
    log(f"training phase: {train_s:.1f} s")

    # ---- 7. training as users run it
    import tempfile

    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    accumulation = accumulation_phase(K, UNet3D, gen, launch_counts)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        trained, resilient = resilient_phase(K, UNet3D, gen, launch_counts,
                                             ckpt_dir)
        torch.cuda.empty_cache()
        validation, val_rows = validation_phase(K, P, gen, launch_counts,
                                                trained, ckpt_dir)
    del trained
    phase7_s = time.perf_counter() - t7
    log(f"phase 7: {phase7_s:.1f} s")

    # ---- 8. segmentation from files
    import shutil

    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    cohort_dir = os.path.join("chiprun_out", "chip_smoke_cohort")
    try:
        phase8_parts_s = {}

        def lap(part):
            phase8_parts_s[part] = time.perf_counter() - t8 - sum(
                phase8_parts_s.values())

        ds, items, raw, cohort = cohort_phase(gen, cohort_dir)
        lap("8a")
        landmarks, prepped, preprocessing = preprocessing_phase(items, raw)
        del items, raw
        lap("8b")
        augmentation = augmentation_phase(prepped)
        torch.cuda.empty_cache()
        lap("8c")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as d:
            patch_state, from_files, patch_fwd_rows, patch_dx_rows = (
                files_training_phase(K, P, UNet3D, gen, launch_counts, ds,
                                     landmarks, d))
        torch.cuda.empty_cache()
        lap("8d")
        sliding, sw_rows = sliding_window_phase(
            K, P, UNet3D, patch_state, prepped[0], gen, launch_counts,
            cohort_dir)
        lap("8e")
    finally:
        # 4 subjects of 96 MB each: too large to bring back
        shutil.rmtree(cohort_dir, ignore_errors=True)
    del patch_state, prepped
    phase8_s = time.perf_counter() - t8
    log(f"phase 8: {phase8_s:.1f} s ({json.dumps(phase8_parts_s)})")

    # ---- 9. fader and classification training
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    fader, fader_rows, fader_errs = fader_phase(K, Fd, gen, launch_counts)
    torch.cuda.empty_cache()
    fader_parity = fader_parity_phase(K, Fd, gen)
    torch.cuda.empty_cache()
    ae_train, ae_sites = ae_phase(K, Fd, gen, launch_counts)
    torch.cuda.empty_cache()
    ae_bwd_rows, ae_bwd_errs = b3_bwd_rows(K, "ae", ae_sites, gen,
                                           [(None, "bf16")], (None, "bf16"))
    torch.cuda.empty_cache()
    # the AE's stacks (fused, or per-axis where too wide: those launches
    # are ae_bwd_rows' "axis" sites)
    ae_bwd_rows["stack"], ae_bwd_errs["stack"] = sep_kernel_phase(
        K, named_stacks("ae", ae_sites["stack"]), gen,
        [(1, "f32"), (None, "bf16")], (None, "bf16"), fused_only=False)
    torch.cuda.empty_cache()
    classification = classification_phase(K, gen, launch_counts)
    phase9_s = time.perf_counter() - t9
    log(f"phase 9: {phase9_s:.1f} s")

    # the kernels of the served path, one entry per kernel instantiation:
    # launches from the timed ensemble run, times summed over the sites
    # each serves in bf16.  B1 and its B2-epilogue launches are counted
    # apart (the wrappers' counters), so the entries do not overlap.
    c = ens_counts
    fused_sites = set(B2_SITES)
    tc_rows = [r for r in b1_rows
               if r["route"] == "tc" and r["site"] not in fused_sites]
    f_tc = [r for r in fused_rows if r["route"] == "tc"]
    f_cc = [r for r in fused_rows if r["route"] == "cuda_core"]
    src = "mri_epilepsy_diagnosis_torch/csrc/"
    tpu = "mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py:"
    b2_split = {
        "b2_fused_sites": list(B2_SITES),
        "fused_ms": sum(r["ms"] for r in fused_rows),
        "same_launches_without_epilogue_ms": sum(r["unfused_ms"]
                                                 for r in fused_rows),
        "replaced_b1_add_b2_ms": sum(r["replaced_ms"] for r in fused_rows),
        "b2_standalone_ms": sum(r["ms"] for r in b2_rows)}
    kernels = [
        kernel_entry("conv2_packed_tc", src + "conv2_packed_tc.cu",
                     tpu + "265", tc_rows,
                     {"f32": None, "bf16": b1_errs["tc"]["bf16"]},
                     c["conv2_packed_tc"] - c["conv2_packed_as_bn_act_tc"],
                     B1_TC_PER_BATCH - len(f_tc), path="serving"),
        kernel_entry("conv2_packed_tc_bn_act", src + "conv2_packed_tc.cu",
                     tpu + "197", f_tc,
                     {"f32": None, "bf16": fused_errs["tc"]["bf16"]},
                     c["conv2_packed_as_bn_act_tc"], len(f_tc),
                     fuses=tpu + "265 (B1) + " + tpu + "197 (B2)",
                     b2=b2_split, path="serving"),
        kernel_entry("conv2_packed_bn_act", src + "conv2_packed.cu",
                     tpu + "197", f_cc, fused_errs["cuda_core"],
                     c["conv2_packed_as_bn_act"]
                     - c["conv2_packed_as_bn_act_tc"], len(f_cc),
                     fuses=tpu + "265 (B1) + " + tpu + "197 (B2)",
                     b2=b2_split, path="serving"),
        kernel_entry("separable_conv3d", src + "separable_conv3d.cu",
                     tpu + "70", sep_rows, sep_errs,
                     c["separable_conv3d"], len(B3_STACKS), path="serving",
                     fuses="three " + tpu + "70 calls of " + tpu
                     + "148 separable_conv3d",
                     per_axis_ms=sum(r["per_axis_ms"] for r in sep_rows),
                     cudnn_3calls_ms=sum(r["cudnn_3calls_ms"]
                                         for r in sep_rows)),
    ]
    # training: launches from the timed train steps, times summed over the
    # sites of one step (batch 2, bf16); B1's forward on tensor cores, the
    # stem's forward on the CUDA-core kernel, and the input gradients
    t = training["launches_timed_steps"]
    per_step = (f"sum over the sites of one batch-{TRAIN_BATCH} bf16 train "
                f"step at {SIZE}^3; launches from {TIMED_STEPS} steps")
    fwd_tc = [r for r in train_rows["forward"] if r["route"] == "tc"]
    fwd_cc = [r for r in train_rows["forward"] if r["route"] == "cuda_core"]
    kernels += [
        kernel_entry("conv2_packed_tc.train_forward",
                     src + "conv2_packed_tc.cu", tpu + "265", fwd_tc,
                     {"f32": None,
                      "bf16": train_errs["forward"]["tc"]["bf16"]},
                     t["conv2_packed_tc"] - t["conv2_packed_dx_tc"],
                     len(fwd_tc), path="training", shapes=per_step),
        kernel_entry("conv2_packed.train_stem", src + "conv2_packed.cu",
                     tpu + "265", fwd_cc, train_errs["forward"]["cuda_core"],
                     t["conv2_packed"] - t["conv2_packed_tc"]
                     - (t["conv2_packed_dx"] - t["conv2_packed_dx_tc"]),
                     len(fwd_cc), path="training", shapes=per_step),
        kernel_entry("conv2_packed_tc.dx", src + "conv2_packed_tc.cu",
                     tpu + "265", train_rows["dx"],
                     {"f32": None, "bf16": train_errs["dx"]["tc"]["bf16"]},
                     t["conv2_packed_dx_tc"], len(DX_SITES), path="training",
                     shapes=per_step, gradient_of="mri_epilepsy_diagnosis_tpu"
                     "/ops/packed.py:230 (_conv3_packed_bwd), :479 "
                     "(_conv3_packed_as_bwd)",
                     max_abs_err_f32_cuda_core=train_errs["dx"]["cuda_core"]
                     ["f32"]),
    ]
    # the f32 validation forward of phase 7c: B1 on the CUDA-core kernel,
    # with B2 fused at the aligned->shifted sites
    v = validation["launches"]
    val_errs = validation["kernel_max_abs_err"]
    per_val = (f"sum over the sites of one batch-{VAL_BATCH} f32 "
               f"validation forward at {SIZE}^3; launches from "
               f"{VAL_SUBJECTS} subjects")
    kernels += [
        kernel_entry("conv2_packed.validate_f32", src + "conv2_packed.cu",
                     tpu + "265", [r for r in val_rows if not r["fused"]],
                     {"f32": val_errs["cuda_core"]["f32"],
                      "bf16": val_errs["cuda_core"]["f32"]},
                     _counted_b1(v)["conv2_packed"],
                     len(B1_SITES) - len(B2_SITES), path="validation",
                     shapes=per_val),
        kernel_entry("conv2_packed_bn_act.validate_f32",
                     src + "conv2_packed.cu", tpu + "197",
                     [r for r in val_rows if r["fused"]],
                     {"f32": val_errs["cuda_core_bn_act"]["f32"],
                      "bf16": val_errs["cuda_core_bn_act"]["f32"]},
                     _counted_b1(v)["conv2_packed_bn_act"], len(B2_SITES),
                     fuses=tpu + "265 (B1) + " + tpu + "197 (B2)",
                     path="validation", shapes=per_val),
    ]
    # phase 8: one bf16 sliding-window call (batch 64 of 64^3 patches) and
    # the timed batch-16 64^3 patch train steps
    sw = sliding["launches"]["bf16_crop"]
    per_sw = (f"sum over the sites of one batch-{SW_BATCH} bf16 sliding-"
              f"window call on {PATCH}^3 patches of a {SIZE}^3 volume; "
              "launches from that call")
    sw_sel = {"tc": [r for r in sw_rows if r["route"] == "tc"
                     and not r["fused"]],
              "tc_bn_act": [r for r in sw_rows if r["route"] == "tc"
                            and r["fused"]],
              "bn_act": [r for r in sw_rows if r["route"] == "cuda_core"
                         and r["fused"]]}
    # the f32 call takes the CUDA-core kernel at every site: its errors
    # stand beside the tensor-core entries of the same sites
    sw_errs = sliding["kernel_max_abs_err"]
    fuses = tpu + "265 (B1) + " + tpu + "197 (B2)"
    kernels += [
        kernel_entry("conv2_packed_tc.sliding_window",
                     src + "conv2_packed_tc.cu", tpu + "265", sw_sel["tc"],
                     {"f32": None, "bf16": sw_errs["tc"]["bf16"]},
                     _counted_b1(sw)["conv2_packed_tc"],
                     len(sw_sel["tc"]), path="sliding_window", shapes=per_sw,
                     max_abs_err_f32_cuda_core=sw_errs["cuda_core"]["f32"]),
        kernel_entry("conv2_packed_tc_bn_act.sliding_window",
                     src + "conv2_packed_tc.cu", tpu + "197",
                     sw_sel["tc_bn_act"],
                     {"f32": None, "bf16": sw_errs["tc_bn_act"]["bf16"]},
                     _counted_b1(sw)["conv2_packed_tc_bn_act"],
                     len(sw_sel["tc_bn_act"]), fuses=fuses,
                     path="sliding_window", shapes=per_sw,
                     max_abs_err_f32_cuda_core=sw_errs["cuda_core_bn_act"]
                     ["f32"]),
        kernel_entry("conv2_packed_bn_act.sliding_window",
                     src + "conv2_packed.cu", tpu + "197", sw_sel["bn_act"],
                     sw_errs["cuda_core_bn_act"],
                     _counted_b1(sw)["conv2_packed_bn_act"],
                     len(sw_sel["bn_act"]), fuses=fuses,
                     path="sliding_window", shapes=per_sw),
    ]
    pt = from_files["patches"]["launches_timed_steps"]
    per_patch = (f"sum over the sites of one batch-{PATCH_BATCH} bf16 train "
                 f"step on {PATCH}^3 patches; launches from {PATCH_STEPS} "
                 "steps")
    pf_tc = [r for r in patch_fwd_rows if r["route"] == "tc"]
    pf_cc = [r for r in patch_fwd_rows if r["route"] == "cuda_core"]
    pf_errs = from_files["patches"]["forward_max_abs_err"]
    pdx_errs = from_files["patches"]["dx_max_abs_err"]
    kernels += [
        kernel_entry("conv2_packed_tc.patch_train_forward",
                     src + "conv2_packed_tc.cu", tpu + "265", pf_tc,
                     pf_errs["tc"], _counted_b1(pt)["conv2_packed_tc"],
                     len(pf_tc), path="patch_training", shapes=per_patch),
        kernel_entry("conv2_packed.patch_train_stem", src + "conv2_packed.cu",
                     tpu + "265", pf_cc, pf_errs["cuda_core"],
                     _counted_b1(pt)["conv2_packed"], len(pf_cc),
                     path="patch_training", shapes=per_patch),
        kernel_entry("conv2_packed_tc.patch_dx", src + "conv2_packed_tc.cu",
                     tpu + "265", patch_dx_rows, pdx_errs["tc"],
                     pt["conv2_packed_dx_tc"], len(patch_dx_rows),
                     path="patch_training", shapes=per_patch,
                     gradient_of="mri_epilepsy_diagnosis_tpu/ops/packed.py:"
                     "230 (_conv3_packed_bwd), :479 (_conv3_packed_as_bwd)"),
    ]
    # phase 9: the B3 backward of the fader alternation, summed over the
    # calls of one batch (3 disc_step + 1 enc_clf_step, batch 35, bf16)
    fb = fader["launches_timed_batches"]
    per_alt = (f"sum over the calls of one fader alternation batch "
               f"({FADER_DISC_LOOP} disc_step + 1 enc_clf_step) at batch "
               f"{FADER_BATCH}, bf16, {SIZE}^3; launches from "
               f"{FADER_TIMED_BATCHES} batches")
    grad_of = (tpu + "70 (conv_axis_last, through :131 conv_one_axis and "
               ":148 separable_conv3d; the JAX package takes this gradient "
               "through XLA convolutions)")
    kernels += [
        kernel_entry("separable_conv3d.fader_training",
                     src + "separable_conv3d.cu", tpu + "70",
                     fader_rows["stack"], fader_errs["stack"],
                     fb["separable_conv3d"],
                     fader["launches_per_batch"]["separable_conv3d"],
                     path="fader_training", shapes=per_alt,
                     fuses="three " + tpu + "70 calls of " + tpu
                     + "148 separable_conv3d",
                     per_axis_ms=sum(r["per_axis_ms"]
                                     for r in fader_rows["stack"]),
                     cudnn_3calls_ms=sum(r["cudnn_3calls_ms"]
                                         for r in fader_rows["stack"]),
                     max_abs_err_ae_bf16=ae_bwd_errs["stack"]["bf16"],
                     max_abs_err_ae_f32=ae_bwd_errs["stack"]["f32"]),
        kernel_entry("conv_axis_dx", src + "conv_axis_bwd.cu", tpu + "70",
                     fader_rows["dx"], fader_errs["dx"], fb["conv_axis_dx"],
                     fader["launches_per_batch"]["conv_axis_dx"],
                     path="fader_training", shapes=per_alt,
                     gradient_of=grad_of,
                     max_abs_err_ae_bf16=ae_bwd_errs["dx"]["bf16"]),
        kernel_entry("conv_axis_dw", src + "conv_axis_bwd.cu", tpu + "70",
                     fader_rows["dw"], fader_errs["dw"], fb["conv_axis_dw"],
                     fader["launches_per_batch"]["conv_axis_dw"],
                     path="fader_training", shapes=per_alt,
                     gradient_of=grad_of,
                     max_abs_err_ae_bf16=ae_bwd_errs["dw"]["bf16"]),
        kernel_entry("conv_axis", src + "conv_axis.cu", tpu + "70",
                     fader_rows["axis"], fader_errs["axis"], fb["conv_axis"],
                     fader["launches_per_batch"]["conv_axis"],
                     path="fader_training", shapes=per_alt,
                     role="recomputes the stacks' intermediates in the "
                     "backward; the per-axis route of wide AE stacks",
                     max_abs_err_ae_bf16=ae_bwd_errs["axis"]["bf16"]),
    ]
    # every entry's launches on each path driven with the counts at 0
    paths = {"serving_ensemble": c, "train_step": t,
             "fader_alternation": fb,
             "ae_step": ae_train["launches_per_step"],
             "accumulated_step": accumulation["launches"],
             "resilient_training": resilient["launches"],
             "validation_f32": v,
             "whole_volumes_from_files": from_files["whole"]["launches"],
             "patch_epoch_from_files":
                 from_files["patches"]["launches_epoch"],
             "patch_train_steps": pt, "sliding_window_bf16": sw}
    counted_as = {"conv2_packed_tc.train_forward": "conv2_packed_tc",
                  "conv2_packed.train_stem": "conv2_packed",
                  "conv2_packed.validate_f32": "conv2_packed",
                  "conv2_packed_bn_act.validate_f32": "conv2_packed_bn_act",
                  "conv2_packed_tc.sliding_window": "conv2_packed_tc",
                  "conv2_packed_tc_bn_act.sliding_window":
                      "conv2_packed_tc_bn_act",
                  "conv2_packed_bn_act.sliding_window": "conv2_packed_bn_act",
                  "conv2_packed_tc.patch_train_forward": "conv2_packed_tc",
                  "conv2_packed.patch_train_stem": "conv2_packed",
                  "conv2_packed_tc.patch_dx": "conv2_packed_tc.dx",
                  "separable_conv3d.fader_training": "separable_conv3d"}
    for entry in kernels:
        key = counted_as.get(entry["name"], entry["name"])
        entry["launches_by_path"] = {p: _counted_b1(n)[key]
                                     for p, n in paths.items()}
        if entry["launches"] <= 0:
            raise AssertionError(f"{entry['name']} was not launched on its "
                                 "path")
    dw_rows = train_rows["dw"]
    dw = {"route": training["dw_route"],
          "ms": sum(r["ms"] for r in dw_rows),
          "einsum_f32_ms": sum(r["einsum_f32_ms"] for r in dw_rows),
          "library_ms": sum(r["library_ms"] for r in dw_rows),
          "bound_ms": sum(r["bound_ms"] for r in dw_rows),
          "flops": sum(r["flops"] for r in dw_rows),
          "max_abs_err": train_errs["dw"], "shapes": per_step}
    log(f"dw (cuBLAS GEMMs, not a kernel of the port): {json.dumps(dw)}")
    # the counterparts of the JAX functions that the served path no longer
    # launches (0 launches there), with their phase-3 numbers
    cc_rows = [r for r in b1_rows if r["route"] == "cuda_core"]
    off_path = [
        kernel_entry("conv2_packed", src + "conv2_packed.cu", tpu + "265",
                     cc_rows, b1_errs["cuda_core"],
                     c["conv2_packed"] - c["conv2_packed_tc"]
                     - (c["conv2_packed_as_bn_act"]
                        - c["conv2_packed_as_bn_act_tc"]), 0),
        kernel_entry("bn_act_zero_pads", src + "bn_act_zero_pads.cu",
                     tpu + "197", b2_rows, b2_errs, c["bn_act_zero_pads"],
                     0),
    ]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "off_path_kernels": off_path,
                   "b1_sites": b1_rows, "b2_fused_sites": fused_rows,
                   "b2_sites": b2_rows, "b3_fused_stacks": sep_rows,
                   "ae_b3_fused_stacks": ae_sep_rows, "b3_sites": b3_rows,
                   "ae_b3_sites": ae_rows, "serving": serving,
                   "ensemble": ensemble, "profile": profile,
                   "profile_ensemble": ens_profile,
                   "train_sites": train_sites,
                   "train_site_names": {"dx": dx_names, "dw": dw_names},
                   "train_forward_sites": train_rows["forward"],
                   "train_dx_sites": train_rows["dx"],
                   "train_dw_sites": dw_rows, "dw": dw,
                   "train_errs": train_errs, "parity_f32": parity,
                   "training": training, "training_phase_s": train_s,
                   "accumulation": accumulation, "resilient": resilient,
                   "validation": validation, "validation_sites": val_rows,
                   "phase7_s": phase7_s,
                   "cohort": cohort, "preprocessing": preprocessing,
                   "augmentation": augmentation, "from_files": from_files,
                   "patch_train_forward_sites": patch_fwd_rows,
                   "patch_train_dx_sites": patch_dx_rows,
                   "sliding_window": sliding, "sliding_window_sites": sw_rows,
                   "phase8_s": phase8_s, "phase8_parts_s": phase8_parts_s,
                   "fader": fader, "fader_bwd_sites": fader_rows,
                   "fader_parity_f32": fader_parity, "ae_train": ae_train,
                   "ae_bwd_sites": ae_bwd_rows,
                   "b3_per_axis_serving_sites": {"rows": b3_rows,
                                                 "errs": b3_errs},
                   "classification": classification, "phase9_s": phase9_s,
                   "build_s": build_s,
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
