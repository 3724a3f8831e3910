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
     through `conv_axis` (`F.conv3d` as its yardstick; bf16 takes the
     tensor-core kernel of `conv_axis_tc.cu`, f32 `conv_axis.cu`); the
     stride-1 stacks of one fader AE forward likewise at batch 1;
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
      input takes none), and the 12 weight gradients (`_dw_packed_qgroup`
      over the saved, unpadded input: `dw_packed`, in bf16 one split-K
      wgmma launch of `csrc/dw_packed_tc.cu` and its fold, float32 out).
      Each site's forward at batch 2 and dx at batch 1 and 2, in f32 and
      bf16, is held against the plain version, dw against an f32 einsum
      (bf16 on the kernel, f32 on the plain GEMMs), and all three are timed
      beside cuDNN's `convolution_backward` of the same packed conv; the
      step's BatchNorm tail (`BnActTrainPacked`, `csrc/bn_train_packed.cu`:
      9 statistics, 10 apply, 10 backward reduction and 10 dx passes) is
      recorded too, and each pass at its shape is held against its plain
      version and timed beside it and its byte bound, on parameters
      built as the Function builds them (the dx pass's statistics term
      at least 16 bf16 steps of max|dy|, so a dx kernel that dropped it
      would fail);
   b. f32 parity at 64^3, batch 1, TF32 off: the packed step's loss,
      gradients and running statistics against the fine UNet3D train
      step (cuDNN);
   c. `train_segmentation` (packed, bf16, one epoch of 3 batches of 2
      T1w-like 192^3 volumes with FreeSurfer-style labels, a validation
      batch, a checkpoint into `chiprun_out/` that is reloaded), then 1
      warm-up and 5 timed `packed_seg_train_step`s: finite and falling
      losses, float32 master weights, exact launch counts per step (B1 23,
      22 on tensor cores, 11 of them input gradients; B2 0; the tail's
      passes 9, 10, 10, 10 and no call of their plain versions), ms per
      step, vol/s, peak memory, and the B1-forward / B1-dx / dw / other split
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
      trainer; every B1 launch and every pass of the BatchNorm tail of a
      batch-16 patch step against its plain version (the tail's passes
      timed beside theirs and their byte bound); 5 timed steps with exact
      launch counts (B1 23, 22 on tensor cores, 11 dx; the tail's passes
      9, 10, 10, 10, no plain call), the device split of a step, and the
      device idle share of a profiled epoch from files;
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
      `conv3d_input` / `conv3d_weight` / `conv3d`; each site's route
      (bf16: the tensor-core kernels of `conv_axis_tc.cu` and
      `conv_axis_bwd_tc.cu`; f32: the CUDA-core ones of `conv_axis.cu` and
      `conv_axis_bwd.cu`); two bf16 `conv_axis` calls equal bit for bit;
      each stack's time on the fused and on the per-axis route;
   b. the alternation of `examples/train_fader.py` (3 `disc_step`s and one
      `enc_clf_step` a batch, Adam 7e-4 / 7e-4 / 5e-4, lambda ramp, class
      weight [1, 2]): exact launch counts per batch (fused 17, `conv_axis`
      14, dw 21, dx 20, every conv_axis, dw and dx on tensor cores), ms
      per batch,
      vol/s, peak memory, finite losses,
      float32 master weights, one profiled batch (host syncs and copies
      counted; its idle share also with the device alone traced); then
      `train_fader` over
      two batches and a validation batch;
   c. f32 parity at 48^3, depth 2: one `enc_clf_step` and one `disc_step`
      with the kernels against the same steps with per-axis cuDNN convs
      (loss 1e-5, gradients 2e-2 x max, running statistics 1e-5); their
      recomputes stay on `conv_axis.cu` (no tensor-core launch);
   d. `ae_step` at 192^3 with `examples/train_ae.py`'s settings (depth 6,
      c_base 16, batch 3, bf16), its B3 sites checked and timed as in
      9a (its stacks in f32 at batch 1), fused or per-axis as the plan
      routes them, each stack timed on both routes; ms per step, peak
      memory, every conv_axis, dw and dx launch on tensor cores;
   e. bf16 `_class_step`s of DilatedCNN (180^3) and VoxResNet (192^3) at
      batch 10, and one `class_train_step_accum` (micro 2): ms per step,
      vol/s, peak memory (cuDNN convs: no kernel of the port launches).
10. detection on a synthetic template on the 1 mm MNI152 grid
   (182 x 218 x 182, made from a seed: `mni_template`), f32 (no kernel of
   the port launches: counts gated at 0):
   a. registration (`transforms/registration.py`): `apply_transform`,
      20 Adam steps of `_register_level` at level 4 (dof 9 and 12) and
      `bias_field_correction`, card against the port on the CPU; the
      quality gates of `tests/test_transforms.py` at full size (the
      dof-9 misalignment: NCC against the true inverse's, gray-mask Dice,
      the moved mask's Dice; a quarter turn with dof 6 through the coarse
      search); `register_img_and_mask` from NIfTI files with another
      world grid, a bias field and a lesion mask that must land; ms of
      the grid's scores, its 16 refinements, each pyramid level's step,
      the bias fit, a subject; peak memory; the idle share of a profiled
      descent;
   b. detection (`data/patches.py`, `models/patch_model.py`,
      `infer/detection.py`): a bright lesion in the template, its patches
      and labels (host ms), PatchModel's forward on 512 patches against
      the CPU, training at batch 128 with Adam 3e-4 through
      `train_classifier` (ms per step, patches/s, peak memory, falling
      losses), then `FCDMaskGenerator.inference_pipeline` from NIfTI
      files at batch 512 (host and device ms, idle share, IoU against the
      lesion and the mask read back from disk).
11. int8 serving:
   a. the phase-4 UNet calibrated on 2 of its volumes and quantized
      (`models/unet_packed_q.py::quantize_inference`); every K1
      (`conv2_packed_s8`: `csrc/conv2_packed_s8_tc.cu`, wgmma, at 9
      sites, `csrc/conv2_packed_s8.cu`, mma.sync, at the stem) and K2
      (`upconv_packed_s8`, `csrc/upconv_packed_s8.cu`, wgmma: d0 and d1)
      launch of its 192^3 int8 trunk, recorded at batch 1, against its
      plain version (float64 sums): int32 and fused-epilogue int8 outputs
      equal exactly, each site on its route; ms at batch 8, the plain ms
      at batch 1, the bound (int8 operations at 1,979 TOP/s or bytes at
      3.35 TB/s), the share of the int8 peak, and the bf16 B1 launch at
      the same site (for K2 also `upsample2_packed` and the float
      composed up-conv, one cuDNN transposed conv);
   b. the 16 volumes served through `segment_volumes(mask_fn=
      packed_unet_mask_v2_int8)` at batch 8: masks against phase 4's f32
      fine masks (agreement >= 0.995, JAX's gate; foreground Dice >= 0.9),
      exact launch counts per batch (K1 10, all with the epilogue fused,
      9 on wgmma, K2 2, no other kernel of the port), vol/s, batch latency, a
      profiled batch beside phase 4's bf16 numbers.
12. the segmentation model zoo (`ZOO`: ResidualUNet3D with and without
   Bayesian convs, Modified3DUNet, BraTSUnet, at the JAX package's
   default widths with one channel and two classes) through
   `train/seg.py::seg_train_step`; cuDNN convs and plain torch, so no
   kernel of the port launches (counts gated at 0 over the phase):
   a. parity at 64^3, batch 1, TF32 off, card against the port on
      the CPU with one host draw of noise and Dropout masks: train-mode
      logits (1e-4 x max) and one step's loss (1e-5) in f32, every
      gradient of that step in f64 (1e-10 x max|ref| per tensor; the f32
      ones are recorded), and the card's AdamW step applied to the CPU's
      gradients against the CPU's parameters (1e-6);
   b. bf16 steps at 64^3 batch 16 (phase 8d's patches) and 192^3 batch
      1 (a whole volume): ms per step, patches or volumes per second,
      peak memory, finite and falling losses; `seg_eval_step` ms at
      192^3;
   c. one profiled 192^3 step: device time split into cuDNN conv, norm,
      resize, copies, strided-tensor copies and elementwise
      (`zoo_split`), and the idle share
      (recorded, not gated).
13. the packed encoders:
   a. the fader encoder of phase 4 (one train-mode pass moves its running
      statistics) through `models/fader_packed.py::encoder_apply_packed`
      at batch 8: its B3 calls recorded in bf16 (e0 one fused
      `separable_conv3d`, e1 and e2 three `conv_axis` each: 1 + 6 per
      forward, in f32 too, asserted) and each held against its plain
      version in f32 and bf16 (timed beside cuDNN); the latent against the
      fine `Encoder` (f32 within 1e-4 x max); ms per batch packed, fine
      and fused; then the 16 volumes of phase 4 served as the ensemble
      with `classify_fn` on the packed encoder: exact launch counts per
      batch (phase 4's UNet, 2 fused stacks, 6 `conv_axis` on tensor
      cores), probabilities within 0.1 of phase 4's, the same masks, vol/s
      and batch latency beside phase 4's, a profiled batch;
   b. `models/fader.py::encoder_apply_fused` (one cuDNN conv a block) at
      batch 8, f32 and bf16: the latent against the fine `Encoder`, ms
      per batch, no kernel of the port launched;
   c. `models/voxresnet_packed.py`: f32 parity with the fine port (cuDNN,
      TF32 off) at 64^3 (4 stages, 2 filters) and 32^3 (stride 1, the
      cuDNN stem): eval and train logits, running statistics, every
      gradient (against the fine model with the packed step's ReLU
      masks), exact B1 counts; then bench.py's configuration (192^3,
      batch 10, 32 filters, 4 stages, dropout 0.5, 192 FC units, Adam
      1e-5 with L2 decay 0.01) in bf16: every distinct B1 site of the step
      (forward, dx, and the eval forward's B2-fused launches) against its
      plain version, timed beside cuDNN's conv of the fine layer; 1
      warm-up and 5 timed packed steps through `run_one_epoch(...,
      packed=True)`'s route (B1 43 per step: 22 forward, 17 of them at
      stride 1 and 5 at stride 2, 21 dx, all on tensor cores; the
      BatchNorm tail's Function 22 sites x 4 passes, no plain pass and no
      plain BatchNorm composition), the same for the fine `_class_step`,
      ms, vol/s, peak memory, a profiled step each (idle share; B1
      forward, B1 dx, dw, the BatchNorm tail, cuDNN, other); every
      pass of the step's BatchNorm tail against its plain version and
      timed (the kernels line's `bn_train_packed.voxresnet_training`),
      every distinct dw site against an f32 einsum and timed
      (`dw_packed.voxresnet_training`, 22 launches and folds a step);
      one eval forward (22 B1, 9 with B2 fused).
14. distribution: an NCCL process group of world size 1 (one card: NCCL
   refuses two ranks on one device, so ranks > 1 are held on the CPU by
   gloo in tests/test_torch_parallel.py) and a (data, spatial) = (1, 1)
   mesh, through the code paths of the CPU tests:
   a. one 192^3 batch-2 bf16 `packed_seg_train_step` under the mesh beside
      the same step without it, from one state: loss, gradients and
      running statistics at phase 6b's tolerances, parameters within one
      AdamW step's bound, B1 23 per step either way (22 on tensor cores,
      11 dx); ms per step with and without the mesh; the NCCL kernels'
      count and device time in one profiled mesh step;
   b. phase 4's volumes through `segment_volumes(..., sharding=
      data_sharding(mesh))`: phase 4's masks and launch counts;
   c. `sliding_window_predict` through `make_sharded_apply` in f32: logits
      within phase 8e's tolerance of the unsharded call, equal counts;
   d. fault C3's gate: the fine UNet3D and ResidualUNet3D forwards in
      float32 with cuDNN allowed TF32 (torch's default) against the CPU,
      1e-4 x max|ref|.
15. observability and the examples (`obs/`, `examples/torch_*.py`), each
   example called in this process through its `main(argv)`:
   a. one served bf16 batch of phase 4 inside `obs.profile_trace`: the
      trace reader (`obs/trace_summary.py`) counts every port kernel's
      launches as the same profiler's `key_averages()` does (B1 12, 5 of
      them with B2 fused), device ms within 1%, and attributes copies to
      the port's source lines; in phase 14's profiled mesh step it counts
      21 all-reduces.  The profiler drops a kernel's record now and then:
      a window whose trace holds a launch without its kernel is traced
      again (here and in b and e);
   b. `torch_train_segmentation.py` at phase 6's configuration (192^3,
      batch 2, bf16, packed): every step's launch counts (B1 23), the
      first step's in the trace (23, 22 on tensor cores, 11 dx), one
      finite logged loss a step, a checkpoint; `obs.StepTimer` times the
      steps;
   c. `torch_infer_whole_brain.py` on phase 4's weights as a `.pth` and
      its first volume as NIfTI (f32, packed): the mask against phase 4's
      served bf16 mask (>= 0.99) and the fine f32 one (>= 0.999), phase
      7c's launch counts;
   d. `obs.analysis.collect_latents` with phase 4's fader encoder and
      classifier over the 16 volumes at batch 8 (4 fused B3 a batch),
      f32 latents against the CPU's (1e-4 x max); `pca_embed` and t-SNE's
      objective on the card against the CPU; full exact t-SNE runs on the
      card and the CPU (on the latents recorded, on a curve gated: KL 1%,
      trustworthiness 0.01);
   e. `torch_train_fader.py --synthetic --img-size 192 --bf16` for one
      epoch: each alternation batch's counts (phase 9's: fused B3 17, dx
      20, dw 21, recomputes 14), the first batch's in the trace, the
      validation forward's counted apart.

It prints one line per check, then `{"kernels": [...]}` (the kernels of
the served path: B1 on tensor cores, B2 fused into B1 on either route,
fused B3; of the training path: B1's forward on tensor cores, the
stem's forward on CUDA cores, B1 as input gradient; of f32 validation;
of the BatchNorm tail's passes and of dw (`csrc/dw_packed_tc.cu`) on
the training, patch-training and VoxResNet training paths;
of phase 8's sliding window and patch training; of phase 9's fader
training: fused B3, B3's dx and dw and the `conv_axis` recomputes on
tensor cores; of phase 11's int8 serving: K1 on its wgmma route and on
the stem's mma.sync route, and K2; of phase 13: B1 forward and dx of the
packed VoxResNet step, B1 with B2 fused in its eval forward, fused B3 and
`conv_axis` on the packed ensemble; the standalone
B2, off every path, goes to the JSON file with its numbers), the card's
`nvidia-smi` name and power limit, and last
`{"ok": true, "device": {...}}`.  Per-site numbers also go to
`chiprun_out/chip_smoke.json`.  Exits nonzero without printing a result
when no CUDA device is available or the port's package is missing.
"""
from __future__ import annotations

import contextlib
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
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}

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
                  "conv_axis_tc": 0, "separable_conv3d": 0,
                  "conv_axis_dx": 0, "conv_axis_dw": 0,
                  "conv_axis_dx_tc": 0, "conv_axis_dw_tc": 0,
                  "bn_train_stats": 0, "bn_train_apply": 0,
                  "bn_train_reduce": 0, "bn_train_dx": 0,
                  "dw_packed": 0, "dw_packed_fold": 0}
ENSEMBLE_PER_BATCH = {**UNET_PER_BATCH, "separable_conv3d": len(B3_STACKS)}

# training (phase 6): a packed train step launches B1 for each of the 12
# convs (none with the B2 epilogue: BN needs the batch statistics of the
# conv's output) and for each input gradient but the stem's input (11).
# In bf16 all but the 8Ci = 8 stem forward take the tensor cores: every
# dx has 8Ci and 8Co multiples of 64.  The tail of each of the 10
# ConvBlocks is one `BnActTrainPacked`: an apply pass forward and a
# reduction and a dx pass backward each, a statistics pass for all but
# the stem's conv1, which has no BatchNorm.  Each conv's weight gradient
# is one `dw_packed` launch and its fold.
TRAIN_BATCH = 2
TRAIN_BATCHES = 3              # training loader of train_segmentation
TIMED_STEPS = 5
DX_SITES = B1_SITES[1:]
BN_TAILS = 2 * (2 * (BLOCKS - 1) + 1)   # two ConvBlocks a block
TRAIN_PER_STEP = {"conv2_packed": len(B1_SITES) + len(DX_SITES),
                  "conv2_packed_tc": len(B1_SITES) - 1 + len(DX_SITES),
                  "conv2_packed_dx": len(DX_SITES),
                  "conv2_packed_dx_tc": len(DX_SITES),
                  "conv2_packed_as_bn_act": 0, "conv2_packed_as_bn_act_tc": 0,
                  "bn_act_zero_pads": 0, "conv_axis": 0,
                  "conv_axis_tc": 0, "separable_conv3d": 0,
                  "conv_axis_dx": 0, "conv_axis_dw": 0,
                  "conv_axis_dx_tc": 0, "conv_axis_dw_tc": 0,
                  "bn_train_stats": BN_TAILS - 1, "bn_train_apply": BN_TAILS,
                  "bn_train_reduce": BN_TAILS, "bn_train_dx": BN_TAILS,
                  "dw_packed": len(B1_SITES),
                  "dw_packed_fold": len(B1_SITES)}
BN_PASSES = ("bn_train_stats", "bn_train_apply", "bn_train_reduce",
             "bn_train_dx")
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
    # in bf16 every recompute, dw and dx takes the tensor-core kernels
    for d in (enc_clf, disc):
        d["conv_axis_tc"], d["conv_axis_dw_tc"], d["conv_axis_dx_tc"] = (
            d["conv_axis"], d["conv_axis_dw"], d["conv_axis_dx"])
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

# phase 10: detection on the card.  The reference registers each detection
# subject to the 1 mm MNI152 grid (FSL FLIRT and FAST), cuts hemisphere-
# pair patches guided by the MNI152 gray-matter template and trains and
# applies PatchModel on them (`detection/`).  The repository holds no
# template, so a synthetic one on the same grid, made from a seed, stands
# in for it: a folded cortical shell around white matter, deep nuclei,
# ventricles and a cerebellum, inside a zero margin, with the gray-matter
# probability map derived from the same tissue model.
MNI_SHAPE = (182, 218, 182)
MNI_AFFINE = ((-1.0, 0.0, 0.0, 90.0), (0.0, 1.0, 0.0, -126.0),
              (0.0, 0.0, 1.0, -72.0), (0.0, 0.0, 0.0, 1.0))
REG_PARITY_ITERS = 20          # 10a: Adam steps at level 4, card vs CPU
# Adam turns the float32 noise of the two devices' sums into parameter
# differences of up to 2.8e-4 after 20 steps on an H100 (a component that
# crosses zero makes its moment a cancelling sum); the NCC holds to 1e-4.
# A step of lr 0.03 with a flipped sign would move a parameter by 0.06.
REG_PARAM_TOL = 1e-3
REG_LOSS_TOL = 1e-4
BIAS_TOL = 1e-4                # x max|ref|
APPLY_TOL = 1e-5               # x max|ref|
# `tests/test_transforms.py`'s misalignment (dof 9) and quarter turn about
# x with a shift (dof 6), in `params_to_affine`'s order
MISALIGN_PARAMS = (4.0, -3.0, 2.0, 0.09, -0.07, 0.05, float(np.log(1.03)),
                   float(np.log(0.97)), 0.0, 0.0, 0.0, 0.0)
QUARTER_PARAMS = (8.0, -6.0, 5.0, float(np.pi / 2)) + (0.0,) * 8
GRAY_THRESHOLD = 0.25
REG_TIMED_ITERS = 10           # ms per iteration at each pyramid level
REG_PROFILE_ITERS = (40, 20, 10)   # the profiled descent: fewer steps
SUBJECT_SHIFT = (6.0, -5.0, 4.0)   # voxels between subject and MNI grids
LESION_RADIUS = 14.0
LESION_CONTRAST = 0.45
DET_BATCH = 512                # FCDMaskGenerator's batch (the reference's)
DET_TRAIN_BATCH = 128          # examples/detection_pipeline.py
DET_LR = 3e-4
DET_EPOCHS = 5
DET_TIMED_STEPS = 10
DET_FORWARD_TOL = 1e-4         # x max|ref|, card vs CPU, 512 patches
DET_IOU_GATE = 0.1             # tests/test_infer.py's gate

# int8 serving (phase 11): the K1 sites of the 192^3 int8 trunk in call
# order, and the K2 sites
Q_SITES = ("e0c1", "e0c2", "e1c1", "e1c2", "bc1", "bc2", "d0c1", "d0c2",
           "d1c1", "d1c2")
Q_UP_SITES = ("d0", "d1")
Q_TIMED_BATCH = BATCH
Q_CALIB_VOLUMES = 2
Q_MASK_AGREEMENT = 0.995       # tests/test_quant.py:72
Q_DICE_GATE = 0.9              # foreground Dice, int8 vs f32 masks
# per served batch: K1 at every k=2 packed conv (all with the epilogue
# fused), K2 at both up branches, no other kernel of the port
Q_PER_BATCH = {"conv2_packed_s8": len(Q_SITES),
               "conv2_packed_s8_fused": len(Q_SITES),
               "upconv_packed_s8": len(Q_UP_SITES), "other_kernels": 0}
# K1's route at each site (`_conv2_s8_route`): the 8Ci = 8 stem on
# mma.sync, the others on wgmma; K2 always on wgmma
Q_ROUTES = ("mma_sync",) + ("wgmma",) * (len(Q_SITES) - 1)
Q_WGMMA_PER_BATCH = Q_ROUTES.count("wgmma")

# the segmentation model zoo (phase 12): the JAX package's default widths
# with one T1 channel and two classes (the seg dice loss is two-class).
# Its convs, norms and resizes are cuDNN and plain torch: no kernel of
# the port launches (counts gated at 0).
ZOO = {
    "residual_unet3d": ("ResidualUNet3D", dict(
        n_classes=2, n_channels=(1, 16, 32, 64, 128))),
    "residual_unet3d_bayes": ("ResidualUNet3D", dict(
        n_classes=2, n_channels=(1, 16, 32, 64, 128), bayes=True)),
    "modified_3dunet": ("Modified3DUNet", dict(
        in_channels=1, n_classes=2, base_n_filter=8)),
    "brats_unet": ("BraTSUnet", dict(
        c=1, n=16, dropout=0.5, norm="gn", num_classes=2)),
}
ZOO_LOGIT_TOL = 1e-4           # x max|ref|, card vs CPU in f32
ZOO_OPT_ATOL = 1e-6            # the card's AdamW step against the CPU's
# float32 rounding alone can move a zoo gradient by more than 2e-2 of its
# tensor's max (Modified3DUNet at 64^3: its chains of InstanceNorms cancel
# most of each sum, and on some inputs the card's float32 step and the
# CPU's each land that far from their float64 one), so the gradients are
# held in float64, card against CPU, per tensor
ZOO_GRAD64_RTOL = 1e-10        # x max|ref|
ZOO_TIMED_STEPS = 4
ZOO_EVAL_REPS = 3

# phase 13: the packed encoders.  13a serves the ensemble's fader encoder
# through `models/fader_packed.py::encoder_apply_packed` (bench.py:134-151
# serves the seg+clf ensemble that way): pack2 and one B3 call per block.
# By `_separable_route`, e0 (8Ci = 8) takes the fused kernel and e1, e2
# (8Ci = 64, 128: no fused plan in f32, per-axis in bf16) three
# `conv_axis` launches each, in f32 and bf16 alike; the classifier's stack
# stays fused.  13b runs `encoder_apply_fused` (one cuDNN conv per block:
# no kernel of the port).  13c trains bench.py's VoxResNet
# (bench.py:591-640) through `voxresnet_class_step_packed`.
PACKED_ENC_PER_BATCH = {**{k: 0 for k in UNET_PER_BATCH},
                        "separable_conv3d": 1, "conv_axis": 6}
PACKED_ENSEMBLE_PER_BATCH = {**UNET_PER_BATCH, "separable_conv3d": 2,
                             "conv_axis": 6, "conv_axis_tc": 6}
ENC_LATENT_TOL = 1e-4          # f32 packed / fused vs fine latent, x max
# bench.py:603-606: VoxResNet(192^3, 32 filters, stride 2, 4 stages,
# dropout 0.5, 192 FC units), torch_adam(1e-5, weight_decay=0.01) (Adam
# with L2 decay, also `create_model_opt`'s), batch 10, bf16
VOX_KWARGS = dict(input_shape=(SIZE,) * 3, n_filters=32, stride=2,
                  n_blocks=4, dropout=0.5, n_fc_units=192)
VOX_LR, VOX_WD = 1e-5, 0.01
VOX_BATCH = CLASS_BATCH
VOX_TIMED_STEPS = 5
# B1 per packed step at stride 2 and 4 stages: the stem, conv3d_2, 4
# downsamples and 16 block convs forward; every input gradient but the
# stem's (its input, the image, takes none); all on tensor cores in bf16
# (8Ci 64-1024, 8Co or Co multiples of 64); 5 of the forward launches at
# stride 2 (the stem and the downsamples).  Every train-mode BatchNorm is
# one `BnActTrainPacked` (22 sites: 2, then 5 a stage): each of its four
# passes once a site.  Eval: the same 22 forward launches, the stem and
# the 8 block conv1s with B2 fused.
VOX_FWD, VOX_DX, VOX_FUSED, VOX_STRIDE2, VOX_BN = 22, 21, 9, 5, 22
VOX_PER_STEP = {**{k: 0 for k in UNET_PER_BATCH},
                "conv2_packed": VOX_FWD + VOX_DX,
                "conv2_packed_tc": VOX_FWD + VOX_DX,
                "conv2_packed_dx": VOX_DX, "conv2_packed_dx_tc": VOX_DX,
                **{k: VOX_BN for k in BN_PASSES},
                "dw_packed": VOX_FWD, "dw_packed_fold": VOX_FWD}
VOX_SPLIT_PER_STEP = {"b1_stride1": VOX_FWD - VOX_STRIDE2,
                      "b1_stride2": VOX_STRIDE2, "b1_dx": VOX_DX,
                      **{k: VOX_BN for k in BN_PASSES},
                      "dw_packed": VOX_FWD, "dw_packed_fold": VOX_FWD}
VOX_EVAL_PER_CALL = {**{k: 0 for k in UNET_PER_BATCH},
                     "conv2_packed": VOX_FWD, "conv2_packed_tc": VOX_FWD,
                     "conv2_packed_as_bn_act": VOX_FUSED,
                     "conv2_packed_as_bn_act_tc": VOX_FUSED}
# 13c f32 parity, packed against the fine port on the card (cuDNN, TF32
# off): the sizes and tolerances of tests/test_torch_voxresnet_packed.py
VOX_PARITY = {"s64_nb4": (64, dict(n_blocks=4, n_filters=2)),
              "s32_stride1": (32, dict(n_blocks=3, n_filters=4, stride=1))}
VOX_EVAL_TOL = (1e-5, 1e-4)    # atol, rtol
VOX_TRAIN_TOL = (2e-5, 1e-4)
VOX_STATS_TOL = (1e-5, 1e-4)
VOX_GRAD_RTOL = 1e-4           # x max|ref| of the tensor, + f32 rounding
VOX_PRE_BN_BIASES = ("model.conv3d_1.bias", "model.conv3d_2.bias")
# The gradients are held against the fine model run with the packed
# step's ReLU masks.  An input within float32 rounding of 0 can take the
# other branch of a ReLU in the two models; the gradient at that voxel
# then passes in one and not in the other.  A BatchNorm bias just before
# that ReLU has a cancelling sum for its gradient, which one such voxel
# moves by up to 1e-2 of its max, 100x and more its bound.


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
    P.K = k_proxy(K, conv2_packed=rec_conv, conv2_packed_as_bn_act=rec_fused,
                  bn_act_zero_pads=rec_epi)
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


def sep_kernel_phase(K, named, gen, checks, timed, fused_only=True,
                     route_rows=None):
    """Each (name, separable stack, calls per step) of `named` through
    `separable_conv3d` at each (batch, dtype) of `checks`, batch None
    meaning the recorded one, against its plain version; timed at the pair
    `timed` where it takes the fused kernel (the row repeated by its
    calls).  `fused_only`: every stack must take the fused kernel; else a
    stack may take the per-axis route, whose `conv_axis` launches
    `b3_bwd_rows` holds.  `route_rows`, a list: each stack's times on both
    routes at `timed` (three runs each, in turns; fused none where its
    plan does not fit) are appended to it."""
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
            if (batch, dn) == timed and route_rows is not None:
                route_rows.append(route_time_row(K, name, x, ws, kw, plan,
                                                 route, calls))
            del x, ws, got, ref
            torch.cuda.empty_cache()
    return rows, errs


def route_time_row(K, name, x, ws, kw, plan, route, calls):
    """The stack's time through the fused kernel and through three
    `conv_axis` launches, three runs each in turns (F P P F F P), so that
    `_separable_route` can be held to what the card measures."""
    def per_axis():
        v = x
        for a in range(3):
            v = K.conv_axis(v, ws[a], kw["biases"][a], axis=a + 1,
                            stride=kw["stride"][a], pad=kw["pad"][a])

    def fused_kernel():
        # the fused kernel whatever `_separable_route` says
        route_ = K._separable_route
        K._separable_route = lambda dtype, plan: "fused"
        try:
            K.separable_conv3d(x, *ws, **kw)
        finally:
            K._separable_route = route_

    fused, split = [], []
    for order in ("fp", "pf", "fp"):
        for r in order:
            if r == "f" and plan is not None:
                fused.append(time_ms(fused_kernel, 10))
            elif r == "p":
                split.append(time_ms(per_axis, 10))
    row = {"site": name, "x": list(x.shape),
           "w": [list(w.shape) for w in ws], "route": route,
           "calls_per_step": calls, "fused_ms_runs": fused or None,
           "per_axis_ms_runs": split}
    log(f"route {name} b{x.shape[0]}: {json.dumps(row)}")
    return row


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
    # the kernel reads the weights in x's dtype and the biases in float32
    nbytes = (x.numel() + out.numel() + sum(w.numel() for w in ws)
              ) * x.element_size() + sum(4 * b.numel() for b in bs
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
    # the CUDA-core kernel on the same inputs (bf16 x with float32 w takes
    # it): the route this site took before the tensor-core one
    wf = w.float()
    cuda_core_ms = time_ms(lambda: K.conv_axis(x, wf, bias, **kw), 5)
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
           "stride": kw["stride"], "pad": kw["pad"], "co": co,
           "route": K._axis_fwd_route(x.dtype, w.dtype), "ms": ms,
           "cuda_core_ms": cuda_core_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "flops": flops,
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


# the kernels of the port by their profiler names
PORT_KERNELS = ("conv2_packed_tc_kernel", "conv2_packed_kernel",
                "bn_act_zero_pads_kernel", "conv_axis_kernel",
                "axis_fwd_tc_kernel", "separable_conv3d_kernel",
                "conv_axis_dx_kernel", "conv_axis_dw_partial_kernel",
                "conv_axis_dw_finish_kernel", "axis_dx_tc_kernel",
                "axis_dw_tc_kernel", "axis_dw_tc_finish_kernel",
                "conv2_packed_s8_kernel", "conv2_packed_s8_tc_kernel",
                "upconv_packed_s8_kernel", "bn_train_stats_kernel",
                "bn_train_apply_kernel", "bn_train_reduce_kernel",
                "bn_train_dx_kernel", "bn_train_fold_kernel")
BN_KERNELS = PORT_KERNELS[-5:]


def absorb_profiler_startup():
    """A first, tiny profiled op on the card in a session of its own, to
    absorb the profiler's start-up before a measured window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace_window(trace_dir):
    """`obs.profile_trace(trace_dir)` opened after a start-up session of its
    own (`absorb_profiler_startup`), as `profile_batch` opens its window."""
    from mri_epilepsy_diagnosis_torch.obs import profile_trace

    absorb_profiler_startup()
    with profile_trace(trace_dir) as prof:
        yield prof


def device_rows(prof):
    """(kernel or copy name, device ms, calls) of a finished profiler's
    `key_averages()`, largest first: device-side events only (an aten
    op's row repeats the time of the kernels it launched)."""
    import torch

    rows = []
    for e in prof.key_averages():
        # a range (`obs.span`, `record_function`) around work on the card
        # also has a device-side row, over the kernels it holds: not an
        # event of its own (torch's own table leaves it out too)
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_batch(fn, top: int = 12, host_ops: bool = True,
                  name_len: int = 90, groups=None):
    """torch.profiler over one served batch: device time by kernel name,
    the port's kernels (B1 on tensor cores split into its plain-store and
    B2-epilogue instantiations), everything else, and the device's idle share
    of the window (1 - device time / wall time; kernels run on one stream
    at a time here, so their times add).  A first, tiny profiled op
    absorbs the profiler's own start-up.  `host_ops=False` traces the
    device alone: recording every host op slows the host threads, which
    set the pace of an epoch from files.  `top` rows of kernel names cut
    to `name_len` characters are returned; `groups`, {label: name
    substrings}, adds the device ms by label (`groups_ms`), each kernel
    counted under the first label one of whose substrings its name
    holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CPU] if host_ops else []) + [
        ProfilerActivity.CUDA]
    absorb_profiler_startup()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()            # the trace is read from here
    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows)
    ours = {k: sum(r[1] for r in rows if k in r[0]) for k in PORT_KERNELS}
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
            "kernels": sum(r[2] for r in rows if not r[0].startswith(
                ("Memcpy", "Memset"))),
            "host_syncs": syncs, "h2d_copies": h2d,
            "idle_share": (1 - device_ms / wall_ms) if device_ms else None,
            "conv2_packed_tc_ms": ours["conv2_packed_tc_kernel"],
            "conv2_packed_tc_bn_act_ms": fused_tc,
            "conv2_packed_ms": ours["conv2_packed_kernel"],
            "conv2_packed_bn_act_ms": fused_cc,
            "bn_act_zero_pads_ms": ours["bn_act_zero_pads_kernel"],
            "conv_axis_ms": ours["conv_axis_kernel"]
            + ours["axis_fwd_tc_kernel"],
            "separable_conv3d_ms": ours["separable_conv3d_kernel"],
            "conv_axis_dx_ms": ours["conv_axis_dx_kernel"]
            + ours["axis_dx_tc_kernel"],
            "conv_axis_dw_ms": ours["conv_axis_dw_partial_kernel"]
            + ours["conv_axis_dw_finish_kernel"] + ours["axis_dw_tc_kernel"]
            + ours["axis_dw_tc_finish_kernel"],
            "conv2_packed_s8_ms": ours["conv2_packed_s8_kernel"]
            + ours["conv2_packed_s8_tc_kernel"],
            "conv2_packed_s8_tc_ms": ours["conv2_packed_s8_tc_kernel"],
            "upconv_packed_s8_ms": ours["upconv_packed_s8_kernel"],
            "bn_train_ms": sum(ours[k] for k in BN_KERNELS),
            "other_kernels_ms": device_ms - copy_ms - sum(ours.values()),
            "groups_ms": _group_ms(rows, groups or {}),
            "top": [{"name": k[:name_len], "ms": ms, "calls": n}
                    for k, ms, n in rows[:top]]}


def _group_ms(rows, groups):
    """Device ms of profiler rows (name, ms, calls) by label of `groups`,
    each row under the first label one of whose substrings it holds."""
    out = dict.fromkeys(groups, 0.0)
    for name, ms, _ in rows:
        label = next((lb for lb, keys in groups.items()
                      if any(k in name for k in keys)), None)
        if label is not None:
            out[label] += ms
    return out


def k_proxy(K, **over):
    """The kernels module's public names with `over` in place of some:
    what a recorder installs as a packed module's `K`."""
    import types

    return types.SimpleNamespace(**{
        **{k: getattr(K, k) for k in dir(K) if not k.startswith("__")},
        **over})


def record_train_sites(K, P, fn):
    """The B1 launches (forward and input gradient), the dw contractions
    and the passes of the BatchNorm tail (`bn`: pass, tensor shape, dtype
    and keywords) of one packed train step `fn()`, in call order, with
    their shapes."""
    sites = {"forward": [], "dx": [], "dw": [], "bn": []}
    conv, dx, dw = K.conv2_packed, K.conv2_packed_dx, P._dw_packed_qgroup

    def rec_bn(name):
        def run(y, *args, **kw):
            sites["bn"].append({"pass": name, "y": tuple(y.shape),
                                "dtype": str(y.dtype).split(".")[-1],
                                **kw})
            return getattr(K, name)(y, *args, **kw)
        return run

    def rec_conv(x, wp, bias=None, *, pad=0):
        sites["forward"].append({"x": tuple(x.shape), "wp": tuple(wp.shape),
                                 "pad": pad, "bias": bias is not None})
        return conv(x, wp, bias, pad=pad)

    def rec_dx(g, wp, *, pad):
        sites["dx"].append({"g": tuple(g.shape), "wp": tuple(wp.shape),
                            "pad": pad})
        return dx(g, wp, pad=pad)

    def rec_dw(x, g):
        sites["dw"].append({"x": tuple(x.shape), "g": tuple(g.shape)})
        return dw(x, g)

    # the packed convs reach B1 through their module's `K` and dw through
    # the module-level `_dw_packed_qgroup`
    P.K = k_proxy(K, conv2_packed=rec_conv, conv2_packed_dx=rec_dx,
                  **{k: rec_bn(k) for k in BN_PASSES})
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
               and s["x"][1:4] == d["x"][1:4]) for d in sites["dw"]]
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
                dw_err, dw_row = dw_check(K, P, TF, name, x, g, pad)
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


def dw_check(K, P, TF, name, x, g, pad):
    """dw of one site (`_dw_packed_qgroup` over the conv's unpadded input,
    as the backward runs it) against the f32 einsum of the same operands;
    its time, its bound and share of it, and the plain version's time
    (`plain_ms`: `dw_packed_plain`, the 8 float32 window GEMMs).  Returns
    (error, row)."""
    import torch

    od, oh, ow = g.shape[1:4]
    dt = "f32" if x.dtype == torch.float32 else "bf16"
    if K.dw_pad(x.shape[1:4], g.shape[1:4]) != pad:
        raise AssertionError(f"dw {name}: extents {tuple(x.shape)}, "
                             f"{tuple(g.shape)} do not read as pad {pad}")

    def dw():
        return P._dw_packed_qgroup(x, g)

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
    route = K.dw_packed_route(x.dtype, x.device)
    err = check(f"dw_packed {name} b{x.shape[0]} ({route})", got,
                ref, dt, {dt: DW_TOL})
    c8i, c8o = x.shape[4], g.shape[4]
    m = g.shape[0] * od * oh * ow
    flops = 2.0 * 8 * m * c8i * c8o
    nbytes = (x.numel() + g.numel()) * x.element_size() + 4 * 8 * c8i * c8o
    bound_ms, bound_by = _bound(flops, nbytes, "bf16" if route == "tc"
                                else "f32")
    ms = time_ms(dw, 5)
    row = {"site": name, "x": list(x.shape), "g": list(g.shape),
           "route": route, "ms": ms,
           "plain_ms": time_ms(lambda: K.dw_packed_plain(x, g), 3),
           "einsum_f32_ms": time_ms(einsum_f32, 1),
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / ms,
           "tflops": flops / ms / 1e9, "max_abs_err": err,
           "library_ms": None}
    log(f"time dw_packed {name} b{x.shape[0]} {dt}: {json.dumps(row)}")
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
    launches, the dw contractions and the passes of the BatchNorm tail
    of one call of fn, from CUDA events
    recorded around each call on the stream (the wrappers' own weight
    re-layouts included).  Returns fn's result and a function that reads
    the sums (after a synchronize)."""
    import torch

    pairs = {"b1_forward": [], "b1_dx": [], "dw": [], "bn_tail": []}

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
    P.K = k_proxy(K, conv2_packed=bracket("b1_forward", K.conv2_packed),
                  conv2_packed_dx=bracket("b1_dx", K.conv2_packed_dx),
                  **{k: bracket("bn_tail", getattr(K, k))
                     for k in BN_PASSES})
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
    with no_plain_bn(K, f"{TIMED_STEPS} train steps"):
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
                                 - split["b1_dx_ms"] - split["dw_ms"]
                                 - split["bn_tail_ms"])
    out = {"size": SIZE, "batch": TRAIN_BATCH, "dtype": "bf16",
           "ocfl": OCFL,
           "foreground_share": fg,
           "epoch_train_losses": [float(v) for v in tr],
           "epoch_val_losses": [float(v) for v in va],
           "epoch_s": epoch_s, "warmup_loss": warm_loss,
           "timed_losses": losses, "ms_per_step": step_s * 1e3,
           "vol_per_s": TRAIN_BATCH / step_s, "peak_memory_gb": peak_gb,
           "master_weights_f32": master_f32,
           "dw_route": K.dw_packed_route(torch.bfloat16, xb.device),
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


@contextlib.contextmanager
def no_plain_bn(K, label):
    """Counts the calls of the BatchNorm tail's plain passes while the
    block runs: a CUDA tensor never takes them, so there must be none."""
    calls = []
    saved = {k: getattr(K, k + "_plain") for k in BN_PASSES}

    def counting(name, f):
        def run(*args, **kw):
            calls.append(name)
            return f(*args, **kw)
        return run

    for k, f in saved.items():
        setattr(K, k + "_plain", counting(k, f))
    try:
        yield
    finally:
        for k, f in saved.items():
            setattr(K, k + "_plain", f)
    log(f"plain BatchNorm-tail passes ({label}): {len(calls)} (expected 0)")
    if calls:
        raise AssertionError(f"{label}: plain passes ran on the card: "
                             f"{sorted(set(calls))}")


def bn_step_sites(sites):
    """The recorded tail passes of one train step, their count by pass
    gated at TRAIN_PER_STEP's."""
    got = {k: sum(s["pass"] == k for s in sites["bn"]) for k in BN_PASSES}
    want = {k: TRAIN_PER_STEP[k] for k in BN_PASSES}
    if got != want:
        raise AssertionError(f"BatchNorm-tail passes per step {got} != {want}")
    return sites["bn"]


# bytes each pass of the tail moves, in units of the tensor's size: stats
# reads y; apply reads y and writes out; reduce reads y and g; dx reads y
# and g and writes dy
BN_PASS_BYTES = {"bn_train_stats": 1, "bn_train_apply": 2,
                 "bn_train_reduce": 2, "bn_train_dx": 3}


# the dx pass's statistics term against dy, at the check's parameters:
# at least this share of max|dy| (16 bf16 steps), so that a dx kernel that
# dropped the term, flipped it or put it on other cells fails the check
BN_STAT_SHARE_MIN = 16 * 2.0 ** -7


def bn_check_inputs(K, P, shape, dtype, gen, kw):
    """y, a cotangent g and the (8, C) parameter rows of a check of the
    tail's passes, built as `BnActTrainPacked` builds them: mean and rstd
    from y's statistics over the owned cells, gamma, beta, alpha drawn,
    k2 and k3 from the reduction of a g that follows yh (so the dx pass's
    statistics term is of the size of its other term)."""
    import torch

    c = shape[-1] // 8
    faces = {"shifted": kw["shifted"], "d_faces": kw["d_faces"]}
    owned = kw.get("owned_d", shape[1])
    y = (torch.randn(shape, generator=gen, device="cuda") * 2
         + 0.5).to(dtype)
    valid = K.bn_train_stats_plain(torch.ones_like(y), owned_d=owned,
                                   **faces)[0, 0].item()
    mean, _, rstd, kept = P.bn_train_moments(
        K.bn_train_stats_plain(y, owned_d=owned, **faces), valid)
    prm = torch.stack([mean, rstd,
                       torch.rand(c, generator=gen, device="cuda") + 0.5,
                       torch.randn(c, generator=gen, device="cuda"),
                       torch.rand(c, generator=gen, device="cuda") * 0.5])
    yh = (y.float() - mean.repeat(8)) * rstd.repeat(8)
    g = (torch.randn(shape, generator=gen, device="cuda") + yh).to(dtype)
    del yh
    sums = K.bn_train_reduce_plain(y, g, prm, **faces)
    return y, g, P.bn_train_dx_rows(prm, sums[:2], valid, kept)


def bn_tail_rows(K, P, sites, label, reps=20, plain_reps=3):
    """Each distinct pass of the BatchNorm tail recorded in one train step
    (`record_train_sites(...)["bn"]`) at its shape and dtype, on the
    inputs of `bn_check_inputs`: the kernel against its plain version (the
    sums to float32 summation order over the sums of magnitudes, the
    elementwise passes to one rounding of the dtype; the dx pass's
    statistics term at least BN_STAT_SHARE_MIN of max|dy|), timed with
    CUDA events beside the plain version and the byte bound
    (BN_PASS_BYTES at HBM_BYTES_PER_S).  Returns the rows and, by pass,
    the step's launches, ms, bound_ms and plain_ms (each row times the
    calls that share it).  Its inputs come from a generator of its own, so
    the phases after it draw what they drew before it was added."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    groups = {}
    for site in sites:
        key = json.dumps(site, sort_keys=True)
        groups.setdefault(key, [site, 0])[1] += 1
    rows = []
    for site, calls in groups.values():
        name = site["pass"]
        dtype = getattr(torch, site["dtype"])
        kw = {k: v for k, v in site.items()
              if k not in ("pass", "y", "dtype")}
        y, g, prm = bn_check_inputs(K, P, site["y"], dtype, gen, kw)
        args = {"bn_train_stats": (y,), "bn_train_apply": (y, prm[:5]),
                "bn_train_reduce": (y, g, prm[:5]),
                "bn_train_dx": (y, g, prm)}[name]
        kernel, plain = getattr(K, name), getattr(K, name + "_plain")
        got = kernel(*args, **kw)
        ref = plain(*args, **kw)
        diff = (got.float() - ref.float()).abs()
        stat_share = None
        if name in ("bn_train_stats", "bn_train_reduce"):
            mag = K.bn_train_sum_scale(*args, **kw)
            err = (diff / (mag + 1e-30)).max().item()
            ok = bool((diff <= 1e-5 * mag + 1e-6).all())
        else:
            err = (diff.max() / ref.float().abs().max()).item()
            ok = err <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5)
        if name == "bn_train_dx":
            no_stat = prm.clone()
            no_stat[6:] = 0
            stat_share = ((plain(y, g, no_stat, **kw).float()
                           - ref.float()).abs().max()
                          / ref.float().abs().max()).item()
            ok = ok and stat_share >= BN_STAT_SHARE_MIN
        abs_err = diff.max().item()
        del got, ref, diff
        ms = time_ms(lambda: kernel(*args, **kw), reps)
        plain_ms = time_ms(lambda: plain(*args, **kw), plain_reps)
        nbytes = BN_PASS_BYTES[name] * y.numel() * y.element_size()
        rows.append({"pass": name, "y": site["y"], "dtype": site["dtype"],
                     **kw, "calls": calls, "ms": ms, "plain_ms": plain_ms,
                     "bytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "library_ms": None,
                     "max_rel_err": err, "max_abs_err": abs_err,
                     "stat_share": stat_share})
        del y, g, args
        if not ok:
            raise AssertionError(f"{label} {name} {site}: kernel against "
                                 f"plain {err}, statistics term "
                                 f"{stat_share} of max|dy|")
    torch.cuda.empty_cache()
    totals = {name: {k: sum(r[k] * (r["calls"] if k != "calls" else 1)
                            for r in rows if r["pass"] == name)
                     for k in ("calls", "ms", "bound_ms", "plain_ms")}
              for name in BN_PASSES}
    for t in totals.values():
        t["share_of_bound"] = t["bound_ms"] / t["ms"] if t["ms"] else None
    log(f"BatchNorm tail ({label}): {json.dumps(totals)}")
    return rows, totals


def bn_tail_entry(rows, totals, launches, per_step=None,
                  replaces="mri_epilepsy_diagnosis_tpu/models/unet_packed.py"
                           ":339 (_block_train, and its autograd)", **extra):
    """A kernels-line entry for `csrc/bn_train_packed.cu` on one path: its
    rows of `bn_tail_rows` summed over the calls of one step, the passes'
    totals beside; `per_step` the passes a step (the UNet's by default)."""
    src = "mri_epilepsy_diagnosis_torch/csrc/bn_train_packed.cu"
    step_rows = [{k: r[k] * r["calls"] for k in ("ms", "plain_ms",
                                                 "bound_ms")}
                 | {"bound_by": "bytes", "library_ms": None} for r in rows]
    errs = {dn: max((r["max_abs_err"] for r in rows if r["dtype"] == dt),
                    default=None)
            for dn, dt in (("bf16", "bfloat16"), ("f32", "float32"))}
    if per_step is None:
        per_step = sum(TRAIN_PER_STEP[k] for k in BN_PASSES)
    return kernel_entry(
        "bn_train_packed." + extra["path"], src, replaces, step_rows, errs,
        launches, per_step, passes=totals,
        stat_share_min=min(r["stat_share"] for r in rows
                           if r["stat_share"] is not None), **extra)


def _counted_b1(c):
    """B1 launches of a counts dict per kernel instantiation (the entries
    of the kernels line): tensor-core plain store (forward, no dx),
    tensor-core with B2 fused, CUDA-core plain store (the stem and all of
    f32), CUDA-core with B2 fused, tensor-core input gradients; and the
    other kernels' (`bn_train_packed`: the BatchNorm tail's passes;
    `dw_packed`: the weight gradients, each with its fold)."""
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
            "conv_axis": c["conv_axis"], "conv_axis_tc": c["conv_axis_tc"],
            "conv_axis_dx": c["conv_axis_dx"],
            "conv_axis_dw": c["conv_axis_dw"],
            "conv_axis_dx_tc": c["conv_axis_dx_tc"],
            "conv_axis_dw_tc": c["conv_axis_dw_tc"],
            "bn_train_packed": sum(c.get(k, 0) for k in BN_PASSES),
            "dw_packed": c.get("dw_packed", 0)}


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
                                           (None, "bf16"),
                                           dw_at=((None, "bf16"),))
    bn_rows, bn_totals = bn_tail_rows(
        K, P, bn_step_sites(sites),
        f"patch train step, {PATCH}^3 batch {PATCH_BATCH} bf16")

    pstate, loss = Tr.packed_seg_train_step(pstate, xb, lb)     # warm-up
    warm_loss = float(loss)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    with no_plain_bn(K, f"{PATCH_STEPS} patch train steps"):
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
                                 - split["b1_dx_ms"] - split["dw_ms"]
                                 - split["bn_tail_ms"])
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
                       "dx_max_abs_err": bwd_err["dx"],
                       "dw_max_abs_err": bwd_err["dw"],
                       "bn_tail": bn_totals, "bn_tail_sites": bn_rows}}
    log(f"training from files: {json.dumps(out)}")
    if not np.isfinite(tr + va + ptr + pva + losses).all():
        raise AssertionError("non-finite losses from files")
    if not np.isfinite(dsc + asd_gt + asd_pred + iou).all():
        raise AssertionError("non-finite validation metrics from files")
    return pstate, out, fwd_rows, bwd_rows["dx"], bwd_rows["dw"]


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
        rec.launches = rec.tc_launches = 0
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
    # the kernel route of every checked site, by dtype: bf16 must take the
    # tensor cores, float32 the CUDA cores
    routes = {k: {"f32": [], "bf16": []} for k in ("dx", "dw", "axis")}
    repeats = []

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
                    route = K._axis_bwd_route(g.dtype, w.dtype)
                    routes["dx"][dn].append(route)
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
                    route = K._axis_bwd_route(x.dtype)
                    routes["dw"][dn].append(route)
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
                    routes["axis"][dn].append(K._axis_fwd_route(x.dtype,
                                                                w.dtype))
                    got = K.conv_axis(x, w, bias, **kw)
                    torch.cuda.synchronize()
                    ref = K.conv_axis_plain(x, w, bias, **kw)
                    err = check(f"{label} conv_axis {xshape} axis {axis}",
                                got, ref, dn)
                    if dn == "bf16":
                        # no atomics: a second call repeats bit for bit
                        repeats.append(bool(torch.equal(
                            got, K.conv_axis(x, w, bias, **kw))))
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
    want = {"f32": "cuda_core", "bf16": "tc"}
    for kind, by_dtype in routes.items():
        for dn, seen in by_dtype.items():
            log(f"{label} {kind} {dn}: routes {sorted(set(seen))} over "
                f"{len(seen)} sites")
            if any(r != want[dn] for r in seen):
                raise AssertionError(f"{label} {kind} {dn} sites took "
                                     f"routes {seen}, not {want[dn]}")
    log(f"{label} conv_axis bf16: {sum(repeats)} of {len(repeats)} sites "
        "repeat bit for bit")
    if not all(repeats):
        raise AssertionError(f"{label} conv_axis: a second call differs")
    rows["routes"] = routes
    rows["repeat_bit_for_bit"] = len(repeats)
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
    nbytes = ((g.numel() + dx.numel()) * g.element_size()
              + w.numel() * w.element_size())
    bound_ms, bound_by = _bound(flops, nbytes, "bf16")
    stride, pad = [1, 1, 1], [0, 0, 0]
    stride[axis - 1], pad[axis - 1] = s, p
    wc = _axis_conv_weight(w, axis)
    gc = g.permute(0, 4, 1, 2, 3)
    in_size = list(gc.shape)
    in_size[1], in_size[1 + axis] = ci, length
    ms = time_ms(lambda: K.conv_axis_dx(g, w, **kw), 10)
    row = {"site": label, "g": list(g.shape), "axis": axis, "k": k,
           "stride": s, "pad": p, "ci": ci, "co": co,
           "route": K._axis_bwd_route(g.dtype, w.dtype), "ms": ms,
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
    route = K._axis_bwd_route(x.dtype)
    if route == "tc":
        a = int(np.prod(x.shape[:axis]))
        plan = K.conv_axis_dw_tc_plan(a, x.shape[axis], g.shape[axis],
                                      rows_ab // a, ci, co, k, s, p)
        chunks = plan.slots
    else:
        chunks = K.conv_axis_dw_plan(rows_ab * g.shape[axis], k, ci,
                                     co).chunks
    row = {"site": label, "x": list(x.shape), "g": list(g.shape),
           "axis": axis, "k": k, "stride": s, "pad": p, "ci": ci, "co": co,
           "route": route, "chunks": chunks, "ms": ms,
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
    rows["route_check"] = []
    rows["stack"], errs["stack"] = sep_kernel_phase(
        K, named_stacks("fader", sites["stack"]), gen, checks, timed_at,
        route_rows=rows["route_check"])

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
            K.reset_launch_counts()
            try:
                if step == "enc_clf_step":
                    out = Tr.enc_clf_step(fs, x, y, dom, 0.3, rng,
                                          FADER_N_DOMAINS,
                                          FADER_CLASS_WEIGHT)
                else:
                    out = Tr.disc_step(fs, x, dom, rng, FADER_N_DOMAINS)
            finally:
                Fd._separable_conv = stack
            if path == "kernels":
                # the f32 recomputes keep the CUDA-core conv_axis.cu
                axis_launches = {"conv_axis": K.conv_axis.launches,
                                 "conv_axis_tc": K.conv_axis.tc_launches}
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
               "running_stats_err": stats_err,
               "launches": axis_launches}
        log(f"f32 parity {step} (kernels vs per-axis cuDNN, "
            f"{FADER_PARITY_SIZE}^3 b{FADER_PARITY_BATCH}): "
            f"{json.dumps(res)}")
        if (worst > 1 or res["loss_rel_err"] > PARITY_LOSS_RTOL
                or stats_err > PARITY_STATS_TOL
                or axis_launches["conv_axis"] <= 0
                or axis_launches["conv_axis_tc"] != 0):
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
    # in bf16 every conv_axis, dw and dx launch takes the tensor cores
    c0 = per_step[0]
    if (not all(np.isfinite(losses)) or any(c != c0 for c in per_step)
            or min(_b3_counts(c0).values()) <= 0
            or c0["conv_axis_tc"] != c0["conv_axis"]
            or c0["conv_axis_dw_tc"] != c0["conv_axis_dw"]
            or c0["conv_axis_dx_tc"] != c0["conv_axis_dx"]):
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


def _logistic(v, edge, width=0.012):
    return 1.0 / (1.0 + np.exp(-(v - edge) / width))


def mni_template(shape=MNI_SHAPE, seed=SEED):
    """(T1 template, gray-matter probability map), float32 on the host.
    Geometry scales with `shape` (MNI_SHAPE is the 1 mm grid).  The brain
    is an egg-shaped ellipsoid (normalized radius rho); sines of seeded
    phases fold a cortex about 3 voxels thick (gray matter between folded
    radii 0.88 and 0.925) with sulci about 15 voxels apart, so that
    `MISALIGN_PARAMS` is a real misalignment (NCC 0.48 before, on the
    CPU) while twice resampling keeps it sharp (the true inverse reaches
    NCC 0.995 and gray-mask Dice 0.968).  Every voxel beyond rho 1.05 is
    exactly 0, so each slice has the zero margin the band walk asserts."""
    rng = np.random.default_rng(seed)
    sc = np.asarray(shape, np.float64) / np.asarray(MNI_SHAPE)
    x, y, z = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in shape],
                          indexing="ij", sparse=True)
    c = np.array([90.5, 112.0, 84.0]) * sc
    ay = np.where(y > c[1], 82.0, 90.0) * sc[1]      # narrower in front
    rho = np.sqrt(((x - c[0]) / (68.0 * sc[0])) ** 2 + ((y - c[1]) / ay) ** 2
                  + ((z - c[2]) / (66.0 * sc[2])) ** 2)
    ph = rng.uniform(0.0, 2 * np.pi, 5)
    xs, ys, zs = x / sc[0], y / sc[1], z / sc[2]
    fold = (0.06 * np.sin(0.42 * xs + ph[0]) * np.sin(0.36 * ys + ph[1])
            * np.sin(0.40 * zs + ph[2])
            + 0.034 * np.sin(0.11 * (xs + ys) + ph[3])
            * np.sin(0.13 * zs + ph[4]))
    rf = rho + fold
    wm = 1.0 - _logistic(rf, 0.88)
    gm = _logistic(rf, 0.88) * (1.0 - _logistic(rf, 0.925))
    csf = _logistic(rf, 0.925) * (1.0 - _logistic(rho, 1.0))

    def blob(center, radii):
        d = sum(((v - ci * s) / (ri * s)) ** 2
                for v, ci, ri, s in zip((x, y, z), center, radii, sc))
        return np.exp(-d ** 2)

    nuclei = (blob((72.5, 105.0, 80.0), (8, 12, 9))
              + blob((108.5, 105.0, 80.0), (8, 12, 9)))
    ventricles = (blob((83.5, 125.0, 92.0), (4, 18, 6))
                  + blob((97.5, 125.0, 92.0), (4, 18, 6)))
    cerebellum = blob((90.5, 62.0, 42.0), (38, 22, 17))
    t1 = 0.8 * wm + 0.5 * gm + 0.15 * csf
    t1 = t1 * (1 - nuclei) + 0.55 * nuclei
    t1 = t1 * (1 - ventricles) + 0.1 * ventricles
    t1 = t1 * (1 - cerebellum) + 0.6 * cerebellum
    gray = np.clip(gm * (1 - ventricles) + nuclei, 0, 1)
    inside = rho < 1.05
    gray = np.where(inside & (gray >= 1e-3), gray, 0.0)
    return (np.where(inside, t1, 0.0).astype(np.float32),
            gray.astype(np.float32))


def lesion_ball(shape, radius=LESION_RADIUS):
    """A ball in the left cortex (x below the midline) at normalized radius
    0.87 along a fixed direction: a soft profile (a one-voxel edge) and its
    binary mask."""
    sc = np.asarray(shape, np.float64) / np.asarray(MNI_SHAPE)
    c = np.array([90.5, 112.0, 84.0]) * sc
    u = np.array([-1.0, 0.3, 0.25])
    a = np.array([68.0, 82.0, 66.0]) * sc
    p = c + 0.87 * u / np.sqrt(((u / a) ** 2).sum())
    x, y, z = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in shape],
                          indexing="ij", sparse=True)
    d = np.sqrt((x - p[0]) ** 2 + (y - p[1]) ** 2 + (z - p[2]) ** 2)
    r = radius * float(sc.mean())
    return (_logistic(d, r, -1.0).astype(np.float32), d <= r)


def _dice(a, b) -> float:
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    return float(2 * (a & b).sum() / max(a.sum() + b.sum(), 1))


def _sync_ms(fn):
    """(fn(), host ms around it, synchronized)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def registration_phase(K, t1, gmpm, launch_counts, out_dir):
    """Phase 10a: registration and bias correction on the card at the
    template's full size, f32 (TF32 off).  No kernel of the port runs."""
    import torch

    from mri_epilepsy_diagnosis_torch.transforms import registration as R
    from mri_epilepsy_diagnosis_torch.transforms.preprocessing import (
        register_img_and_mask)
    from mri_epilepsy_diagnosis_torch.utils.nifti import (
        NiftiImage, load_nifti, save_nifti)

    shape = tuple(t1.shape)
    zero = {k: 0 for k in launch_counts()}
    K.reset_launch_counts()
    res = {"shape": list(shape), "seed": SEED}
    tpl = torch.from_numpy(gmpm).cuda()
    fwd = R.params_to_affine(torch.tensor(MISALIGN_PARAMS), shape).numpy()

    # card against the port on the CPU
    subject = R.apply_transform(tpl, fwd, shape)
    ref = R.apply_transform(gmpm, fwd, shape, device="cpu")
    err = (subject.cpu() - ref).abs().max().item() / ref.abs().max().item()
    res["apply_transform_rel_err"] = err
    if not err <= APPLY_TOL:
        raise AssertionError(f"apply_transform card vs CPU: {err}")
    mv, fx = R._downsample(ref, 4), R._downsample(torch.from_numpy(gmpm), 4)
    for dof in (9, 12):
        mask = torch.tensor([1.0] * dof + [0.0] * (12 - dof))
        p_ref, l_ref = R._register_level(mv, fx, torch.zeros(12), mask,
                                         REG_PARITY_ITERS, 0.03)
        p, loss = R._register_level(mv.cuda(), fx.cuda(),
                                    torch.zeros(12).cuda(), mask.cuda(),
                                    REG_PARITY_ITERS, 0.03)
        diff = (p.cpu() - p_ref).abs()
        res[f"register_level4_dof{dof}"] = {
            "param_err": diff.tolist(), "loss": [loss.item(), l_ref.item()]}
        if not (diff.max().item() <= REG_PARAM_TOL
                and abs(loss.item() - l_ref.item()) <= REG_LOSS_TOL):
            raise AssertionError(f"_register_level (dof {dof}) card vs CPU: "
                                 f"{res[f'register_level4_dof{dof}']}")
    g = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32)
                      for n in shape], indexing="ij", sparse=True)
    field = np.exp(0.25 * g[0] - 0.2 * g[1] * g[2] + 0.15 * g[2] ** 2)
    corrupted = (t1 * field + 0.01).astype(np.float32)
    corrupted_card = torch.from_numpy(corrupted).cuda()
    R.bias_field_correction(corrupted_card)                  # warm-up
    (got, _), res["bias_correction_ms"] = _sync_ms(
        lambda: R.bias_field_correction(corrupted_card))
    ref, _ = R.bias_field_correction(corrupted, device="cpu")
    err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    res["bias_correction_rel_err"] = err
    if not err <= BIAS_TOL:
        raise AssertionError(f"bias_field_correction card vs CPU: {err}")
    del got, ref, corrupted_card

    # where the time goes: the grid's scores, the 16 refinements, and the
    # descent's ms per iteration at each pyramid level
    quarter = R.params_to_affine(torch.tensor(QUARTER_PARAMS), shape).numpy()
    subject_q = R.apply_transform(tpl, quarter, shape)
    mv, fx = R._downsample(subject_q, 4), R._downsample(tpl, 4)
    com_mv, com_fx = R._center_of_mass(mv), R._center_of_mass(fx)
    grid = np.deg2rad(np.arange(-150.0, 180.0 + 1e-6, 30.0,
                                dtype=np.float32))
    angles = torch.tensor([(a, b, c) for a in grid for b in grid
                           for c in grid], device="cuda")
    R._search_scores(mv, fx, com_mv, com_fx, angles[:64])   # warm-up
    scores, res["search_scores_ms"] = _sync_ms(
        lambda: R._search_scores(mv, fx, com_mv, com_fx, angles))
    center = (torch.tensor(mv.shape, dtype=torch.float32,
                           device="cuda") - 1) / 2
    cands = R._candidate_params(angles[torch.argsort(-scores)[:R.PRESELECT]],
                                com_mv, com_fx, center)
    rigid = torch.tensor([1.0] * 6 + [0.0] * 6, device="cuda")
    _, res["search_refine_ms"] = _sync_ms(
        lambda: R._register_level(mv, fx, cands, rigid, 60, 0.03))
    res["search_candidates"] = len(angles)
    mask9 = torch.tensor([1.0] * 9 + [0.0] * 3, device="cuda")
    res["ms_per_iter"] = {}
    for level in (4, 2, 1):
        a, b = R._downsample(subject, level), R._downsample(tpl, level)
        R._register_level(a, b, torch.zeros(12, device="cuda"), mask9, 2,
                          0.03)
        _, ms = _sync_ms(lambda: R._register_level(
            a, b, torch.zeros(12, device="cuda"), mask9, REG_TIMED_ITERS,
            0.03))
        res["ms_per_iter"][f"level{level}"] = ms / REG_TIMED_ITERS
    del subject_q, mv, fx, scores

    # quality: tests/test_transforms.py's gates at the template's full size
    def ncc(a, b):
        return float(R._ncc(a, b))

    oracle = R.apply_transform(subject, np.linalg.inv(fwd), shape)
    torch.cuda.reset_peak_memory_stats()
    (aff, warped), res["register_dof9_ms"] = _sync_ms(
        lambda: R.register_affine(subject, tpl, dof=9))
    res["register_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gt = (tpl > GRAY_THRESHOLD).cpu().numpy()
    moved = R.apply_transform((subject > GRAY_THRESHOLD).float(), aff, shape)
    q = {"ncc_oracle": ncc(oracle, tpl), "ncc_before": ncc(subject, tpl),
         "ncc_after": ncc(warped, tpl),
         "dice_gray": _dice(gt, (warped > GRAY_THRESHOLD).cpu().numpy()),
         "dice_moved_mask": _dice(gt, (moved > 0.5).cpu().numpy())}
    res["misalignment_dof9"] = q
    log(f"registration dof 9: {json.dumps(q)}")
    if not (q["ncc_after"] > q["ncc_oracle"] - 0.005 and q["ncc_after"] > 0.95
            and q["ncc_before"] < 0.5 and q["dice_gray"] > 0.95
            and q["dice_moved_mask"] > 0.93):
        raise AssertionError(f"registration quality (dof 9): {q}")
    del oracle, warped, moved
    subject_q = R.apply_transform(tpl, quarter, shape)
    (aff_q, warped_q), res["register_quarter_turn_ms"] = _sync_ms(
        lambda: R.register_affine(subject_q, tpl, dof=6))
    q = {"ncc_before": ncc(subject_q, tpl), "ncc_after": ncc(warped_q, tpl)}
    res["quarter_turn_dof6"] = q
    log(f"registration quarter turn, dof 6: {json.dumps(q)}")
    if not q["ncc_after"] > 0.95:
        raise AssertionError(f"registration quality (quarter turn): {q}")
    del subject_q, warped_q

    prof = profile_batch(lambda: R.register_affine(
        subject, tpl, dof=9, search=False, iters=REG_PROFILE_ITERS),
        host_ops=False)
    res["profile_descent"] = {k: prof[k] for k in (
        "wall_ms", "device_ms", "kernel_ms", "copy_ms", "idle_share",
        "top")}
    res["profile_descent"]["iters"] = list(REG_PROFILE_ITERS)

    # a subject from NIfTI files: its own world grid, a smooth bias, a
    # lesion mask carried along by the recovered transform
    shift = np.eye(4)
    shift[:3, 3] = SUBJECT_SHIFT
    tpl_affine = np.asarray(MNI_AFFINE)
    to_tpl = fwd @ shift                 # subject voxel -> template voxel
    soft, ball = lesion_ball(shape)
    data = R.apply_transform(t1, to_tpl, shape).cpu().numpy()
    data = np.round(data * field * 1000).astype(np.int16)
    mask = R.apply_transform(ball.astype(np.float32), to_tpl,
                             shape).cpu().numpy() > 0.5
    paths = [os.path.join(out_dir, n) for n in ("subject_T1w.nii",
                                                "subject_lesion.nii")]
    save_nifti(paths[0], data, tpl_affine @ shift)
    save_nifti(paths[1], mask.astype(np.uint8), tpl_affine @ shift)
    template = NiftiImage(t1, tpl_affine)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, lesion = load_nifti(paths[0]), load_nifti(paths[1])
    load_ms = (time.perf_counter() - t0) * 1e3
    (warped, corrected, wmask, total), ms = _sync_ms(
        lambda: register_img_and_mask(img, template, lesion))
    t1_card = torch.from_numpy(t1).cuda()
    q = {"load_ms": load_ms, "register_and_correct_ms": ms,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
         "ncc_warped": ncc(warped, t1_card),
         "ncc_corrected": ncc(corrected, t1_card),
         "dice_lesion": _dice(wmask > 0.5, ball),
         "lesion_voxels": int(ball.sum())}
    res["from_files"] = q
    for p in paths:
        os.remove(p)
    log(f"register_img_and_mask from files: {json.dumps(q)}")
    if not q["dice_lesion"] > 0.93:
        raise AssertionError(f"the lesion mask did not land: {q}")
    _expect_counts("registration", launch_counts(), zero)
    return res


class _Patches:
    """`examples/detection_pipeline.py`'s dataset: channels-last patches."""

    def __init__(self, patches, labels):
        self.patches = patches.astype(np.float32)
        self.target = labels.astype(np.int64)

    def __len__(self):
        return len(self.patches)

    def __getitem__(self, i):
        return (np.moveaxis(self.patches[i], 0, -1), int(self.target[i]), 0)


class _LossLog:
    """The `experiment` of `train`: keeps the per-batch and per-epoch
    train losses."""

    def __init__(self):
        self.batches, self.epochs = [], []

    def log_metric(self, name, value):
        if name == "train_loss":
            self.batches.append(float(value))

    def log_metrics(self, values, epoch=None):
        if "mean_train_loss" in values:
            self.epochs.append(float(values["mean_train_loss"]))


def detection_phase(K, t1, gmpm, launch_counts, out_dir):
    """Phase 10b: patches, PatchModel training and whole-brain inference of
    a synthetic subject with a bright lesion, f32, the reference's
    settings.  No kernel of the port runs (PatchModel is cuDNN's)."""
    import torch

    from mri_epilepsy_diagnosis_torch.data import DataLoader
    from mri_epilepsy_diagnosis_torch.data.patches import (
        get_all_patches_and_labels, iter_band_patches)
    from mri_epilepsy_diagnosis_torch.infer import FCDMaskGenerator
    from mri_epilepsy_diagnosis_torch.metrics import roc_auc_score
    from mri_epilepsy_diagnosis_torch.models import PatchModel
    from mri_epilepsy_diagnosis_torch.train import (create_model_opt,
                                                    train_classifier)
    from mri_epilepsy_diagnosis_torch.train.classification import _class_step
    from mri_epilepsy_diagnosis_torch.utils.nifti import (load_nifti,
                                                         save_nifti)

    zero = {k: 0 for k in launch_counts()}
    K.reset_launch_counts()
    soft, ball = lesion_ball(t1.shape)
    img = t1 + LESION_CONTRAST * soft
    img_n = (img - img.min()) / (img.max() - img.min())
    res = {"shape": list(t1.shape), "lesion_voxels": int(ball.sum())}
    t0 = time.perf_counter()
    patches, labels = get_all_patches_and_labels(img_n, gmpm, ball)
    res["patches"] = {"host_ms": (time.perf_counter() - t0) * 1e3,
                      "count": len(patches), "positives": int(labels.sum())}
    log(f"detection patches: {json.dumps(res['patches'])}")

    state, _ = create_model_opt(PatchModel(device="cuda"), None, lr=DET_LR,
                                weight_decay=0.0, seed=SEED, device="cuda")
    cpu = PatchModel(device="cpu").eval()
    cpu.load_state_dict(state.model.state_dict())
    x = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(patches[:DET_BATCH], 1, -1)))
    with torch.no_grad():
        got = state.model.eval()(x.cuda()).cpu()
        ref = cpu(x)
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    res["forward_rel_err"] = err
    if not err <= DET_FORWARD_TOL:
        raise AssertionError(f"PatchModel card vs CPU: {err}")

    loader = DataLoader(_Patches(patches, labels), batch_size=DET_TRAIN_BATCH,
                        shuffle=True, seed=SEED)
    steps = [tuple(torch.as_tensor(a).cuda() for a in b[:2])
             for _, b in zip(range(DET_TIMED_STEPS + 1), loader)]
    _class_step(state, *steps[0], None, True)                # warm-up
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for xb, yb in steps[1:]:
        _class_step(state, xb, yb, None, True)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / DET_TIMED_STEPS
    logbook = _LossLog()
    t0 = time.perf_counter()
    state, *_ = train_classifier(state, loader, None, roc_auc_score,
                                 max_epoch=DET_EPOCHS, experiment=logbook)
    torch.cuda.synchronize()
    train = {"batch": DET_TRAIN_BATCH, "lr": DET_LR,
             "ms_per_step": step_s * 1e3,
             "patches_per_s": DET_TRAIN_BATCH / step_s,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "epochs_s": time.perf_counter() - t0,
             "epoch_losses": logbook.epochs,
             "f32_master_weights": all(p.dtype == torch.float32
                                       for p in state.model.parameters())}
    res["training"] = train
    log(f"detection training: {json.dumps(train)}")
    if not (np.isfinite(logbook.batches).all() and train["f32_master_weights"]
            and logbook.epochs[-1] < logbook.epochs[0]):
        raise AssertionError(f"PatchModel training: {train}")

    paths = [os.path.join(out_dir, n) for n in (
        "detection_T1w.nii", "detection_lesion.nii", "detection_pred.nii")]
    save_nifti(paths[0], img.astype(np.float32), np.asarray(MNI_AFFINE))
    save_nifti(paths[1], ball.astype(np.uint8), np.asarray(MNI_AFFINE))
    gen = FCDMaskGenerator(state.model.eval(), gmpm, batch_size=DET_BATCH)
    gen.get_mask(img_n)                                       # warm-up
    (pred, iou), wall = _sync_ms(
        lambda: gen.inference_pipeline(paths[0], paths[1],
                                       out_name=paths[2]))
    back = load_nifti(paths[2]).get_fdata()
    t0 = time.perf_counter()
    brain = load_nifti(paths[0]).get_fdata()
    brain = (brain - brain.min()) / (brain.max() - brain.min())
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cut, dests = gen._collect_patches(brain)
    collect_ms = (time.perf_counter() - t0) * 1e3
    found, forward_ms = _sync_ms(lambda: gen._predict(cut))
    t0 = time.perf_counter()
    pmt = np.zeros((4, gmpm.shape[1] // gen.h, gmpm.shape[2]), np.int64)
    pmt[dests[:, 0], dests[:, 1], dests[:, 2]] = found
    gen._masking(brain, gen._postprocess(pmt))
    post_ms = (time.perf_counter() - t0) * 1e3
    # the patch grid's ceiling: the mask of the true patch labels
    truth = np.zeros_like(pmt)
    for i, band, kind, _, lab in iter_band_patches(brain, gmpm, ball, gen.h,
                                                   gen.w):
        truth[kind, band, i] = lab
    ceiling = gen.get_iou(gen._masking(brain, gen._postprocess(truth)) > 0,
                          ball)
    prof = profile_batch(lambda: gen._predict(cut), host_ops=False)
    brain_prof = profile_batch(lambda: gen.get_mask(brain), host_ops=False)
    for p in paths:
        os.remove(p)
    inf = {"batch": DET_BATCH, "patches": len(cut),
           "positives": int(found.sum()), "wall_ms_per_brain": wall,
           "load_ms": load_ms, "collect_host_ms": collect_ms,
           "forward_ms": forward_ms, "forward_device_ms": prof["device_ms"],
           "forward_idle_share": prof["idle_share"],
           "post_host_ms": post_ms, "iou": float(iou),
           "iou_of_true_patch_labels": float(ceiling),
           "brain_idle_share": brain_prof["idle_share"],
           "brain_profile_wall_ms": brain_prof["wall_ms"],
           "brain_device_ms": brain_prof["device_ms"],
           "mask_voxels": int(pred.sum()),
           "mask_read_back_equal": bool(np.array_equal(back, pred)),
           "top_kernels": prof["top"]}
    res["inference"] = inf
    log(f"detection inference: {json.dumps(inf)}")
    if not (iou > DET_IOU_GATE and inf["mask_read_back_equal"]):
        raise AssertionError(f"detection inference: {inf}")
    _expect_counts("detection", launch_counts(), zero)
    return res


def record_s8_sites(Q, K, fn):
    """The K1 (`conv2_packed_s8`) and K2 (`upconv_packed_s8`) calls of one
    int8 forward `fn()`, in call order, with their arguments (the int8
    activations, weights and epilogue vectors as the path gives them).
    Patches the int8 model module's `K`, not the kernels module."""
    import types

    calls = {"conv2_packed_s8": [], "upconv_packed_s8": []}

    def recorder(name):
        real = getattr(K, name)

        def run(*args, **kw):
            calls[name].append((args, kw))
            return real(*args, **kw)
        return run

    proxy = types.SimpleNamespace(**{k: getattr(K, k) for k in dir(K)
                                     if not k.startswith("__")})
    for name in calls:
        setattr(proxy, name, recorder(name))
    Q.K = proxy
    try:
        out = fn()
    finally:
        Q.K = K
    return out, calls


def _batched_like(t, batch):
    """t (batch 1) repeated to `batch` items, contiguous."""
    return None if t is None else t.expand(batch, *t.shape[1:]).contiguous()


def _bound_row(ops, nbytes, peak):
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"flops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def s8_kernel_phase(K, P, calls):
    """Phase 11a: every K1 and K2 launch of the 192^3 int8 trunk (recorded
    at batch 1): the kernel against its plain version on the path's own
    tensors at batch 1, int32 (raw) and int8 (fused) equal exactly; then
    ms at batch Q_TIMED_BATCH (the batch-1 tensors repeated), the plain
    version's ms at batch 1, the bound (operations at the int8 peak or
    bytes at HBM rate, the larger) and its share of the int8 peak, the
    route each launch took (`conv2_packed_s8.wgmma_launches`; gated
    against Q_ROUTES: no site may fall back to the mma.sync kernel) and,
    as a yardstick, the bf16 B1 launch at the same site (for K2, the
    explicit up branch's aligned->shifted launch on the upsampled input,
    beside `upsample2_packed`) and the float composed up-conv
    (`upconv_packed`, one cuDNN transposed conv, bf16).  No library int8
    conv exists to compare with."""
    import torch

    b = Q_TIMED_BATCH
    k1_rows, k2_rows, errs = [], [], {"k1_raw": 0, "k1_fused": 0, "k2": 0}
    routes = []
    for site, (args, kw) in zip(Q_SITES, calls["conv2_packed_s8"]):
        x8, w8 = args
        pad = kw["pad"]
        ep = {k: v for k, v in kw.items() if k != "pad"}
        before = K.conv2_packed_s8.wgmma_launches
        raw = K.conv2_packed_s8(x8, w8, pad=pad)
        raw_ref = K.conv2_packed_s8_plain(x8, w8, pad=pad)
        fused = K.conv2_packed_s8(x8, w8, pad=pad, **ep)
        wgmma = K.conv2_packed_s8.wgmma_launches - before
        route = {2: "wgmma", 0: "mma_sync"}.get(wgmma, f"mixed ({wgmma})")
        routes.append(route)
        t0 = time.perf_counter()
        fused_ref = K.conv2_packed_s8_plain(x8, w8, pad=pad, **ep)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        e_raw = (raw.long() - raw_ref.long()).abs().max().item()
        e_fused = (fused.int() - fused_ref.int()).abs().max().item()
        errs["k1_raw"] = max(errs["k1_raw"], e_raw)
        errs["k1_fused"] = max(errs["k1_fused"], e_fused)
        xb = _batched_like(x8, b)
        add = _batched_like(ep.get("addend"), b)
        epb = {**ep, "addend": add}
        ms = time_ms(lambda: K.conv2_packed_s8(xb, w8, pad=pad, **epb), 5)
        raw_ms = time_ms(lambda: K.conv2_packed_s8(xb, w8, pad=pad), 3)
        xh = torch.randn(xb.shape, device="cuda").to(torch.bfloat16)
        wh = (torch.randn(w8.shape, device="cuda")
              / (8 * w8.shape[3]) ** 0.5).to(torch.bfloat16)
        b1_ms = time_ms(lambda: K.conv2_packed(xh, wh, pad=pad), 5)
        n, di, hi, wi, c8i = xb.shape
        c8o = w8.shape[4]
        step = 1 if pad else -1
        cells = n * (di + step) * (hi + step) * (wi + step)
        nbytes = (xb.numel() + w8.numel() + cells * c8o
                  + (4 * add.numel() if add is not None else 0)
                  + 4 * 4 * c8o)
        row = {"site": site, "pad": pad, "x": list(xb.shape),
               "w": list(w8.shape), "addend": add is not None,
               "route": route, "ms": ms,
               "raw_int32_ms": raw_ms, "plain_ms": plain_ms,
               "plain_batch": int(x8.shape[0]), "bf16_b1_ms": b1_ms,
               "max_abs_err_raw": e_raw, "max_abs_err_fused": e_fused,
               **_bound_row(2.0 * cells * 8 * c8i * c8o, nbytes,
                            PEAK_OPS_PER_S["int8"])}
        row["tops"] = row["flops"] / ms / 1e9
        row["pct_int8_peak"] = 100 * row["flops"] / (
            ms * 1e-3 * PEAK_OPS_PER_S["int8"])
        k1_rows.append(row)
        log(f"K1 {site}: {json.dumps(row)}")
        del xb, add, epb, xh, wh, raw, raw_ref, fused, fused_ref
    for site, (args, _) in zip(Q_UP_SITES, calls["upconv_packed_s8"]):
        xe8, wk8 = args
        got = K.upconv_packed_s8(xe8, wk8)
        t0 = time.perf_counter()
        ref = K.upconv_packed_s8_plain(xe8, wk8)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (got.long() - ref.long()).abs().max().item()
        errs["k2"] = max(errs["k2"], err)
        del got, ref
        xeb = _batched_like(xe8, b)
        ms = time_ms(lambda: K.upconv_packed_s8(xeb, wk8), 3)
        n, dp, hp, wp, c8i = xeb.shape
        c8o = wk8.shape[4]
        plan = K.upconv_s8_plan((dp, hp, wp), c8i, c8o)
        ops = 2.0 * n * c8o * sum(int(np.prod(c.cells)) * c.k for c in plan)
        out_cells = n * (2 * dp - 3) * (2 * hp - 3) * (2 * wp - 3)
        nbytes = xeb.numel() + wk8.numel() + 4 * out_cells * c8o
        # the explicit bf16 up branch at this site: the coarse aligned
        # cells upsampled, then an aligned->shifted B1 launch
        sc = (dp - 2, hp - 2, wp - 2)
        xa = torch.randn((n, *sc, c8i), device="cuda").to(torch.bfloat16)
        wa = (torch.randn((2, 2, 2, c8i, c8o), device="cuda")
              / (8 * c8i) ** 0.5).to(torch.bfloat16)
        up = P.upsample2_packed(xa)
        b1_ms = time_ms(lambda: K.conv2_packed(up, wa, pad=1), 3)
        up_ms = time_ms(lambda: P.upsample2_packed(xa), 3)
        wk = torch.randn(wk8.shape, device="cuda").to(torch.bfloat16) / (
            125 * c8i) ** 0.5
        composed_ms = time_ms(lambda: P.upconv_packed(xa, wk), 3)
        # the float composed conv's own bound: the same parity-class work
        # at the bf16 peak, bf16 input, kernel and output moved once
        composed_bound = _bound_row(
            ops, 2 * (xa.numel() + wk.numel() + out_cells * c8o),
            PEAK_OPS_PER_S["bf16"])["bound_ms"]
        row = {"site": site, "x_padded": list(xeb.shape),
               "w": list(wk8.shape), "route": "wgmma", "ms": ms,
               "plain_ms": plain_ms,
               "plain_batch": int(xe8.shape[0]), "bf16_b1_ms": b1_ms,
               "bf16_upsample_ms": up_ms,
               "bf16_composed_cudnn_ms": composed_ms,
               "bf16_composed_bound_ms": composed_bound,
               "taps_per_cell": sum(int(np.prod(c.cells)) * int(
                   np.prod(c.taps)) for c in plan) / (out_cells / n),
               "max_abs_err": err,
               **_bound_row(ops, nbytes, PEAK_OPS_PER_S["int8"])}
        row["tops"] = row["flops"] / ms / 1e9
        row["pct_int8_peak"] = 100 * row["flops"] / (
            ms * 1e-3 * PEAK_OPS_PER_S["int8"])
        k2_rows.append(row)
        log(f"K2 {site}: {json.dumps(row)}")
        del xeb, xa, wa, up, wk
    torch.cuda.empty_cache()
    log(f"K1/K2 max |kernel - plain|: {json.dumps(errs)} (must be 0)")
    if any(errs.values()):
        raise AssertionError(f"int8 kernels differ from their plain "
                             f"versions: {errs}")
    log(f"K1 routes: {json.dumps(dict(zip(Q_SITES, routes)))}")
    if tuple(routes) != Q_ROUTES:
        raise AssertionError(f"K1 routes {routes} != {list(Q_ROUTES)}")
    return k1_rows, k2_rows, errs


def _s8_counts(K, launch_counts):
    c = launch_counts()
    return {"conv2_packed_s8": K.conv2_packed_s8.launches,
            "conv2_packed_s8_fused": K.conv2_packed_s8.fused_launches,
            "upconv_packed_s8": K.upconv_packed_s8.launches,
            "other_kernels": sum(c.values())}


def int8_serving_phase(K, Q, q, vols, fine_masks, znorm_batch,
                       launch_counts, bf16):
    """Phase 11b: serve phase 4's volumes with the quantized phase-4 UNet
    `q` (He-scaled, 2% foreground; calibrated on Q_CALIB_VOLUMES of them)
    through `segment_volumes(mask_fn=packed_unet_mask_v2_int8)` at batch
    BATCH, float32 input: masks against phase 4's f32 fine masks
    (agreement >= Q_MASK_AGREEMENT, JAX's gate; foreground Dice >=
    Q_DICE_GATE), exact launch counts per batch (K1 10, all fused, 9 of
    them on the wgmma route, K2 2, no other kernel of the port), vol/s, batch latency, peak memory and
    one profiled batch beside phase 4's bf16 numbers.  Returns the
    numbers and the gates that failed."""
    import torch

    from mri_epilepsy_diagnosis_torch.infer.serving import segment_volumes

    n_batches = -(-len(vols) // BATCH)

    def serve(volumes):
        t = time.perf_counter()
        outs = list(segment_volumes(
            None, q, volumes, batch_size=BATCH, dtype=torch.float32,
            device="cuda", device_preprocess=znorm_batch,
            transfer_dtype=np.int16, mask_fn=Q.packed_unet_mask_v2_int8,
            pack_masks=True))
        dt = time.perf_counter() - t
        if (len(outs) != len(volumes)
                or outs[0]["mask"].shape != (SIZE,) * 3):
            raise AssertionError("int8 serving returned wrong masks")
        return dt, np.stack([o["mask"] for o in outs])

    serve(vols[:BATCH])                            # warm-up
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t_s, masks = serve(vols)
    counts = _s8_counts(K, launch_counts)
    wgmma = K.conv2_packed_s8.wgmma_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: v * n_batches for k, v in Q_PER_BATCH.items()}
    profile = profile_batch(lambda: serve(vols[:BATCH]))
    agree = float(np.mean(masks == fine_masks))
    fg8, fgf = masks.astype(bool), fine_masks.astype(bool)
    dice = float(2 * (fg8 & fgf).sum() / (fg8.sum() + fgf.sum()))
    out = {"volumes": len(vols), "batch": BATCH, "size": SIZE,
           "calibration_volumes": Q_CALIB_VOLUMES, "s": t_s, "vol_per_s": len(vols) / t_s,
           "ms_per_batch": t_s / n_batches * 1e3, "peak_memory_gb": peak_gb,
           "launches": counts, "launches_expected": want,
           "k1_wgmma_launches": wgmma,
           "k1_wgmma_launches_expected": Q_WGMMA_PER_BATCH * n_batches,
           "foreground_share": float(masks.mean()),
           "foreground_share_f32": float(fine_masks.mean()),
           "mask_agreement_vs_f32": agree, "foreground_dice_vs_f32": dice,
           "profile": profile,
           "bf16_vol_per_s": bf16["serving"]["int16_vol_per_s"],
           "bf16_ms_per_batch": bf16["serving"]["int16_ms_per_batch"],
           "bf16_profile_device_ms": bf16["profile"]["device_ms"],
           "bf16_profile_idle_share": bf16["profile"]["idle_share"]}
    log(f"int8 serving: {json.dumps({k: v for k, v in out.items() if k != 'profile'})}")
    log(f"int8 profile: {json.dumps(profile)}")
    fails = []
    if counts != want:
        fails.append(f"launch counts {counts} != {want}")
    if wgmma != Q_WGMMA_PER_BATCH * n_batches:
        fails.append(f"K1 wgmma launches {wgmma} != "
                     f"{Q_WGMMA_PER_BATCH * n_batches}")
    if agree < Q_MASK_AGREEMENT:
        fails.append(f"mask agreement {agree} < {Q_MASK_AGREEMENT}")
    if dice < Q_DICE_GATE:
        fails.append(f"foreground Dice {dice} < {Q_DICE_GATE}")
    if not FG_GATE[0] <= out["foreground_share"] <= FG_GATE[1]:
        fails.append(f"degenerate int8 masks: {out['foreground_share']}")
    return out, fails


@contextlib.contextmanager
def replaced_draws(eps, keep):
    """The port's random draws from the given sources in place of its
    generators: `eps(like)` for the Bayesian layers' noise
    (`models.bayes.draw_eps`) and `keep(x, rate)`, a boolean keep mask,
    for Dropout (`ops.functional.dropout`, still the identity in eval mode
    or at rate 0).  The models call both through their modules."""
    from mri_epilepsy_diagnosis_torch.models import bayes
    from mri_epilepsy_diagnosis_torch.ops import functional as F

    def draw_eps(like, generator=None):
        return eps(like).to(like.device, like.dtype)

    def dropout(x, rate, training, generator=None):
        if not training or rate == 0.0:
            return x
        return F.dropout_core(x, keep(x, rate).to(x.device), rate)

    saved = bayes.draw_eps, F.dropout
    bayes.draw_eps, F.dropout = draw_eps, dropout
    try:
        yield
    finally:
        bayes.draw_eps, F.dropout = saved


def host_draws(seed):
    """`replaced_draws` from one host generator seeded with `seed`, in
    call order, so that the card and the CPU see the same noise and masks
    (phase 12a's parity check)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return replaced_draws(
        lambda like: torch.randn(like.shape, generator=gen),
        lambda x, rate: torch.rand(x.shape, generator=gen) < 1.0 - rate)


def zoo_model(name, device, seed=SEED):
    """The phase-12 configuration `name`, its weights drawn by torch's
    default initialization from a generator seeded with `seed` (torch's
    global generator is left as it was)."""
    import torch

    from mri_epilepsy_diagnosis_torch import models

    cls, kw = ZOO[name]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = getattr(models, cls)(**kw, device="cpu")
    return model.to(device)


def adamw_step_on(model, grads, device):
    """name -> parameter of a copy of `model` on `device` after one
    `torch_adamw()` step from a fresh optimizer with the gradients `grads`
    (name -> tensor), on the host."""
    import copy

    from mri_epilepsy_diagnosis_torch.train.optim import torch_adamw

    m = copy.deepcopy(model).to(device)
    for k, p in m.named_parameters():
        p.grad = grads[k].to(device, p.dtype)
    torch_adamw()(m.parameters()).step()
    return {k: p.detach().cpu() for k, p in m.named_parameters()}


def grads_of(model):
    """name -> the gradient of each parameter of `model` on the host (zeros
    where it has none), in float64."""
    import torch

    return {k: (torch.zeros_like(p) if p.grad is None else p.grad
                ).detach().cpu().double()
            for k, p in model.named_parameters()}


def zoo_parity(name, gen):
    """Phase 12a: the card against the port on the CPU at PARITY_SIZE^3,
    batch 1, TF32 off, with one shared host draw of noise and masks.  In
    float32: train-mode logits (ZOO_LOGIT_TOL x max), then one
    `seg_train_step`'s loss (PARITY_LOSS_RTOL).  The gradients of that
    step in float64 on both devices, every tensor within ZOO_GRAD64_RTOL
    x its max|ref| (the float32 ones are recorded beside their float64
    references).  The card's AdamW step applied to the CPU's float32
    gradients from the same pre-step state gives the CPU's parameters
    within ZOO_OPT_ATOL; the card's own parameters after its step are
    recorded against the CPU's (Adam moves an element whose gradient is
    float32 noise around 0 by up to lr either way)."""
    import copy

    import torch

    from mri_epilepsy_diagnosis_torch.train import seg as TS
    from mri_epilepsy_diagnosis_torch.train.optim import torch_adamw
    from mri_epilepsy_diagnosis_torch.train.state import create_train_state

    x, labels = (torch.from_numpy(a) for a in
                 seg_batches(gen, 1, 1, PARITY_SIZE)[0])
    y64 = TS.binarize_segmentation(labels).double()
    model = zoo_model(name, "cpu")
    res = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev).train()
        with torch.no_grad(), host_draws(SEED + 1):
            logits = m(x.to(dev)).cpu()
        state = create_train_state(m, torch_adamw())
        with host_draws(SEED + 2):
            state, loss = TS.seg_train_step(state, x.to(dev),
                                            labels.to(dev))
        m64 = copy.deepcopy(model).to(dev, torch.float64).train()
        with host_draws(SEED + 2):
            TS.seg_loss(m64, x.to(dev, torch.float64),
                        y64.to(dev)).backward()
        res[dev] = dict(
            logits=logits, loss=loss.item(), grads=grads_of(m),
            grads64=grads_of(m64),
            params={k: p.detach().cpu() for k, p in m.named_parameters()})
    cpu, card = res["cpu"], res["cuda"]
    on_card = adamw_step_on(model, cpu["grads"], "cuda")

    def worst(a, b, ref):
        """max over tensors of max|a - b| / max|ref| (0 / 0 as 0)."""
        return max(((a[k] - b[k]).abs().max()
                    / r.abs().max().clamp_min(1e-300)).item()
                   for k, r in ref.items())

    out = {"size": PARITY_SIZE, "batch": 1,
           "logits_err_over_max": ((card["logits"] - cpu["logits"]).abs()
                                   .max() / cpu["logits"].abs().max()).item(),
           "loss_card": card["loss"], "loss_cpu": cpu["loss"],
           "loss_rel_err": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
           "grad64_err_over_max": worst(card["grads64"], cpu["grads64"],
                                        cpu["grads64"]),
           "grad32_err_over_max": worst(card["grads"], cpu["grads"],
                                        cpu["grads64"]),
           "cpu_grad32_own_over_max": worst(cpu["grads"], cpu["grads64"],
                                            cpu["grads64"]),
           "card_grad32_own_over_max": worst(card["grads"],
                                             card["grads64"],
                                             cpu["grads64"]),
           "adamw_max_abs_err": max((on_card[k] - p).abs().max().item()
                                    for k, p in cpu["params"].items()),
           "param_max_abs_err": max(
               (card["params"][k] - p).abs().max().item()
               for k, p in cpu["params"].items()),
           "parameters": sum(p.numel() for p in cpu["params"].values()),
           "foreground_share": y64.mean().item()}
    log(f"zoo {name} parity (card vs CPU): {json.dumps(out)}")
    if (out["logits_err_over_max"] > ZOO_LOGIT_TOL
            or out["loss_rel_err"] > PARITY_LOSS_RTOL
            or out["grad64_err_over_max"] > ZOO_GRAD64_RTOL
            or out["adamw_max_abs_err"] > ZOO_OPT_ATOL):
        raise AssertionError(f"zoo {name}: card and CPU disagree: {out}")
    return out


# kernel-name tokens of phase 12's device split, matched in this order
# (lower case); the rest is elementwise
ZOO_KINDS = (
    ("copy", ("memcpy", "memset")),
    ("elementwise", ("distribution",)),          # the random draws
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit",
              "nchwtonhwc", "nhwctonchw")),
    ("norm", ("reduce_kernel", "norm")),
    ("resize", ("gemm", "gemv", "nvjet", "index", "scatter", "gather")),
    ("layout", ("copy_kernel",)),                # strided tensor copies
)


def zoo_split(rows):
    """Device ms of a profiled zoo step by kind, from `profile_batch`'s
    rows (kernel name, ms, calls), by ZOO_KINDS: cuDNN convolutions (and
    their layout transforms), norms (the reductions of the Instance and
    Group norms, and the dice loss's), resizes (the trilinear matmuls,
    the nearest gathers and their gradients' scatters), host-device
    copies, copies of strided tensors (layout), and the elementwise
    rest."""
    split = {f"{kind}_ms": 0.0 for kind, _ in ZOO_KINDS}
    for row in rows:
        name = row["name"].lower()
        kind = next((kind for kind, tokens in ZOO_KINDS
                     if any(t in name for t in tokens)), "elementwise")
        split[f"{kind}_ms"] += row["ms"]
    return split


def zoo_timing(name, gen):
    """Phase 12b-c: bf16 `seg_train_step`s at PATCH^3 batch PATCH_BATCH
    and SIZE^3 batch 1 (1 warm-up, ZOO_TIMED_STEPS timed on one batch:
    ms, volumes or patches per second, peak memory, finite and falling
    losses), `seg_eval_step` ms at SIZE^3, and one profiled SIZE^3 step
    split by `zoo_split` with the device's idle share."""
    import torch

    from mri_epilepsy_diagnosis_torch.train import seg as TS
    from mri_epilepsy_diagnosis_torch.train.optim import torch_adamw
    from mri_epilepsy_diagnosis_torch.train.state import create_train_state

    state = create_train_state(zoo_model(name, "cuda"), torch_adamw())
    out = {}
    for label, size, batch in (("patch", PATCH, PATCH_BATCH),
                               ("volume", SIZE, 1)):
        x, labels = (torch.from_numpy(a).cuda() for a in
                     seg_batches(gen, 1, batch, size)[0])
        x = x.to(torch.bfloat16)
        losses = [TS.seg_train_step(state, x, labels)[1].item()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(ZOO_TIMED_STEPS):
            losses.append(TS.seg_train_step(state, x, labels)[1].item())
        step_s = (time.perf_counter() - t0) / ZOO_TIMED_STEPS
        res = {"size": size, "batch": batch, "dtype": "bf16",
               "losses": losses, "ms_per_step": step_s * 1e3,
               "per_s": batch / step_s,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        timed = losses[1:]
        if not (np.all(np.isfinite(losses)) and timed[-1] < timed[0]):
            raise AssertionError(f"zoo {name} {label}: losses {losses}")
        if label == "volume":
            TS.seg_eval_step(state, x, labels)            # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ZOO_EVAL_REPS):
                eval_loss = TS.seg_eval_step(state, x, labels).item()
            res["eval_ms"] = (time.perf_counter() - t0) / ZOO_EVAL_REPS * 1e3
            res["eval_loss"] = eval_loss
            prof = profile_batch(lambda: TS.seg_train_step(state, x, labels),
                                 top=100_000, name_len=400)
            res["profile"] = {
                **zoo_split(prof["top"]),
                **{k: prof[k] for k in ("wall_ms", "device_ms", "kernel_ms",
                                        "idle_share")},
                "top": [dict(r, name=r["name"][:160])
                        for r in prof["top"][:12]]}
        out[label] = res
        log(f"zoo {name} {label} ({size}^3 b{batch} bf16): "
            f"{json.dumps({k: v for k, v in res.items() if k != 'profile'})}")
        del x, labels
    log(f"zoo {name} profile ({SIZE}^3 step): "
        f"{json.dumps({k: v for k, v in out['volume']['profile'].items() if k != 'top'})}")
    del state
    torch.cuda.empty_cache()
    return out


def zoo_phase(K, gen):
    """Phase 12: each ZOO configuration's parity (12a) and timing and
    profile (12b-c); no kernel of the port launches in the whole phase
    (12d)."""
    K.reset_launch_counts()
    out = {}
    for name in ZOO:
        t0 = time.perf_counter()
        out[name] = {"parity": zoo_parity(name, gen),
                     "timing": zoo_timing(name, gen)}
        out[name]["seconds"] = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in K.KERNELS}
    log(f"launches (zoo phase): {launches} (expected all 0)")
    if any(launches.values()):
        raise AssertionError(f"zoo phase launched port kernels: {launches}")
    out["launches"] = launches
    return out


# kernel-name substrings of the device split of a classification step
# (phase 13c): cuDNN's convolutions (its `*_implicit_gemm` kernels too),
# cuBLAS's GEMMs (the FC layers), the packed convs' dw and its fold
STEP_GROUPS = {"cudnn_ms": ("fprop", "dgrad", "wgrad", "cudnn", "convolve"),
               "gemm_ms": ("gemm", "nvjet", "cutlass"),
               "dw_ms": ("dw_packed",)}


def packed_encoder_phase(K, Fd, FP, enc, x8, gen, launch_counts):
    """Phase 13a-b on the kernel side, batch BATCH at 192^3: a copy of the
    ensemble's encoder after one train-mode pass (running statistics moved
    from phase 4's), its packed forward's B3 launches recorded in bf16
    (e0 fused, e1 and e2 three `conv_axis` each) and each held against its
    plain version in f32 and bf16 (the stacks at SEP_TOL, each one-axis
    launch at TOL; bf16 timed beside cuDNN); the packed and fused latents
    against the fine `Encoder` (f32 within ENC_LATENT_TOL x max, bf16
    recorded), exact launch counts per forward (the fused path launches no
    kernel of the port), ms per batch of each."""
    import copy

    import torch

    kw = FADER_AE_KWARGS
    enc = copy.deepcopy(enc)
    with torch.no_grad():
        enc.train()
        enc(x8[:2])
    enc.eval()
    xb = x8.to(torch.bfloat16)
    with torch.inference_mode():
        calls = record_b3(K, lambda: FP.encoder_apply_packed(enc, xb, kw))
        stacks, axes = calls["stack"], calls["axis"]
        routes = [K._separable_route(torch.bfloat16, K.separable_plan(
            st["x"][0], st["x"][1:4], (st["x"][4], *(w[2] for w in st["w"])),
            [w[0] for w in st["w"]], st["stride"], st["pad"],
            torch.bfloat16)) for st in stacks]
        log(f"packed encoder stacks: {stacks}, routes {routes}")
        if routes != ["fused", "per_axis", "per_axis"] or len(axes) != 6:
            raise AssertionError(f"packed encoder B3 calls: {routes}, "
                                 f"{len(axes)} conv_axis")
        names = ("pe0", "pe1", "pe2")
        sep_rows, sep_errs = sep_kernel_phase(
            K, [(n, st, 1) for n, st in zip(names, stacks)], gen,
            [(None, "f32"), (None, "bf16")], (None, "bf16"),
            fused_only=False)
        axis_names = [f"{n}{ax}" for n in names[1:] for ax in "xyz"]
        axis_rows, axis_errs = b3_kernel_phase(K, axis_names, axes, gen,
                                               (BATCH,))
        lat, counts, ms = {}, {}, {}
        for dn, x in (("f32", x8), ("bf16", xb)):
            ref, ref_sizes = enc(x)
            for path, fn in (("packed", FP.encoder_apply_packed),
                             ("fused", Fd.encoder_apply_fused)):
                K.reset_launch_counts()
                got, sizes = fn(enc, x, kw)
                torch.cuda.synchronize()
                counts[f"{path}_{dn}"] = launch_counts()
                # the packed forward's `conv_axis` launches all take the
                # tensor cores in bf16; the fused path launches no kernel
                want = ({k: 0 for k in PACKED_ENC_PER_BATCH}
                        if path == "fused" else {
                            **PACKED_ENC_PER_BATCH,
                            "conv_axis_tc": 6 if dn == "bf16" else 0})
                _expect_counts(f"{path} encoder forward {dn}",
                               counts[f"{path}_{dn}"], want)
                if sizes != ref_sizes:
                    raise AssertionError(f"{path} size_list {sizes} != "
                                         f"{ref_sizes}")
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                lat[f"{path}_{dn}_max_abs_err"] = err
                lat[f"{path}_{dn}_max_abs_ref"] = scale
                log(f"{path} encoder latent {dn}: max_abs_err {err:.3e} "
                    f"(max|ref| {scale:.3e}; f32 tol {ENC_LATENT_TOL} x max)")
                if dn == "f32" and err > ENC_LATENT_TOL * scale:
                    raise AssertionError(f"{path} latent differs by {err}")
            if dn == "bf16":
                for path, fn in (("fine", lambda: enc(xb)),
                                 ("packed", lambda: FP.encoder_apply_packed(
                                     enc, xb, kw)),
                                 ("fused", lambda: Fd.encoder_apply_fused(
                                     enc, xb, kw))):
                    ms[f"{path}_ms_per_batch"] = time_ms(fn, 5)
    out = {"batch": BATCH, "size": SIZE, "latents": lat,
           "launches_per_forward": counts, "bf16": ms,
           "stack_routes": routes,
           "kernel_max_abs_err": {"stacks": sep_errs, "axis": axis_errs}}
    log(f"packed encoder: {json.dumps(out)}")
    return enc, out, sep_rows, axis_rows


def _vox_model(gen, seed=SEED, **kw):
    """A VoxResNet on the card: torch's default init drawn under `seed`
    (on the host, then moved), then random BatchNorm statistics and
    affine parameters and conv biases from `gen`, so that eval mode and
    the bias folds are exercised."""
    import torch

    from mri_epilepsy_diagnosis_torch.models import VoxResNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = VoxResNet(device="cpu", **kw).to("cuda")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                for t, lo, hi in ((m.running_var, 0.5, 1.5),
                                  (m.weight, 0.5, 1.5)):
                    t.copy_(lo + (hi - lo) * torch.rand(
                        t.shape, generator=gen, device="cuda"))
                for t in (m.running_mean, m.bias):
                    t.copy_(0.2 * torch.randn(t.shape, generator=gen,
                                              device="cuda"))
            elif isinstance(m, torch.nn.Conv3d) and m.bias is not None:
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen,
                                               device="cuda"))
    return model


def _allclose_err(got, ref, tol):
    """max(|got - ref| - rtol |ref|) against atol, numpy's allclose."""
    atol, rtol = tol
    return ((got.double() - ref.double()).abs()
            - rtol * ref.double().abs()).max().item(), atol


@contextlib.contextmanager
def _packed_relu_masks():
    """Collects, in call order and in the fine layout, where each ReLU of
    the packed VoxResNet step passed its input (output > 0): the
    BatchNorm tails' (`ops/packed.py::bn_act_train_packed`, shifted or
    aligned), and the residual adds' and the head's
    (`models/voxresnet_packed.py::_relu`)."""
    from mri_epilepsy_diagnosis_torch.models import voxresnet_packed as VP
    from mri_epilepsy_diagnosis_torch.ops import packed as P

    tail, relu = P.bn_act_train_packed, VP._relu
    masks = []

    def passed(out, shifted=False):
        if out.ndim == 5:
            out = P.unpack2(out)
            if shifted:
                out = out[:, 1:-1, 1:-1, 1:-1]
        masks.append((out > 0).detach())

    def tail_seen(y, gamma, beta, alpha, running, *, shifted, valid):
        out = tail(y, gamma, beta, alpha, running, shifted=shifted,
                   valid=valid)
        if alpha is not None:
            passed(out[0], shifted)
        return out

    def relu_seen(t):
        out = relu(t)
        passed(out)
        return out

    P.bn_act_train_packed, VP._relu = tail_seen, relu_seen
    try:
        yield masks
    finally:
        P.bn_act_train_packed, VP._relu = tail, relu


@contextlib.contextmanager
def _fine_at_masks(masks):
    """The fine model's ReLUs pass exactly where the packed step's did
    (`masks`, in call order), so that an input that float32 rounding puts
    on the other side of 0 takes the same branch in both."""
    from mri_epilepsy_diagnosis_torch.ops import functional as F

    relu = F.relu
    taken = iter(masks)

    def at_mask(t):
        mask = next(taken)
        if mask.shape != t.shape:
            raise AssertionError(f"ReLU mask {tuple(mask.shape)} for "
                                 f"{tuple(t.shape)}")
        return t * mask

    F.relu = at_mask
    try:
        yield
    finally:
        F.relu = relu
    if next(taken, None) is not None:
        raise AssertionError("the fine model took fewer ReLUs than the "
                             "packed step")


def voxresnet_parity_phase(K, VP, gen, launch_counts):
    """Phase 13c, f32 parity of the packed VoxResNet (B1 on CUDA cores)
    with the fine port (cuDNN, TF32 off) on the card, at the sizes and
    tolerances of tests/test_torch_voxresnet_packed.py (VOX_PARITY): eval
    and train logits and the new running statistics against the fine
    model; every gradient against the fine model run at the packed step's
    batch statistics, 1e-4 x its tensor's max plus that model's own
    float32 rounding (its float32 gradient against its float64 one on the
    card, both at those statistics); the pre-BN conv biases (true gradient
    0) at 1e-4 x the largest gradient.  Exact B1 launch counts of the
    packed train step."""
    import copy

    import torch

    from mri_epilepsy_diagnosis_torch.train.classification import (
        cross_entropy)

    out = {}
    for name, (size, kw) in VOX_PARITY.items():
        model = _vox_model(gen, input_shape=(size,) * 3, n_fc_units=16, **kw)
        x = torch.randn((2, size, size, size, 1), generator=gen,
                        device="cuda")
        y = torch.tensor([0, 1], device="cuda")
        res = {}
        with torch.no_grad():
            ref = model.eval()(x)
            got, _ = VP.voxresnet_apply_packed(model, x, train=False)
        res["eval"] = _allclose_err(got, ref, VOX_EVAL_TOL)
        fine = copy.deepcopy(model).train()
        with torch.no_grad():
            ref = fine(x)
        packed = copy.deepcopy(model)
        K.reset_launch_counts()
        with _packed_relu_masks() as masks:
            got, stats = VP.voxresnet_apply_packed(packed, x, train=True)
        cross_entropy(got, y).backward()
        torch.cuda.synchronize()
        # forward: conv3d_2, 5 convs a stage and, at stride 2, the stem
        # (at stride 1 it is cuDNN's); dx: all but the stem's; the
        # BatchNorm tail: 2 sites, then 5 a stage, each pass once a site
        stages, stride = model.stages, model.model["conv3d_1"].stride[0]
        n_fwd, n_dx = 1 + (stride == 2) + 5 * stages, 1 + 5 * stages
        res["launches"] = launch_counts()
        _expect_counts(f"voxresnet f32 {name} train step", res["launches"], {
            **{k: 0 for k in VOX_PER_STEP}, "conv2_packed": n_fwd + n_dx,
            "conv2_packed_dx": n_dx,
            **{k: 2 + 5 * stages for k in BN_PASSES}})
        res["train"] = _allclose_err(got, ref, VOX_TRAIN_TOL)
        buffers = dict(fine.named_buffers())
        res["stats"] = max((_allclose_err(v, buffers[k], VOX_STATS_TOL)
                            for k, v in stats.items()), key=lambda e: e[0])
        at = copy.deepcopy(model).train()
        m64 = copy.deepcopy(model).double().train()
        for m, xm in ((at, x), (m64, x.double())):
            with _fine_at_masks(masks):
                cross_entropy(m(xm), y).backward()
        g64 = dict(m64.named_parameters())
        gf = dict(at.named_parameters())
        largest = max(p.grad.abs().max().item() for p in gf.values())
        worst = (0.0, None)
        for n, p in packed.named_parameters():
            r = gf[n].grad
            err = (p.grad - r).abs().max().item()
            if n in VOX_PRE_BN_BIASES:
                tol = VOX_GRAD_RTOL * largest
            else:
                rounding = (r.double() - g64[n].grad).abs().max().item()
                tol = VOX_GRAD_RTOL * r.abs().max().item() + rounding
                if tol >= 0.5 * r.abs().max().item():
                    raise AssertionError(f"{name} {n}: vacuous bound {tol}")
            worst = max(worst, (err / tol, n), key=lambda e: e[0])
        res["grad_worst_share_of_tol"] = worst
        log(f"voxresnet f32 parity {name}: {json.dumps(res)}")
        for key in ("eval", "train", "stats"):
            if res[key][0] > res[key][1]:
                raise AssertionError(f"{name} {key} differs: {res[key]}")
        if worst[0] > 1.0:
            raise AssertionError(f"{name} gradient {worst[1]} differs")
        out[name] = res
        del model, fine, packed, at, m64
        torch.cuda.empty_cache()
    return out


def vox_layers(model, size):
    """(name, fine nn.Conv3d, fine input size) of each distinct B1 site of
    the packed forward in call order, and the site index of each of the
    forward's launches: the stem, conv3d_2, then per stage the downsample
    and the two blocks' conv1 / conv2 (the same shapes in both blocks)."""
    m = model.model
    layers = [("stem", m["conv3d_1"], size),
              ("conv3d_2", m["conv3d_2"], size // 2)]
    order = [0, 1]
    f = size // 2
    for i in range(model.stages):
        layers.append((f"conv3d_{i + 3}", m[f"conv3d_{i + 3}"], f))
        f //= 2
        blk = m[f"block_{2 * i + 1}"]
        layers += [(f"stage{i + 1}.conv1", blk.conv1, f),
                   (f"stage{i + 1}.conv2", blk.conv2, f)]
        base = len(layers) - 3
        order += [base, base + 1, base + 2, base + 1, base + 2]
    return layers, order


def _fine_yardstick(conv, size, batch, dtype, gen):
    """cuDNN's forward and input gradient of the fine layer (the library
    yardstick of a B1 site): callables on random channels-last data."""
    import torch
    import torch.nn.functional as TF

    s, ci, co = conv.stride[0], conv.in_channels, conv.out_channels
    x = torch.randn((batch, ci, size, size, size), generator=gen,
                    device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last_3d)
    w = conv.weight.detach().to(dtype).contiguous(
        memory_format=torch.channels_last_3d)
    out = size // s
    g = torch.randn((batch, co, out, out, out), generator=gen,
                    device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last_3d)
    return (lambda: TF.conv3d(x, w, None, stride=s, padding=1),
            lambda: torch.ops.aten.convolution_backward(
                g, x, w, None, [s] * 3, [1] * 3, [1] * 3, False, [0] * 3, 1,
                [True, False, False]))


def vox_site_rows(K, P, sites, model, gen):
    """Each distinct B1 site of the recorded packed VoxResNet step (bf16,
    batch VOX_BATCH at 192^3) against its plain version: the forward
    launch (bf16 at batch VOX_BATCH, f32 at batch 1), its input gradient
    (all but the stem's) and, at the aligned->shifted sites the eval
    forward takes, the launch with B2 fused (alpha 0); each timed in bf16
    beside cuDNN's forward / input gradient of the fine layer; and its
    weight gradient in bf16 (`dw_check`).  Rows are repeated by their
    calls per step.  Returns rows {"forward", "dx", "fused", "dw"} and the
    largest errors by kind and dtype."""
    import torch
    import torch.nn.functional as TF

    layers, order = vox_layers(model, SIZE)
    fwd = sites["forward"]
    if len(fwd) != len(order):
        raise AssertionError(f"{len(fwd)} forward B1 launches per step")
    calls = [order.count(i) for i in range(len(layers))]
    first = [order.index(i) for i in range(len(layers))]
    want_dx = sorted((tuple(fwd[j]["wp"]), fwd[j]["pad"])
                     for j in range(1, len(fwd)))
    got_dx = sorted((d["wp"], d["pad"]) for d in sites["dx"])
    if got_dx != want_dx:
        raise AssertionError(f"dx launches {got_dx} != {want_dx}")
    if len(sites["dw"]) != len(fwd):
        raise AssertionError(f"{len(sites['dw'])} weight gradients per "
                             f"step, not {len(fwd)}")
    rows = {"forward": [], "dx": [], "fused": [], "dw": []}
    errs = {k: {"f32": 0.0, "bf16": 0.0} for k in rows}
    errs["dw"]["f32"] = None          # dw is checked in bf16 only
    for i, (name, conv, fine) in enumerate(layers):
        site = fwd[first[i]]
        c8i, c8o, pad = site["x"][4], site["wp"][4], site["pad"]
        fine_fwd, fine_dx = _fine_yardstick(conv, fine, VOX_BATCH,
                                            torch.bfloat16, gen)
        for batch, dn in ((1, "f32"), (VOX_BATCH, "bf16")):
            dt = torch.float32 if dn == "f32" else torch.bfloat16
            x = torch.randn((batch, *site["x"][1:]), generator=gen,
                            device="cuda").to(dt)
            wp = (torch.randn(site["wp"], generator=gen, device="cuda")
                  / np.sqrt(8 * c8i)).to(dt)
            bias = (torch.randn(c8o, generator=gen, device="cuda")
                    if site["bias"] else None)
            got = K.conv2_packed(x, wp, bias, pad=pad)
            torch.cuda.synchronize()
            route = K._conv2_route(dt, c8i, c8o)
            err = check(f"voxresnet conv2_packed {name} b{batch} ({route})",
                        got, K.conv2_packed_plain(x, wp, bias, pad=pad), dn)
            errs["forward"][dn] = max(errs["forward"][dn], err)
            m = got.shape[0] * got.shape[1] * got.shape[2] * got.shape[3]
            flops = 2.0 * m * (8 * c8i) * c8o          # 8 taps
            nbytes = (x.numel() + wp.numel() + got.numel()) \
                * x.element_size() + (0 if bias is None else 4 * c8o)
            timed = dn == "bf16"
            if timed:
                rows["forward"] += [vox_row(
                    name, route, err, x, flops, nbytes,
                    lambda: K.conv2_packed(x, wp, bias, pad=pad),
                    lambda: K.conv2_packed_plain(x, wp, bias, pad=pad),
                    fine_fwd, calls[i])] * calls[i]
            if i > 0:           # the stem's input takes no gradient
                g = torch.randn(got.shape, generator=gen,
                                device="cuda").to(dt)
                dx = K.conv2_packed_dx(g, wp, pad=pad)
                torch.cuda.synchronize()
                err = check(f"voxresnet conv2_packed_dx {name} b{batch}", dx,
                            K.conv2_packed_dx_plain(g, wp, pad=pad), dn)
                errs["dx"][dn] = max(errs["dx"][dn], err)
                if timed:
                    rows["dx"] += [vox_row(
                        name, K._conv2_route(dt, c8o, c8i), err, g, flops,
                        (g.numel() + wp.numel() + dx.numel())
                        * g.element_size(),
                        lambda: K.conv2_packed_dx(g, wp, pad=pad),
                        lambda: K.conv2_packed_dx_plain(g, wp, pad=pad),
                        fine_dx, calls[i])] * calls[i]
            if pad == 1:        # eval: BN + ReLU + pad zeroing fused
                scale = 0.5 + torch.rand(c8o, generator=gen, device="cuda")
                shift = torch.randn(c8o, generator=gen, device="cuda")
                alpha = torch.zeros(c8o, device="cuda")
                fused = K.conv2_packed_as_bn_act(x, wp, scale, shift, alpha)
                torch.cuda.synchronize()
                err = check(f"voxresnet conv2_packed_as_bn_act {name} "
                            f"b{batch}", fused, K.conv2_packed_as_bn_act_plain(
                                x, wp, scale, shift, alpha), dn)
                errs["fused"][dn] = max(errs["fused"][dn], err)
                if timed:
                    rows["fused"] += [vox_row(
                        name, route, err, x, flops, nbytes + 3 * 4 * c8o,
                        lambda: K.conv2_packed_as_bn_act(x, wp, scale, shift,
                                                         alpha),
                        lambda: K.conv2_packed_as_bn_act_plain(
                            x, wp, scale, shift, alpha),
                        fine_fwd, calls[i])] * calls[i]
            if timed:           # the weight gradient, on the kernel
                gw = torch.randn(got.shape, generator=gen,
                                 device="cuda").to(dt)
                err, row = dw_check(K, P, TF, name, x, gw, pad)
                errs["dw"][dn] = max(errs["dw"][dn], err)
                rows["dw"] += [row] * calls[i]
                del gw
            del x, wp, got
            torch.cuda.empty_cache()
    return rows, errs


def vox_row(name, route, err, x, flops, nbytes, run, plain, library, calls):
    bound_ms, bound_by = _bound(flops, nbytes, "bf16")
    ms = time_ms(run, 10)
    row = {"site": name, "x": list(x.shape), "route": route,
           "calls_per_step": calls, "max_abs_err": err, "ms": ms,
           "plain_ms": time_ms(plain, 1), "library_ms": time_ms(library, 10),
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / ms,
           "tflops": flops / ms / 1e9}
    log(f"time voxresnet {name} b{x.shape[0]} bf16: {json.dumps(row)}")
    return row


@contextlib.contextmanager
def no_plain_bn_composition(K, P, label):
    """`no_plain_bn`, and counts the calls of the plain BatchNorm
    composition that `BnActTrainPacked` replaced on the packed VoxResNet's
    train path (`zero_shifted_pads`, `batch_norm_packed`,
    `models/unet_packed.py::_bn_train_packed`) while the block runs: there
    must be none."""
    from mri_epilepsy_diagnosis_torch.models import unet_packed as UP

    calls = []
    saved = [(P, "zero_shifted_pads"), (P, "batch_norm_packed"),
             (UP, "_bn_train_packed")]
    originals = [getattr(m, k) for m, k in saved]

    def counting(name, f):
        def run(*args, **kw):
            calls.append(name)
            return f(*args, **kw)
        return run

    for (m, k), f in zip(saved, originals):
        setattr(m, k, counting(k, f))
    try:
        with no_plain_bn(K, label):
            yield
    finally:
        for (m, k), f in zip(saved, originals):
            setattr(m, k, f)
    log(f"plain BatchNorm composition calls ({label}): {len(calls)} "
        "(expected 0)")
    if calls:
        raise AssertionError(f"{label}: the plain BatchNorm composition ran: "
                             f"{sorted(set(calls))}")


def voxresnet_train_phase(K, P, VP, gen, launch_counts):
    """Phase 13c at bench.py's configuration (VOX_KWARGS, bf16, batch
    VOX_BATCH, Adam lr VOX_LR with L2 decay VOX_WD, Dropout from a seeded
    card generator): every B1 launch and BatchNorm-tail pass of one packed
    step recorded, each distinct B1 site checked and timed
    (`vox_site_rows`), each tail pass checked and timed (`bn_tail_rows`);
    1 warm-up and VOX_TIMED_STEPS timed packed steps through
    `run_one_epoch(..., packed=True)`'s route (exact launch counts, also
    by kind (`launch_split`), no plain BatchNorm pass or composition,
    finite losses, parameters that move, ms, vol/s, peak memory), one
    profiled step (device ms and kernel count; B1 forward and input
    gradients, cuDNN, cuBLAS GEMMs, dw, the BatchNorm tail, other kernels,
    copies; the idle share), the same for the fine `_class_step` of the
    same initial model; one bf16 eval forward of each (the packed one with
    B2 fused at 9 launches)."""
    import copy

    import torch

    from mri_epilepsy_diagnosis_torch.train import TrainState
    from mri_epilepsy_diagnosis_torch.train.classification import (
        _class_step, run_one_epoch)
    from mri_epilepsy_diagnosis_torch.train.optim import torch_adam

    model = _vox_model(gen, **VOX_KWARGS)
    fine_model = copy.deepcopy(model)
    x = torch.randn((VOX_BATCH, SIZE, SIZE, SIZE, 1), generator=gen,
                    device="cuda").to(torch.bfloat16)
    y = torch.arange(VOX_BATCH, device="cuda") % 2
    drop = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"config": {**VOX_KWARGS, "batch": VOX_BATCH, "dtype": "bf16",
                      "optimizer": f"torch_adam({VOX_LR}, weight_decay="
                                   f"{VOX_WD})"}}

    def new_state(m):
        return TrainState(m, torch_adam(VOX_LR, weight_decay=VOX_WD)(
            m.parameters()))

    def b1_ms(prof):
        return prof["conv2_packed_tc_ms"] + prof["conv2_packed_ms"]

    def packed_step(st):
        """One packed train step through `run_one_epoch`'s route (the
        batch already on the card, staged as it is)."""
        st, losses, p1, _ = run_one_epoch(st, [(x, y)], True,
                                          rng_stream=drop, prefetch=0,
                                          packed=True)
        p1 = torch.tensor(p1, device="cuda")
        return st, losses[0], torch.stack([1 - p1, p1], dim=-1)

    def run(step_fn, state, tag, forward_fn):
        before = {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()}
        sites = None
        if tag == "packed":
            sites = record_train_sites(K, P, lambda: step_fn(state))
        else:
            step_fn(state)                               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        VP.reset_launch_counts()
        losses = []
        guard = (no_plain_bn_composition(K, P, f"{VOX_TIMED_STEPS} packed "
                                                "VoxResNet steps")
                 if tag == "packed" else contextlib.nullcontext())
        t0 = time.perf_counter()
        with guard:
            for _ in range(VOX_TIMED_STEPS):
                _, loss, probs = step_fn(state)
                losses.append(float(loss))
        step_s = (time.perf_counter() - t0) / VOX_TIMED_STEPS
        counts = launch_counts()
        want = ({k: VOX_TIMED_STEPS * v for k, v in VOX_PER_STEP.items()}
                if tag == "packed" else {k: 0 for k in VOX_PER_STEP})
        _expect_counts(f"voxresnet {tag} steps", counts, want)
        split = VP.launch_split()
        _expect_counts(f"voxresnet {tag} steps by kind", split, {
            k: VOX_TIMED_STEPS * v if tag == "packed" else 0
            for k, v in VOX_SPLIT_PER_STEP.items()})
        # the device split from the profiler's kernel times (CUDA events
        # around each call would count the host's gaps too): B1 of the
        # step less B1 of a train-mode forward gives the input gradients
        prof = profile_batch(lambda: step_fn(state), groups=STEP_GROUPS)
        with torch.no_grad():
            fwd = profile_batch(forward_fn, groups=STEP_GROUPS)
        grp = prof["groups_ms"]
        split_ms = {"b1_forward_ms": b1_ms(fwd),
                    "b1_dx_ms": b1_ms(prof) - b1_ms(fwd),
                    "cudnn_ms": grp["cudnn_ms"],
                    "cudnn_forward_ms": fwd["groups_ms"]["cudnn_ms"],
                    "gemm_ms": grp["gemm_ms"], "dw_ms": grp["dw_ms"],
                    "bn_tail_ms": prof["bn_train_ms"],
                    "other_ms": prof["kernel_ms"] - b1_ms(prof)
                    - grp["cudnn_ms"] - grp["gemm_ms"] - grp["dw_ms"]
                    - prof["bn_train_ms"],
                    "copy_ms": prof["copy_ms"],
                    "device_ms": prof["device_ms"]}
        after = state.model.state_dict()
        floats = [k for k in before if before[k].is_floating_point()]
        moved = sum(not torch.equal(before[k], after[k]) for k in floats)
        res = {"losses": losses, "ms_per_step": step_s * 1e3,
               "vol_per_s": VOX_BATCH / step_s,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches_timed_steps": counts, "launch_split": split,
               "step_split": split_ms,
               # against the unprofiled step's wall, and the profiled one's
               "idle_share": 1 - prof["device_ms"] / (step_s * 1e3),
               "idle_share_profiled": prof["idle_share"], "profile": prof,
               "forward_profile": fwd,
               "moved_tensors": moved, "tensors": len(floats),
               "probs_sum_to_one": bool(torch.allclose(
                   probs.sum(-1), torch.ones_like(probs[:, 0])))}
        log(f"voxresnet {tag} training: {json.dumps(res)}")
        if not (np.isfinite(losses).all() and res["probs_sum_to_one"]
                and moved == len(floats)):
            raise AssertionError(f"voxresnet {tag} steps: {res}")
        return res, sites

    out["packed"], sites = run(
        packed_step, new_state(model), "packed",
        lambda: VP.voxresnet_apply_packed(model, x, train=True,
                                          generator=drop))
    out["fine"], _ = run(lambda st: _class_step(st, x, y, drop, True),
                         new_state(fine_model), "fine",
                         lambda: fine_model.train()(x, generator=drop))
    # one eval forward of each on the trained models
    with torch.inference_mode():
        K.reset_launch_counts()
        VP.voxresnet_apply_packed(model, x, train=False)
        torch.cuda.synchronize()
        out["eval_launches"] = launch_counts()
        _expect_counts("voxresnet packed eval forward", out["eval_launches"],
                       VOX_EVAL_PER_CALL)
        out["eval_ms"] = {
            "packed": time_ms(lambda: VP.voxresnet_apply_packed(
                model, x, train=False), 3),
            "fine": time_ms(lambda: fine_model.eval()(x), 3)}
    del fine_model
    torch.cuda.empty_cache()
    rows, errs = vox_site_rows(K, P, sites, model, gen)
    out["kernel_max_abs_err"] = errs
    got = {k: sum(s["pass"] == k for s in sites["bn"]) for k in BN_PASSES}
    if got != {k: VOX_BN for k in BN_PASSES}:
        raise AssertionError(f"BatchNorm-tail passes per VoxResNet step "
                             f"{got} != {VOX_BN} each")
    out["bn_tail_rows"], out["bn_tail"] = bn_tail_rows(
        K, P, sites["bn"], f"VoxResNet step, {SIZE}^3 batch {VOX_BATCH} "
                           "bf16")
    return out, rows


# phase 14: distribution on the card.  One NCCL process group of world size
# 1 (the machine has one card, and NCCL refuses two ranks on one device;
# ranks > 1 are held on the CPU by the gloo tests), a (data, spatial) =
# (1, 1) mesh, and the code paths of tests/test_torch_parallel.py: 14a the
# 192^3 batch-2 bf16 packed step under the mesh beside the same step without
# it (BatchNorm sums, dice sums and the gradients all-reduced through
# NCCL); 14b phase 4's volumes served with `sharding=`; 14c the sliding
# window through `make_sharded_apply`; 14d fault C3's gate: float32 fine
# forwards with torch's TF32 default (cuDNN allowed TF32) against the CPU.
DIST_TIMED_STEPS = 3
DIST_PARAM_RTOL = 5e-7         # x |w|: a few float32 ulps of a weight
DIST_SERVE_ORDER = ("plain", "mesh", "mesh", "plain", "plain", "mesh")
DIST_SW_SIZE = 128             # f32 sliding window: 27 patches of PATCH^3
DIST_SW_OVERLAP = 8
DIST_SW_BATCH = 8
C3_SIZE = 64
C3_TOL = 1e-4                  # x max|ref|, card (TF32 allowed) vs CPU


def _free_local_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_profile(fn, trace_dir):
    """torch.profiler over one call of fn, through the port's
    `obs.profile_trace` (its trace kept under `trace_dir` for phase 15a's
    reader): the NCCL collectives the host issued (the process group's
    `nccl:*` ranges, by name), the NCCL kernels' count and device ms, and
    all device time."""
    import torch

    from mri_epilepsy_diagnosis_torch.obs import profile_trace

    with profile_trace(trace_dir) as prof:
        fn()
        torch.cuda.synchronize()
    rows, calls = [], {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.key.startswith("nccl:"):
                calls[e.key] = calls.get(e.key, 0) + e.count
            continue
        if getattr(e, "is_user_annotation", False):     # as `device_rows`
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((e.key, us / 1e3, e.count))
    nccl = [r for r in rows if "nccl" in r[0].lower()]
    device_ms = sum(r[1] for r in rows)
    nccl_ms = sum(r[1] for r in nccl)
    return {"nccl_host_calls": calls,
            "nccl_kernels": sum(r[2] for r in nccl), "nccl_ms": nccl_ms,
            "device_ms": device_ms,
            "nccl_share": nccl_ms / device_ms if device_ms else None,
            "nccl_names": sorted({r[0][:80] for r in nccl})}


def _first_adamw_step_agrees(state, ref):
    """Parameters after one AdamW step from zero moments on each state,
    from the same weights: Adam's first update is `lr g / (|g| + eps)`, so
    `state`'s parameters must lie within DIST_PARAM_RTOL x |w| plus that
    update's difference between the two gradients (float64) of `ref`'s.
    Returns (largest difference, worst difference / tolerance)."""
    group = ref.optimizer.param_groups[0]
    lr, eps = group["lr"], group["eps"]
    pm = dict(state.model.named_parameters())
    err = worst = 0.0
    for k, p in ref.model.named_parameters():
        g, gr = pm[k].grad.double(), p.grad.double()
        du = lr * (g / (g.abs() + eps) - gr / (gr.abs() + eps)).abs()
        diff = (pm[k].double() - p.double()).abs()
        tol = DIST_PARAM_RTOL * p.double().abs() + du
        err = max(err, diff.max().item())
        worst = max(worst, (diff / tol.clamp_min(1e-30)).max().item())
    return err, worst


def distribution_phase(K, UNet3D, gen, launch_counts, serving_inputs,
                       znorm_batch, mesh_trace_dir):
    """Phase 14 (see the comment above DIST_TIMED_STEPS)."""
    import copy

    import torch
    import torch.distributed as dist

    from mri_epilepsy_diagnosis_torch.core.mesh import (
        create_mesh, data_sharding, initialize_distributed)
    from mri_epilepsy_diagnosis_torch.infer import (make_sharded_apply,
                                                    segment_volumes,
                                                    sliding_window_predict)
    from mri_epilepsy_diagnosis_torch.models.unet_packed import (
        fold_bn_inference, packed_unet_apply_v2, packed_unet_mask_v2)
    from mri_epilepsy_diagnosis_torch.parallel import use_mesh
    from mri_epilepsy_diagnosis_torch.train import (TrainState,
                                                    packed_seg_train_step,
                                                    torch_adamw)

    if not initialize_distributed(f"127.0.0.1:{_free_local_port()}", 1, 0,
                                  device="cuda"):
        raise AssertionError("no process group")
    out = {}
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"process group backend {backend}")
        mesh = create_mesh(("data", "spatial"), (1, 1))
        if mesh.device.type != "cuda" or not mesh.distributed:
            raise AssertionError(f"mesh on {mesh.device}")

        # 14a: the packed step with and without the mesh, from one state
        model = UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
                       out_channels_first_layer=OCFL, device="cuda")
        random_state_dict(model, gen)
        xb, lb = seg_batches(gen, 1, TRAIN_BATCH, SIZE)[0]
        xb = torch.from_numpy(xb).cuda().to(torch.bfloat16)
        lb = torch.from_numpy(lb).cuda()
        states = {}
        for name in ("plain", "mesh"):
            m = copy.deepcopy(model)
            states[name] = TrainState(m, torch_adamw()(m.parameters()))
        del model

        def step(name):
            with use_mesh(mesh if name == "mesh" else None):
                return packed_seg_train_step(states[name], xb, lb)[1]

        losses, counts = {}, {}
        for name in ("plain", "mesh"):
            K.reset_launch_counts()
            losses[name] = float(step(name))
            counts[name] = launch_counts()
            _expect_counts(f"14a {name} step", counts[name], TRAIN_PER_STEP)
        parity = _grads_and_stats_agree(
            "14a mesh step vs plain step (bf16, phase 6b tolerances)",
            states["mesh"].model, states["plain"].model, losses["mesh"],
            losses["plain"])
        param_err, param_worst = _first_adamw_step_agrees(
            states["mesh"], states["plain"])
        n_bn = sum(isinstance(m, torch.nn.BatchNorm3d)
                   for m in states["mesh"].model.modules())
        # per BatchNorm its (Σy, Σy²) forward and its two cotangent sums
        # backward (`BnActTrainPacked`, one all-reduce each), the dice
        # loss's global mean and its cotangent, one flat gradient
        want_calls = {"nccl:all_reduce": 2 * n_bn + 2 + 1}
        ms = {}
        for name in ("plain", "mesh", "plain", "mesh"):
            step(name)                                   # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DIST_TIMED_STEPS):
                step(name)
            torch.cuda.synchronize()
            ms.setdefault(name, []).append(
                (time.perf_counter() - t0) / DIST_TIMED_STEPS * 1e3)
        prof = nccl_profile(lambda: step("mesh"), mesh_trace_dir)
        out["train_step"] = {
            "size": SIZE, "batch": TRAIN_BATCH, "dtype": "bf16",
            "loss_plain": losses["plain"], "loss_mesh": losses["mesh"],
            "parity": parity, "param_max_abs_diff": param_err,
            "param_worst_err_over_tol": param_worst,
            "nccl_host_calls_expected": want_calls,
            "ms_per_step_plain": ms["plain"], "ms_per_step_mesh": ms["mesh"],
            "launches_plain": counts["plain"],
            "launches_mesh": counts["mesh"], "profile_mesh_step": prof}
        log(f"14a distributed step: {json.dumps(out['train_step'])}")
        if param_worst > 1:
            raise AssertionError(f"14a parameters differ by {param_err} "
                                 f"({param_worst} x the tolerance)")
        if prof["nccl_host_calls"] != want_calls:
            raise AssertionError(
                f"14a: the mesh step issued NCCL collectives "
                f"{prof['nccl_host_calls']}, not {want_calls}")
        del states, xb, lb
        torch.cuda.empty_cache()

        # 14b: phase 4's volumes served data-parallel
        vols, state4, masks4 = serving_inputs
        params = fold_bn_inference(state4)
        n_batches = -(-len(vols) // BATCH)

        def serve(sharding):
            return np.stack([r["mask"] for r in segment_volumes(
                None, params, vols, batch_size=BATCH, dtype=torch.bfloat16,
                device="cuda", device_preprocess=znorm_batch,
                transfer_dtype=np.int16, mask_fn=packed_unet_mask_v2,
                pack_masks=True, sharding=sharding)])

        serve(data_sharding(mesh))                       # warm-up
        K.reset_launch_counts()
        masks = serve(data_sharding(mesh))
        serve_counts = launch_counts()
        _expect_counts("14b sharded serving", serve_counts,
                       {k: v * n_batches for k, v in UNET_PER_BATCH.items()})
        # phase 4's path (no sharding) and the sharded one in turns
        vps = {}
        for name in DIST_SERVE_ORDER:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(data_sharding(mesh) if name == "mesh" else None)
            vps.setdefault(name, []).append(
                len(vols) / (time.perf_counter() - t0))
        out["serving"] = {"volumes": len(vols), "batch": BATCH,
                          "order": list(DIST_SERVE_ORDER),
                          "vol_per_s": vps["mesh"],
                          "vol_per_s_plain": vps["plain"],
                          "masks_equal_phase4": bool(np.array_equal(
                              masks, masks4)),
                          "launches": serve_counts}
        log(f"14b sharded serving: {json.dumps(out['serving'])}")
        if not out["serving"]["masks_equal_phase4"]:
            raise AssertionError("14b: sharded masks differ from phase 4's")
        del params

        # 14c: the sliding window through make_sharded_apply, in f32
        sw_model = UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
                          out_channels_first_layer=OCFL, device="cuda")
        sw_params = fold_bn_inference(random_state_dict(sw_model, gen))
        del sw_model
        vol = torch.randn((DIST_SW_SIZE,) * 3 + (1,), generator=gen,
                          device="cuda")
        logits, sw_counts = {}, {}
        with torch.inference_mode():
            for name, fn in (("plain", packed_unet_apply_v2),
                             ("mesh", make_sharded_apply(
                                 packed_unet_apply_v2, mesh))):
                K.reset_launch_counts()
                logits[name] = sliding_window_predict(
                    fn, sw_params, vol, PATCH, DIST_SW_OVERLAP,
                    DIST_SW_BATCH)
                sw_counts[name] = launch_counts()
        sw_err = (logits["mesh"] - logits["plain"]).abs().max().item()
        sw_max = logits["plain"].abs().max().item()
        out["sliding_window"] = {
            "size": DIST_SW_SIZE, "patch": PATCH,
            "overlap": DIST_SW_OVERLAP, "batch": DIST_SW_BATCH,
            "dtype": "f32", "max_abs_err": sw_err, "max_abs": sw_max,
            "tol": SW_LOGIT_TOL, "launches": sw_counts["mesh"]}
        log(f"14c sharded sliding window: "
            f"{json.dumps(out['sliding_window'])}")
        if sw_counts["mesh"] != sw_counts["plain"] or not sw_counts[
                "mesh"]["conv2_packed"]:
            raise AssertionError(f"14c launch counts {sw_counts}")
        if sw_err > SW_LOGIT_TOL * sw_max:
            raise AssertionError(f"14c: sharded logits differ by {sw_err}")
        del logits, vol, sw_params
        torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()

    # 14d: C3, float32 fine forwards with torch's TF32 default for cuDNN
    out["c3"] = c3_phase(UNet3D, gen)
    return out


def c3_phase(UNet3D, gen):
    """The fine UNet3D and ResidualUNet3D forwards in float32 on the card
    with cuDNN allowed TF32 (torch's default) against the same models on
    the CPU: `ops/functional.py`'s convs must turn TF32 off themselves."""
    import copy

    import torch

    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        rows = {}
        x = torch.randn((1, C3_SIZE, C3_SIZE, C3_SIZE, 1), generator=gen,
                        device="cuda")
        unet = UNet3D(out_classes=2, num_encoding_blocks=BLOCKS,
                      out_channels_first_layer=OCFL, device="cuda").eval()
        random_state_dict(unet, gen)
        zoo = zoo_model("residual_unet3d", "cuda").eval()
        for name, model in (("unet3d", unet), ("residual_unet3d", zoo)):
            cpu = copy.deepcopy(model).to("cpu")
            with torch.inference_mode():
                got = model(x).cpu()
                ref = cpu(x.cpu())
            err = (got - ref).abs().max().item()
            rows[name] = {"size": C3_SIZE, "max_abs_err": err,
                          "max_abs": ref.abs().max().item(), "tol": C3_TOL,
                          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    finally:
        torch.backends.cudnn.allow_tf32 = was
    log(f"14d C3 (f32 with TF32 allowed, card vs CPU): {json.dumps(rows)}")
    bad = [k for k, r in rows.items()
           if r["max_abs_err"] > C3_TOL * r["max_abs"]]
    if bad:
        raise AssertionError(f"14d: float32 forwards differ: {bad}")
    return rows


# ---------------------------------------------------------------------------
# 15. observability and the examples (obs/, examples/torch_*.py) on the card
# ---------------------------------------------------------------------------

# 15a: the trace reader (`obs/trace_summary.py`) against the profiler's
# own `key_averages()` over the same window: launches per port kernel
# equal, device ms within 1%; phase 14's mesh step all-reduces as counted
OBS_DEVICE_MS_RTOL = 0.01
MESH_ALL_REDUCES = 21          # 9 BatchNorms x 2, dice mean and cotangent, 1
# the profiler drops a kernel's record now and then (runs on this card:
# about one launch in a few thousand, in one window of four), which the
# reader sees as a host launch without its kernel (`lost_launches`): such
# a window is traced again, at most this many times in all
OBS_TRACE_ATTEMPTS = 4
# 15b: phase 6's training run through `examples/torch_train_segmentation.py`
OBS_TRAIN_ARGS = ("--synthetic", "--packed", "--bf16", "--img-size",
                  str(SIZE), "--ocfl", str(OCFL), "--batch-size",
                  str(TRAIN_BATCH), "--epochs", "1", "--weights-stem",
                  "obs")
OBS_TRAIN_STEPS = 8 // TRAIN_BATCH    # the example's 8 synthetic volumes
# 15d: `obs.analysis` on phase 4's fader encoder and classifier
OBS_LATENT_BATCH = BATCH
OBS_CPU_VOLUMES = 2
OBS_LATENT_TOL = 1e-4          # f32 card vs CPU, x max|ref|
OBS_PCA_TOL = 1e-6             # card vs CPU float64, x max|ref|, up to sign
OBS_OBJECTIVE_RTOL = 1e-9      # t-SNE's P, KL and gradient, card vs CPU
# sklearn requires a perplexity below the number of points: 16 latents
OBS_TSNE_PERPLEXITY = 5.0
# full exact t-SNE runs, card vs CPU, gated on a curve: on the latents a
# run is chaotic (float64 rounding moves the KL it ends at by per cents)
TSNE_KL_RTOL = 0.01
TSNE_TRUST_TOL = 0.01


def load_example(name):
    """An `examples/torch_*.py` script as a module (the directory is no
    package), to call its `main(argv)` in this process."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def working_dir(path):
    """Run the enclosed examples in `path` (made if missing): they write
    `weights/` and `logs/` where they run."""
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(old)


def _kind_counts(rollup, names):
    """Launches by kernel name of the trace reader's rollup by kind, whose
    kinds keep their namespaces (`mri::tc::conv2_packed_tc_kernel`)."""
    return {k: sum(c for kind, (_, c) in rollup.items()
                   if kind.rsplit("::", 1)[-1] == k) for k in names}


def trace_reader_phase(serve_batch, trace_dir, mesh_trace_dir):
    """15a: one served bf16 batch inside `obs.profile_trace`; the trace
    reader against `device_rows` of the same profiler (as `profile_batch`
    reads it), the copies it attributes, and the collectives of phase
    14's profiled mesh step."""
    import torch

    from mri_epilepsy_diagnosis_torch.obs import trace_summary as TSum

    serve_batch()                                   # warm-up
    lost = []
    for attempt in range(OBS_TRACE_ATTEMPTS):
        window = os.path.join(trace_dir, str(attempt))
        with trace_window(window) as prof:
            serve_batch()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = TSum.load_events(window)
        if not TSum.lost_launches(events):
            break
        lost.append(len(TSum.lost_launches(events)))
        log(f"15a: the profiler dropped {lost[-1]} kernel records; the "
            "batch is traced again")
    else:
        raise AssertionError(f"15a: every window lost kernel records {lost}")
    rows = device_rows(prof)
    rollup, total_us = TSum.summarize(events)
    names = TSum.top_ops(events, top=10 ** 6)
    read_s = time.perf_counter() - t0
    prof_counts = {k: sum(c for n, _, c in rows if k in n)
                   for k in PORT_KERNELS}
    trace_counts = _kind_counts(rollup, PORT_KERNELS)

    def fused(table):
        return sum(c for n, _, c in table if "conv2_packed" in n
                   and "true>" in n)

    prof_ms = sum(r[1] for r in rows)
    b1 = (trace_counts["conv2_packed_tc_kernel"]
          + trace_counts["conv2_packed_kernel"])
    copies = TSum.copy_rows(events)
    sources = sorted({r[3] for r in copies
                      if r[3].startswith(TSum.PACKAGE)})
    mesh = TSum.collective_rows(TSum.load_events(mesh_trace_dir))
    mesh_kinds = {}
    for b, kind, _, _ in mesh:
        n, nb = mesh_kinds.get(kind, (0, 0))
        mesh_kinds[kind] = (n + 1, nb + b)
    out = {"launches_trace": {k: v for k, v in trace_counts.items() if v},
           "launches_profiler": {k: v for k, v in prof_counts.items() if v},
           "b1_launches": b1, "b2_fused_trace": fused(names),
           "b2_fused_profiler": fused(rows),
           "device_ms_trace": total_us / 1e3, "device_ms_profiler": prof_ms,
           "device_events_trace": sum(c for _, c in rollup.values()),
           "device_events_profiler": sum(r[2] for r in rows),
           "trace_read_s": read_s, "windows_with_lost_records": lost,
           "copy_ops": len(copies),
           "copy_bytes": sum(r[0] for r in copies),
           "copy_sources": sources[:12], "copy_top": copies[:5],
           "mesh_collectives": {k: {"count": n, "bytes": b}
                                for k, (n, b) in mesh_kinds.items()}}
    log(f"15a trace reader: {json.dumps(out)}")
    if trace_counts != prof_counts:
        raise AssertionError(f"15a: the trace reader counts {trace_counts}, "
                             f"the profiler {prof_counts}")
    if (b1, out["b2_fused_trace"]) != (len(B1_SITES), len(B2_SITES)) or (
            out["b2_fused_profiler"] != len(B2_SITES)):
        raise AssertionError(f"15a: B1 {b1} and B2 fused "
                             f"{out['b2_fused_trace']} a batch")
    if abs(total_us / 1e3 - prof_ms) > OBS_DEVICE_MS_RTOL * prof_ms:
        in_trace = {n: c for n, _, c in names}
        unmatched = [r for r in rows if in_trace.get(r[0]) != r[2]]
        raise AssertionError(f"15a: device ms {total_us / 1e3} in the trace "
                             f"against {prof_ms} in the profiler; rows "
                             f"whose count differs: {unmatched[:8]}")
    if not sources:
        raise AssertionError("15a: no copy attributed to the port's source")
    if mesh_kinds.get("all_reduce", (0, 0))[0] != MESH_ALL_REDUCES:
        raise AssertionError(f"15a: {mesh_kinds} collectives in the mesh "
                             f"step, not {MESH_ALL_REDUCES} all-reduces")
    return out


@contextlib.contextmanager
def instrumented(module, name, before, after):
    """Replace `module.name` by a wrapper that calls `before(*args)` and
    `after(result)` around the original."""
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        before(*args)
        return after(orig(*args, **kw))

    setattr(module, name, wrapper)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def example_training_phase(K, launch_counts, workdir):
    """15b: `examples/torch_train_segmentation.py` at phase 6's
    configuration.  Each packed train step it runs is timed by
    `obs.StepTimer` and counted by the launch counters; the first runs
    inside `obs.profile_trace`, whose trace the reader counts (the next
    ones too while the profiler has dropped a kernel record)."""
    from mri_epilepsy_diagnosis_torch.obs import StepTimer
    from mri_epilepsy_diagnosis_torch.obs import trace_summary as TSum
    from mri_epilepsy_diagnosis_torch.train import seg as TS

    example = load_example("torch_train_segmentation")
    timer, steps, traced = StepTimer(), [], {}
    window = contextlib.ExitStack()
    complete = []                   # the events of a complete window

    def trace_dir(i):
        return os.path.join(workdir, f"trace_step{i}")

    def before(*args):
        if not complete and len(traced) < OBS_TRACE_ATTEMPTS:
            traced[len(steps)] = None
            window.enter_context(trace_window(trace_dir(len(steps))))
        steps.append(launch_counts())
        timer.start()

    def after(result):
        timer.stop(result[1])
        window.close()
        now = launch_counts()
        i = len(steps) - 1
        steps[i] = {k: now[k] - v for k, v in steps[i].items()}
        if i in traced:
            events = TSum.load_events(trace_dir(i))
            traced[i] = len(TSum.lost_launches(events))
            if not traced[i]:
                complete.append(events)
        return result

    K.reset_launch_counts()
    t0 = time.perf_counter()
    with working_dir(workdir), instrumented(TS, "packed_seg_train_step",
                                            before, after):
        example.main(list(OBS_TRAIN_ARGS))
    run_s = time.perf_counter() - t0
    total = launch_counts()
    if not complete:
        raise AssertionError(f"15b: every traced step lost kernel records "
                             f"{traced}")
    events = complete[0]
    kinds = _kind_counts(TSum.summarize(events)[0], PORT_KERNELS)
    dx = _kind_counts(TSum.summarize_within(events, "): conv2_packed_dx")[0],
                      PORT_KERNELS)
    trace = {"b1": kinds["conv2_packed_tc_kernel"]
             + kinds["conv2_packed_kernel"],
             "b1_tc": kinds["conv2_packed_tc_kernel"],
             "b1_dx": dx["conv2_packed_tc_kernel"] + dx["conv2_packed_kernel"]}
    (log_path,) = [os.path.join(workdir, "logs", f)
                   for f in os.listdir(os.path.join(workdir, "logs"))]
    losses = [json.loads(line)["value"] for line in open(log_path)
              if '"train_dice_loss"' in line]
    ckpt = os.path.join(workdir, "weights", "obs_epoch_1.ckpt")
    out = {"argv": list(OBS_TRAIN_ARGS), "run_s": run_s,
           "steps": len(steps), "step_ms": [t * 1e3 for t in timer.times],
           "step_ms_mean_after_first": float(np.mean(timer.times[1:])) * 1e3,
           "traced_steps_lost_records": traced,
           "trace_complete_step": trace, "train_losses": losses,
           "checkpoint": os.path.exists(ckpt),
           "launches_per_step": steps[1] if len(steps) > 1 else None,
           "launches_run": total}
    log(f"15b training example: {json.dumps(out)}")
    for i, c in enumerate(steps):
        _expect_counts(f"15b step {i}", c, TRAIN_PER_STEP)
    want = {"b1": TRAIN_PER_STEP["conv2_packed"],
            "b1_tc": TRAIN_PER_STEP["conv2_packed_tc"],
            "b1_dx": TRAIN_PER_STEP["conv2_packed_dx"]}
    if trace != want or len(steps) != OBS_TRAIN_STEPS:
        raise AssertionError(f"15b: {len(steps)} steps, the trace reader "
                             f"counts {trace}, not {want}")
    if len(losses) != len(steps) or not np.isfinite(losses).all():
        raise AssertionError(f"15b: logged train losses {losses}")
    if not out["checkpoint"]:
        raise AssertionError(f"15b: no checkpoint {ckpt}")
    return out


def example_serving_phase(K, launch_counts, workdir, state, vol,
                          served_mask, fine_mask):
    """15c: `examples/torch_infer_whole_brain.py` on phase 4's weights
    (as a `.pth`) and first volume (as NIfTI) at 192^3: float32, the
    packed layout, B1 with B2 fused; its mask against phase 4's served
    bf16 mask and the fine float32 one at PERF.md's gates."""
    import torch

    from mri_epilepsy_diagnosis_torch.utils.nifti import (load_nifti,
                                                          save_nifti)

    os.makedirs(workdir, exist_ok=True)
    pth = os.path.join(workdir, "unet.pth")
    torch.save({k: v.cpu() for k, v in state.items()}, pth)
    image = os.path.join(workdir, "t1.nii")
    out_path = os.path.join(workdir, "pred.nii")
    save_nifti(image, vol, np.eye(4))
    example = load_example("torch_infer_whole_brain")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with working_dir(workdir):
        example.main(["--pth", pth, "--image", image, "--ocfl", str(OCFL),
                      "--img-size", str(SIZE), "--coord-min", "0", "0", "0",
                      "--out", out_path])
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    mask = np.asarray(load_nifti(out_path).data)
    out = {"run_s": run_s, "foreground_share": float(mask.mean()),
           "agreement_vs_served_bf16": float(np.mean(mask == served_mask)),
           "agreement_vs_fine_f32": float(np.mean(mask == fine_mask)),
           "launches": counts}
    log(f"15c serving example: {json.dumps(out)}")
    _expect_counts("15c", counts, VAL_PER_BATCH)
    if out["agreement_vs_served_bf16"] < MASK_AGREEMENT_BF16 or (
            out["agreement_vs_fine_f32"] < VAL_MASK_AGREEMENT):
        raise AssertionError(f"15c: mask agreement {out}")
    return out


def _sign_aligned_err(got, ref):
    return max(min(np.abs(got[:, k] - s * ref[:, k]).max() for s in (1, -1))
               for k in range(ref.shape[1]))


def latent_phase(K, launch_counts, enc, clf, vols, normalized):
    """15d: `obs.analysis.collect_latents` over phase 4's volumes at batch
    8 on the card (fused B3 per stack and batch), against the port on the
    CPU; PCA and t-SNE of the latents on the card against the same calls
    on the CPU (see the comment above OBS_TSNE_PERPLEXITY and PERF.md)."""
    import copy

    import torch

    from mri_epilepsy_diagnosis_torch.obs import analysis as A

    domains = np.arange(len(vols)) % 3
    targets = np.arange(len(vols)) % 2

    def loader(device_volumes, n):
        for i in range(0, n, OBS_LATENT_BATCH):
            x = normalized(vols[i:min(i + OBS_LATENT_BATCH, n)])
            yield (x if device_volumes else x.cpu(),
                   targets[i:i + len(x)], domains[i:i + len(x)])

    K.reset_launch_counts()
    t0 = time.perf_counter()
    lat = A.collect_latents(enc, loader(True, len(vols)), clf=clf)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    counts = launch_counts()
    n_batches = -(-len(vols) // OBS_LATENT_BATCH)
    want = {**{k: 0 for k in UNET_PER_BATCH},
            "separable_conv3d": len(B3_STACKS) * n_batches}
    _expect_counts("15d collect_latents", counts, want)
    cpu = A.collect_latents(copy.deepcopy(enc).cpu(),
                            loader(False, OBS_CPU_VOLUMES),
                            clf=copy.deepcopy(clf).cpu(), device="cpu")
    lat_err = {k: float(np.abs(lat[k][:OBS_CPU_VOLUMES] - cpu[k]).max()
                        / np.abs(cpu[k]).max()) for k in ("encoder", "clf")}
    feats = lat["encoder"]
    pca = {d: A.pca_embed(feats, device=d) for d in ("cuda", "cpu")}
    pca_err = _sign_aligned_err(pca["cuda"], pca["cpu"]) / np.abs(
        pca["cpu"]).max()
    # t-SNE's objective, deterministic: P and (KL, gradient) at a fixed
    # embedding; then full runs on the latents (reported) and on a curve
    # with one layout to find (gated), as tests/test_torch_obs.py runs it
    p = {d: A.joint_probabilities(feats, OBS_TSNE_PERPLEXITY, device=d)
         for d in ("cuda", "cpu")}
    y0 = np.random.default_rng(SEED).normal(size=(len(feats), 2))
    kl = {d: A.kl_divergence(y0, p[d]) for d in p}
    objective_err = {
        "p": float((p["cuda"].cpu() - p["cpu"]).abs().max()
                   / p["cpu"].abs().max()),
        "kl": abs(float(kl["cuda"][0]) - float(kl["cpu"][0]))
        / abs(float(kl["cpu"][0])),
        "grad": float((kl["cuda"][1].cpu() - kl["cpu"][1]).abs().max()
                      / kl["cpu"][1].abs().max())}

    def tsne_runs(x, perplexity):
        p_cpu = A.joint_probabilities(x, perplexity, device="cpu")
        res = {}
        for d in ("cuda", "cpu"):
            t = time.perf_counter()
            y = A.tsne_embed(x, perplexity=perplexity, device=d)
            res[d] = {"s": time.perf_counter() - t,
                      "kl": float(A.kl_divergence(y, p_cpu)[0]),
                      "trust": A.trustworthiness(x, y, device="cpu"),
                      "finite": bool(np.isfinite(y).all())}
        return res

    rng = np.random.default_rng(1)
    t = np.linspace(0, 3 * np.pi, 60)
    curve = (np.stack([np.cos(t), np.sin(t), t / 3], 1)
             @ rng.normal(size=(3, 20)) + 1e-3 * rng.normal(size=(60, 20)))
    runs = {"latents": tsne_runs(feats, OBS_TSNE_PERPLEXITY),
            "curve": tsne_runs(curve, 30.0)}
    out = {"volumes": len(vols), "batch": OBS_LATENT_BATCH,
           "collect_s": collect_s, "launches": counts,
           "latent_shapes": {k: list(v.shape) for k, v in lat.items()},
           "latent_err_vs_cpu": lat_err, "pca_err": pca_err,
           "tsne_objective_err": objective_err, "tsne_runs": runs}
    log(f"15d latents: {json.dumps(out)}")
    if max(lat_err.values()) > OBS_LATENT_TOL:
        raise AssertionError(f"15d: latents differ from the CPU's {lat_err}")
    if pca_err > OBS_PCA_TOL:
        raise AssertionError(f"15d: PCA differs by {pca_err}")
    if max(objective_err.values()) > OBS_OBJECTIVE_RTOL:
        raise AssertionError(f"15d: t-SNE objective {objective_err}")
    c = runs["curve"]
    if not all(r["finite"] for v in runs.values() for r in v.values()) or (
            abs(c["cuda"]["kl"] - c["cpu"]["kl"])
            > TSNE_KL_RTOL * c["cpu"]["kl"]) or (
            abs(c["cuda"]["trust"] - c["cpu"]["trust"]) > TSNE_TRUST_TOL):
        raise AssertionError(f"15d: t-SNE runs {runs}")
    return out


def example_fader_phase(K, launch_counts, workdir):
    """15e: `examples/torch_train_fader.py --synthetic --img-size 192
    --bf16` for one epoch (one alternation batch of its 8 volumes, the
    default --disc-loop 3).  Each alternation batch is counted by the
    launch counters; the first runs inside `obs.profile_trace`, whose
    trace the reader counts (the run is repeated while the profiler has
    dropped a kernel record); the validation forward's launches are the
    rest of the run's."""
    import torch

    from mri_epilepsy_diagnosis_torch.obs import trace_summary as TSum
    from mri_epilepsy_diagnosis_torch.train import fader as TF

    example = load_example("torch_train_fader")
    per_batch = alternation_per_batch(FADER_DEPTH)

    def run(attempt):
        """One epoch of the example; returns (its alternation batches'
        counts, the run's counts, the first batch's trace events, s)."""
        cwd = os.path.join(workdir, str(attempt))
        trace_dir = os.path.join(cwd, "trace_alternation")
        window = contextlib.ExitStack()
        batches, open_batch = [], []

        def disc_before(*args):
            if not open_batch:
                if not batches:
                    window.enter_context(trace_window(trace_dir))
                open_batch.append(launch_counts())

        def enc_after(result):
            torch.cuda.synchronize()
            window.close()
            now = launch_counts()
            batches.append({k: now[k] - v
                            for k, v in open_batch.pop().items()})
            return result

        K.reset_launch_counts()
        t0 = time.perf_counter()
        with working_dir(cwd), \
                instrumented(TF, "disc_step", disc_before, lambda r: r), \
                instrumented(TF, "enc_clf_step", lambda *a: None, enc_after):
            example.main(["--synthetic", "--img-size", str(SIZE), "--bf16",
                          "--epochs", "1"])
        run_s = time.perf_counter() - t0
        for i, b in enumerate(batches):
            _expect_counts(f"15e alternation batch {i}", b, per_batch)
        return batches, launch_counts(), TSum.load_events(trace_dir), run_s

    lost = []
    for attempt in range(OBS_TRACE_ATTEMPTS):
        batches, total, events, run_s = run(attempt)
        if not TSum.lost_launches(events):
            break
        lost.append(len(TSum.lost_launches(events)))
        log(f"15e: the profiler dropped {lost[-1]} kernel records; the "
            "example runs again")
    else:
        raise AssertionError(f"15e: every window lost kernel records {lost}")
    kinds = _kind_counts(TSum.summarize(events)[0], PORT_KERNELS)
    trace = {"separable_conv3d": kinds["separable_conv3d_kernel"],
             "conv_axis_dx": kinds["axis_dx_tc_kernel"]
             + kinds["conv_axis_dx_kernel"],
             "conv_axis_dw": kinds["axis_dw_tc_kernel"]
             + kinds["conv_axis_dw_partial_kernel"],
             "conv_axis": kinds["axis_fwd_tc_kernel"]
             + kinds["conv_axis_kernel"]}
    validation = {k: v - sum(b[k] for b in batches)
                  for k, v in total.items()}
    out = {"run_s": run_s, "alternation_batches": len(batches),
           "runs_with_lost_records": lost, "trace_first_batch": trace,
           "launches_per_batch": batches, "launches_validation": validation}
    log(f"15e fader example: {json.dumps(out)}")
    want = {k: per_batch[k] for k in trace}
    if trace != want or not batches:
        raise AssertionError(f"15e: the trace reader counts {trace}, not "
                             f"{want}")
    if validation["separable_conv3d"] <= 0 or validation["conv_axis_dw"]:
        raise AssertionError(f"15e: validation launches {validation}")
    return out


def s8_kernel_entries(k1_rows, k2_rows, errs, counts, serving):
    """The kernels-line entries of K1 (its wgmma route at 9 sites, its
    mma.sync route at the stem) and K2: launches from phase 11b's served
    run, times summed over the sites of one batch-Q_TIMED_BATCH forward
    (the plain versions' at batch 1)."""
    src = "mri_epilepsy_diagnosis_torch/csrc/"
    q = "mri_epilepsy_diagnosis_tpu/models/unet_packed_q.py:"
    shapes = (f"sum over the sites of one batch-{Q_TIMED_BATCH} int8 "
              f"forward at {SIZE}^3 (plain_ms at batch 1, float64); "
              f"launches from the {serving['volumes']} served volumes")

    def entry(name, source, replaces, rows, err, launches, per_batch,
              **extra):
        t_ops = sum(r["bound_ms"] for r in rows
                    if r["bound_by"] == "operations")
        t_bytes = sum(r["bound_ms"] for r in rows
                      if r["bound_by"] == "bytes")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "launches_per_batch": per_batch, "max_abs_err": err,
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": t_ops + t_bytes,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None, "shapes": shapes, "path": "int8_serving",
                "bf16_b1_ms": sum(r["bf16_b1_ms"] for r in rows), **extra}

    tc_rows = [r for r in k1_rows if r["route"] == "wgmma"]
    mma_rows = [r for r in k1_rows if r["route"] == "mma_sync"]
    wgmma = serving["k1_wgmma_launches"]
    return [
        entry("conv2_packed_s8_tc", src + "conv2_packed_s8_tc.cu", q + "68",
              tc_rows, max(errs["k1_raw"], errs["k1_fused"]), wgmma,
              Q_WGMMA_PER_BATCH, fuses=q + "267 (_epilogue)",
              raw_int32_ms=sum(r["raw_int32_ms"] for r in tc_rows),
              k1_ms_all_sites=sum(r["ms"] for r in k1_rows)),
        entry("conv2_packed_s8", src + "conv2_packed_s8.cu", q + "68",
              mma_rows, max(errs["k1_raw"], errs["k1_fused"]),
              counts["conv2_packed_s8"] - wgmma,
              Q_PER_BATCH["conv2_packed_s8"] - Q_WGMMA_PER_BATCH,
              fuses=q + "267 (_epilogue)",
              raw_int32_ms=sum(r["raw_int32_ms"] for r in mma_rows)),
        entry("upconv_packed_s8", src + "upconv_packed_s8.cu", q + "76",
              k2_rows, errs["k2"], counts["upconv_packed_s8"],
              Q_PER_BATCH["upconv_packed_s8"],
              bf16_upsample_ms=sum(r["bf16_upsample_ms"] for r in k2_rows),
              bf16_composed_cudnn_ms=sum(r["bf16_composed_cudnn_ms"]
                                         for r in k2_rows),
              bf16_composed_bound_ms=sum(r["bf16_composed_bound_ms"]
                                         for r in k2_rows)),
    ]


def ae_entry(rows, keys=("ms", "plain_ms", "bound_ms", "library_ms")):
    """The AE step's sums of a kernel's timed rows (one bf16 step)."""
    return {k: sum(r[k] for r in rows) for k in keys}


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
    from mri_epilepsy_diagnosis_torch.models import fader_packed as FP
    from mri_epilepsy_diagnosis_torch.models import voxresnet_packed as VP
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
        # the AE's last stack ends in one channel: in bf16 it takes the
        # per-axis route (`_separable_route`), checked all the same
        ae_sep_rows, ae_sep_errs = sep_kernel_phase(
            K, [(n, st, 1) for n, st in zip(AE_B3_STACKS, ae_stacks)], gen,
            [(1, "f32"), (1, "bf16")], (1, "bf16"), fused_only=False)
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
                "conv_axis_tc": K.conv_axis.tc_launches,
                "separable_conv3d": K.separable_conv3d.launches,
                "conv_axis_dx": K.conv_axis_dx.launches,
                "conv_axis_dw": K.conv_axis_dw.launches,
                "conv_axis_dx_tc": K.conv_axis_dx.tc_launches,
                "conv_axis_dw_tc": K.conv_axis_dw.tc_launches,
                **{k: getattr(K, k).launches for k in BN_PASSES},
                "dw_packed": K.dw_packed.launches,
                "dw_packed_fold": K.dw_packed.fold_launches}

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
    fine_mask0 = fine_masks[0].copy()              # phase 15c
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
    obs_models = (enc, clf)                        # phase 15d

    def serve_ensemble(volumes,
                       classify_fn=lambda p, x: p["clf"](p["enc"](x)[0])):
        t = time.perf_counter()
        outs = list(segment_volumes(
            None, ens_params, volumes, batch_size=BATCH,
            dtype=torch.bfloat16, device="cuda",
            device_preprocess=znorm_batch, transfer_dtype=np.int16,
            mask_fn=lambda p, x: packed_unet_mask_v2(p["seg"], x),
            classify_fn=classify_fn, pack_masks=True))
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

    # phase 11 quantizes the served UNet and serves the same volumes,
    # phase 13 serves them through the packed encoder, and phase 14 serves
    # them data-parallel
    int8_inputs = (vols, state, fine_masks)
    dist_inputs = (vols, {k: v.clone() for k, v in state.items()},
                   masks_int16)
    obs_inputs = dist_inputs + (fine_mask0,)       # phase 15
    ensemble_inputs = (vols, probs, ens_masks)
    del vols, noise, model, params, enc, clf
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
    # every pass of the BatchNorm tail of that step, against its plain
    # version and timed
    bn_train_rows, bn_train = bn_tail_rows(
        K, P, bn_step_sites(train_sites),
        f"train step, {SIZE}^3 batch {TRAIN_BATCH} bf16")
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
            (patch_state, from_files, patch_fwd_rows, patch_dx_rows,
             patch_dw_rows) = (files_training_phase(K, P, UNet3D, gen, launch_counts, ds,
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
    ae_bwd_rows["route_check"] = []
    ae_bwd_rows["stack"], ae_bwd_errs["stack"] = sep_kernel_phase(
        K, named_stacks("ae", ae_sites["stack"]), gen,
        [(1, "f32"), (None, "bf16")], (None, "bf16"), fused_only=False,
        route_rows=ae_bwd_rows["route_check"])
    torch.cuda.empty_cache()
    classification = classification_phase(K, gen, launch_counts)
    phase9_s = time.perf_counter() - t9
    log(f"phase 9: {phase9_s:.1f} s")

    # ---- 10. detection: registration to the MNI grid, patches, PatchModel
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    t1_tpl, gmpm = mni_template()
    template_s = time.perf_counter() - t10
    det_dir = os.path.join("chiprun_out", "chip_smoke_detection")
    os.makedirs(det_dir, exist_ok=True)
    registration = registration_phase(K, t1_tpl, gmpm, launch_counts,
                                      det_dir)
    torch.cuda.empty_cache()
    detection = detection_phase(K, t1_tpl, gmpm, launch_counts, det_dir)
    os.rmdir(det_dir)
    phase10_s = time.perf_counter() - t10
    log(f"phase 10: {phase10_s:.1f} s (template {template_s:.1f} s)")

    # ---- 11. int8 serving (K1, K2)
    from mri_epilepsy_diagnosis_torch.models import unet_packed_q as Q

    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    vols, state, fine_masks = int8_inputs
    with torch.inference_mode():
        # 11a: calibrate and quantize the phase-4 UNet, then every K1 and
        # K2 site of its 192^3 trunk at batch 1
        t0 = time.perf_counter()
        q = Q.quantize_inference(state, normalized(vols[:Q_CALIB_VOLUMES]))
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        probe = normalized(vols[:1])
        _, s8_calls = record_s8_sites(
            Q, K, lambda: Q.packed_unet_mask_v2_int8(q, probe))
        k1_rows, k2_rows, s8_errs = s8_kernel_phase(K, P, s8_calls)
    del s8_calls, probe
    torch.cuda.empty_cache()
    # 11b: int8 serving of the 16 volumes
    int8_serving, int8_fails = int8_serving_phase(
        K, Q, q, vols, fine_masks, znorm_batch, launch_counts,
        {"serving": serving, "profile": profile})
    int8_serving["quantize_s"] = quantize_s
    del q, vols, state, fine_masks, int8_inputs
    torch.cuda.empty_cache()
    phase11_s = time.perf_counter() - t11
    log(f"phase 11: {phase11_s:.1f} s")

    # ---- 12. the segmentation model zoo through seg_train_step
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    zoo = zoo_phase(K, gen)
    phase12_s = time.perf_counter() - t12
    log(f"phase 12: {phase12_s:.1f} s")

    # ---- 13. the packed encoders: the fader's packed and fused encoders
    # (13a-b), the ensemble served through the packed one (13a), and the
    # packed VoxResNet trained through B1 (13c)
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    vols, probs4, masks4 = ensemble_inputs
    del ensemble_inputs
    with torch.inference_mode():
        x8 = normalized(vols[:BATCH])
    _, packed_enc, pe_sep_rows, pe_axis_rows = packed_encoder_phase(
        K, Fd, FP, ens_params["enc"], x8, gen, launch_counts)
    del x8
    torch.cuda.empty_cache()

    def packed_classify(p, x):
        return p["clf"](FP.encoder_apply_packed(p["enc"], x,
                                                FADER_AE_KWARGS)[0])

    serve_ensemble(vols, packed_classify)            # warm-up
    torch.cuda.reset_peak_memory_stats()
    (t_pens, (pmasks, pprobs)), pens_counts = counted(
        lambda: serve_ensemble(vols, packed_classify),
        PACKED_ENSEMBLE_PER_BATCH)
    p_err = float(np.abs(pprobs - probs4).max())
    packed_ensemble = {
        "volumes": N_VOLUMES, "batch": BATCH, "size": SIZE,
        "int16_s": t_pens, "int16_vol_per_s": N_VOLUMES / t_pens,
        "int16_ms_per_batch": t_pens / n_batches * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "phase4_int16_vol_per_s": ensemble["int16_vol_per_s"],
        "phase4_int16_ms_per_batch": ensemble["int16_ms_per_batch"],
        "probs_vs_phase4_max_abs_err": p_err,
        "masks_equal_phase4": bool(np.array_equal(pmasks, masks4)),
        "launches": pens_counts, "device": kind, "nvidia_smi": smi}
    log(f"packed ensemble: {json.dumps(packed_ensemble)}")
    if not packed_ensemble["masks_equal_phase4"]:
        raise AssertionError("packed-encoder ensemble masks differ")
    if not np.isfinite(pprobs).all() or p_err > PROBS_TOL_BF16:
        raise AssertionError(f"packed-encoder probabilities differ from "
                             f"phase 4's by {p_err}")
    pens_profile = profile_batch(lambda: serve_ensemble(vols[:BATCH],
                                                        packed_classify))
    log(f"profile packed ensemble: {json.dumps(pens_profile)}")
    del vols, ens_params, pmasks, masks4
    torch.cuda.empty_cache()
    vox_parity = voxresnet_parity_phase(K, VP, gen, launch_counts)
    torch.cuda.empty_cache()
    voxresnet, vox_rows = voxresnet_train_phase(K, P, VP, gen,
                                                launch_counts)
    phase13_s = time.perf_counter() - t13
    log(f"phase 13: {phase13_s:.1f} s")

    # ---- 14. distribution: an NCCL group of one rank on a (1, 1) mesh
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    obs_dir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        distribution = distribution_phase(
            K, UNet3D, gen, launch_counts, dist_inputs, znorm_batch,
            os.path.join(obs_dir, "trace_mesh_step"))
        del dist_inputs
        phase14_s = time.perf_counter() - t14
        log(f"phase 14: {phase14_s:.1f} s")

        # ---- 15. observability and the examples: the trace reader against
        # the profiler, then the examples' training and serving paths and
        # the latent analysis at full width
        torch.cuda.empty_cache()
        t15 = time.perf_counter()
        vols, state15, masks4, fine_mask0 = obs_inputs
        params = fold_bn_inference(state15)
        observability = {"trace_reader": trace_reader_phase(
            lambda: serve(vols[:BATCH], transfer_dtype=np.int16),
            os.path.join(obs_dir, "trace_served_batch"),
            os.path.join(obs_dir, "trace_mesh_step"))}
        del params
        torch.cuda.empty_cache()
        observability["training_example"] = example_training_phase(
            K, launch_counts, os.path.join(obs_dir, "train"))
        torch.cuda.empty_cache()
        observability["serving_example"] = example_serving_phase(
            K, launch_counts, os.path.join(obs_dir, "serve"), state15,
            vols[0], masks4[0], fine_mask0)
        torch.cuda.empty_cache()
        observability["latents"] = latent_phase(
            K, launch_counts, *obs_models, vols, normalized)
        del vols, state15, masks4, obs_inputs, obs_models
        torch.cuda.empty_cache()
        observability["fader_example"] = example_fader_phase(
            K, launch_counts, os.path.join(obs_dir, "fader"))
    finally:
        shutil.rmtree(obs_dir, ignore_errors=True)
    phase15_s = time.perf_counter() - t15
    observability.update(device=kind, nvidia_smi=smi)
    log(f"phase 15: {phase15_s:.1f} s ({smi})")

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
    dw_tpu = ("mri_epilepsy_diagnosis_tpu/ops/packed.py:173 "
              "(_dw_packed_qgroup: an einsum, XLA's)")
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
        bn_tail_entry(bn_train_rows, bn_train,
                      sum(t[k] for k in BN_PASSES), path="training",
                      shapes=per_step),
        kernel_entry("dw_packed.training", src + "dw_packed_tc.cu", dw_tpu,
                     train_rows["dw"], train_errs["dw"],
                     _counted_b1(t)["dw_packed"], len(B1_SITES),
                     path="training", shapes=per_step,
                     fold_launches=t["dw_packed_fold"]),
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
        bn_tail_entry(from_files["patches"]["bn_tail_sites"],
                      from_files["patches"]["bn_tail"],
                      sum(pt[k] for k in BN_PASSES), path="patch_training",
                      shapes=per_patch),
        kernel_entry("dw_packed.patch_training", src + "dw_packed_tc.cu",
                     dw_tpu, patch_dw_rows,
                     from_files["patches"]["dw_max_abs_err"],
                     pt["dw_packed"], len(patch_dw_rows),
                     path="patch_training", shapes=per_patch,
                     fold_launches=pt["dw_packed_fold"]),
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
                     ae_step=ae_entry(ae_bwd_rows["stack"], (
                         "ms", "plain_ms", "bound_ms", "per_axis_ms",
                         "cudnn_3calls_ms")),
                     max_abs_err_ae_bf16=ae_bwd_errs["stack"]["bf16"],
                     max_abs_err_ae_f32=ae_bwd_errs["stack"]["f32"]),
        kernel_entry("conv_axis_dx", src + "conv_axis_bwd_tc.cu", tpu + "70",
                     fader_rows["dx"], fader_errs["dx"],
                     fb["conv_axis_dx_tc"],
                     fader["launches_per_batch"]["conv_axis_dx_tc"],
                     path="fader_training", shapes=per_alt,
                     gradient_of=grad_of,
                     f32_route=src + "conv_axis_bwd.cu (CUDA cores; "
                     "max_abs_err_f32)",
                     ae_step=ae_entry(ae_bwd_rows["dx"]),
                     max_abs_err_ae_bf16=ae_bwd_errs["dx"]["bf16"]),
        kernel_entry("conv_axis_dw", src + "conv_axis_bwd_tc.cu", tpu + "70",
                     fader_rows["dw"], fader_errs["dw"],
                     fb["conv_axis_dw_tc"],
                     fader["launches_per_batch"]["conv_axis_dw_tc"],
                     path="fader_training", shapes=per_alt,
                     gradient_of=grad_of,
                     f32_route=src + "conv_axis_bwd.cu (CUDA cores; "
                     "max_abs_err_f32)",
                     ae_step=ae_entry(ae_bwd_rows["dw"]),
                     max_abs_err_ae_bf16=ae_bwd_errs["dw"]["bf16"]),
        kernel_entry("conv_axis_tc", src + "conv_axis_tc.cu", tpu + "70",
                     fader_rows["axis"],
                     {"f32": None, "bf16": fader_errs["axis"]["bf16"]},
                     fb["conv_axis_tc"],
                     fader["launches_per_batch"]["conv_axis_tc"],
                     path="fader_training", shapes=per_alt,
                     role="recomputes the stacks' intermediates in the "
                     "backward; the per-axis route of wide AE stacks",
                     f32_route=src + "conv_axis.cu (CUDA cores; "
                     "off_path_kernels)",
                     cuda_core_ms=sum(r["cuda_core_ms"]
                                      for r in fader_rows["axis"]),
                     ae_step=ae_entry(ae_bwd_rows["axis"], (
                         "ms", "cuda_core_ms", "plain_ms", "bound_ms",
                         "library_ms")),
                     max_abs_err_ae_bf16=ae_bwd_errs["axis"]["bf16"]),
    ]
    # phase 13: B1 on the packed VoxResNet's paths (launches from the timed
    # bf16 steps and the eval forward), B3 on the packed ensemble's (the
    # encoder's e0 and the classifier's stack fused, e1 and e2 per axis)
    vt = voxresnet["packed"]["launches_timed_steps"]
    ve = voxresnet["eval_launches"]
    vox_errs = voxresnet["kernel_max_abs_err"]
    per_vox = (f"sum over the sites of one batch-{VOX_BATCH} bf16 packed "
               f"VoxResNet step at {SIZE}^3 (bench.py's configuration; "
               f"library_ms: cuDNN's fine conv of the same layer); launches "
               f"from {VOX_TIMED_STEPS} steps")
    pe_errs = packed_enc["kernel_max_abs_err"]
    per_pens = (f"sum over the sites of one batch-{BATCH} bf16 forward of "
                f"the packed encoder and the classifier at {SIZE}^3; "
                f"launches from the {N_VOLUMES} served volumes")
    kernels += [
        kernel_entry("conv2_packed_tc.voxresnet_forward",
                     src + "conv2_packed_tc.cu", tpu + "265",
                     vox_rows["forward"], vox_errs["forward"],
                     _counted_b1(vt)["conv2_packed_tc"], VOX_FWD,
                     path="voxresnet_training", shapes=per_vox),
        kernel_entry("conv2_packed_tc.voxresnet_dx",
                     src + "conv2_packed_tc.cu", tpu + "265", vox_rows["dx"],
                     vox_errs["dx"], vt["conv2_packed_dx_tc"], VOX_DX,
                     path="voxresnet_training", shapes=per_vox,
                     gradient_of="mri_epilepsy_diagnosis_tpu/ops/packed.py:"
                     "975 (conv3s2_packed_aa), :268, :286 (conv3_packed, "
                     "conv3_packed_as; XLA's gradients in JAX)"),
        kernel_entry("conv2_packed_tc_bn_act.voxresnet_eval",
                     src + "conv2_packed_tc.cu", tpu + "197",
                     vox_rows["fused"], vox_errs["fused"],
                     ve["conv2_packed_as_bn_act_tc"], VOX_FUSED,
                     fuses=tpu + "265 (B1) + " + tpu + "197 (B2, slope 0)",
                     path="voxresnet_eval", shapes=per_vox.replace(
                         "step", "eval forward").replace(
                         f"launches from {VOX_TIMED_STEPS} steps",
                         "launches from one forward")),
        bn_tail_entry(voxresnet["bn_tail_rows"], voxresnet["bn_tail"],
                      sum(vt[k] for k in BN_PASSES),
                      per_step=len(BN_PASSES) * VOX_BN,
                      replaces="mri_epilepsy_diagnosis_tpu/models/"
                               "voxresnet_packed.py (_bn_packed and "
                               "_bn_train_packed in train mode, and their "
                               "autograd)",
                      path="voxresnet_training", shapes=per_vox),
        kernel_entry("dw_packed.voxresnet_training",
                     src + "dw_packed_tc.cu", dw_tpu, vox_rows["dw"],
                     vox_errs["dw"], vt["dw_packed"], VOX_FWD,
                     path="voxresnet_training", shapes=per_vox,
                     fold_launches=vt["dw_packed_fold"]),
        kernel_entry("separable_conv3d.packed_ensemble",
                     src + "separable_conv3d.cu", tpu + "70",
                     pe_sep_rows + [r for r in sep_rows
                                    if r["site"] == "clf"],
                     pe_errs["stacks"], pens_counts["separable_conv3d"],
                     PACKED_ENSEMBLE_PER_BATCH["separable_conv3d"],
                     path="packed_ensemble", shapes=per_pens,
                     fuses="three " + tpu + "70 calls of " + tpu
                     + "148 separable_conv3d (models/fader_packed.py:87 "
                     "conv_axis_packed, per axis)"),
        kernel_entry("conv_axis_tc.packed_ensemble",
                     src + "conv_axis_tc.cu", tpu + "70", pe_axis_rows,
                     {"f32": None, "bf16": pe_errs["axis"]["bf16"]},
                     pens_counts["conv_axis_tc"],
                     PACKED_ENSEMBLE_PER_BATCH["conv_axis_tc"],
                     path="packed_ensemble", shapes=per_pens,
                     max_abs_err_f32_cuda_core=pe_errs["axis"]["f32"]),
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
             "patch_train_steps": pt, "sliding_window_bf16": sw,
             "packed_ensemble": pens_counts, "voxresnet_packed_steps": vt,
             "voxresnet_packed_eval": ve,
             "distributed_train_step":
                 distribution["train_step"]["launches_mesh"],
             "sharded_serving": distribution["serving"]["launches"],
             "sharded_sliding_window_f32":
                 distribution["sliding_window"]["launches"],
             "example_train_step":
                 observability["training_example"]["launches_per_step"],
             "example_serving": observability["serving_example"]["launches"],
             "collect_latents": observability["latents"]["launches"],
             "example_fader_alternation":
                 observability["fader_example"]["launches_per_batch"][0]}
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
                  "separable_conv3d.fader_training": "separable_conv3d",
                  "conv_axis_dx": "conv_axis_dx_tc",
                  "conv_axis_dw": "conv_axis_dw_tc",
                  "conv2_packed_tc.voxresnet_forward": "conv2_packed_tc",
                  "conv2_packed_tc.voxresnet_dx": "conv2_packed_tc.dx",
                  "conv2_packed_tc_bn_act.voxresnet_eval":
                      "conv2_packed_tc_bn_act",
                  "separable_conv3d.packed_ensemble": "separable_conv3d",
                  "conv_axis_tc.packed_ensemble": "conv_axis_tc",
                  "bn_train_packed.training": "bn_train_packed",
                  "bn_train_packed.patch_training": "bn_train_packed",
                  "bn_train_packed.voxresnet_training": "bn_train_packed",
                  "dw_packed.training": "dw_packed",
                  "dw_packed.patch_training": "dw_packed",
                  "dw_packed.voxresnet_training": "dw_packed"}
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
    log(f"dw (csrc/dw_packed_tc.cu, phase 6a): {json.dumps(dw)}")
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
    # B3's backward in float32 (CUDA cores): checked at batch 2 in phase 9a
    # and run by the f32 parity steps of 9c, off the bf16 paths
    off_path += [{"name": f"{kind}.f32_cuda_core", "route": "cuda",
                  "source": src + "conv_axis_bwd.cu", "replaces": tpu + "70",
                  "launches_by_path": {"fader_alternation":
                                       fb[kind] - fb[f"{kind}_tc"]},
                  "max_abs_err_f32": fader_errs[kind[-2:]]["f32"]}
                 for kind in ("conv_axis_dx", "conv_axis_dw")]
    # the one-axis conv in float32 (and bf16 x with float32 w) on CUDA
    # cores: checked at batch 2 in 9a and in phase 3, run by the f32
    # parity steps of 9c
    off_path.append({
        "name": "conv_axis.f32_cuda_core", "route": "cuda",
        "source": src + "conv_axis.cu", "replaces": tpu + "70",
        "launches_by_path": {
            "fader_alternation": fb["conv_axis"] - fb["conv_axis_tc"],
            **{f"fader_parity_f32.{step}": r["launches"]["conv_axis"]
               for step, r in fader_parity.items()}},
        "max_abs_err_f32": fader_errs["axis"]["f32"]})
    # phase 11: K1 and K2 on the int8 serving path (launches from 11b)
    s8_entries = s8_kernel_entries(k1_rows, k2_rows, s8_errs,
                                   int8_serving["launches"], int8_serving)
    for entry in s8_entries:
        if entry["launches"] <= 0:
            raise AssertionError(f"{entry['name']} was not launched on its "
                                 "path")
    kernels += s8_entries
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
                   "bn_tail_train": bn_train,
                   "bn_tail_train_sites": bn_train_rows,
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
                   "patch_train_dw_sites": patch_dw_rows,
                   "sliding_window": sliding, "sliding_window_sites": sw_rows,
                   "phase8_s": phase8_s, "phase8_parts_s": phase8_parts_s,
                   "fader": fader, "fader_bwd_sites": fader_rows,
                   "fader_parity_f32": fader_parity, "ae_train": ae_train,
                   "ae_bwd_sites": ae_bwd_rows,
                   "b3_per_axis_serving_sites": {"rows": b3_rows,
                                                 "errs": b3_errs},
                   "classification": classification, "phase9_s": phase9_s,
                   "registration": registration, "detection": detection,
                   "phase10_s": phase10_s, "template_s": template_s,
                   "int8_k1_sites": k1_rows, "int8_k2_sites": k2_rows,
                   "int8_serving": int8_serving,
                   "phase11_s": phase11_s,
                   "zoo": zoo, "phase12_s": phase12_s,
                   "packed_encoder": packed_enc,
                   "packed_encoder_sites": {"stacks": pe_sep_rows,
                                            "axis": pe_axis_rows},
                   "packed_ensemble": packed_ensemble,
                   "profile_packed_ensemble": pens_profile,
                   "voxresnet_parity_f32": vox_parity,
                   "voxresnet_packed": voxresnet,
                   "voxresnet_sites": vox_rows, "phase13_s": phase13_s,
                   "distribution": distribution, "phase14_s": phase14_s,
                   "observability": observability, "phase15_s": phase15_s,
                   "build_s": build_s,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    if int8_fails:
        raise AssertionError(f"int8 serving: {int8_fails}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
