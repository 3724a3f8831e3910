"""PyTorch/CUDA port of `mri_epilepsy_diagnosis_tpu` for NVIDIA Hopper.

The JAX package is the reference; this package follows its module layout
(`models/unet.py` here mirrors `models/unet.py` there, and so on) and
imports nothing from it.  Activations are channels-last `(N, D, H, W, C)`
at every public function, as in JAX; parameters are a torch `state_dict`
with fepegar `.pth` keys and shapes.

Entry points run on CUDA unless the caller passes `device="cpu"`; on a
machine without a GPU, an entry point called without a device raises.
The packed UNet's convolutions and BN/PReLU/pad-mask epilogue, and the
fader family's separable convolutions, run as the hand-written kernels of
`ops/cuda_kernels.py` on CUDA tensors and as their plain PyTorch versions
on CPU tensors.
"""
