"""Whole-brain segmentation inference from a PyTorch checkpoint with the
port, on the card.

The port's counterpart of `examples/infer_whole_brain.py` (the
reference's `segmentation/results_validation.ipynb`): read a `.pth` state
dict of the reference's UNet3D, run whole-volume inference (the packed
layout with BatchNorm folded, B1 with B2 fused, by default; `--fine` for
the fine UNet3D, `--sliding-window` for 64^3 patches), save the predicted
mask, and report DSC/ASD/IoU against a FreeSurfer segmentation.

    python examples/torch_infer_whole_brain.py \\
        --pth whole_im_train_seg_parc_epoch_7.pth --image subj_norm.nii.gz \\
        --seg subj_aparc+aseg.nii.gz --ocfl 8 [--device cpu]
"""
import argparse

import numpy as np
import torch

from mri_epilepsy_diagnosis_torch.infer import sliding_window_predict
from mri_epilepsy_diagnosis_torch.interop import load_torch_checkpoint
from mri_epilepsy_diagnosis_torch.metrics import (
    compute_average_surface_distance, compute_dice_coefficient,
    compute_surface_distances, get_iou_score)
from mri_epilepsy_diagnosis_torch.models import UNet3D
from mri_epilepsy_diagnosis_torch.models.unet_packed import (
    fold_bn_inference, packed_unet_apply_v2, packed_unet_mask_v2)
from mri_epilepsy_diagnosis_torch.transforms import (binarize_segmentation,
                                                     znormalization)
from mri_epilepsy_diagnosis_torch.utils.data import reshape_image
from mri_epilepsy_diagnosis_torch.utils.nifti import load_nifti, save_nifti


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pth", required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--seg", default=None, help="aseg+aparc ground truth")
    p.add_argument("--ocfl", type=int, default=8)
    p.add_argument("--img-size", type=int, default=192)
    p.add_argument("--coord-min", type=int, nargs=3, default=(30, 30, 30))
    p.add_argument("--sliding-window", action="store_true",
                   help="64^3 patches with overlap 4 instead of the whole "
                        "volume")
    p.add_argument("--fine", action="store_true",
                   help="the fine UNet3D forward instead of the packed "
                        "layout (same masks up to ties)")
    p.add_argument("--out", default="pred_mask.nii.gz")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain versions)")
    args = p.parse_args(argv)
    device = torch.device(args.device)

    model = UNet3D(out_channels_first_layer=args.ocfl, device=device).eval()
    state = {k: torch.from_numpy(v)
             for k, v in load_torch_checkpoint(args.pth).items()}
    model.load_state_dict(state)

    img_nii = load_nifti(args.image)
    shape = (args.img_size,) * 3
    vol = reshape_image(np.asarray(img_nii.data), args.coord_min, shape)
    x = znormalization(torch.from_numpy(np.array(vol[0], np.float32)).to(
        device))[..., None]

    # the packed layout needs sizes divisible by 2^num_encoding_blocks;
    # e.g. --img-size 180 takes the fine path
    use_packed = not args.fine and args.img_size % 8 == 0
    with torch.inference_mode():
        if use_packed:
            params = fold_bn_inference(model.state_dict())
        if args.sliding_window:
            fn, variables = ((packed_unet_apply_v2, params) if use_packed
                             else (lambda m, b: m(b), model))
            logits = sliding_window_predict(fn, variables, x,
                                            patch_size=64, overlap=4)
            pred = logits.argmax(-1)
        elif use_packed:
            pred = packed_unet_mask_v2(params, x[None])[0]
        else:
            pred = model(x[None])[0].argmax(-1)
    pred = pred.to(torch.uint8).cpu().numpy()
    save_nifti(args.out, pred, img_nii.affine)
    print(f"saved {args.out}: {int(pred.sum())} foreground voxels")

    if args.seg:
        seg = reshape_image(np.asarray(load_nifti(args.seg).data),
                            args.coord_min, shape)[0]
        gt = binarize_segmentation(torch.from_numpy(np.array(seg))).to(
            torch.uint8).numpy()
        sd = compute_surface_distances(gt, pred, (1, 1, 1))
        asd = compute_average_surface_distance(sd)
        print(f"DSC {compute_dice_coefficient(gt, pred):.4f}  "
              f"ASD {asd[0]:.4f}/{asd[1]:.4f}  "
              f"IoU {get_iou_score(pred, gt):.4f}")
    return pred


if __name__ == "__main__":
    main()
