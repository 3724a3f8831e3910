"""Checkpoint-sweep validation with the port: read every `.pth` state
dict that a glob matches and score it, on the card.

The port's counterpart of `examples/validate_checkpoints.py` (the
reference's `segmentation/results_validation.ipynb` cells 8-9 and the
per-epoch sweep of `pretraining_3d_unet.ipynb` cell 17): each checkpoint
is loaded into the UNet3D, validated on whole volumes (the packed layout
by default) and reported as DSC, ASD and IoU, then the best by DSC.

    # the reference's shipped weights against real subjects
    python examples/torch_validate_checkpoints.py \\
        --pth-dir reference/segmentation/weights --ocfl 8 \\
        --image subj_norm.nii.gz --seg subj_aparc+aseg.nii.gz

    # synthetic blob volumes (no MRI bank needed)
    python examples/torch_validate_checkpoints.py --pth-dir weights \\
        --synthetic --img-size 16 --ocfl 4 [--device cpu]
"""
import argparse
import glob
import os

import numpy as np
import torch

from mri_epilepsy_diagnosis_torch.data.pipeline import DataLoader
from mri_epilepsy_diagnosis_torch.interop import load_torch_checkpoint
from mri_epilepsy_diagnosis_torch.models import UNet3D
from mri_epilepsy_diagnosis_torch.train.optim import torch_adamw
from mri_epilepsy_diagnosis_torch.train.seg import validate_dsc_asd
from mri_epilepsy_diagnosis_torch.train.state import create_train_state
from mri_epilepsy_diagnosis_torch.transforms import znormalization
from mri_epilepsy_diagnosis_torch.utils.data import (SyntheticVolumes,
                                                     reshape_image)
from mri_epilepsy_diagnosis_torch.utils.nifti import load_nifti


def _nifti_loader(images, segs, img_size, coord_min, batch_size):
    """(img, raw-seg) batches from NIfTI pairs: the reference's crop and
    z-normalization, channels last."""
    shape = (img_size,) * 3
    pairs = []
    for im, sg in zip(images, segs):
        vol = reshape_image(np.asarray(load_nifti(im).data), coord_min, shape)
        x = znormalization(torch.as_tensor(vol[0], dtype=torch.float32))
        seg = reshape_image(np.asarray(load_nifti(sg).data), coord_min,
                            shape)[0]
        pairs.append((x.numpy()[..., None],
                      seg[..., None].astype(np.float32)))
    for i in range(0, len(pairs), batch_size):
        chunk = pairs[i:i + batch_size]
        yield (np.stack([c[0] for c in chunk]),
               np.stack([c[1] for c in chunk]))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pth-dir", default="reference/segmentation/weights",
                   help="directory of the .pth files (the reference's "
                        "segmentation/weights)")
    p.add_argument("--pattern", default="*.pth")
    p.add_argument("--ocfl", type=int, default=8)
    p.add_argument("--img-size", type=int, default=192)
    p.add_argument("--coord-min", type=int, nargs=3, default=(30, 30, 30))
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--image", action="append", default=[],
                   help="T1 NIfTI (repeatable; pairs with --seg)")
    p.add_argument("--seg", action="append", default=[],
                   help="aseg+aparc ground-truth NIfTI (repeatable)")
    p.add_argument("--synthetic", action="store_true",
                   help="score against synthetic blob volumes (also used "
                        "when no --image/--seg pairs are given)")
    p.add_argument("--n-synthetic", type=int, default=4)
    p.add_argument("--fine", action="store_true",
                   help="the fine UNet3D forward instead of the packed "
                        "layout")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain versions)")
    args = p.parse_args(argv)

    model = UNet3D(out_channels_first_layer=args.ocfl,
                   device=torch.device(args.device))
    state = create_train_state(model, torch_adamw())

    paths = sorted(glob.glob(os.path.join(args.pth_dir, args.pattern)))
    if not paths:
        raise SystemExit(f"no checkpoints match {args.pth_dir}/{args.pattern}")

    def make_loader():
        if args.image and not args.synthetic:
            if len(args.image) != len(args.seg):
                raise SystemExit("--image/--seg must come in pairs")
            return _nifti_loader(args.image, args.seg, args.img_size,
                                 args.coord_min, args.batch_size)
        data = SyntheticVolumes(
            n=args.n_synthetic, img_shape=(args.img_size,) * 3,
            kind="blobs").as_segmentation()
        # raw labels above 1000 binarize to 1 (the reference's aparc rule):
        # scale the 0/1 masks
        return DataLoader(data, batch_size=args.batch_size,
                          transform=lambda s: (s[0], s[1] * 2000.0))

    packed = not args.fine and args.img_size % 8 == 0
    print(f"{'checkpoint':52s} {'DSC':>7s} {'ASD':>7s} {'IoU':>7s}")
    results = {}
    for path in paths:
        try:
            model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                   load_torch_checkpoint(path).items()})
        except (RuntimeError, KeyError, ValueError) as e:
            # a .pth of another network in the directory: skip it
            print(f"{os.path.basename(path):52s} skipped "
                  f"({type(e).__name__})")
            continue
        dsc, asd_mean, _, iou = validate_dsc_asd(state, make_loader(),
                                                 packed=packed)
        row = (float(np.nanmean(dsc)), float(np.nanmean(asd_mean)),
               float(np.mean(iou)))
        results[path] = row
        print(f"{os.path.basename(path):52s} {row[0]:7.4f} {row[1]:7.4f} "
              f"{row[2]:7.4f}")

    if results:
        best = max(results, key=lambda k: results[k][0])
        print(f"best: {os.path.basename(best)} "
              f"(DSC {results[best][0]:.4f})")
    return results


if __name__ == "__main__":
    main()
