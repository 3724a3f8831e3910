"""End-to-end 2-D patch FCD detection with the PyTorch port, on the card.

The port's counterpart of `examples/detection_pipeline.py`: optionally
register the subject to the MNI152 template first (`--template`: affine
registration, the lesion mask carried along, bias correction), extract
hemisphere-pair patches guided by the gray-matter template, train the
PatchModel on them (`--mask`) or load its weights (`--weights`: a JAX
msgpack checkpoint or the port's `torch.save` one), and write the
whole-brain mask.

    python examples/torch_detection_pipeline.py \\
        --gmpm MNI152_T1_1mm_brain_gray.nii.gz --image subject_T1w.nii.gz \\
        [--mask lesion.nii.gz] [--weights ckpt] [--template MNI152.nii.gz] \\
        [--device cpu]
"""
import argparse
import os

import numpy as np

from mri_epilepsy_diagnosis_torch.core.device import resolve_device
from mri_epilepsy_diagnosis_torch.data.patches import get_image_patches
from mri_epilepsy_diagnosis_torch.data.pipeline import DataLoader
from mri_epilepsy_diagnosis_torch.infer.detection import FCDMaskGenerator
from mri_epilepsy_diagnosis_torch.metrics import roc_auc_score
from mri_epilepsy_diagnosis_torch.models import PatchModel
from mri_epilepsy_diagnosis_torch.train.checkpoint import save_checkpoint
from mri_epilepsy_diagnosis_torch.train.classification import (
    create_model_opt, train)
from mri_epilepsy_diagnosis_torch.transforms.preprocessing import (
    register_img_and_mask)
from mri_epilepsy_diagnosis_torch.utils.nifti import load_nifti, save_nifti


class _PatchDataset:
    def __init__(self, patches, labels):
        # (N, 2, h, w) -> channels-last items; labels int
        self.patches = patches.astype(np.float32)
        self.target = labels.astype(np.int64)

    def __len__(self):
        return len(self.patches)

    def __getitem__(self, i):
        return (np.moveaxis(self.patches[i], 0, -1), int(self.target[i]), 0)


def register(args, device):
    """Register the image (and mask) onto the template's grid; returns the
    paths of the bias-corrected image and the moved mask, written beside
    `--out`."""
    template = load_nifti(args.template)
    mask = load_nifti(args.mask) if args.mask else None
    _, corrected, moved_mask, _ = register_img_and_mask(
        load_nifti(args.image), template, mask, device=device)
    stem = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                        "registered")
    image = stem + "_image.nii.gz"
    save_nifti(image, corrected.cpu().numpy(), template.affine)
    if moved_mask is None:
        return image, None
    save_nifti(stem + "_mask.nii.gz", moved_mask.astype(np.uint8),
               template.affine)
    return image, stem + "_mask.nii.gz"


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--gmpm", required=True,
                   help="MNI152 gray-matter probability template (.nii.gz)")
    p.add_argument("--image", required=True)
    p.add_argument("--mask", default=None, help="lesion mask for training/IoU")
    p.add_argument("--weights", default=None,
                   help="trained PatchModel checkpoint (JAX or port)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--out", default="pred_mask.nii.gz")
    p.add_argument("--template", default=None,
                   help="MNI152 T1 template: register the subject first")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args()

    device = resolve_device(args.device)
    image, mask = args.image, args.mask
    if args.template:
        image, mask = register(args, device)
    gmpm = load_nifti(args.gmpm).get_fdata()
    state, _ = create_model_opt(PatchModel(device=device), None,
                                model_load_path=args.weights, lr=3e-4,
                                weight_decay=0.0, device=device)
    if not args.weights and mask:
        # train on this subject's labeled patches (extraction + oversampling)
        patches, labels = get_image_patches(image, gmpm, mask)
        loader = DataLoader(_PatchDataset(patches, labels), batch_size=128,
                            shuffle=True)
        state, *_ = train(state, loader, None, roc_auc_score,
                          max_epoch=args.epochs, verbose=1)
        save_checkpoint("best_model.ckpt", state)

    gen = FCDMaskGenerator(state.model.eval(), gmpm, device=device)
    pred, _ = gen.inference_pipeline(image, mask, out_name=args.out)
    print(f"predicted mask voxels: {int(pred.sum())}  saved to {args.out}")


if __name__ == "__main__":
    main()
