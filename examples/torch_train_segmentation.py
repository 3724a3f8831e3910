"""Whole-volume 3D U-Net segmentation training with the PyTorch port, on
the card.

The port's counterpart of `examples/train_segmentation.py` (the
reference's `segmentation/pretraining_3d_unet.ipynb` driver): manifest ->
loaders -> UNet3D -> dice-loss training -> per-epoch checkpoints under
`weights/` -> surface-metric validation, logged as JSONL under `logs/`.

Run on real data:
    python examples/torch_train_segmentation.py --image-path /data/bank \\
        --targets /data/targets_fcd_bank.csv --sample all --epochs 12
Run on synthetic blob volumes (no data needed; `--img-size` sets their
size):
    python examples/torch_train_segmentation.py --synthetic --packed \\
        --bf16 --epochs 1 [--device cpu]
"""
import argparse

import numpy as np
import torch

from mri_epilepsy_diagnosis_torch.data.pipeline import (DataLoader,
                                                        PatchQueue, Subset,
                                                        batched)
from mri_epilepsy_diagnosis_torch.obs.logger import Experiment
from mri_epilepsy_diagnosis_torch.train.seg import (get_model_and_optimizer,
                                                    train_segmentation,
                                                    validate_dsc_asd)
from mri_epilepsy_diagnosis_torch.utils.data import (MriSegmentation,
                                                     SyntheticVolumes)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image-path",
                   default="/gpfs/gpfs0/sbi/data/fcd_classification_bank")
    p.add_argument("--targets", default="../targets/targets_fcd_bank.csv")
    p.add_argument("--sample", default="all")
    p.add_argument("--mask", default="seg", choices=["seg", "bb", "combined"])
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--ocfl", type=int, default=16,
                   help="out_channels_first_layer (reference uses 16 or 8)")
    p.add_argument("--img-size", type=int, default=192)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--patches", action="store_true",
                   help="train on random 64^3 patches (torchio Queue mode)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--packed", action="store_true",
                   help="train in the packed (space-to-depth) layout: every "
                        "3x3x3 conv on the port's B1 kernel")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: bf16 activations, f32 master "
                        "weights, AdamW state and BN statistics (needs "
                        "--packed)")
    p.add_argument("--resilient", action="store_true",
                   help="auto-resume + NaN rollback + preemption-safe "
                        "checkpointing (train/resilience.py)")
    p.add_argument("--weights-stem", default="whole_im_train")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain versions)")
    args = p.parse_args(argv)
    if args.bf16 and not args.packed:
        raise SystemExit("--bf16 requires --packed (the fine UNet3D keeps "
                         "float32 weights and inputs)")

    if args.synthetic:
        data = SyntheticVolumes(n=8, img_shape=(args.img_size,) * 3,
                                kind="blobs").as_segmentation()
        train_set, val_set = data, data
    else:
        data = MriSegmentation(args.sample, image_path=args.image_path,
                               targets_path=args.targets, mask=args.mask,
                               img_shape=(args.img_size,) * 3)
        idx = np.random.default_rng(0).permutation(len(data))
        cut = max(1, int(0.9 * len(data)))
        train_set, val_set = Subset(data, idx[:cut]), Subset(data, idx[cut:])

    if args.patches:
        queue = PatchQueue(train_set, samples_per_volume=6,
                           patch_size=64, max_length=180,
                           num_workers=2)
        train_loader = batched(queue, batch_size=16)
        val_loader = DataLoader(val_set, batch_size=1)
    else:
        train_loader = DataLoader(train_set, batch_size=args.batch_size)
        val_loader = DataLoader(val_set, batch_size=args.batch_size)

    _, state, scheduler = get_model_and_optimizer(
        None, out_channels_first_layer=args.ocfl, device=args.device)
    experiment = Experiment(project_name="segmentation")
    input_dtype = torch.bfloat16 if args.bf16 else None

    if args.resilient:
        from mri_epilepsy_diagnosis_torch.train.resilience import (
            CheckpointManager, train_segmentation_resilient)
        manager = CheckpointManager("weights", stem=args.weights_stem)
        state, train_losses, val_losses, _ = train_segmentation_resilient(
            args.epochs, train_loader, val_loader, state, scheduler,
            manager, experiment=experiment, packed=args.packed,
            input_dtype=input_dtype)
    else:
        state, train_losses, val_losses = train_segmentation(
            args.epochs, train_loader, val_loader, state, scheduler,
            args.weights_stem, experiment=experiment, packed=args.packed,
            input_dtype=input_dtype)
    experiment.close()

    dsc, asd_mean, _, iou = validate_dsc_asd(state, val_loader,
                                             packed=args.packed)
    print(f"mean DSC {np.nanmean(dsc):.4f}  mean ASD {np.nanmean(asd_mean):.4f}"
          f"  mean IoU {np.mean(iou):.4f}")
    return state


if __name__ == "__main__":
    main()
