"""Whole-volume classification with k-fold cross validation with the port,
on the card.

The port's counterpart of `examples/classification_cv.py`
(`classification/baseline/baseline_sample_classification.ipynb`, the
DilatedCNN baseline, and `classification/transfer/
full_sample_classification.ipynb`, the VoxResNet transfer): stratified
k-fold (`train.classification.StratifiedKFold`, sklearn's splitter fold
for fold), Adam + ReduceLROnPlateau, ROC-AUC.

    python examples/torch_classification_cv.py --synthetic --model voxresnet \\
        [--device cpu]
"""
import argparse

import numpy as np

from mri_epilepsy_diagnosis_torch.metrics import roc_auc_score
from mri_epilepsy_diagnosis_torch.models import DilatedCNN, VoxResNet
from mri_epilepsy_diagnosis_torch.train.classification import (
    StratifiedKFold, cross_val_score)
from mri_epilepsy_diagnosis_torch.utils.data import (MriClassification,
                                                     SyntheticVolumes)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image-path",
                   default="/gpfs/gpfs0/sbi/data/fcd_classification_bank")
    p.add_argument("--targets", default="../targets/targets_fcd_bank.csv")
    p.add_argument("--sample", default="soloviev")
    p.add_argument("--model", default="dilated",
                   choices=["dilated", "voxresnet"])
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--max-epoch", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--img-size", type=int, default=180)
    p.add_argument("--transfer-from", default=None,
                   help=".pth or checkpoint to transfer from (frozen body, "
                        "new head)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain versions)")
    args = p.parse_args(argv)

    size = 32 if args.synthetic else args.img_size
    if args.synthetic:
        data = SyntheticVolumes(n=16, img_shape=(size,) * 3, kind="noise")
        args.folds, args.max_epoch, args.lr = 2, 2, 1e-3
    else:
        data = MriClassification(args.sample, data_type="img",
                                 image_path=args.image_path,
                                 targets_path=args.targets,
                                 img_shape=(size,) * 3)

    if args.model == "dilated":
        # the reference DilatedCNN's flatten formula ((s-61)//16 - 5)^3
        # needs s >= 157
        if (size - 61) // 16 - 5 < 1:
            raise SystemExit(
                f"DilatedCNN needs --img-size >= 157 (got {size}); "
                "use --model voxresnet for small smoke runs")
        model = DilatedCNN(input_shape=(size,) * 3,
                           n_channels=4 if args.synthetic else 32,
                           device=args.device)
    else:
        model = VoxResNet(input_shape=(size,) * 3,
                          n_filters=4 if args.synthetic else 32,
                          stride=1 if args.synthetic else 2,
                          device=args.device)

    scores = cross_val_score(
        model, data, StratifiedKFold(args.folds), roc_auc_score, None,
        batch_size=args.batch_size, max_epoch=args.max_epoch, lr=args.lr,
        model_load_path=args.transfer_from,
        transfer=args.transfer_from is not None, device=args.device)
    scores = [s for s in scores if s is not None]
    print(f"CV ROC-AUC: {np.mean(scores):.3f} +- {np.std(scores):.3f}  "
          f"{scores}")
    return scores


if __name__ == "__main__":
    main()
