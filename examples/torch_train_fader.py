"""Adversarial fader encoder-classifier-discriminator training with the
port, on the card.

The port's counterpart of `examples/train_fader.py`
(`classification/train_ENC_CLF.ipynb`): the block schemas of cell 17, the
optimizer and lambda settings of cell 18, the per-batch histogram
standardization collate (`--landmarks`), and the 3-optimizer alternation
(`--disc-loop` discriminator steps, then one encoder + classifier step, a
batch) of `train.fader.train_fader`.

    python examples/torch_train_fader.py --synthetic --epochs 2 \\
        [--img-size 192|48|12] [--bf16] [--device cpu]
"""
import argparse

import numpy as np
import torch

from mri_epilepsy_diagnosis_torch.data.collate import fader_collate
from mri_epilepsy_diagnosis_torch.data.pipeline import DataLoader
from mri_epilepsy_diagnosis_torch.models import Classificator, Discriminator
from mri_epilepsy_diagnosis_torch.models.fader import make_encoder
from mri_epilepsy_diagnosis_torch.train.fader import FaderState, train_fader
from mri_epilepsy_diagnosis_torch.train.optim import torch_adam
from mri_epilepsy_diagnosis_torch.train.state import TrainState
from mri_epilepsy_diagnosis_torch.utils.data import (MriClassification,
                                                     SyntheticVolumes)

# train_ENC_CLF.ipynb cell 17 schemas
DOWN_BLOCK_KWARGS = dict(conv_k=6, conv_pad=2, conv_s=2, maxpool_k=2,
                         maxpool_s=2, batch_norm=True, act="l_relu")
AE_KWARGS = dict(c_in=1, is_skip=False, deapth=3, c_base=8, inc_size=2,
                 reduce_size=False, down_block_kwargs=DOWN_BLOCK_KWARGS,
                 up_block_kwargs=dict(up="upsample", scale=4,
                                      scale_mode="nearest", conv_k=3,
                                      conv_pad=1, conv_s=1, batch_norm=False,
                                      act="l_relu"))
HEAD_KWARGS = dict(c_in=32, c_out=64, conv_k=3, conv_s=1, conv_pad=0,
                   l_in=64, l_out=32, batch_norm=True, act="relu", p_drop=0.5)
N_DOMAINS = 18


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image-path",
                   default="/gpfs/gpfs0/sbi/data/fcd_classification_bank")
    p.add_argument("--targets", default="../targets/targets_fcd_bank.csv")
    p.add_argument("--landmarks", default=None,
                   help="path to trained Nyul landmarks .npy")
    p.add_argument("--epochs", type=int, default=17)
    p.add_argument("--batch-size", type=int, default=35)
    p.add_argument("--disc-loop", type=int, default=3)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision (bf16 activations, f32 master "
                        "weights)")
    p.add_argument("--img-size", type=int, default=192,
                   help="must be 3*4^depth (the heads want a 3^3 latent): "
                        "192, 48, or 12; smaller sizes shrink the encoder "
                        "depth for smoke runs")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain versions)")
    args = p.parse_args(argv)
    device = torch.device(args.device)

    size = args.img_size
    depth = {192: 3, 48: 2, 12: 1}.get(size)
    if depth is None:
        raise SystemExit(f"--img-size must be one of 192/48/12, got {size}")

    n_domains = N_DOMAINS
    if args.synthetic:
        data = SyntheticVolumes(n=8, img_shape=(size,) * 3, kind="noise",
                                domains=np.arange(8) % 3)
        n_domains = 3
    else:
        data = MriClassification("all", data_type="img",
                                 image_path=args.image_path,
                                 targets_path=args.targets)

    loader_kw = dict(batch_size=args.batch_size)
    if args.landmarks:
        loader_kw["collate_fn"] = fader_collate(np.load(args.landmarks),
                                                device=device)
    train_loader = DataLoader(data, shuffle=True, **loader_kw)
    val_loader = DataLoader(data, **loader_kw)

    ae_kwargs = dict(AE_KWARGS, deapth=depth)
    head_kwargs = dict(HEAD_KWARGS)
    if depth != 3:  # the heads scaled to the shrunken latent's channels
        c_latent = ae_kwargs["c_base"] * 2 ** (depth - 1)
        head_kwargs.update(c_in=c_latent, c_out=2 * c_latent,
                           l_in=2 * c_latent, l_out=c_latent)

    torch.manual_seed(0)           # the modules' default initialisation
    encoder = make_encoder(ae_kwargs, device=device)
    clf = Classificator(n_class=2, device=device, **head_kwargs)
    disc = Discriminator(n_domains=n_domains, device=device, **head_kwargs)

    def state(model, lr):
        return TrainState(model, torch_adam(lr, betas=(0.9, 0.999),
                                            weight_decay=1e-4)(
            model.parameters()))

    fstate = FaderState(encoder=state(encoder, 7e-4), clf=state(clf, 7e-4),
                        disc=state(disc, 5e-4))

    # cell 18: lambda 1e-4 -> 1e-1 over 300 steps; weighted CE
    class_weight = [1.0, 2.0]
    fstate, hist = train_fader(
        fstate, train_loader, val_loader, epochs=args.epochs,
        lambda_initial=1e-4, lambda_step=(1e-1 - 1e-4) / 300, max_step=300,
        n_domains=n_domains, disc_loop=args.disc_loop,
        class_weight=class_weight,
        input_dtype=torch.bfloat16 if args.bf16 else None)
    print("final val accuracy:", hist["acc"][-1] if hist["acc"] else None)
    return fstate, hist


if __name__ == "__main__":
    main()
