"""Fader autoencoder pretraining with the port (MSE reconstruction and the
adversarial domain loss), on the card.

The port's counterpart of `examples/train_ae.py`
(`classification/train_AE.ipynb`), including its synthetic `np.ones`
smoke cohort (cell 3) and the cell-8 block schemas: per batch
`--disc-loop` discriminator steps, then one encoder + decoder step
against the frozen discriminator.

    python examples/torch_train_ae.py --synthetic --epochs 1 [--device cpu]
"""
import argparse

import numpy as np
import torch

from mri_epilepsy_diagnosis_torch.data.pipeline import DataLoader
from mri_epilepsy_diagnosis_torch.models import AE, Discriminator
from mri_epilepsy_diagnosis_torch.train.fader import (FaderState, ae_step,
                                                      disc_step)
from mri_epilepsy_diagnosis_torch.train.optim import torch_adam
from mri_epilepsy_diagnosis_torch.train.state import TrainState
from mri_epilepsy_diagnosis_torch.utils.data import SyntheticVolumes

# train_AE.ipynb cell 8 schemas
DOWN_BLOCK_KWARGS = dict(conv_k=3, conv_pad=1, conv_s=1, maxpool_k=2,
                         maxpool_s=2, batch_norm=True, act="relu")
UP_BLOCK_KWARGS = dict(up="upsample", scale=2, scale_mode="nearest", conv_k=3,
                       conv_pad=1, conv_s=1, batch_norm=True, act="relu")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--c-base", type=int, default=16)
    p.add_argument("--img-size", type=int, default=192)
    p.add_argument("--disc-loop", type=int, default=1)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: bf16 activations, f32 master "
                        "weights")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain versions)")
    args = p.parse_args(argv)
    device = torch.device(args.device)

    if args.synthetic:
        # the notebook's 192^3 / depth-6 geometry (the latent reduces to 1^3
        # inside the discriminator): 16^3 at depth 3 gives a 2^3 latent
        args.img_size, args.depth, args.c_base = 16, 3, 4
        data = SyntheticVolumes(n=6, img_shape=(args.img_size,) * 3,
                                kind="ones", domains=[1, 2, 0, 2, 0, 1])
        n_domains = 3
    else:
        raise SystemExit("wire a MriClassification dataset here for real data")

    latent_c = args.c_base * 2 ** (args.depth - 1)
    torch.manual_seed(0)           # the modules' default initialisation
    ae = AE(c_in=1, is_skip=False, deapth=args.depth, c_base=args.c_base,
            inc_size=2, reduce_size=False,
            down_block_kwargs=DOWN_BLOCK_KWARGS,
            up_block_kwargs=UP_BLOCK_KWARGS, device=device)
    disc = Discriminator(c_in=latent_c, c_out=2 * latent_c, conv_k=2,
                         conv_s=2, conv_pad=0, l_in=2 * latent_c,
                         l_out=latent_c, batch_norm=False, act="l_relu",
                         p_drop=0.0, n_domains=n_domains, device=device)

    def state(model):
        return TrainState(model, torch_adam(1e-4)(model.parameters()))

    # the AE's encoder and decoder train as the fader steps' two states
    fstate = FaderState(encoder=state(ae.enc), clf=None, disc=state(disc),
                        decoder=state(ae.dec))
    rng = torch.Generator(device=device).manual_seed(0)
    loader = DataLoader(data, batch_size=3, shuffle=True)
    lambda_t, lam_step, max_step, step = 0.0, 1e-4 / 500000, 500000, 0
    for epoch in range(args.epochs):
        for batch in loader:
            x = torch.as_tensor(batch[0], device=device)
            if args.bf16:
                x = x.to(torch.bfloat16)
            dom = torch.as_tensor(np.asarray(batch[2]), dtype=torch.long,
                                  device=device)
            for _ in range(args.disc_loop):
                fstate, loss_disc, _ = disc_step(fstate, x, dom, rng,
                                                 n_domains)
            fstate, loss = ae_step(fstate, x, dom, lambda_t, rng)
            step += 1
            if step < max_step:
                lambda_t += lam_step
        print(f"epoch {epoch}: rec+adv loss {float(loss):.5f} "
              f"disc loss {float(loss_disc):.5f}")
    return fstate


if __name__ == "__main__":
    main()
