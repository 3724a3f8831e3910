"""One rank of the two-process gloo runs of `tests/test_torch_parallel.py`.

Imports torch and the port only (the parent test holds the JAX
references).  Every check of the test module runs here in one process
pair, on the meshes (data, spatial) = (2, 1) and (1, 2) of the same
two-rank group; each rank writes what it computed, its local shards and
its gradients, with `torch.save`:

    python tests/torch_mesh_worker.py INIT RANK INPUTS OUT_DIR
"""
import contextlib
import copy
import io
import os
import signal
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mri_epilepsy_diagnosis_torch.core.mesh import (  # noqa: E402
    Sharding, create_mesh, data_sharding, initialize_distributed)
from mri_epilepsy_diagnosis_torch.data.pipeline import (  # noqa: E402
    prefetch_to_device)
from mri_epilepsy_diagnosis_torch.infer.serving import (  # noqa: E402
    segment_volumes)
from mri_epilepsy_diagnosis_torch.infer.sliding_window import (  # noqa: E402
    make_sharded_apply, sliding_window_predict)
from mri_epilepsy_diagnosis_torch.models import fader as TFd  # noqa: E402
from mri_epilepsy_diagnosis_torch.models.brats_unet import (  # noqa: E402
    BraTSUnet)
from mri_epilepsy_diagnosis_torch.models.cnn import VoxResNet  # noqa: E402
from mri_epilepsy_diagnosis_torch.models.modified_unet import (  # noqa: E402
    Modified3DUNet)
from mri_epilepsy_diagnosis_torch.models.residual_unet import (  # noqa: E402
    ResidualUNet3D)
from mri_epilepsy_diagnosis_torch.models.unet import UNet3D  # noqa: E402
from mri_epilepsy_diagnosis_torch.models.unet_packed import (  # noqa: E402
    fold_bn_inference, packed_unet_apply_v2, packed_unet_mask_v2)
from mri_epilepsy_diagnosis_torch.models.voxresnet_packed import (  # noqa
    voxresnet_class_step_packed)
from mri_epilepsy_diagnosis_torch.ops import functional as F  # noqa: E402
from mri_epilepsy_diagnosis_torch.parallel import sharding as S  # noqa
from mri_epilepsy_diagnosis_torch.train import fader as TF  # noqa: E402
from mri_epilepsy_diagnosis_torch.train.checkpoint import (  # noqa: E402
    load_checkpoint)
from mri_epilepsy_diagnosis_torch.train.classification import (  # noqa
    _class_step)
from mri_epilepsy_diagnosis_torch.train.optim import (  # noqa: E402
    torch_adam, torch_adamw)
from mri_epilepsy_diagnosis_torch.train.resilience import (  # noqa: E402
    CheckpointManager, train_segmentation_resilient)
from mri_epilepsy_diagnosis_torch.train.seg import (  # noqa: E402
    get_model_and_optimizer, packed_seg_train_step, seg_train_step,
    train_segmentation)
from mri_epilepsy_diagnosis_torch.train.state import TrainState  # noqa

MESHES = {"2x1": (2, 1), "1x2": (1, 2)}


def halo_cotangent(halo: int, mode: str, index: int, shape):
    """The fixed cotangent that rank `index` of the spatial axis puts on
    its haloed slab (the parent rebuilds it)."""
    seed = 100 * halo + 10 * (mode == "edge") + index
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _sd(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def unet(sd, nb):
    model = UNet3D(out_channels_first_layer=4, num_encoding_blocks=nb,
                   device="cpu")
    model.load_state_dict(sd)
    return model


def halo_checks(mesh):
    out = {}
    vs = Sharding(mesh, (None, "spatial"))
    x = torch.linspace(-1, 1, 8 * 3 * 3 * 2).reshape(1, 8, 3, 3, 2)
    for mode in ("zeros", "edge"):
        for halo in (1, 2):
            xl = S.local_shard(x, vs).clone().requires_grad_(True)
            h = S.halo_exchange(xl, mesh.group("spatial"), halo, 1, mode)
            g = halo_cotangent(halo, mode, mesh.index("spatial"), h.shape)
            (h * g).sum().backward()
            out[(mode, halo)] = (h.detach(), xl.grad.clone())
    return out


def conv_checks(mesh, c):
    vs = S.volume_sharding(mesh)
    xl = S.local_shard(c["cx"], vs).clone().requires_grad_(True)
    w = c["cw"].clone().requires_grad_(True)
    b = c["cb"].clone().requires_grad_(True)
    with S.use_mesh(mesh):
        y = F.conv3d(xl, w, b, padding=1)
        (y * S.local_shard(c["cg"], vs)).sum().backward()
    return {"y": y.detach(), "dx": xl.grad.clone(), "dw": w.grad.clone(),
            "db": b.grad.clone()}


def unet_apply_checks(mesh, c):
    model = unet(c["unet"], 3).eval()
    par = S.make_parallel_apply(lambda v, x: model(x), mesh)
    with torch.no_grad():
        out = {"eval": par(None, c["x"])}
        train_model = copy.deepcopy(model).train()
        par = S.make_parallel_apply(lambda v, x: train_model(x), mesh)
        out["train"] = par(None, c["x"])
        out["train_stats"] = {k: v.clone() for k, v in
                              train_model.state_dict().items()}
    return out


def step_checks(mesh, c):
    vs = S.volume_sharding(mesh)
    x, y = S.local_shard(c["x"], vs), S.local_shard(c["labels"], vs)
    out = {}
    for name, step in (("fine", seg_train_step),
                       ("packed", packed_seg_train_step)):
        model = unet(c["unet"], 3)
        state = TrainState(model, torch_adamw(1e-3)(model.parameters()))
        with S.use_mesh(mesh):
            state, loss = step(state, x, y)
        out[name] = {"loss": float(loss), "grads": _grads(model),
                     "state": _sd(model)}
    return out


def zoo_checks(mesh, c):
    """One AdamW step of BraTSUnet with GroupNorm and with InstanceNorm
    (their per-sample statistics span the whole volume), from the
    bridged JAX weights, in float32 and (its gradients) float64; at 1x2
    also the zoo models whose strided convs
    cannot run on a D slab, which must raise."""
    vs = S.volume_sharding(mesh)
    x, y = S.local_shard(c["bx"], vs), S.local_shard(c["by"], vs)
    out = {}
    for norm in ("gn", "in"):
        res = {}
        for dtype in (torch.float32, torch.float64):
            model = BraTSUnet(c=1, n=4, norm=norm, num_classes=2,
                              device="cpu")
            model.load_state_dict(c[f"brats_{norm}"])
            model = model.to(dtype)
            state = TrainState(model, torch_adamw(1e-3, weight_decay=1e-2)(
                model.parameters()))
            with S.use_mesh(mesh):
                state, loss = seg_train_step(state, x.to(dtype), y.to(dtype))
            if dtype == torch.float64:
                res["grads64"] = _grads(model)
            else:
                res.update(loss=float(loss), grads=_grads(model),
                           state=_sd(model))
        out[norm] = res
    if mesh.axis_size("spatial") > 1:
        raised = {}
        for name, model in (
                ("modified", Modified3DUNet(in_channels=1, n_classes=2,
                                            base_n_filter=2, device="cpu")),
                ("residual", ResidualUNet3D(n_classes=2,
                                            n_channels=(1, 2, 4, 8, 16),
                                            shorten=True, device="cpu"))):
            state = TrainState(model, torch_adamw(1e-3)(model.parameters()))
            try:
                with S.use_mesh(mesh):
                    seg_train_step(state, x[:, :, :16, :16, :16],
                                   y[:, :, :16, :16, :16])
                raised[name] = None
            except NotImplementedError as e:
                raised[name] = str(e)
        model = VoxResNet(**c["vox_kw"], dropout=0.0, device="cpu")
        state = TrainState(model, torch_adam(1e-3)(model.parameters()))
        try:
            with S.use_mesh(mesh):
                voxresnet_class_step_packed(
                    state, S.local_shard(c["vx"], vs), c["vy"],
                    torch.Generator().manual_seed(0))
            raised["voxresnet_packed"] = None
        except NotImplementedError as e:
            raised["voxresnet_packed"] = str(e)
        out["raised"] = raised
    return out


def slab_op_checks(mesh, c):
    """The D-windowed ops on each rank's slab: the ones whose windows tile
    the slab (their local results, to join), and the ones that would
    reach across it (the message they raise)."""
    vs = S.volume_sharding(mesh)
    x = S.local_shard(c["cx"], vs)
    tw = c["tw"]
    ok = {"deconv": lambda: F.conv3d_transpose(x, tw, stride=2),
          "avgpool": lambda: F.avgpool3d(x, 2),
          "nearest": lambda: F.resize_nearest(
              x, tuple(2 * s for s in x.shape[1:4]))}
    bad = {"deconv": lambda: F.conv3d_transpose(
               x, torch.zeros(3, 2, 4, 4, 4), stride=2, padding=1),
           "avgpool": lambda: F.avgpool3d(x, 3, 1),
           "nearest": lambda: F.resize_nearest(
               x, (3 * x.shape[1],) + x.shape[2:4])}
    out = {}
    with S.use_mesh(mesh):
        for name, fn in ok.items():
            out[name] = fn()
        for name, fn in bad.items():
            try:
                fn()
                out[("raised", name)] = None
            except NotImplementedError as e:
                out[("raised", name)] = str(e)
    return out


def class_checks(mesh, c):
    """The fine `_class_step` and the packed VoxResNet step, at dropout 0
    (held to JAX) and 0.5 (held to the unsharded port step)."""
    rows = data_sharding(mesh)
    out = {}
    for rate in (0.0, 0.5):
        for name in ("fine", "packed"):
            res = {}
            for sharded in (True, False):
                model = VoxResNet(**c["vox_kw"], dropout=rate, device="cpu")
                model.load_state_dict(c["vox"])
                state = TrainState(model, torch_adam(1e-3, weight_decay=0.01)(
                    model.parameters()))
                x, y = c["vx"], c["vy"]
                if sharded:
                    x, y = S.local_shard(x, rows), S.local_shard(y, rows)
                gen = torch.Generator().manual_seed(7)
                with S.use_mesh(mesh if sharded else None):
                    if name == "fine":
                        state, loss, probs = _class_step(state, x, y, gen,
                                                         True)
                    else:
                        state, loss, probs = voxresnet_class_step_packed(
                            state, x, y, gen)
                res["sharded" if sharded else "plain"] = {
                    "loss": float(loss), "probs": probs,
                    "grads": _grads(model), "state": _sd(model)}
            out[(name, rate)] = res
    return out


def fader_checks(mesh, c):
    def fstate():
        enc = TFd.make_encoder(c["enc_kw"], device="cpu")
        clf = TFd.Classificator(n_class=2, device="cpu", **c["head_kw"])
        disc = TFd.Discriminator(n_domains=c["n_domains"], device="cpu",
                                 **c["head_kw"])
        for m, k in ((enc, "enc"), (clf, "clf"), (disc, "disc")):
            m.load_state_dict(c[k])
        return TF.FaderState(
            *(TrainState(m, torch.optim.SGD(m.parameters(), lr=1.0))
              for m in (enc, clf, disc)))

    rows = data_sharding(mesh)
    fs = fstate()
    x, y, d = (S.local_shard(c[k], rows) for k in ("fx", "fy", "fd"))
    with S.use_mesh(mesh):
        fs, dl, _ = TF.disc_step(fs, x, d, torch.Generator().manual_seed(1),
                                 c["n_domains"])
        fs, loss, ladv, _ = TF.enc_clf_step(
            fs, x, y, d, c["lam"], torch.Generator().manual_seed(2),
            c["n_domains"], c["class_weight"])
    return {"losses": (float(dl), float(loss), float(ladv)),
            "enc": _sd(fs.encoder.model), "clf": _sd(fs.clf.model),
            "disc": _sd(fs.disc.model)}


def _loader(n_batches, batch=4, poison=None):
    out = []
    for b in range(n_batches):
        r = np.random.default_rng(b)
        x = r.normal(size=(batch, 16, 16, 16, 1)).astype(np.float32)
        y = (r.random((batch, 16, 16, 16, 1)) > 0.7).astype(np.float32)
        if poison is not None:
            x[poison] = np.nan
        out.append((x, y))
    return out


class _EpochLoader:
    """Train batches; the `bad`-th pass over it has NaN rows `rows`."""

    def __init__(self, bad, rows):
        self.passes, self.bad, self.rows = 0, bad, rows

    def __iter__(self):
        self.passes += 1
        yield from _loader(1, poison=self.rows if self.passes == self.bad
                           else None)


class _Preempt:
    """An experiment logger that sends SIGTERM to its own process on the
    first batch it logs, if armed."""

    def __init__(self, armed):
        self.armed = armed

    def log_metric(self, name, value):
        if self.armed and name == "train_dice_loss":
            self.armed = False
            os.kill(os.getpid(), signal.SIGTERM)

    def log_epoch_end(self, epoch):
        pass


class _Dashboard:
    """Records the loop's per-epoch updates."""

    def __init__(self):
        self.calls = []

    def update(self, **kw):
        self.calls.append(kw)


def loop_checks(mesh, rank, out_dir):
    vs = S.volume_sharding(mesh)
    shared = os.path.join(out_dir, "loop")
    res = {}

    def fresh(seed=0):
        _, state, sched = get_model_and_optimizer(
            None, 2, 4, seed=seed, device="cpu")
        return state, sched

    state, sched = fresh()
    dashboard = _Dashboard()
    state, tr, va = train_segmentation(
        2, _loader(2), _loader(1), state, sched, weights_stem="mesh",
        weights_dir=shared, verbose=False, sharding=vs, dashboard=dashboard)
    res["tr"], res["va"] = tr, va
    res["dashboard"] = dashboard.calls
    res["files"] = sorted(os.listdir(shared))
    res["state"] = _sd(state.model)
    plain_state, plain_sched = fresh()
    _, ptr, pva = train_segmentation(
        2, _loader(2), _loader(1), plain_state, plain_sched,
        weights_stem="plain", weights_dir=os.path.join(out_dir, f"p{rank}"),
        verbose=False)
    res["plain_tr"], res["plain_va"] = ptr, pva
    fresh_state, sched2 = fresh(123)
    resumed = load_checkpoint(os.path.join(shared, "mesh_epoch_1.ckpt"),
                              fresh_state)
    res["resumed_step"] = resumed.step
    resumed, tr2, _ = train_segmentation(
        1, _loader(2), _loader(1), resumed, sched2, weights_stem="resumed",
        weights_dir=shared, verbose=False, sharding=vs)
    res["tr2"] = tr2

    # rollback: the second train pass has NaN in rank 1's rows only
    state, sched = fresh()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        state, tr, va, done = train_segmentation_resilient(
            3, _EpochLoader(2, slice(2, 4)), _loader(1), state, sched,
            CheckpointManager(os.path.join(out_dir, "resilient"),
                              stem="r"), verbose=True, sharding=vs)
    res["rollback"] = {"tr": tr, "done": done,
                       "rollbacks": printed.getvalue().count("rolling back"),
                       "finite": all(bool(torch.isfinite(p).all())
                                     for p in state.model.parameters()),
                       "state": _sd(state.model)}
    # rerunning the same call resumes from the last checkpoint: nothing
    # is left to train, and the state is the finished run's
    state, sched = fresh(5)
    with contextlib.redirect_stdout(io.StringIO()):
        state, tr, _, done = train_segmentation_resilient(
            3, _loader(1), _loader(1), state, sched,
            CheckpointManager(os.path.join(out_dir, "resilient"),
                              stem="r"), verbose=True, sharding=vs)
    res["resumed"] = {"tr": tr, "done": done, "state": _sd(state.model)}
    # preemption: only rank 0 gets SIGTERM; both ranks stop together
    state, sched = fresh()
    with contextlib.redirect_stdout(io.StringIO()):
        _, tr, _, done = train_segmentation_resilient(
            3, _loader(1), _loader(1), state, sched,
            CheckpointManager(os.path.join(out_dir, "preempt"), stem="p"),
            experiment=_Preempt(rank == 0), verbose=True, sharding=vs)
    res["preempt"] = {"tr": tr, "done": done}
    res["agree"] = (S.all_agree(rank == 0, mesh), S.any_rank(rank == 0, mesh),
                    S.all_agree(True, mesh))
    return res


def serving_checks(mesh, c):
    params = fold_bn_inference(unet(c["serve_unet"], 3).state_dict())
    vols = [c["vols"][i].numpy() for i in range(len(c["vols"]))]

    def classify(p, x):
        return torch.stack([x.mean(dim=(1, 2, 3, 4)),
                            x.std(dim=(1, 2, 3, 4))], -1)

    out = {}
    for pack in (False, True):
        for sharded in (True, False):
            res = list(segment_volumes(
                None, params, iter(vols), batch_size=2, dtype=torch.float32,
                device="cpu", mask_fn=packed_unet_mask_v2,
                classify_fn=classify, pack_masks=pack,
                sharding=data_sharding(mesh) if sharded else None))
            out[(pack, sharded)] = (np.stack([r["mask"] for r in res]),
                                    np.stack([r["probs"] for r in res]))
    return out


def window_checks(mesh, c):
    model = unet(c["unet"], 3).eval()
    folded = fold_bn_inference(model.state_dict())
    out = {}
    for name, fn, params in (
            ("fine", lambda v, x: model(x), None),
            ("packed", packed_unet_apply_v2, folded)):
        with torch.no_grad():
            for sharded in (True, False):
                apply = make_sharded_apply(fn, mesh) if sharded else fn
                out[(name, sharded)] = sliding_window_predict(
                    apply, params, c["wvol"], patch_size=16, overlap=8,
                    batch_size=2, device="cpu")
    return out


def pipeline_checks(mesh):
    vs = S.volume_sharding(mesh)
    batches = [(torch.arange(4 * 4 * 2 * 2, dtype=torch.float32)
                .reshape(4, 4, 2, 2, 1) + 100 * i, torch.arange(4) + i)
               for i in range(2)]
    got = list(prefetch_to_device(iter(batches), sharding=vs))
    want = [tuple(S.local_shard(t, vs) for t in b) for b in batches]
    return all(torch.equal(a, b) for g, w in zip(got, want)
               for a, b in zip(g, w)) and len(got) == 2


def main():
    init, rank, inputs, out_dir = sys.argv[1:5]
    rank = int(rank)
    torch.set_num_threads(2)
    assert initialize_distributed(init, 2, rank, device="cpu")
    c = torch.load(inputs, weights_only=False)
    results = {}
    for name, sizes in MESHES.items():
        mesh = create_mesh(("data", "spatial"), sizes)
        r = {"shape": dict(mesh.shape),
             "coord": (mesh.index("data"), mesh.index("spatial")),
             "halo": halo_checks(mesh), "conv": conv_checks(mesh, c),
             "apply": unet_apply_checks(mesh, c),
             "steps": step_checks(mesh, c), "zoo": zoo_checks(mesh, c),
             "slab_ops": slab_op_checks(mesh, c),
             "window": window_checks(mesh, c),
             "pipeline": pipeline_checks(mesh)}
        if name == "2x1":
            r["class"] = class_checks(mesh, c)
            r["fader"] = fader_checks(mesh, c)
            r["serving"] = serving_checks(mesh, c)
            r["loop"] = loop_checks(mesh, rank, out_dir)
        results[name] = r
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
