"""Port parity: the distribution layer (`parallel/sharding.py`, the
mesh-aware ops, steps, loops, serving and sliding window) on two real
processes, against the JAX package's UNSHARDED functions.

One pair of gloo ranks (`tests/torch_mesh_worker.py`, which imports torch
and the port only) runs every check of this module once, on the meshes
(data, spatial) = (2, 1) and (1, 2) of one two-rank group, and writes what
each rank computed; this process builds the inputs from numpy seeds and
JAX-initialised weights, holds the JAX references, and compares.

Tolerances (float32 throughout, JAX at HIGHEST):
- outputs and logits: 1e-5 x max|ref|; losses: 1e-5 relative;
- gradients: each tensor within 1e-4 x its max plus its float32 rounding
  (the port's unsharded float32 gradient against float64); the conv
  biases before a BatchNorm have a true gradient of 0 and are held to
  1e-4 x the network's largest gradient;
- parameters after one Adam(W) step: as the single-device step-parity
  tests (`test_torch_train.py`, `test_torch_voxresnet_packed.py`): Adam
  turns the f32 noise of a near-zero gradient into a step of up to lr,
  so pre-BN biases are held to 2 lr.
Sharded against unsharded runs of the port itself (dropout at 0.5, the
loops, serving, the sliding window) are held to the same limits or, where
the arithmetic is the same, to equality."""
import copy
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models.unet_packed import (
    fold_bn_inference, packed_unet_apply_v2)
from mri_epilepsy_diagnosis_torch.ops import functional as TF_
from mri_epilepsy_diagnosis_torch.train.seg import seg_loss
from mri_epilepsy_diagnosis_torch.transforms.labels import (
    binarize_segmentation)
from mri_epilepsy_diagnosis_torch.models.brats_unet import (
    BraTSUnet as TBraTSUnet)
from mri_epilepsy_diagnosis_tpu.models import (BraTSUnet, Classificator,
                                               Discriminator)
from mri_epilepsy_diagnosis_tpu.models.cnn import VoxResNet as JVoxResNet
from mri_epilepsy_diagnosis_tpu.models.fader import make_encoder
from mri_epilepsy_diagnosis_tpu.models import unet_packed as JU
from mri_epilepsy_diagnosis_tpu.models.voxresnet_packed import (
    voxresnet_class_step_packed as j_vox_packed_step)
from mri_epilepsy_diagnosis_tpu.ops import functional as JF_
from mri_epilepsy_diagnosis_tpu.train import fader as JF
from mri_epilepsy_diagnosis_tpu.train import seg as JS
from mri_epilepsy_diagnosis_tpu.train.classification import (
    _class_step as j_class_step)
from mri_epilepsy_diagnosis_tpu.train.optim import torch_adam, torch_adamw
from mri_epilepsy_diagnosis_tpu.train.state import create_train_state
from mri_epilepsy_diagnosis_tpu.transforms.labels import (
    binarize_segmentation as j_binarize)
from test_torch_bridge import jax_unet_variables, torch_unet
from test_torch_fader import randomized

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
MESHES = ("2x1", "1x2")
LR = 1e-3
VOX_KW = dict(input_shape=(16,) * 3, n_filters=4, stride=1, n_blocks=3,
              n_fc_units=16)
DOWN = dict(conv_k=6, conv_pad=2, conv_s=2, maxpool_k=2, maxpool_s=2,
            batch_norm=True, act="l_relu")
ENC_KW = dict(c_in=1, deapth=1, c_base=8, inc_size=2, reduce_size=False,
              down_block_kwargs=DOWN)
HEAD_KW = dict(c_in=8, c_out=16, conv_k=3, conv_s=1, conv_pad=0, l_in=16,
               l_out=8, batch_norm=True, act="relu", p_drop=0.0)
N_DOMAINS = 3
LAMBDA = 0.3
CLASS_WEIGHT = [1.0, 2.0]
VOX_PRE_BN = ("model.conv3d_1.bias", "model.conv3d_2.bias")
BRATS_NORMS = ("gn", "in")
WD, EPS = 1e-2, 1e-8
# AdamW against optax's: about 4 float32 ulps of the weight, plus optax's
# float32 bias correction (`test_torch_zoo_train.py`)
OPT_RTOL, OPT_ATOL = 5e-7, 3e-8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serving_unet(sd, vols):
    """The UNet with its classifier bias shifted so that about a third of
    the voxels are foreground (a random net's masks are one class)."""
    folded = fold_bn_inference(sd)
    with torch.no_grad():
        logits = packed_unet_apply_v2(folded, _t(vols[..., None]))
    diff = (logits[..., 1] - logits[..., 0]).flatten()
    sd = dict(sd)
    bias = sd["classifier.conv_layer.bias"].clone()
    bias[1] -= float(torch.quantile(diff, 0.66))
    sd["classifier.conv_layer.bias"] = bias
    return sd


def _jax_brats(norm, seed):
    """JAX's BraTSUnet (4 base filters, 2 classes, `norm`) and numpy
    variables from a seed: He-normal kernels, norm gammas in [0.5, 1.5),
    biases N(0, 0.2).  The shapes come from `jax.eval_shape`, so the init
    compiles nothing."""
    jm = BraTSUnet(c=1, n=4, norm=norm, num_classes=2)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.key(0),
                                      "dropout": jax.random.key(1)},
                            jnp.zeros((1, 16, 16, 16, 1)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if len(leaf.shape) == 5:
            std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            value = rng.normal(0.0, std, leaf.shape)
        elif jax.tree_util.keystr(path).endswith("['weight']"):
            value = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            value = rng.normal(0.0, 0.2, leaf.shape)
        return value.astype(np.float32)

    return jm, jax.tree_util.tree_map_with_path(fill, shapes)


class _Workers:
    """The two worker processes; `results()` waits for them once."""

    def __init__(self, inputs, out_dir):
        self.out_dir = out_dir
        init = f"tcp://127.0.0.1:{_free_port()}"
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, init, str(r), inputs, out_dir],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(2)]
        self._results = None

    def results(self):
        if self._results is None:
            logs = []
            for p in self.procs:
                try:
                    out, _ = p.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    raise
                logs.append(out.decode(errors="replace"))
            assert all(p.returncode == 0 for p in self.procs), \
                "\n".join(logs)
            self._results = [torch.load(
                os.path.join(self.out_dir, f"rank{r}.pt"),
                weights_only=False) for r in range(2)]
        return self._results


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs (numpy seeds, JAX-initialised weights), the JAX variables
    they came from, and the running worker pair."""
    rng = np.random.default_rng(31)
    jmodel, uvars = jax_unet_variables(ocfl=4, nb=3, seed=11)
    jvox = JVoxResNet(**VOX_KW, dropout=0.0)
    vvars = randomized(jax.jit(jvox.init)(
        jax.random.key(1), jnp.zeros((1, 16, 16, 16, 1))), seed=3)
    fx = rng.normal(size=(4, 12, 12, 12, 1)).astype(np.float32)
    jenc = make_encoder(ENC_KW)
    jclf = Classificator(n_class=2, **HEAD_KW)
    jdisc = Discriminator(n_domains=N_DOMAINS, **HEAD_KW)
    venc = randomized(jax.jit(jenc.init)(jax.random.key(2),
                                         jnp.asarray(fx)), 2)
    latent, _ = jenc.apply(venc, jnp.asarray(fx))
    vclf = randomized(jax.jit(jclf.init)(jax.random.key(3), latent), 3)
    vdisc = randomized(jax.jit(jdisc.init)(jax.random.key(4), latent), 4)
    sd = variables_to_state_dict(uvars, device="cpu")
    vols = rng.normal(size=(3, 16, 16, 16)).astype(np.float32)
    jbrats = {norm: _jax_brats(norm, 40 + i)
              for i, norm in enumerate(BRATS_NORMS)}
    c = {
        "unet": sd, "serve_unet": _serving_unet(sd, vols),
        "x": _t(rng.normal(size=(4, 16, 16, 16, 1)).astype(np.float32)),
        "labels": _t(np.where(rng.random((4, 16, 16, 16, 1)) > 0.6, 1002,
                              41).astype(np.float32)),
        "cx": _t(rng.normal(size=(2, 16, 6, 6, 3)).astype(np.float32)),
        "cw": _t(rng.normal(size=(4, 3, 3, 3, 3)).astype(np.float32)),
        "cb": _t(rng.normal(size=4).astype(np.float32)),
        "cg": _t(rng.normal(size=(2, 16, 6, 6, 4)).astype(np.float32)),
        "vox_kw": VOX_KW,
        "vox": variables_to_state_dict(vvars, device="cpu"),
        "vx": _t(rng.normal(size=(4, 16, 16, 16, 1)).astype(np.float32)),
        "vy": _t(np.array([0, 1, 1, 0])),
        "enc_kw": ENC_KW, "head_kw": HEAD_KW, "n_domains": N_DOMAINS,
        "enc": variables_to_state_dict(venc, device="cpu"),
        "clf": variables_to_state_dict(vclf, device="cpu"),
        "disc": variables_to_state_dict(vdisc, device="cpu"),
        "fx": _t(fx), "fy": _t(np.array([0, 1, 1, 0])),
        "fd": _t(np.array([0, 2, 1, 2])), "lam": LAMBDA,
        "class_weight": CLASS_WEIGHT,
        "vols": _t(vols),
        "wvol": _t(rng.normal(size=(24, 24, 24, 1)).astype(np.float32)),
        "bx": _t(rng.normal(size=(2, 32, 32, 32, 1)).astype(np.float32)),
        "by": _t((rng.random((2, 32, 32, 32, 1)) > 0.6).astype(np.float32)),
        "tw": _t(rng.normal(size=(3, 2, 2, 2, 2)).astype(np.float32)),
    }
    for norm, (_, v) in jbrats.items():
        c[f"brats_{norm}"] = variables_to_state_dict(v, device="cpu")
    out_dir = tmp_path_factory.mktemp("mesh")
    inputs = str(out_dir / "inputs.pt")
    torch.save(c, inputs)
    workers = _Workers(inputs, str(out_dir))
    yield dict(c=c, jmodel=jmodel, uvars=uvars, jvox=jvox, vvars=vvars,
               jenc=jenc, jclf=jclf, jdisc=jdisc, venc=venc, vclf=vclf,
               vdisc=vdisc, jbrats=jbrats, workers=workers)
    for p in workers.procs:
        if p.poll() is None:
            p.kill()


def _ranks(case, mesh):
    """Both ranks' results on `mesh`, ordered by their coordinate."""
    res = [r[mesh] for r in case["workers"].results()]
    return sorted(res, key=lambda r: r["coord"])


def _joined(case, mesh, get):
    """The shards of one output of both ranks, joined along the mesh's
    split dim (the batch at 2x1, D at 1x2)."""
    return torch.cat([get(r) for r in _ranks(case, mesh)],
                     dim=0 if mesh == "2x1" else 1)


def _close(got, ref, rel=1e-5):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _rounding(model_fn, loss_fn):
    """Per parameter, max |float32 - float64 gradient| of the port's
    unsharded function: its float32 rounding."""
    grads = []
    for dtype in (torch.float32, torch.float64):
        model = model_fn().to(dtype)
        loss_fn(model, dtype).backward()
        grads.append({n: p.grad.double() for n, p in
                      model.named_parameters()})
    return {n: float((grads[0][n] - grads[1][n]).abs().max())
            for n in grads[0]}


def _assert_grads(got, ref, rounding, pre_bn):
    largest = max(float(v.abs().max()) for v in ref.values())
    for n, r in ref.items():
        err = float((got[n].double() - r.double()).abs().max())
        tol = (1e-4 * largest if pre_bn(n)
               else 1e-4 * float(r.abs().max()) + rounding[n])
        assert err <= tol, (n, err, tol)


def _is_unet_pre_bn(sd):
    return lambda k: (k.endswith("conv_layer.bias") and k.replace(
        "conv_layer.bias", "norm_layer.weight") in sd)


# ---------------------------------------------------------------------------
# mesh, halo exchange, the sharded conv and apply
# ---------------------------------------------------------------------------


def test_two_ranks_lay_out_both_meshes(case):
    for mesh, sizes in (("2x1", (2, 1)), ("1x2", (1, 2))):
        ranks = _ranks(case, mesh)
        assert [r["shape"] for r in ranks] == [
            {"data": sizes[0], "spatial": sizes[1]}] * 2
        assert [r["coord"] for r in ranks] == (
            [(0, 0), (1, 0)] if mesh == "2x1" else [(0, 0), (0, 1)])


@pytest.mark.parametrize("mode", ["zeros", "edge"])
@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_matches_padding(case, mode, halo):
    """Each rank's haloed slab is its window of the padded volume (zeros,
    or the edge plane repeated), and the gradient through both ranks'
    windows is the padded volume's gradient (1x2); at 2x1 the spatial
    axis has one rank, so both halos are the volume's faces."""
    from torch_mesh_worker import halo_cotangent

    x = torch.linspace(-1, 1, 8 * 3 * 3 * 2).reshape(1, 8, 3, 3, 2)
    for mesh, n in (("1x2", 2), ("2x1", 1)):
        xr = x.clone().requires_grad_(True)
        idx = torch.arange(-halo, 8 + halo)
        padded = (xr[:, idx.clamp(0, 7)] if mode == "edge" else
                  torch.nn.functional.pad(xr, (0,) * 6 + (halo, halo)))
        per = 8 // n
        loss = 0.0
        for i, r in enumerate(_ranks(case, mesh)[:n]):
            window = padded[:, i * per:i * per + per + 2 * halo]
            h, _ = r["halo"][(mode, halo)]
            assert torch.equal(h, window.detach()), (mesh, i)
            loss = loss + (window * halo_cotangent(
                halo, mode, i, window.shape)).sum()
        loss.backward()
        grads = [r["halo"][(mode, halo)][1] for r in _ranks(case, mesh)[:n]]
        torch.testing.assert_close(torch.cat(grads, 1), xr.grad, rtol=0,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def jax_conv(case):
    c = case["c"]
    w = jnp.asarray(c["cw"].permute(2, 3, 4, 1, 0).numpy())

    def f(x, w, b):
        return JF_.conv3d(x, w, b, padding=1)

    y, vjp = jax.vjp(f, jnp.asarray(c["cx"].numpy()), w,
                     jnp.asarray(c["cb"].numpy()))
    dx, dw, db = vjp(jnp.asarray(c["cg"].numpy()))
    return (np.asarray(y), np.asarray(dx),
            np.asarray(dw).transpose(4, 3, 0, 1, 2), np.asarray(db))


@pytest.mark.parametrize("mesh", MESHES)
def test_spatially_sharded_conv3d_matches_jax(case, jax_conv, mesh):
    """`F.conv3d` on each rank's shard (a D halo at 1x2) joins into JAX's
    unsharded conv; dx joins into JAX's, and dw, db summed over the ranks
    are JAX's."""
    y, dx, dw, db = jax_conv
    _close(_joined(case, mesh, lambda r: r["conv"]["y"]), y)
    _close(_joined(case, mesh, lambda r: r["conv"]["dx"]), dx)
    ranks = _ranks(case, mesh)
    _close(sum(r["conv"]["dw"] for r in ranks), dw)
    _close(sum(r["conv"]["db"] for r in ranks), db)


@pytest.fixture(scope="module")
def jax_apply(case):
    jmodel, v = case["jmodel"], case["uvars"]
    x = jnp.asarray(case["c"]["x"].numpy())
    ev = jax.jit(lambda v, x: jmodel.apply(v, x))(v, x)
    tr, bs = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, x)
    return np.asarray(ev), np.asarray(tr), variables_to_state_dict(
        {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                               bs["batch_stats"])},
        device="cpu")


@pytest.mark.parametrize("mesh", MESHES)
def test_unet_parallel_apply_matches_jax(case, jax_apply, mesh):
    """`make_parallel_apply` of the fine UNet3D (every rank gets the
    gathered output) against JAX's unsharded apply: eval mode, and train
    mode, whose BatchNorm statistics (and running statistics) are the
    global batch's."""
    ev, tr, stats = jax_apply
    for r in _ranks(case, mesh):
        _close(r["apply"]["eval"], ev)
        _close(r["apply"]["train"], tr)
        for k, v in stats.items():
            if not k.endswith("num_batches_tracked"):
                _close(r["apply"]["train_stats"][k], v)


# ---------------------------------------------------------------------------
# segmentation steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_seg(case):
    """JAX's unsharded fine and packed steps: loss, gradients (torch keys)
    and the state after one AdamW(1e-3) step."""
    jmodel, v = case["jmodel"], case["uvars"]
    x = jnp.asarray(case["c"]["x"].numpy())
    labels = jnp.asarray(case["c"]["labels"].numpy())
    targets = j_binarize(labels)

    def fine_loss(params):
        logits, bs = jmodel.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return JS._dice_loss_from_logits(logits, targets)

    def packed_loss(params):
        yp, _ = JU.packed_unet_train_apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x)
        return JU.packed_dice_loss(yp, targets)

    out = {}
    for name, loss_fn, step in (
            ("fine", fine_loss, JS.seg_train_step),
            ("packed", packed_loss, JS.packed_seg_train_step)):
        loss, g = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
        st = create_train_state(jmodel, torch_adamw(LR),
                                jnp.zeros((1, 8, 8, 8, 1)),
                                variables=jax.tree_util.tree_map(
                                    jnp.asarray, v))
        st, _ = step(st, x, labels)
        out[name] = dict(
            loss=float(loss),
            grads=variables_to_state_dict(
                {"params": jax.tree_util.tree_map(np.asarray, g)},
                device="cpu"),
            state=variables_to_state_dict(
                {"params": jax.tree_util.tree_map(np.asarray, st.params),
                 "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                       st.batch_stats)},
                device="cpu"))
    return out


@pytest.fixture(scope="module")
def seg_rounding(case):
    c = case["c"]

    def loss(model, dtype):
        return seg_loss(model, c["x"].to(dtype),
                        binarize_segmentation(c["labels"]).to(dtype))

    return _rounding(lambda: torch_unet(case["uvars"], ocfl=4, nb=3), loss)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["fine", "packed"])
def test_seg_train_step_on_mesh_matches_jax(case, jax_seg, seg_rounding,
                                            mesh, name):
    """`seg_train_step` / `packed_seg_train_step` under `use_mesh` on each
    rank's rows or D slab (16^3, 3 blocks, 4 first-layer channels):
    BatchNorm statistics and dice sums all-reduced, the loss global, the
    gradients summed.  Loss, gradients and the stepped state against JAX's
    unsharded step; both ranks hold the same state."""
    ref = jax_seg[name]
    r0, r1 = (r["steps"][name] for r in _ranks(case, mesh))
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], ref["loss"], rtol=1e-5)
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    pre_bn = _is_unet_pre_bn(ref["state"])
    _assert_grads(r0["grads"], ref["grads"], seg_rounding, pre_bn)
    for k, v in ref["state"].items():
        got = r0["state"][k]
        if k.endswith("num_batches_tracked"):
            assert int(got) == 1, k
        elif pre_bn(k):
            np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=0,
                                       atol=2 * LR, err_msg=k)
        else:
            np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=5e-3,
                                       atol=5e-4, err_msg=k)


@pytest.fixture(scope="module")
def jax_brats(case):
    """JAX's unsharded `seg_train_step` of BraTSUnet with GroupNorm and
    with InstanceNorm, one AdamW(1e-3, weight decay 1e-2) step: the loss,
    the gradients it fed the optimizer (taken out of the compiled step by
    a `jax.debug.callback` in a wrapper around the optimizer's update) and
    the stepped parameters, with torch keys."""
    x = jnp.asarray(case["c"]["bx"].numpy())
    y = jnp.asarray(case["c"]["by"].numpy())
    out = {}
    for norm, (jm, v) in case["jbrats"].items():
        tx = torch_adamw(LR, weight_decay=WD)
        grads = []

        def update(g, opt_state, params=None, _grads=grads, **kw):
            jax.debug.callback(lambda g: _grads.append(
                jax.tree_util.tree_map(np.array, g)), g)
            return tx.update(g, opt_state, params, **kw)

        st = create_train_state(
            jm, optax.GradientTransformation(tx.init, update), None,
            variables=jax.tree_util.tree_map(jnp.asarray, v))
        st, loss = JS.seg_train_step(st, x, y)
        loss = float(loss)
        jax.effects_barrier()
        out[norm] = dict(
            loss=loss,
            grads=variables_to_state_dict({"params": grads[0]},
                                          device="cpu"),
            params=variables_to_state_dict(
                {"params": jax.tree_util.tree_map(np.asarray, st.params)},
                device="cpu"))
    return out


@pytest.fixture(scope="module")
def brats_float64(case):
    """The port's unsharded BraTSUnet gradients in float64 (0 where the
    loss does not reach a parameter): the function's value, to within
    float64 rounding."""
    c = case["c"]
    out = {}
    for norm in BRATS_NORMS:
        model = TBraTSUnet(c=1, n=4, norm=norm, num_classes=2, device="cpu")
        model.load_state_dict(c[f"brats_{norm}"])
        model = model.double().train()
        seg_loss(model, c["bx"].double(),
                 binarize_segmentation(c["by"]).double()).backward()
        out[norm] = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                     for n, p in model.named_parameters()}
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("norm", BRATS_NORMS)
def test_brats_norms_on_mesh_match_jax(case, jax_brats, brats_float64,
                                       mesh, norm):
    """`seg_train_step` of BraTSUnet (32^3, batch 2, 4 base filters) with
    GroupNorm or InstanceNorm on each rank's rows (2x1) or D slab (1x2):
    each sample's norm statistics are the whole volume's (summed over the
    spatial ranks), as in JAX's unsharded step.
    - The function: the sharded step in float64 gives the unsharded
      float64 gradients within 1e-9 x each tensor's max (a slab's own
      statistics would be off by the tensor's size).
    - float32 against JAX: loss 1e-5; each gradient tensor within 1e-4 x
      its max plus both sides' float32 error on it (the sharded float32
      gradient's distance to its float64 one, and JAX's to the port's
      float64 one: the norms over the 2^3 voxels at the bottom amplify
      rounding up to 1e-3 of a first-layer tensor's max); the parameters
      after one AdamW step within float32 rounding of JAX's plus the
      difference of Adam's first step `lr g / (|g| + eps)` between the
      port's gradient and JAX's (float64)."""
    ref = jax_brats[norm]
    r0, r1 = (r["zoo"][norm] for r in _ranks(case, mesh))
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], ref["loss"], rtol=1e-5)
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    g64 = brats_float64[norm]
    assert r0["grads"].keys() == ref["grads"].keys() == g64.keys()
    for k, r in ref["grads"].items():
        big = float(g64[k].abs().max())
        assert float((r0["grads64"][k] - g64[k]).abs().max()) <= 1e-9 * big
        r = r.double()
        bound = (1e-4 * float(r.abs().max())
                 + float((r0["grads"][k].double() - g64[k]).abs().max())
                 + float((r - g64[k]).abs().max()))
        assert bound < big or not r.any(), (k, bound)
        err = float((r0["grads"][k].double() - r).abs().max())
        assert err <= bound, (k, err, bound)
    for k, w in ref["params"].items():
        g, gj = r0["grads"][k].double(), ref["grads"][k].double()
        du = LR * (g / (g.abs() + EPS) - gj / (gj.abs() + EPS)).abs()
        w = w.double()
        tol = OPT_RTOL * w.abs() + OPT_ATOL + du
        assert bool(((r0["state"][k].double() - w).abs() <= tol).all()), k


def test_models_with_strided_convs_raise_on_a_d_split(case):
    """Modified3DUNet and ResidualUNet3D downsample with stride-2 convs,
    whose windows reach across a D slab, and the packed VoxResNet runs on
    the data axis only: under a spatial split their steps raise on both
    ranks, naming the op, instead of training another function."""
    want = {"modified": "conv3d under a spatial mesh",
            "residual": "conv3d under a spatial mesh",
            "voxresnet_packed": "packed VoxResNet under a spatial mesh"}
    for r in _ranks(case, "1x2"):
        raised = r["zoo"]["raised"]
        assert raised.keys() == want.keys()
        for name, msg in raised.items():
            assert msg is not None and msg.startswith(want[name]), (name,
                                                                     msg)


@pytest.mark.parametrize("op", ["deconv", "avgpool", "nearest"])
def test_slab_ops_tile_the_slab_or_raise(case, op):
    """A deconv with stride == kernel, a 2^3 average pool and a x2 nearest
    upsample map each D slab to its own output slab: joined, the ranks'
    results are the unsharded op's.  Their overlapping forms (a k4 s2
    deconv, a 3^3 pool of stride 1, a x3 nearest resize of D) raise at
    1x2 and run at 2x1, where D is whole."""
    x, tw = case["c"]["cx"], case["c"]["tw"]
    want = {"deconv": lambda: TF_.conv3d_transpose(x, tw, stride=2),
            "avgpool": lambda: TF_.avgpool3d(x, 2),
            "nearest": lambda: TF_.resize_nearest(
                x, tuple(2 * s for s in x.shape[1:4]))}[op]()
    name = {"deconv": "conv3d_transpose", "avgpool": "avgpool3d",
            "nearest": "resize_nearest"}[op]
    for mesh in MESHES:
        _close(_joined(case, mesh, lambda r: r["slab_ops"][op]), want)
        for r in _ranks(case, mesh):
            msg = r["slab_ops"][("raised", op)]
            if mesh == "1x2":
                assert msg is not None and msg.startswith(
                    f"{name} under a spatial mesh"), msg
            else:
                assert msg is None


# ---------------------------------------------------------------------------
# classification and fader steps on the data axis
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_class(case):
    """JAX's unsharded fine `_class_step` and packed VoxResNet step at
    dropout 0 (Adam, L2 weight decay 0.01): loss and state."""
    jvox, v = case["jvox"], case["vvars"]
    x = jnp.asarray(case["c"]["vx"].numpy())
    y = jnp.asarray(case["c"]["vy"].numpy().astype(np.int32))
    out = {}
    with jax.default_matmul_precision("highest"):
        for name in ("fine", "packed"):
            st = create_train_state(jvox, torch_adam(LR, weight_decay=0.01),
                                    None, variables=v)
            if name == "fine":
                st, loss, _ = j_class_step(st, x, y, jax.random.key(0), True)
            else:
                st, loss, _ = j_vox_packed_step(st, x, y, jax.random.key(0),
                                                model=jvox)
            out[name] = (float(loss), variables_to_state_dict(
                jax.tree_util.tree_map(np.asarray, st.variables),
                device="cpu"))
    return out


@pytest.mark.parametrize("name", ["fine", "packed"])
def test_classification_steps_on_mesh_match_jax(case, jax_class, name):
    """VoxResNet's fine `_class_step` and `voxresnet_class_step_packed` on
    each rank's 2 of 4 rows (2x1), dropout 0: the loss and the stepped
    state against JAX's unsharded step (the tolerance of the
    single-device packed-step parity test), and the gradients against
    the port's unsharded step."""
    loss, want = jax_class[name]
    ranks = _ranks(case, "2x1")
    r0, r1 = (r["class"][(name, 0.0)] for r in ranks)
    assert r0["sharded"]["loss"] == r1["sharded"]["loss"]
    assert abs(r0["sharded"]["loss"] - loss) <= 1e-5 * abs(loss)
    got = r0["sharded"]["state"]
    for k, r in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k
            continue
        tol = (2 * LR if k in VOX_PRE_BN
               else 1e-5 * max(1.0, float(r.abs().max())))
        assert float((got[k] - r).abs().max()) <= tol, k
        assert torch.equal(got[k], r1["sharded"]["state"][k]), k


@pytest.mark.parametrize("name", ["fine", "packed"])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_classification_steps_on_mesh_match_the_unsharded_port(case, name,
                                                               rate):
    """The same steps against the port's unsharded step from the same
    generator: at dropout 0.5 the mask is drawn at the global shape and
    each rank keeps its rows, so the sharded step drops what the
    unsharded one does.  Loss and probabilities to 1e-5, gradients to
    1e-4 x their max (1e-4 x the largest for the pre-BN biases)."""
    ranks = _ranks(case, "2x1")
    plain = ranks[0]["class"][(name, rate)]["plain"]
    got = [r["class"][(name, rate)]["sharded"] for r in ranks]
    assert abs(got[0]["loss"] - plain["loss"]) <= 1e-5 * abs(plain["loss"])
    torch.testing.assert_close(torch.cat([g["probs"] for g in got]),
                               plain["probs"], rtol=0, atol=1e-5)
    largest = max(float(v.abs().max()) for v in plain["grads"].values())
    for n, r in plain["grads"].items():
        tol = 1e-4 * (largest if n in VOX_PRE_BN else float(r.abs().max()))
        assert float((got[0]["grads"][n] - r).abs().max()) <= tol, n


@pytest.fixture(scope="module")
def jax_fader(case):
    c = case["c"]
    x = jnp.asarray(c["fx"].numpy())
    y = jnp.asarray(c["fy"].numpy().astype(np.int32))
    d = jnp.asarray(c["fd"].numpy().astype(np.int32))
    fs = JF.FaderState(*(
        create_train_state(case[m], optax.sgd(1.0), None,
                           variables=case[v])
        for m, v in (("jenc", "venc"), ("jclf", "vclf"),
                     ("jdisc", "vdisc"))))
    key = jax.random.key(0)
    with jax.default_matmul_precision("highest"):
        fs, dl, _ = JF.disc_step(fs, x, d, key, N_DOMAINS)
        fs, loss, ladv, _ = JF.enc_clf_step(
            fs, x, y, d, jnp.float32(LAMBDA), key, N_DOMAINS,
            jnp.asarray(CLASS_WEIGHT, jnp.float32))

    def sd(st):
        return variables_to_state_dict(jax.tree_util.tree_map(
            np.asarray, st.variables), device="cpu")

    return ((float(dl), float(loss), float(ladv)),
            {"enc": sd(fs.encoder), "clf": sd(fs.clf), "disc": sd(fs.disc)})


def test_fader_alternation_on_mesh_matches_jax(case, jax_fader):
    """A discriminator step, then an encoder + classifier step against the
    frozen discriminator, each rank on 2 of 4 rows (2x1), BatchNorm
    (BatchNorm1d too) on the global batch, weighted cross entropy: the
    three losses and the three networks against JAX's unsharded
    alternation (1e-5 x max(1, max|ref|) a tensor).  SGD at lr 1 on both
    sides, as in the single-device fader parity tests, so that the states
    show the gradients linearly (Adam would amplify the float32 noise of
    near-zero gradients into steps of lr)."""
    losses, want = jax_fader
    r0, r1 = (r["fader"] for r in _ranks(case, "2x1"))
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    for net in ("enc", "clf", "disc"):
        for k, r in want[net].items():
            got = r0[net][k]
            assert torch.equal(got, r1[net][k]), (net, k)
            if k.endswith("num_batches_tracked"):
                continue
            tol = 1e-5 * max(1.0, float(r.abs().max()))
            assert float((got - r).abs().max()) <= tol, (net, k)


# ---------------------------------------------------------------------------
# loops, serving, the sliding window, the pipeline
# ---------------------------------------------------------------------------


def test_train_segmentation_on_mesh_checkpoints_and_resumes(case):
    """Two epochs of `train_segmentation(sharding=volume_sharding(mesh))`
    on 2x1: every rank logs the global losses, which match an unsharded
    run; rank 0 writes one checkpoint an epoch; epoch 2 from the epoch-1
    checkpoint, loaded into a fresh state on both ranks, repeats the
    uninterrupted epoch 2.  Only rank 0 updates the dashboard, once an
    epoch with the global losses."""
    r0, r1 = (r["loop"] for r in _ranks(case, "2x1"))
    assert r0["tr"] == r1["tr"] and r0["va"] == r1["va"]
    assert r0["dashboard"] == [{"train_loss": t, "val_loss": v}
                               for t, v in zip(r0["tr"], r0["va"])]
    assert r1["dashboard"] == []
    # four AdamW steps: Adam turns the float32 noise of near-zero
    # gradients into steps of up to lr, so the losses drift apart by more
    # than one step's 1e-5 (the gradients are held to 1e-4 above)
    np.testing.assert_allclose(r0["tr"], r0["plain_tr"], rtol=1e-4)
    np.testing.assert_allclose(r0["va"], r0["plain_va"], rtol=1e-4)
    assert r0["files"] == ["mesh_epoch_1.ckpt", "mesh_epoch_2.ckpt"]
    assert r0["resumed_step"] == 2
    np.testing.assert_allclose(r0["tr2"][0], r0["tr"][1], rtol=1e-6)
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k


def test_resilient_loop_rolls_back_and_stops_on_all_ranks(case):
    """NaNs in rank 1's rows of one epoch: both ranks roll back once and
    finish three finite epochs with the same state, which a rerun of the
    same call resumes.  SIGTERM on rank 0 alone: both ranks stop after
    the same epoch.  The agreement flags
    themselves: all-true only if every rank says so, any-true if one
    does."""
    r0, r1 = (r["loop"] for r in _ranks(case, "2x1"))
    for r in (r0, r1):
        rb = r["rollback"]
        assert rb["rollbacks"] == 1 and rb["done"] == 3 and rb["finite"]
        assert len(rb["tr"]) == 3 and np.isfinite(rb["tr"]).all()
        assert r["preempt"]["done"] == 1 and len(r["preempt"]["tr"]) == 1
        assert r["agree"] == (False, True, True)
    for k in r0["rollback"]["state"]:
        assert torch.equal(r0["rollback"]["state"][k],
                           r1["rollback"]["state"][k]), k
    # the same call again resumes at epoch 3 on both ranks: no epoch left,
    # the finished run's state restored from rank 0's checkpoint
    for r in (r0, r1):
        assert r["resumed"]["done"] == 3 and r["resumed"]["tr"] == []
        for k, v in r0["rollback"]["state"].items():
            assert torch.equal(r["resumed"]["state"][k], v), k


@pytest.mark.parametrize("pack", [False, True])
def test_sharded_segment_volumes_equals_unsharded(case, pack):
    """Data-parallel serving (2x1, batch 2, three volumes: the last batch
    padded): each rank runs its row of every batch and gathers the masks
    (bit-packed or not) and probabilities; every rank yields the whole
    stream, equal to the unsharded run's, with a non-trivial mask."""
    for r in _ranks(case, "2x1"):
        masks, probs = r["serving"][(pack, True)]
        ref_masks, ref_probs = r["serving"][(pack, False)]
        assert masks.shape == (3, 16, 16, 16)
        assert 0.05 < ref_masks.mean() < 0.95
        np.testing.assert_array_equal(masks, ref_masks)
        np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["fine", "packed"])
def test_sharded_sliding_window_equals_unsharded(case, mesh, name):
    """`sliding_window_predict` with `make_sharded_apply` (patches split
    over data at 2x1, each patch's D over spatial at 1x2, outputs
    gathered) against the unsharded call, 1e-5 x max|ref|; the fine
    UNet3D and the served packed forward (B1 with B2 fused, the D pad
    mask following the rank's slab)."""
    for r in _ranks(case, mesh):
        _close(r["window"][(name, True)], r["window"][(name, False)])


@pytest.mark.parametrize("mesh", MESHES)
def test_prefetch_to_device_stages_local_shards(case, mesh):
    assert all(r["pipeline"] for r in _ranks(case, mesh))


def test_unet_forward_under_a_world_of_one_is_unchanged(case):
    """A mesh of one rank without a process group: the ops' collectives
    are the identity, so a step on it is the plain step, bit for bit."""
    from mri_epilepsy_diagnosis_torch.core.mesh import create_mesh
    from mri_epilepsy_diagnosis_torch.parallel import use_mesh

    model = torch_unet(case["uvars"], ocfl=4, nb=3).train()
    x = case["c"]["x"]
    with torch.no_grad():
        ref = copy.deepcopy(model)(x)
        with use_mesh(create_mesh(("data", "spatial"), devices="cpu")):
            got = model(x)
    assert torch.equal(got, ref)
    assert TF_.dropout(x, 0.5, True, torch.Generator().manual_seed(0)
                       ).shape == x.shape
