"""Port parity: the detection workload (`data/patches.py`,
`models/patch_model.py`, `infer/detection.py`, PatchModel training
through `train/classification.py` and `train/accum.py`, and JAX
checkpoints of PatchModel) against the JAX package on the CPU.

PatchModel runs with JAX-initialised variables (random BatchNorm
statistics and biases) carried across by `interop.variables_to_state_dict`;
in train mode the port's Dropout takes the mask JAX drew (`dropout_core`).
float32, JAX at "highest" precision.  Tolerances: logits and losses
1e-5 x max|ref| (summation order); gradients 1e-5 x max|ref| per leaf
plus a floor of 1e-6 x the largest gradient, for the conv biases before
BatchNorm (true gradient 0); after one Adam step, parameters within
1e-2 lr of JAX's where JAX's gradient is at least 100 eps (1e-6), else
within 2 lr: Adam's first step is lr g / (|g| + eps), which turns the
float32 noise of a gradient near eps, and of the pre-BN conv biases,
into a step of up to lr; patches, labels and masks exactly."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_epilepsy_diagnosis_torch.data import DataLoader
from mri_epilepsy_diagnosis_torch.data import patches as TP
from mri_epilepsy_diagnosis_torch.infer import FCDMaskGenerator as TGen
from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import PatchModel as TPatchModel
from mri_epilepsy_diagnosis_torch.ops import functional as TFn
from mri_epilepsy_diagnosis_torch.train import accum as TA
from mri_epilepsy_diagnosis_torch.train import checkpoint as TCk
from mri_epilepsy_diagnosis_torch.train import classification as TC
from mri_epilepsy_diagnosis_torch.train.optim import torch_adam
from mri_epilepsy_diagnosis_torch.train.state import TrainState
from mri_epilepsy_diagnosis_torch.utils.nifti import load_nifti, save_nifti
from mri_epilepsy_diagnosis_tpu.data import patches as JP
from mri_epilepsy_diagnosis_tpu.infer import FCDMaskGenerator as JGen
from mri_epilepsy_diagnosis_tpu.models import PatchModel as JPatchModel
from mri_epilepsy_diagnosis_tpu.ops.layers import Dropout as JDropout
from mri_epilepsy_diagnosis_tpu.train import checkpoint as JCk
from mri_epilepsy_diagnosis_tpu.train import classification as JC
from mri_epilepsy_diagnosis_tpu.train import optim as JO
from mri_epilepsy_diagnosis_tpu.train.state import create_train_state

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5
LR = 3e-4
BATCH = 8


def _head(shape=(96, 96, 4)):
    """`tests/test_infer.py`'s synthetic head: a gray-matter block and an
    image with a bright lesion."""
    rng = np.random.default_rng(0)
    gmpm = np.zeros(shape, np.float32)
    gmpm[10:86, 20:76, :] = 1.0
    img = rng.uniform(0.0, 0.2, size=shape).astype(np.float32)
    img[20:40, 30:60, :] = 0.9
    mask = np.zeros_like(img, dtype=bool)
    mask[20:40, 30:60, :] = True
    return gmpm, img, mask


def _randomized(variables, seed):
    """numpy copy with random BatchNorm statistics, BN affine parameters and
    biases (the JAX init zeroes the biases)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, leaf in tree.items():
            if hasattr(leaf, "items"):
                out[k] = walk(leaf, path + (k,))
                continue
            leaf = np.asarray(leaf, np.float32)
            if k == "running_var" or (path[-1] == "bn" and k == "weight"):
                leaf = rng.uniform(0.5, 1.5, leaf.shape)
            elif k in ("running_mean", "bias"):
                leaf = rng.normal(0.0, 0.2, leaf.shape)
            out[k] = np.asarray(leaf, np.float32)
        return out

    return walk(dict(variables))


@pytest.fixture(scope="module")
def variables():
    v = JPatchModel().init(jax.random.key(0), jnp.zeros((1, 16, 32, 2)))
    return _randomized(v, 1)


def _port_model(variables):
    model = TPatchModel(device="cpu")
    model.load_state_dict(variables_to_state_dict(variables, device="cpu"),
                          strict=True)
    return model


def _jvars(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _jax_dropout_mask(variables, x, key):
    """The keep mask of PatchModel's Dropout for `key`: where its output is
    nonzero.  Where its input is 0 the mask does not matter (0 either way,
    and that input is a max pool of ReLU zeros, whose gradient is 0)."""
    _, state = JPatchModel().apply(
        _jvars(variables), jnp.asarray(x), train=True,
        rngs={"dropout": key}, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JDropout))
    out = state["intermediates"]["dropout"]["__call__"][0]
    return torch.from_numpy(np.asarray(out) != 0)


def _feed_mask(monkeypatch, mask):
    monkeypatch.setattr(TFn, "dropout",
                        lambda x, rate, training, generator=None:
                        TFn.dropout_core(x, mask, rate) if training else x)


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 16, 32, 2)).astype(np.float32)
    y = rng.permutation(np.arange(n) % 2).astype(np.int32)
    return x, y


def _close(got, ref, tol=REL_TOL):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


# -- patches ------------------------------------------------------------------

def test_patches_and_labels_match_jax():
    gmpm, img, mask = _head()
    got_p, got_l = TP.get_all_patches_and_labels(img, gmpm, mask)
    ref_p, ref_l = JP.get_all_patches_and_labels(img, gmpm, mask)
    np.testing.assert_array_equal(got_p, ref_p)
    np.testing.assert_array_equal(got_l, ref_l)
    base = sum(1 for _ in TP.iter_band_patches(img, gmpm, mask))
    assert 0 < got_l.sum() < len(got_l) and len(got_l) > base
    assert got_l[base:].all()       # oversampling adds positives only
    for a, b in zip(TP.iter_band_patches(img, gmpm, mask, offset=5),
                    JP.iter_band_patches(img, gmpm, mask, offset=5)):
        assert a[:3] == b[:3] and a[4] == b[4]
        np.testing.assert_array_equal(a[3], b[3])
    np.testing.assert_array_equal(TP.get_only_patches(img, gmpm),
                                  JP.get_only_patches(img, gmpm))


def test_image_patches_from_files_match_jax(tmp_path):
    gmpm, img, mask = _head()
    ip, mp = str(tmp_path / "img.nii.gz"), str(tmp_path / "mask.nii")
    save_nifti(ip, img * 300 + 20)
    save_nifti(mp, mask.astype(np.uint8))
    for mask_name in (mp, None):
        got = TP.get_image_patches(ip, gmpm, mask_name)
        ref = JP.get_image_patches(ip, gmpm, mask_name)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


# -- PatchModel ---------------------------------------------------------------

def test_patch_model_eval_matches_jax(variables):
    x, _ = _batch(2)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JPatchModel().apply(_jvars(variables),
                                             jnp.asarray(x)))
    model = _port_model(variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (BATCH, 2)
    _close(got, ref)


def test_patch_model_train_matches_jax(variables, monkeypatch):
    """Train mode: batch statistics, torch's running update, and JAX's
    Dropout mask fed to `dropout_core`."""
    x, _ = _batch(3)
    key = jax.random.key(5)
    with jax.default_matmul_precision("highest"):
        ref, new = JPatchModel().apply(_jvars(variables), jnp.asarray(x),
                                       train=True, rngs={"dropout": key},
                                       mutable=["batch_stats"])
    _feed_mask(monkeypatch, _jax_dropout_mask(variables, x, key))
    model = _port_model(variables).train()
    got = model(torch.from_numpy(x)).detach().numpy()
    _close(got, np.asarray(ref))
    ref_sd = variables_to_state_dict(
        {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                               new["batch_stats"])},
        device="cpu")
    sd = model.state_dict()
    for k, r in ref_sd.items():
        if "running" in k:
            _close(sd[k].numpy(), r.numpy())
    assert all(int(sd[k]) == 1 for k in sd if k.endswith("tracked"))


def test_patch_model_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPatchModel()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGen(lambda x: x, np.zeros((8, 8, 8)))


# -- training -----------------------------------------------------------------

def _jax_state(variables, lr=LR):
    return create_train_state(JPatchModel(), JO.torch_adam(lr), None,
                              variables=_jvars(variables))


def _port_state(variables, lr=LR):
    model = _port_model(variables)
    return TrainState(model, torch_adam(lr)(model.parameters()))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_grads(variables, x, y, key):
    """JAX's train-mode gradients of the cross entropy, as a state dict."""
    model = JPatchModel()
    jv = _jvars(variables)

    def loss_fn(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": jv["batch_stats"]},
                             jnp.asarray(x), train=True,
                             rngs={"dropout": key}, mutable=["batch_stats"])
        return JC.cross_entropy(out, jnp.asarray(y))

    with jax.default_matmul_precision("highest"):
        grads = jax.grad(loss_fn)(jv["params"])
    return variables_to_state_dict({"params": _np_tree(grads)}, device="cpu")


@pytest.fixture(scope="module")
def jax_step(variables):
    """JAX's gradients and one `_class_step` on a batch, and its mask."""
    x, y = _batch(4)
    key = jax.random.key(9)
    with jax.default_matmul_precision("highest"):
        state, loss, probs = JC._class_step(_jax_state(variables),
                                            jnp.asarray(x), jnp.asarray(y),
                                            key, True)
    return dict(x=x, y=y, mask=_jax_dropout_mask(variables, x, key),
                grads=_jax_grads(variables, x, y, key),
                state=state, loss=float(loss), probs=np.asarray(probs))


def _check_step(state, ref_state, grads, before):
    """Adam-updated parameters against JAX's, at the tolerances of the
    module docstring; running statistics 1e-5."""
    ref = variables_to_state_dict(
        {"params": _np_tree(ref_state.params),
         "batch_stats": _np_tree(ref_state.batch_stats)}, device="cpu")
    got = state.model.state_dict()
    for k, r in ref.items():
        if "running" in k:
            _close(got[k].numpy(), r.numpy())
        elif not k.endswith("tracked"):
            tol = torch.where(grads[k].abs() >= 1e-6, 1e-2 * LR, 2 * LR)
            if k.endswith("conv.bias"):
                tol = torch.full_like(tol, 2 * LR)
            err = (got[k] - r).abs()
            assert (err <= tol).all(), (k, err.max().item())
            moved = (got[k] - before[k]).abs().max().item()
            assert moved > 0.5 * LR, k


def test_patch_model_gradients_match_jax(variables, jax_step, monkeypatch):
    _feed_mask(monkeypatch, jax_step["mask"])
    model = _port_model(variables).train()
    out = model(torch.from_numpy(jax_step["x"]))
    TC.cross_entropy(out, torch.from_numpy(jax_step["y"])).backward()
    ref = jax_step["grads"]
    floor = 1e-6 * max(r.abs().max().item() for r in ref.values())
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), r, rtol=0,
            atol=REL_TOL * np.abs(r).max() + floor, err_msg=name)


def test_class_step_matches_jax(variables, jax_step, monkeypatch):
    _feed_mask(monkeypatch, jax_step["mask"])
    state = _port_state(variables)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, loss, probs = TC._class_step(
        state, torch.from_numpy(jax_step["x"]),
        torch.from_numpy(jax_step["y"]), None, True)
    np.testing.assert_allclose(loss.item(), jax_step["loss"], rtol=REL_TOL)
    _close(probs.numpy(), jax_step["probs"])
    assert state.step == 1
    _check_step(state, jax_step["state"], jax_step["grads"], before)


def test_class_train_step_accum_equals_flat_step(variables):
    """micro = B is the flat step: the same loss, probabilities, mask
    (one generator, drawn once), parameters and statistics."""
    x, y = (torch.from_numpy(a) for a in _batch(6))
    flat, acc = _port_state(variables), _port_state(variables)
    flat, lf, pf = TC._class_step(flat, x, y,
                                  torch.Generator().manual_seed(3), True)
    acc, la, pa = TA.class_train_step_accum(
        acc, x, y, torch.Generator().manual_seed(3), micro=BATCH)
    assert la.item() == pytest.approx(lf.item(), rel=1e-6)
    torch.testing.assert_close(pa, pf, rtol=1e-6, atol=1e-7)
    for (k, a), b in zip(acc.model.state_dict().items(),
                         flat.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=k)
    acc2 = _port_state(variables)
    acc2, l2, p2 = TA.class_train_step_accum(
        acc2, x, y, torch.Generator().manual_seed(3), micro=2)
    assert torch.isfinite(l2) and p2.shape == (BATCH, 2)


class _PatchDataset:
    """`examples/detection_pipeline.py`'s dataset: channels-last patches."""

    def __init__(self, patches, labels):
        self.patches = patches.astype(np.float32)
        self.target = labels.astype(np.int64)

    def __len__(self):
        return len(self.patches)

    def __getitem__(self, i):
        return (np.moveaxis(self.patches[i], 0, -1), int(self.target[i]), 0)


def test_eval_epoch_on_patches_matches_jax(variables):
    """`run_one_epoch` in eval mode over a DataLoader of 2-D patches (the
    JAX example's dataset): the same losses and probabilities."""
    gmpm, img, mask = _head()
    patches, labels = TP.get_all_patches_and_labels(img, gmpm, mask)
    ds = _PatchDataset(patches[:40], labels[:40])
    with jax.default_matmul_precision("highest"):
        _, jl, jp, jt = JC.run_one_epoch(
            _jax_state(variables), DataLoader(ds, batch_size=16), False)
    _, tl, tp, tt = TC.run_one_epoch(_port_state(variables),
                                     DataLoader(ds, batch_size=16), False)
    np.testing.assert_allclose(tl, jl, rtol=REL_TOL)
    np.testing.assert_allclose(tp, jp, rtol=REL_TOL, atol=1e-7)
    assert tt == [int(t) for t in jt]


def test_train_classifier_on_patches():
    """Two epochs of `train` (the JAX example's loop: Adam 3e-4, batch
    128 there) over the synthetic head's patches: finite losses, float32
    weights, and the last epoch's train loss below the first's."""
    gmpm, img, mask = _head()
    patches, labels = TP.get_all_patches_and_labels(img, gmpm, mask)
    torch.manual_seed(0)
    model = TPatchModel(device="cpu")
    state = TrainState(model, torch_adam(LR)(model.parameters()))
    losses = []
    for epoch in range(2):
        state, ls, _, _ = TC.run_one_epoch(
            state, DataLoader(_PatchDataset(patches, labels), batch_size=32,
                              shuffle=True, seed=epoch), True, epoch=epoch)
        losses.append(np.mean(ls))
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_load_jax_patch_model_checkpoint_then_step(variables, jax_step,
                                                  tmp_path, monkeypatch):
    """A PatchModel `TrainState` written by the JAX package's
    `save_checkpoint` after one step (2-D conv and Linear leaves, Adam's
    moments) loads into a port state bit for bit, and the next step
    matches JAX's."""
    path = str(tmp_path / "patch_epoch_0.ckpt")
    JCk.save_checkpoint(path, jax_step["state"])
    state = TCk.load_checkpoint(path, _port_state(
        _randomized(JPatchModel().init(jax.random.key(3),
                                       jnp.zeros((1, 16, 32, 2))), 4)))
    assert state.step == 1
    ref = variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray,
                                          jax_step["state"].params),
         "batch_stats": jax.tree_util.tree_map(
             np.asarray, jax_step["state"].batch_stats)}, device="cpu")
    for k, v in state.model.state_dict().items():
        if not k.endswith("tracked"):
            assert torch.equal(v, ref[k]), k
    x, y = _batch(7)
    key = jax.random.key(11)
    loaded = {"params": _np_tree(jax_step["state"].params),
              "batch_stats": _np_tree(jax_step["state"].batch_stats)}
    grads = _jax_grads(loaded, x, y, key)
    _feed_mask(monkeypatch, _jax_dropout_mask(loaded, x, key))
    with jax.default_matmul_precision("highest"):
        jstate, jloss, _ = JC._class_step(
            jax.tree_util.tree_map(jnp.copy, jax_step["state"]),
            jnp.asarray(x), jnp.asarray(y), key, True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, loss, _ = TC._class_step(state, torch.from_numpy(x),
                                    torch.from_numpy(y), None, True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL_TOL)
    assert state.step == int(jstate.step) == 2
    _check_step(state, jstate, grads, before)


# -- FCDMaskGenerator ---------------------------------------------------------

def _threshold_jax(variables, x):
    m = jnp.mean(x[..., 0], axis=(1, 2))
    return jnp.stack([1.0 - m, m], axis=-1)


def _threshold_torch(x):
    m = x[..., 0].mean(dim=(1, 2))
    return torch.stack([1.0 - m, m], dim=-1)


def test_mask_generator_matches_jax_threshold_classifier():
    gmpm, img, mask = _head()
    got = TGen(_threshold_torch, gmpm, batch_size=64,
               device="cpu").get_mask(img)
    ref = JGen(_threshold_jax, {}, gmpm, batch_size=64).get_mask(img)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int64 and got.sum() > 0
    assert TGen.get_iou(got > 0, mask) > 0.1


def test_mask_generator_matches_jax_patch_model(variables):
    """The bridged PatchModel, its fc2 bias shifted so that about 30% of
    the patches are called positive, with a margin between the classes
    far above the two packages' float32 noise."""
    gmpm, img, _ = _head()
    gen = TGen(_port_model(variables).eval(), gmpm, batch_size=64,
               device="cpu")
    patches, _ = gen._collect_patches(img)
    with torch.no_grad():
        logits = gen.model(torch.from_numpy(np.moveaxis(patches, 1, -1)))
    margin = np.sort((logits[:, 1] - logits[:, 0]).numpy())
    k = int(0.7 * len(margin))
    k += int(np.argmax(np.diff(margin[k:k + 20])))
    assert margin[k + 1] - margin[k] > 1e-4
    shifted = jax.tree_util.tree_map(np.array, variables)    # a copy
    shifted["params"]["fc2"]["bias"][1] -= (margin[k] + margin[k + 1]) / 2
    gen.model = _port_model(shifted).eval()
    jmodel = JPatchModel()
    with jax.default_matmul_precision("highest"):
        ref = JGen(lambda v, x: jmodel.apply(v, x), _jvars(shifted), gmpm,
                   batch_size=64).get_mask(img)
        got = gen.get_mask(img)
    np.testing.assert_array_equal(got, ref)
    labels = gen._predict(patches)
    # a label of each class, and the zero-padded tail is cut off
    assert len(labels) == len(patches) and 0 < labels.sum() < len(labels)
    assert got.sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_postprocess_matches_jax(seed):
    pmt = np.random.default_rng(seed).integers(0, 2, (4, 6, 5))
    np.testing.assert_array_equal(TGen._postprocess(pmt),
                                  JGen._postprocess(pmt))
    iso = np.zeros((4, 6, 3), np.int64)
    iso[1, 3, 1] = 1                  # an isolated positive is erased
    assert TGen._postprocess(iso)[1, 3, 1] == 0
    hole = np.ones((4, 6, 3), np.int64)
    hole[1, 3, 1] = 0                 # an isolated negative is filled
    assert TGen._postprocess(hole)[1, 3, 1] == 1


def test_inference_pipeline_files(tmp_path):
    gmpm, img, mask = _head()
    ip, mp = str(tmp_path / "img.nii.gz"), str(tmp_path / "mask.nii.gz")
    save_nifti(ip, img)
    save_nifti(mp, mask.astype(np.uint8))
    out = str(tmp_path / "pred.nii.gz")
    pred, iou = TGen(_threshold_torch, gmpm, batch_size=64,
                     device="cpu").inference_pipeline(ip, mp, out_name=out)
    ref, ref_iou = JGen(_threshold_jax, {}, gmpm, batch_size=64
                        ).inference_pipeline(ip, mp, out_name=str(
                            tmp_path / "ref.nii.gz"))
    np.testing.assert_array_equal(pred, ref)
    assert iou == ref_iou and iou > 0.1
    np.testing.assert_array_equal(load_nifti(out).get_fdata(), pred)


def test_detection_example_runs_on_the_cpu(tmp_path):
    """`examples/torch_detection_pipeline.py` at tiny shapes with
    `--device cpu`: trains from the mask, writes the mask and a
    checkpoint, then reloads the checkpoint with `--weights`."""
    gmpm, img, mask = _head()
    paths = {k: str(tmp_path / f"{k}.nii.gz") for k in ("gmpm", "img",
                                                         "mask")}
    save_nifti(paths["gmpm"], gmpm)
    save_nifti(paths["img"], img * 300 + 20)
    save_nifti(paths["mask"], mask.astype(np.uint8))
    script = os.path.join(ROOT, "examples", "torch_detection_pipeline.py")
    env = {**os.environ, "PYTHONPATH": ROOT}
    base = [sys.executable, script, "--gmpm", paths["gmpm"], "--image",
            paths["img"], "--device", "cpu"]
    out = str(tmp_path / "pred.nii.gz")
    ckpt = str(tmp_path / "best_model.ckpt")
    run = subprocess.run(base + ["--mask", paths["mask"], "--epochs", "1",
                                 "--out", out],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "predicted mask voxels" in run.stdout
    assert load_nifti(out).shape == img.shape and os.path.exists(ckpt)
    out2 = str(tmp_path / "pred2.nii.gz")
    run = subprocess.run(base + ["--weights", ckpt, "--out", out2],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    np.testing.assert_array_equal(load_nifti(out2).get_fdata(),
                                  load_nifti(out).get_fdata())
