"""Port parity: packed UNet3D segmentation training (`models/unet_packed.py::
packed_unet_train_apply`, `packed_dice_loss`, `train/`) against the JAX
package, on the CPU.

The same numpy inputs and JAX-initialised weights (random BatchNorm
statistics) go through both packages.  f32 throughout, JAX at its f32
policy (HIGHEST); JAX's conv gradients compile slowly on the CPU, so every
JAX-side gradient runs at 16^3, out_channels_first_layer 4, batch 2.
Inputs are continuous random normals, so the max pools see no ties (the
two frameworks split a tied gradient differently)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.metrics import dice as TD
from mri_epilepsy_diagnosis_torch.models import unet_packed as TU
from mri_epilepsy_diagnosis_torch.ops import packed as TP
from mri_epilepsy_diagnosis_torch.train import checkpoint as TC
from mri_epilepsy_diagnosis_torch.train import optim as TO
from mri_epilepsy_diagnosis_torch.train import seg as TS
from mri_epilepsy_diagnosis_torch.train.state import TrainState
from mri_epilepsy_diagnosis_torch.transforms import labels as TL
from mri_epilepsy_diagnosis_tpu.metrics import dice as JD
from mri_epilepsy_diagnosis_tpu.models import unet_packed as JU
from mri_epilepsy_diagnosis_tpu.train import optim as JO
from mri_epilepsy_diagnosis_tpu.train import seg as JS
from mri_epilepsy_diagnosis_tpu.train.state import create_train_state
from mri_epilepsy_diagnosis_tpu.transforms import labels as JL
from mri_epilepsy_diagnosis_tpu.utils.data import LIST_FCD as J_LIST_FCD
from test_torch_bridge import jax_unet_variables, torch_unet

torch.set_num_threads(2)

SIZE = 16
OCFL = 4
# Conv biases followed by BatchNorm have a true gradient of 0 (BN
# subtracts the batch mean); both sides leave f32 noise there, so a
# gradient leaf is held to GRAD_RTOL x its own max|grad| plus GRAD_FLOOR x
# the largest gradient of the network.
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-6


def _sd(variables):
    return variables_to_state_dict(variables, device="cpu")


def _stats_sd(batch_stats):
    return {k: v for k, v in _sd({"batch_stats": batch_stats}).items()
            if not k.endswith("num_batches_tracked")}


def _pre_bn_bias(key, sd):
    return (key.endswith("conv_layer.bias")
            and key.replace("conv_layer.bias", "norm_layer.weight") in sd)


def _assert_grads_close(got, ref):
    """Every leaf of `ref` (torch keys) against `got`, per-leaf tolerance
    as stated at GRAD_RTOL / GRAD_FLOOR."""
    floor = GRAD_FLOOR * max(float(np.abs(np.asarray(v)).max())
                             for v in ref.values())
    assert got.keys() == ref.keys()
    for k in ref:
        r = np.asarray(ref[k], np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == r.shape, k
        err = np.abs(g - r).max()
        assert err <= GRAD_RTOL * np.abs(r).max() + floor, (k, err)


@pytest.fixture(scope="module")
def case():
    """JAX UNet3D (ocfl 4) variables, inputs, binary targets."""
    jmodel, variables = jax_unet_variables(ocfl=OCFL, nb=3, seed=11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    y = (rng.random((2, SIZE, SIZE, SIZE, 1)) > 0.6).astype(np.float32)
    return jmodel, variables, x, y


@pytest.fixture(scope="module")
def jax_packed(case):
    """JAX's packed train forward, loss and `jax.grad` of the loss in every
    parameter (f32 HIGHEST)."""
    _, variables, x, y = case

    def loss_fn(params):
        yp, bs = JU.packed_unet_train_apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x))
        return JU.packed_dice_loss(yp, jnp.asarray(y)), (yp, bs)

    (loss, (yp, bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    return (float(loss), np.asarray(yp), _stats_sd(bs),
            _sd({"params": jax.tree_util.tree_map(np.asarray, grads)}))


def _torch_model(variables):
    return torch_unet(variables, ocfl=OCFL)


# ---------------------------------------------------------------------------
# labels and metrics
# ---------------------------------------------------------------------------


def test_list_fcd_is_a_copy_of_jax():
    assert TL.LIST_FCD == J_LIST_FCD


@pytest.mark.parametrize("list_fcd", [None, [2, 41, 77]])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_binarize_segmentation_matches_jax(list_fcd, dtype):
    rng = np.random.default_rng(0)
    pool = np.array([0, 1, 2, 4, 17, 41, 53, 77, 85, 255, 999, 1000, 1035,
                     2000, 3, 251])
    labels = rng.choice(pool, size=(2, 6, 5, 4, 1)).astype(dtype)
    if dtype == np.float32:
        labels = labels + rng.uniform(0, 0.9, labels.shape).astype(dtype)
    got = TL.binarize_segmentation(torch.from_numpy(labels), list_fcd)
    ref = np.asarray(JL.binarize_segmentation(jnp.asarray(labels), list_fcd))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.mean() < 1


@pytest.mark.parametrize("dims,shape", [((2, 3, 4), (2, 3, 5, 4, 6)),
                                        ((1, 2, 3), (2, 5, 4, 6, 3))])
def test_dice_score_and_loss_match_jax(dims, shape):
    rng = np.random.default_rng(1)
    p = rng.random(shape).astype(np.float32)
    t = (rng.random(shape) > 0.5).astype(np.float32)
    for tfn, jfn in ((TD.get_dice_score, JD.get_dice_score),
                     (TD.get_dice_loss, JD.get_dice_loss)):
        got = tfn(torch.from_numpy(p), torch.from_numpy(t), dims).numpy()
        ref = np.asarray(jfn(jnp.asarray(p), jnp.asarray(t), dims))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fill", ["random", "empty"])
def test_iou_and_dice_coefficient_match_jax(fill):
    rng = np.random.default_rng(2)
    a = rng.random((6, 7, 5)) > 0.6
    b = rng.random((6, 7, 5)) > 0.5
    if fill == "empty":
        a[:] = b[:] = False
        assert np.isnan(TD.compute_dice_coefficient(a, b))
        assert np.isnan(JD.compute_dice_coefficient(a, b))
        return
    assert TD.get_iou_score(a, b) == JD.get_iou_score(a, b)
    assert TD.compute_dice_coefficient(a, b) == \
        JD.compute_dice_coefficient(a, b)


# ---------------------------------------------------------------------------
# train-mode forwards
# ---------------------------------------------------------------------------


def test_fine_train_forward_matches_jax():
    """The port's fine UNet3D in train mode: logits and the updated
    running statistics == `UNet3D.apply(train=True,
    mutable=["batch_stats"])` (f32)."""
    jmodel, variables = jax_unet_variables(ocfl=OCFL, nb=3, seed=4)
    x = np.random.default_rng(5).normal(
        size=(2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    ref, new_vars = jax.jit(lambda v, a: jmodel.apply(
        v, a, train=True, mutable=["batch_stats"]))(variables, x)
    model = _torch_model(variables).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-4)
    buffers = dict(model.named_buffers())
    for k, v in _stats_sd(new_vars["batch_stats"]).items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5)
        nbt = k.rsplit(".", 1)[0] + ".num_batches_tracked"
        assert int(buffers[nbt]) == 1


def test_packed_train_apply_matches_jax(case, jax_packed):
    """Logits (2e-4) and running statistics (rtol 1e-4, atol 1e-5), the
    tolerances of the JAX package's own packed-vs-fine train test."""
    _, variables, x, _ = case
    _, yp_ref, stats_ref, _ = jax_packed
    model = _torch_model(variables)
    with torch.no_grad():
        yp, stats = TU.packed_unet_train_apply(model.state_dict(),
                                               torch.from_numpy(x))
    np.testing.assert_allclose(yp.numpy(), yp_ref, rtol=2e-4, atol=2e-4)
    assert stats.keys() == stats_ref.keys()
    for k in stats_ref:
        np.testing.assert_allclose(stats[k].numpy(), stats_ref[k].numpy(),
                                   rtol=1e-4, atol=1e-5)
    # new tensors: the model's buffers are untouched until stored
    sd = model.state_dict()
    assert not any(torch.equal(sd[k], stats[k]) for k in stats)


def test_packed_dice_loss_grads_match_jax(case, jax_packed):
    """`packed_dice_loss` of the packed train forward: the loss to 1e-5
    and the gradient of every parameter to the stated per-leaf tolerance,
    against `jax.grad`."""
    _, variables, x, y = case
    loss_ref, _, _, grads_ref = jax_packed
    model = _torch_model(variables)
    loss, _ = TS.packed_seg_loss(model, torch.from_numpy(x),
                                 torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_ref, rtol=1e-5)
    _assert_grads_close({k: p.grad for k, p in model.named_parameters()},
                        grads_ref)


def test_packed_grads_match_port_fine_unet(case):
    """The packed step's gradients == the port's fine `UNet3D` train
    forward's (F.conv3d), same loss."""
    _, variables, x, y = case
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    packed = _torch_model(variables)
    loss_p, stats = TS.packed_seg_loss(packed, xt, yt)
    loss_p.backward()
    fine = _torch_model(variables)
    loss_f = TS.seg_loss(fine, xt, yt)
    loss_f.backward()
    np.testing.assert_allclose(loss_p.item(), loss_f.item(), rtol=1e-5)
    _assert_grads_close({k: p.grad for k, p in packed.named_parameters()},
                        {k: p.grad for k, p in fine.named_parameters()})
    buffers = dict(fine.named_buffers())
    for k, v in stats.items():
        torch.testing.assert_close(v, buffers[k], rtol=1e-4, atol=1e-5)


def test_packed_dice_loss_matches_jax_multiclass():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 4, 4, 4, 24)).astype(np.float32)
    labels = rng.integers(0, 3, size=(2, 8, 8, 8, 1)).astype(np.float32)
    got = TU.packed_dice_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    ref = JU.packed_dice_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# steps, optimizers, schedulers, checkpoints, the epoch loop
# ---------------------------------------------------------------------------


def test_packed_seg_train_step_matches_jax(case):
    """One AdamW step (lr 1e-3): the loss to 1e-5 and the updated
    parameters at the tolerance of the JAX package's own step-parity test
    (rtol 5e-3, atol 5e-4).  A pre-BN conv bias has a true gradient of 0
    and an f32-noise one on both sides, which Adam turns into a step of
    up to lr |g| / (|g| + eps) in either direction: those are held to
    2 lr.  FreeSurfer-style labels, binarized on each side."""
    jmodel, variables, x, y = case
    labels = np.where(y > 0, 1002, 41).astype(np.float32)
    jstate = create_train_state(jmodel, JO.torch_adamw(1e-3),
                                jnp.zeros((1, 8, 8, 8, 1)),
                                variables=jax.tree_util.tree_map(
                                    jnp.asarray, variables))
    jstate, jloss = JS.packed_seg_train_step(jstate, jnp.asarray(x),
                                             jnp.asarray(labels))
    model = _torch_model(variables)
    state = TrainState(model, TO.torch_adamw(1e-3)(model.parameters()))
    state, loss = TS.packed_seg_train_step(state, torch.from_numpy(x),
                                           torch.from_numpy(labels))
    assert state.step == 1
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = _sd({"params": jax.tree_util.tree_map(np.asarray, jstate.params),
               "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                     jstate.batch_stats)})
    got = model.state_dict()
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1
        elif _pre_bn_bias(k, ref):
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=0,
                                       atol=2e-3)
        else:
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=5e-3,
                                       atol=5e-4)


def test_bf16_packed_step_keeps_float32_master_weights(case):
    """Mixed precision: bf16 activations, float32 parameters, gradients,
    AdamW moments and running statistics; a finite loss."""
    _, variables, x, y = case
    model = _torch_model(variables)
    state = TrainState(model, TO.torch_adamw()(model.parameters()))
    state, loss = TS.packed_seg_train_step(
        state, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(y))
    assert torch.isfinite(loss)
    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        assert torch.isfinite(p).all()
    for st in state.optimizer.state.values():
        assert st["exp_avg"].dtype == torch.float32
    for k, b in model.named_buffers():
        if "running" in k:
            assert b.dtype == torch.float32 and torch.isfinite(b).all()


@pytest.mark.parametrize("metrics,kw", [
    ([1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8, 0.9, 0.91],
     dict(factor=0.1, patience=2, threshold=0.01)),
    ([1.0, 0.999, 0.998, 0.997, 0.996, 0.995, 0.5, 0.5, 0.5],
     dict(factor=0.5, patience=1, threshold=0.01)),
    ([3.0, 2.0, 2.5, 2.5, 2.5, 2.5, 1.0, 1.2, 1.2, 1.2, 1.2, 1.2],
     dict(factor=0.2, patience=3, threshold=1e-4)),
])
def test_plateau_lr_sequence_matches_jax(metrics, kw):
    jsched = JO.ReduceLROnPlateau(1e-3, mode="min", **kw)
    opt = TO.torch_adamw(1e-3)([torch.nn.Parameter(torch.zeros(1))])
    tsched = TO.ReduceLROnPlateau(opt, mode="min", **kw)
    got, ref = [], []
    for m in metrics:
        ref.append(jsched.step(m))
        tsched.step(m)
        got.append(opt.param_groups[0]["lr"])
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert len(set(ref)) > 1


@pytest.mark.parametrize("step_size,gamma", [(2, 0.1), (3, 0.5)])
def test_step_lr_sequence_matches_jax(step_size, gamma):
    jsched = JO.StepLR(1e-3, step_size, gamma)
    opt = TO.torch_adam(1e-3)([torch.nn.Parameter(torch.zeros(1))])
    tsched = TO.StepLR(opt, step_size, gamma)
    got, ref = [], []
    for _ in range(8):
        ref.append(jsched.step())
        opt.step()
        tsched.step()
        got.append(opt.param_groups[0]["lr"])
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizer_steps_match_jax(name):
    """Three steps of the torch optimizers == the JAX package's optax
    chains built for torch parity (weight decay 0.01), to f32 rounding of
    differently ordered updates (1e-6 of a parameter of size ~1)."""
    import optax

    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]
    jtx = (JO.torch_adam(1e-2, weight_decay=0.01) if name == "adam"
           else JO.torch_adamw(1e-2, weight_decay=0.01))
    ttx = (TO.torch_adam(1e-2, weight_decay=0.01) if name == "adam"
           else TO.torch_adamw(1e-2, weight_decay=0.01))
    jp = jnp.asarray(p0)
    jst = jtx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ttx([tp])
    for g in grads:
        upd, jst = jtx.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=0, atol=1e-6)


def test_get_model_and_optimizer_is_seeded():
    before = torch.random.get_rng_state()
    m1, s1, sched = TS.get_model_and_optimizer(out_channels_first_layer=4,
                                               seed=3, device="cpu")
    m2, _, _ = TS.get_model_and_optimizer(out_channels_first_layer=4, seed=3,
                                          device="cpu")
    m3, _, _ = TS.get_model_and_optimizer(out_channels_first_layer=4, seed=4,
                                          device="cpu")
    assert torch.equal(torch.random.get_rng_state(), before)
    w = "encoder.encoding_blocks.0.conv1.conv_layer.weight"
    assert torch.equal(m1.state_dict()[w], m2.state_dict()[w])
    assert not torch.equal(m1.state_dict()[w], m3.state_dict()[w])
    assert isinstance(s1.optimizer, torch.optim.AdamW)
    assert isinstance(sched, TO.ReduceLROnPlateau)
    assert s1.optimizer.param_groups[0]["lr"] == 1e-3
    assert s1.optimizer.param_groups[0]["weight_decay"] == 1e-2


def _loader(rng, n_batches):
    out = []
    for _ in range(n_batches):
        x = rng.normal(size=(2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
        blob = rng.random((2, SIZE, SIZE, SIZE, 1)) > 0.7
        labels = np.where(blob, 1002, 41).astype(np.int16)
        out.append((x, labels))
    return out


@pytest.mark.parametrize("packed", [True, False])
def test_train_segmentation_saves_checkpoints_that_restore(tmp_path,
                                                           packed):
    """A 2-epoch `train_segmentation` at 16^3 on the CPU: finite losses,
    one checkpoint per epoch, and loading the last one into a fresh state
    reproduces the model, the optimizer and the step."""
    rng = np.random.default_rng(8)
    model, state, sched = TS.get_model_and_optimizer(
        out_channels_first_layer=OCFL, device="cpu")
    state, tr, va = TS.train_segmentation(
        2, _loader(rng, 2), _loader(rng, 1), state, sched, "seg",
        weights_dir=str(tmp_path), verbose=False, packed=packed)
    assert len(tr) == len(va) == 2 and np.isfinite(tr + va).all()
    assert state.step == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "seg_epoch_1.ckpt", "seg_epoch_2.ckpt"]
    _, fresh, _ = TS.get_model_and_optimizer(out_channels_first_layer=OCFL,
                                             seed=1, device="cpu")
    fresh = TC.load_checkpoint(str(tmp_path / "seg_epoch_2.ckpt"), fresh)
    assert fresh.step == 4
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    a, b = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i in a["state"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a["state"][i][key], b["state"][i][key])


def test_checkpoint_extra_round_trip(tmp_path):
    model, state, sched = TS.get_model_and_optimizer(
        out_channels_first_layer=OCFL, device="cpu")
    path = str(tmp_path / "sub" / "c.ckpt")
    TC.save_checkpoint(path, state, scheduler=sched.state_dict(), note="x")
    extra = TC.load_checkpoint_extra(path)
    assert extra["note"] == "x"
    assert extra["scheduler"]["best"] == sched.state_dict()["best"]


def test_run_epoch_validation_matches_fine_eval(case):
    """A validation epoch through the served packed forward (unfolded BN)
    gives the fine UNet3D's eval dice loss, with and without prefetch."""
    _, variables, x, y = case
    model = _torch_model(variables)
    state = TrainState(model, TO.torch_adamw()(model.parameters()))
    loader = [(x, y)]
    ref = TS.seg_eval_step(state, torch.from_numpy(x), torch.from_numpy(y))
    for prefetch in (0, 2):
        _, losses = TS.run_epoch(1, TS.Action.VALIDATE, loader, state,
                                 prefetch=prefetch, packed=True)
        np.testing.assert_allclose(losses, [ref.item()], rtol=1e-5)


def test_train_step_after_serving_under_inference_mode(case):
    """Serving first, under inference_mode, then training in the same
    process: the device constants the packed ops cache (weight-gather
    index, pad masks, upsample matrices) must be tensors that autograd may
    save, whichever mode made them first."""
    _, variables, x, y = case
    model = _torch_model(variables)
    xt = torch.from_numpy(x[:1, :8, :8, :8])
    with torch.inference_mode():
        TU.packed_unet_mask_v2(TU.fold_bn_inference(model.state_dict()), xt)
    state = TrainState(model, TO.torch_adamw()(model.parameters()))
    state, loss = TS.packed_seg_train_step(state, xt,
                                           torch.from_numpy(y[:1, :8, :8, :8]))
    assert torch.isfinite(loss)
