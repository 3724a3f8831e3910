"""Port parity: the gradient-accumulation segmentation step
(`train/accum.py::packed_seg_train_step_accum`) against the JAX package's,
on the CPU.

The same JAX-initialised weights (random BatchNorm statistics) and numpy
batch go through both: batch 2 at 16^3, out_channels_first_layer 4, in
micro-batches of 2 (the flat step) and of 1 (each volume normalized with
its own statistics, the running statistics threaded from one to the
next); f32, JAX at its f32 policy (HIGHEST).  Each JAX step is computed
once per module."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.train import accum as TA
from mri_epilepsy_diagnosis_torch.train import optim as TO
from mri_epilepsy_diagnosis_torch.train import seg as TS
from mri_epilepsy_diagnosis_torch.train.state import TrainState
from mri_epilepsy_diagnosis_torch.transforms import binarize_segmentation
from mri_epilepsy_diagnosis_tpu.train import accum as JA
from mri_epilepsy_diagnosis_tpu.train import optim as JO
from mri_epilepsy_diagnosis_tpu.train.state import create_train_state
from test_torch_bridge import jax_unet_variables, torch_unet

torch.set_num_threads(2)

SIZE = 16
OCFL = 4
LR = 1e-3
# Tolerances: the loss 1e-5 relative.  Adam's moments hold the gradient
# (exp_avg = 0.1 g, exp_avg_sq = 1e-3 g^2 after one step); the gradients
# of small leaves (PReLU slopes, BatchNorm shifts, the stem's weights) are
# f32 sums over every voxel that cancel heavily, so each leaf is held to
# MOMENT_TOL x the largest value of that moment in the network.
# Parameters after the step as `test_torch_train.py`'s step test (rtol
# 5e-3, atol 5e-4; pre-BN conv biases, whose true gradient is 0 and whose
# f32 noise Adam turns into a step of up to lr, 2 lr); running statistics
# rtol 1e-4, atol 1e-5.
LOSS_RTOL = 1e-5
MOMENT_TOL = 1e-3


@pytest.fixture(scope="module")
def case():
    jmodel, variables = jax_unet_variables(ocfl=OCFL, nb=3, seed=31)
    rng = np.random.default_rng(32)
    x = rng.normal(size=(2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    labels = np.where(rng.random(x.shape) > 0.6, 1002, 41).astype(np.float32)
    return jmodel, variables, x, labels


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_steps(case):
    """micro -> (loss, state dict after the step, exp_avg, exp_avg_sq) of
    JAX's accumulated step, in torch keys and layouts."""
    jmodel, variables, x, labels = case
    out = {}
    for micro in (2, 1):
        jstate = create_train_state(jmodel, JO.torch_adamw(LR),
                                    jnp.zeros((1, 8, 8, 8, 1)),
                                    variables=jax.tree_util.tree_map(
                                        jnp.asarray, variables))
        jstate, loss = JA.packed_seg_train_step_accum(
            jstate, jnp.asarray(x), jnp.asarray(labels), micro=micro)
        adam = jstate.opt_state.inner_state[0]
        out[micro] = (
            float(loss),
            variables_to_state_dict({"params": _np(jstate.params),
                                     "batch_stats": _np(jstate.batch_stats)},
                                    device="cpu"),
            variables_to_state_dict({"params": _np(adam.mu)}, device="cpu"),
            variables_to_state_dict({"params": _np(adam.nu)}, device="cpu"))
    return out


def _port_step(variables, x, labels, micro):
    model = torch_unet(variables, ocfl=OCFL)
    state = TrainState(model, TO.torch_adamw(LR)(model.parameters()))
    state, loss = TA.packed_seg_train_step_accum(
        state, torch.from_numpy(x), torch.from_numpy(labels), micro=micro)
    return state, loss


def _pre_bn_bias(key, sd):
    return (key.endswith("conv_layer.bias")
            and key.replace("conv_layer.bias", "norm_layer.weight") in sd)


@pytest.mark.parametrize("micro", [2, 1])
def test_accum_step_matches_jax(case, jax_steps, micro):
    _, variables, x, labels = case
    loss_ref, sd_ref, mu_ref, nu_ref = jax_steps[micro]
    state, loss = _port_step(variables, x, labels, micro)
    assert state.step == 1
    np.testing.assert_allclose(loss.item(), loss_ref, rtol=LOSS_RTOL)
    got = state.model.state_dict()
    n = 2 // micro
    for k, r in sd_ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == n        # every micro-batch counted
        elif "running" in k:
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=1e-4,
                                       atol=1e-5)
        elif _pre_bn_bias(k, sd_ref):
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=0,
                                       atol=2 * LR)
        else:
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=5e-3,
                                       atol=5e-4)
    names = {p: k for k, p in state.model.named_parameters()}
    for key, ref in (("exp_avg", mu_ref), ("exp_avg_sq", nu_ref)):
        tol = MOMENT_TOL * max(v.abs().max().item() for v in ref.values())
        for p, st in state.optimizer.state.items():
            err = (st[key] - ref[names[p]]).abs().max().item()
            assert err <= tol, (key, names[p], err)


def test_accum_full_micro_equals_the_flat_step(case):
    """micro = batch is the flat `packed_seg_train_step` (one micro-batch,
    the loss divided by 1): the same loss, running statistics and
    gradients.  The CPU's multi-threaded weight-gradient sums differ in
    their last bit from call to call, so gradients are held to 1e-6 of the
    network's largest one."""
    _, variables, x, labels = case
    state, loss = _port_step(variables, x, labels, 2)
    model = torch_unet(variables, ocfl=OCFL)
    flat = TrainState(model, TO.torch_adamw(LR)(model.parameters()))
    flat, flat_loss = TS.packed_seg_train_step(flat, torch.from_numpy(x),
                                               torch.from_numpy(labels))
    assert loss.item() == flat_loss.item()
    flat_sd = flat.model.state_dict()
    for k, v in state.model.state_dict().items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(v, flat_sd[k]), k
    tol = 1e-6 * max(p.grad.abs().max().item()
                     for p in flat.model.parameters())
    for a, b in zip(state.model.parameters(), flat.model.parameters()):
        assert (a.grad - b.grad).abs().max().item() <= tol


def test_accum_micro1_is_the_mean_of_per_sample_steps(case):
    """micro = 1: the mean of the per-volume gradients taken at the same
    parameters (the running statistics threaded volume to volume), the
    oracle of `tests/test_accum.py`, on the port's own packed loss."""
    _, variables, x, labels = case
    state, loss = _port_step(variables, x, labels, 1)
    model = torch_unet(variables, ocfl=OCFL)
    targets = binarize_segmentation(torch.from_numpy(labels))
    sd = model.state_dict(keep_vars=True)
    losses, grads = [], []
    for i in range(2):
        li, stats = TS.packed_seg_loss(model, torch.from_numpy(x[i:i + 1]),
                                       targets[i:i + 1])
        grads.append(torch.autograd.grad(li, list(model.parameters())))
        losses.append(li.item())
        with torch.no_grad():
            for k, v in stats.items():
                sd[k].copy_(v)
    np.testing.assert_allclose(loss.item(), np.mean(losses), rtol=1e-6)
    for p, g0, g1 in zip(state.model.parameters(), *grads):
        torch.testing.assert_close(p.grad, (g0 + g1) / 2, rtol=1e-5,
                                   atol=1e-7)
    for k, v in model.state_dict().items():
        if "running" in k:
            assert torch.equal(state.model.state_dict()[k], v), k


def test_accum_rejects_an_indivisible_batch(case):
    _, variables, x, labels = case
    with pytest.raises(ValueError, match="not divisible"):
        _port_step(variables, x[:1], labels[:1], 2)
