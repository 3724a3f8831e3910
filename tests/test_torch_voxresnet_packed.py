"""Port parity: the packed VoxResNet (`models/voxresnet_packed.py`) against
the JAX package's `models/voxresnet_packed.py`, float32 on the CPU, with
JAX-initialised variables (random BatchNorm statistics and biases) carried
across by `interop.variables_to_state_dict`, at the sizes of
`tests/test_voxresnet_packed.py`: 32^3 with 3 stages, 64^3 with 4 stages
and 2 filters (no activation after fully_conn_1), 16^3 at stride 1 (the
cuDNN stem).

Tolerances: eval logits atol 1e-5, rtol 1e-4; train logits 2e-5; the new
running statistics 1e-5; each gradient tensor 1e-4 x its own max|ref|
plus its measured float32 rounding: how far the port's fine VoxResNet in
float32 lands from the same model in float64 on the same inputs.  At 64^3
with 2 filters and batch 2 the last stage normalizes 16 values a channel,
and float32 rounding alone moves the first stages' gradients by more
than 1e-4 of a tensor's max (`_fine_f32_rounding` measures it), so the
rounding term decides; the bound stays below half of each tensor's max,
so a zeroed gradient fails.  The conv
biases directly followed by train-mode BatchNorm (`conv3d_1`,
`conv3d_2`) have a true gradient of 0: those at 1e-4 x the largest
gradient, as JAX's own test compares them.  One train step
(dropout 0) against JAX's step with Adam (L2 weight decay 0.01, the
classification trainer's and bench.py's optimizer): loss, probabilities
and the new parameters (the pre-BN biases to 2 lr: Adam's first step is lr
times the sign of a float32-noise gradient there)."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import cnn as TC
from mri_epilepsy_diagnosis_torch.models import voxresnet_packed as TV
from mri_epilepsy_diagnosis_torch.train import TrainState
from mri_epilepsy_diagnosis_torch.train.classification import (
    _class_step, cross_entropy)
from mri_epilepsy_diagnosis_torch.train.optim import torch_adam
from mri_epilepsy_diagnosis_tpu.models import cnn as JC
from mri_epilepsy_diagnosis_tpu.models import voxresnet_packed as JV
from mri_epilepsy_diagnosis_tpu.train import classification as JTC
from mri_epilepsy_diagnosis_tpu.train import optim as JO
from mri_epilepsy_diagnosis_tpu.train.state import create_train_state
from test_torch_fader import randomized

torch.set_num_threads(2)

# name: (S, n_blocks, stride, n_filters)
CASES = {"s32_nb3": (32, 3, 2, 4), "s64_nb4": (64, 4, 2, 2),
         "s16_stride1": (16, 3, 1, 4)}
PRE_BN_BIASES = ("model.conv3d_1.bias", "model.conv3d_2.bias")
LR = 1e-3


def _models(name, dropout=0.0):
    s, nb, stride, nf = CASES[name]
    kw = dict(input_shape=(s,) * 3, n_filters=nf, stride=stride,
              n_blocks=nb, dropout=dropout, n_fc_units=16)
    return JC.VoxResNet(**kw), TC.VoxResNet(**kw, device="cpu")


def _torch_tree(tree):
    """JAX params tree -> the port's state-dict keys."""
    return variables_to_state_dict({"params": tree}, device="cpu")


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, port model, input, labels, JAX results: eval logits, train
    logits, new batch statistics, gradients)."""
    name = request.param
    jmodel, tmodel = _models(name)
    s = CASES[name][0]
    rng = np.random.default_rng(s + CASES[name][1])
    x = rng.normal(size=(2, s, s, s, 1)).astype(np.float32)
    y = np.asarray([0, 1], np.int32)
    variables = randomized(jax.jit(jmodel.init)(
        jax.random.key(1), jnp.zeros((1, s, s, s, 1))), seed=3)
    xj = jnp.asarray(x)
    with jax.default_matmul_precision("highest"):
        ev, _ = jax.jit(lambda v: JV.voxresnet_apply_packed(
            jmodel, v, xj, train=False))(variables)

        def loss(p):
            out, bs = JV.voxresnet_apply_packed(
                jmodel, {"params": p, "batch_stats": variables[
                    "batch_stats"]}, xj, train=True)
            return JTC.cross_entropy(out, jnp.asarray(y)), (out, bs)

        (_, (tr, bs)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    tmodel.load_state_dict(variables_to_state_dict(variables, device="cpu"),
                           strict=True)
    ref = {"eval": np.asarray(ev), "train": np.asarray(tr),
           "stats": variables_to_state_dict({"batch_stats": bs},
                                            device="cpu"),
           "grads": _torch_tree(g),
           "rounding": _fine_f32_rounding(tmodel, x, y)}
    return name, tmodel, x, y, variables, ref


def _fine_f32_rounding(model, x, y):
    """Per parameter, max |float32 - float64 gradient| of the fine port
    model (copies of `model`) on (x, y): the float32 rounding of the
    function whose gradient is compared."""
    grads = []
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(model).to(dtype).train()
        out = m(torch.from_numpy(x).to(dtype))
        cross_entropy(out, torch.from_numpy(y)).backward()
        grads.append({n: p.grad.double() for n, p in m.named_parameters()})
    return {n: float((grads[0][n] - grads[1][n]).abs().max())
            for n in grads[0]}


def test_eval_matches_jax(case):
    _, tmodel, x, _, _, ref = case
    with torch.no_grad():
        got, ns = TV.voxresnet_apply_packed(tmodel, torch.from_numpy(x),
                                            train=False)
    assert ns is None
    np.testing.assert_allclose(got.numpy(), ref["eval"], atol=1e-5,
                               rtol=1e-4)


def test_train_logits_stats_and_gradients_match_jax(case):
    _, tmodel, x, y, _, ref = case
    tmodel.zero_grad(set_to_none=True)
    got, stats = TV.voxresnet_apply_packed(tmodel, torch.from_numpy(x),
                                           train=True)
    np.testing.assert_allclose(got.detach().numpy(), ref["train"],
                               atol=2e-5, rtol=1e-4)
    want = {k: v for k, v in ref["stats"].items()
            if not k.endswith("num_batches_tracked")}
    assert set(stats) == set(want)
    for k, r in want.items():
        np.testing.assert_allclose(stats[k].numpy(), r.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    cross_entropy(got, torch.from_numpy(y)).backward()
    grads = ref["grads"]
    assert set(grads) == {n for n, _ in tmodel.named_parameters()}
    largest = max(float(g.abs().max()) for g in grads.values())
    for n, p in tmodel.named_parameters():
        err = float((p.grad - grads[n]).abs().max())
        if n in PRE_BN_BIASES:
            assert err <= 1e-4 * largest, (n, err, largest)
            continue
        scale = float(grads[n].abs().max())
        tol = 1e-4 * scale + ref["rounding"][n]
        assert tol < 0.5 * scale, (n, tol, scale)
        assert err <= tol, (n, err, tol)


def test_class_step_matches_jax():
    """One packed step at dropout 0 against JAX's, from the same variables
    and Adam state."""
    name = "s32_nb3"
    jmodel, tmodel = _models(name)
    s = CASES[name][0]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, s, s, s, 1)).astype(np.float32)
    y = np.asarray([1, 0], np.int32)
    variables = randomized(jax.jit(jmodel.init)(
        jax.random.key(2), jnp.zeros((1, s, s, s, 1))), seed=4)
    st = create_train_state(jmodel, JO.torch_adam(LR, weight_decay=0.01),
                            None, variables=variables)
    with jax.default_matmul_precision("highest"):
        st, jloss, jprobs = JV.voxresnet_class_step_packed(
            st, jnp.asarray(x), jnp.asarray(y), jax.random.key(0),
            model=jmodel)
    tmodel.load_state_dict(variables_to_state_dict(variables, device="cpu"),
                           strict=True)
    state = TrainState(tmodel, torch_adam(LR, weight_decay=0.01)(
        tmodel.parameters()))
    state, loss, probs = TV.voxresnet_class_step_packed(
        state, torch.from_numpy(x), torch.from_numpy(y), None)
    assert state.step == 1
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)
    want = variables_to_state_dict(st.variables, device="cpu")
    got = tmodel.state_dict()
    for k, r in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k
            continue
        tol = (2 * LR if k in PRE_BN_BIASES
               else 1e-5 * max(1.0, float(r.abs().max())))
        assert float((got[k] - r).abs().max()) <= tol, k


def test_packed_and_fine_steps_draw_the_same_dropout():
    """At dropout 0.5 the packed step and the fine `_class_step` draw the
    same mask from one seeded generator: the same loss and probabilities
    (1e-5), and the same gradients, each tensor within 1e-4 x its max plus
    the fine step's float32 rounding (its gradient against the same step
    in float64, same mask); the pre-BN biases at 1e-4 x the largest."""
    torch.manual_seed(0)
    _, fine = _models("s32_nb3", dropout=0.5)
    with torch.no_grad():
        for v in fine.state_dict().values():
            if v.is_floating_point():
                v.add_(0.1 * torch.randn_like(v))
    packed, fine64 = copy.deepcopy(fine), copy.deepcopy(fine).double()
    x = torch.randn(2, 32, 32, 32, 1)
    y = torch.tensor([0, 1])
    states = [TrainState(m, torch_adam(LR, weight_decay=0.01)(
        m.parameters())) for m in (fine, packed)]
    _, fl, fp = _class_step(states[0], x, y,
                            torch.Generator().manual_seed(9), True)
    _, pl, pp = TV.voxresnet_class_step_packed(
        states[1], x, y, torch.Generator().manual_seed(9))
    assert abs(float(pl) - float(fl)) <= 1e-5 * abs(float(fl))
    assert float((pp - fp).abs().max()) <= 1e-5
    cross_entropy(fine64.train()(x.double(), generator=torch.Generator()
                                 .manual_seed(9)), y).backward()
    g64 = dict(fine64.named_parameters())
    gp = dict(packed.named_parameters())
    largest = max(float(p.grad.abs().max()) for p in fine.parameters())
    for n, p in fine.named_parameters():
        err = float((gp[n].grad - p.grad).abs().max())
        scale = float(p.grad.abs().max())
        tol = (1e-4 * largest if n in PRE_BN_BIASES else 1e-4 * scale
               + float((p.grad.double() - g64[n].grad).abs().max()))
        assert err <= tol, (n, err, tol)


def test_eval_runs_b2_fused_and_rejects_odd_geometry():
    """Eval launches the stem's and each block's first conv with the BN /
    ReLU epilogue (`conv3_packed_as_bn_act`, slope 0): 1 + 2 x stages calls
    at stride 2; a size that leaves odd cells raises."""
    _, tmodel = _models("s32_nb3")
    calls = []
    fused = TV.P.conv3_packed_as_bn_act

    def rec(x, wp, scale, shift, alpha, addend=None):
        calls.append(float(alpha.abs().max()))
        return fused(x, wp, scale, shift, alpha, addend)

    TV.P.conv3_packed_as_bn_act = rec
    try:
        with torch.no_grad():
            TV.voxresnet_apply_packed(tmodel.eval(),
                                      torch.randn(1, 32, 32, 32, 1))
    finally:
        TV.P.conv3_packed_as_bn_act = fused
    assert calls == [0.0] * (1 + 2 * tmodel.stages)
    with pytest.raises(ValueError, match="divisible"):
        TV.voxresnet_apply_packed(tmodel, torch.randn(1, 24, 24, 24, 1))
