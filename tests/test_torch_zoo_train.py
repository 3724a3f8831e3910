"""Port parity: `train/seg.py::seg_train_step` and `seg_eval_step` on the
segmentation model zoo against the JAX package's, on the CPU.

Each model starts from the same JAX-initialised weights (norms
randomized, `test_torch_zoo.py`) and JAX takes two AdamW steps (torch's
defaults: lr 1e-3, weight decay 1e-2) on a batch of 2 volumes, then one
eval step.  The port takes each step from JAX's state before it, loaded
through `train.load_jax_checkpoint` (parameters, statistics, Adam
moments, step), so that each step is compared on its own: float32
rounding in a gradient near zero, which Adam's first steps turn into a
move of up to lr, does not carry into the next step's comparison.  The
JAX steps run eagerly (`jax.disable_jit()`) so that their noise and
Dropout masks can be recorded and replayed in the port in call order
(`test_torch_bayes.py::jax_draws`, `port_replay`; `test_torch_zoo.py::
live_draws`), and their gradients are recorded by a wrapper around the
optimizer's `update`; the JAX package is unchanged.  float32, JAX at
`Precision.HIGHEST`.  Tolerances:
- losses 1e-5 relative (train and eval);
- gradients per tensor 1e-4 x max|ref|, plus the port's own float32
  error on that tensor, measured against the same step in float64 (a
  pre-activation within float32 rounding of a ReLU's kink takes the other
  branch in one precision, and that one voxel moved a small tensor's
  gradient by 1% in BraTSUnet; a fault of the port would be in its
  float64 step too), plus JAX's own float32 error on that tensor,
  estimated as JAX_OWN x (the port's own error + JAX's batch-order
  spread).  The spread is measured where the norms mix the batch
  (PERMUTED, BraTSUnet with BatchNorm): the tensor's largest change in
  JAX's float32 gradient when the same batch is reversed (the same
  function, summed in another order); per-sample norms give the reversed
  batch the same sums.  The estimate is needed up to 1.94 x that sum
  (BraTSUnet with BatchNorm, second step; Modified3DUNet 1.0, whose
  bottom InstanceNorm sees one voxel at 16^3).  The bound is checked to
  stay below the tensor's largest |gradient| (up to 0.5 of it, BraTSUnet
  with BatchNorm), so a zero or sign-flipped gradient fails;
- parameters: the port's AdamW applied to JAX's recorded gradients gives
  JAX's parameters within OPT_RTOL x |w| + OPT_ATOL (float32 rounding
  and optax's float32 bias correction); the port's own step lies within that plus |Adam's update with the
  port's gradient - with JAX's|, computed in float64 from the same
  moments, of JAX's parameters;
- BraTSUnet's conv2 / bn2, which the loss does not reach: JAX's zero
  gradient leaves them `w (1 - lr wd)` a step, 1e-6 relative;
- BatchNorm running statistics 1e-5."""
import contextlib
import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.train import checkpoint as TC
from mri_epilepsy_diagnosis_torch.train import optim as TO
from mri_epilepsy_diagnosis_torch.train import seg as TS
from mri_epilepsy_diagnosis_torch.train.state import create_train_state
from mri_epilepsy_diagnosis_torch.transforms import binarize_segmentation
from mri_epilepsy_diagnosis_torch.utils.data import SyntheticVolumes
from mri_epilepsy_diagnosis_tpu.train import checkpoint as JC
from mri_epilepsy_diagnosis_tpu.train import optim as JO
from mri_epilepsy_diagnosis_tpu.train import seg as JS
from mri_epilepsy_diagnosis_tpu.train.state import (
    create_train_state as j_create_train_state)
from test_torch_bayes import jax_draws, port_replay
from test_torch_zoo import buffers_close, jax_zoo, live_draws, torch_zoo

torch.set_num_threads(2)

LR, WD, EPS, BETAS = 1e-3, 1e-2, 1e-8, (0.9, 0.999)
STEPS = 2
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4           # x max|ref| of the tensor
JAX_OWN = 3.0             # x (own error + batch-order spread)
PERMUTED = {"brats_bn"}   # the configurations whose norms mix the batch
# about 4 float32 ulps of the weight, plus optax's float32 bias
# correction: 1 - 0.999^t loses 1.3e-5 of itself to cancellation, 6.5e-6
# of an update of up to 1.4 lr in the first two steps
OPT_RTOL, OPT_ATOL = 5e-7, 3e-8
DECAY_RTOL = 1e-6
TRAIN_ZOO = ["residual_short", "residual_bayes", "modified", "brats_gn",
             "brats_bn", "brats_in"]


def _as_torch_keys(params):
    return {k: v.numpy() for k, v in variables_to_state_dict(
        {"params": params}, device="cpu").items()}


def _grads(model):
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
            for k, p in model.named_parameters()}


def _moments(state):
    """name -> (exp_avg, exp_avg_sq, step) of the optimizer before a step,
    in float64 (zeros and 0 before the first)."""
    out = {}
    for k, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        zero = np.zeros(p.shape)
        out[k] = (st["exp_avg"].double().numpy() if st else zero,
                  st["exp_avg_sq"].double().numpy() if st else zero,
                  int(st["step"]) if st else 0)
    return out


def _adam_update(m, v, t, g):
    """Adam's update `lr m_hat / (sqrt(v_hat) + eps)` for the gradient g
    after t steps with moments m, v, in float64 (torch's AdamW and optax's
    alike; the decoupled decay does not depend on g)."""
    b1, b2 = BETAS
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    return LR * m / (1 - b1 ** (t + 1)) / (
        np.sqrt(v / (1 - b2 ** (t + 1))) + EPS)


@contextlib.contextmanager
def jax_replay_reversed(rec):
    """JAX's `jax.random.normal` and `bernoulli` return the draws `rec`
    (`jax_draws`) in call order, each reversed along the batch axis: the
    step on the batch reversed then computes the same function."""
    draws = {kind: iter(a[::-1] for a in arrays)
             for kind, arrays in rec.items()}

    def replay(kind):
        def draw(*args, **kw):
            return jnp.asarray(next(draws[kind]))
        return draw

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", replay("normal"))
        mp.setattr(jax.random, "bernoulli", replay("bernoulli"))
        yield
    assert all(next(d, None) is None for d in draws.values())


@pytest.fixture(scope="module", params=TRAIN_ZOO)
def trained(request, tmp_path_factory):
    """JAX's two steps and eval step, each with its draws and its
    checkpoint before it (and, for PERMUTED, its gradients on the batch
    reversed); then each step in the port from JAX's state before it, in
    float32 and (gradients only) float64, the port's optimizer step on
    JAX's gradients, and the eval step from JAX's final state."""
    name = request.param
    jm, v, size = jax_zoo(name)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, size, size, size, 1)).astype(np.float32)
    y = (rng.random((2, size, size, size, 1)) > 0.6).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    ckpt = tmp_path_factory.mktemp(name)

    tx = JO.torch_adamw(LR, weight_decay=WD)
    jgrads = []

    def update(grads, opt_state, params=None, **kw):
        jgrads.append(_as_torch_keys(jax.tree_util.tree_map(np.array,
                                                            grads)))
        return tx.update(grads, opt_state, params, **kw)

    jstate = j_create_train_state(
        jm, optax.GradientTransformation(tx.init, update),
        jnp.zeros((1, size, size, size, 1)), variables=v)
    jax_steps = []
    for i in range(STEPS + 1):
        JC.save_checkpoint(str(ckpt / f"step{i}.ckpt"), jstate)
        before = jstate
        with jax.disable_jit(), jax_draws() as rec:
            if i == STEPS:
                jeval = float(JS.seg_eval_step(jstate, jnp.asarray(x),
                                               jnp.asarray(y)))
                break
            jstate, loss = JS.seg_train_step(jstate, jnp.asarray(x),
                                             jnp.asarray(y))
        grads = jgrads[-1]
        spread = None
        if name in PERMUTED:
            with jax.disable_jit(), jax_replay_reversed(rec):
                JS.seg_train_step(before, jnp.asarray(x[::-1]),
                                  jnp.asarray(y[::-1]))
            spread = jgrads[-1]
        jax_steps.append(dict(
            loss=float(loss), grads=grads, draws=live_draws(name, rec),
            params=_as_torch_keys(jstate.params),
            batch_stats=jstate.batch_stats,
            spread=None if spread is None else {
                k: np.abs(spread[k] - g).max() for k, g in grads.items()}))
    eval_draws = live_draws(name, rec)

    def from_jax(i):
        model = torch_zoo(name, v)
        state = create_train_state(model, TO.torch_adamw(LR, weight_decay=WD))
        return TC.load_jax_checkpoint(str(ckpt / f"step{i}.ckpt"), state)

    port_steps = []
    for i, js in enumerate(jax_steps):
        on_jax = from_jax(i)
        for k, p in on_jax.model.named_parameters():
            p.grad = torch.from_numpy(js["grads"][k].copy())
        on_jax.optimizer.step()
        state = from_jax(i)
        before = {k: p.detach().clone()
                  for k, p in state.model.named_parameters()}
        moments = _moments(state)
        m64 = copy.deepcopy(state.model).double()
        with port_replay(js["draws"]):
            state, loss = TS.seg_train_step(state, xt, yt)
        with port_replay(js["draws"]):
            TS.seg_loss(m64, xt.double(),
                        binarize_segmentation(yt).double()).backward()
        port_steps.append(dict(
            loss=loss.item(), grads=_grads(state.model),
            grads64=_grads(m64), before=before, moments=moments,
            on_jax_grads={k: p.detach().numpy() for k, p in
                          on_jax.model.named_parameters()},
            model=state.model, step=state.step))
    state = from_jax(STEPS)
    with port_replay(eval_draws):
        ev = TS.seg_eval_step(state, xt, yt).item()
    return dict(name=name, jax=jax_steps, jeval=jeval, port=port_steps,
                eval=ev, state=state, x=x, y=y)


def test_losses_match_jax(trained):
    assert [p["step"] for p in trained["port"]] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([p["loss"] for p in trained["port"]],
                               [j["loss"] for j in trained["jax"]],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(trained["eval"], trained["jeval"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("step", range(STEPS))
def test_gradients_match_jax(trained, step):
    js = trained["jax"][step]
    ref, spread = js["grads"], js["spread"]
    got = trained["port"][step]["grads"]
    g64 = trained["port"][step]["grads64"]
    assert got.keys() == ref.keys()
    assert (spread is None) == (trained["name"] not in PERMUTED)
    for k, r in ref.items():
        g = got[k].numpy().astype(np.float64)
        own = np.abs(g - g64[k].numpy()).max()
        jax_own = JAX_OWN * (own + (0.0 if spread is None else spread[k]))
        bound = GRAD_TOL * np.abs(r).max() + own + jax_own
        assert bound < np.abs(r).max() or not r.any(), (k, bound)
        err = np.abs(g - r).max()
        assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("step", range(STEPS))
def test_parameters_after_each_step_match_jax(trained, step):
    js, ps = trained["jax"][step], trained["port"][step]
    got = dict(ps["model"].named_parameters())
    assert got.keys() == js["params"].keys()
    for k, r in js["params"].items():
        np.testing.assert_allclose(ps["on_jax_grads"][k], r, rtol=OPT_RTOL,
                                   atol=OPT_ATOL, err_msg=k)
        m, v, t = ps["moments"][k]
        moved = np.abs(
            _adam_update(m, v, t, ps["grads"][k].numpy().astype(np.float64))
            - _adam_update(m, v, t, js["grads"][k].astype(np.float64)))
        err = np.abs(got[k].detach().numpy().astype(np.float64) - r)
        assert (err <= OPT_ATOL + OPT_RTOL * np.abs(r) + moved).all(), (
            k, err.max())
    if js["batch_stats"] is not None:
        buffers_close(ps["model"], js["batch_stats"])


@pytest.mark.parametrize("step", range(STEPS))
def test_parameters_without_gradient_decay_as_in_jax(trained, step):
    """Every parameter whose JAX gradient is zero (BraTSUnet's conv2 /
    bn2, which the loss does not reach; Modified3DUNet's bottom level at
    16^3, whose InstanceNorm sees one voxel) gets a zero gradient in the
    port too and JAX's decay, `w (1 - lr wd)` a step
    (`_apply_gradients`).  With norm="bn" the unused norms still run, so
    their running statistics move as JAX's (every buffer is checked in
    `test_parameters_after_each_step_match_jax`)."""
    js, ps = trained["jax"][step], trained["port"][step]
    got = dict(ps["model"].named_parameters())
    unused = {k for k, g in js["grads"].items() if not g.any()}
    if trained["name"].startswith("brats"):
        overwritten = {k for k in got if k.startswith("convd")
                       and (".conv2." in k or ".bn2." in k)}
        assert overwritten and overwritten <= unused
    for k in unused:
        assert not ps["grads"][k].any(), k
        want = ps["before"][k].numpy().astype(np.float64) * (1 - LR * WD)
        np.testing.assert_allclose(js["params"][k], want, rtol=DECAY_RTOL,
                                   atol=0)
        np.testing.assert_allclose(got[k].detach().numpy(), want,
                                   rtol=DECAY_RTOL, atol=0, err_msg=k)
    if trained["name"] == "brats_bn":
        buffers = dict(ps["model"].named_buffers())
        assert int(buffers["convd1.bn2.num_batches_tracked"]) == step + 1


def test_seg_eval_step_is_deterministic(trained):
    """A fresh seed-0 generator for the Bayesian layers' noise each
    call: two evaluations give the same loss."""
    state = trained["state"]
    x, y = torch.from_numpy(trained["x"]), torch.from_numpy(trained["y"])
    a = TS.seg_eval_step(state, x, y)
    b = TS.seg_eval_step(state, x, y)
    assert torch.equal(a, b) and torch.isfinite(a)


def test_step_generators_follow_the_step():
    a = TS.step_generators(3, "cpu")
    b = TS.step_generators(3, "cpu")
    c = TS.step_generators(4, "cpu")
    draw = {k: torch.rand(4, generator=g) for k, g in a.items()}
    assert set(draw) == {"generator", "sample_generator"}
    assert not torch.equal(draw["generator"], draw["sample_generator"])
    for k in draw:
        assert torch.equal(draw[k], torch.rand(4, generator=b[k]))
        assert not torch.equal(draw[k], torch.rand(4, generator=c[k]))


@pytest.mark.parametrize("name", ["residual_bayes", "brats_gn"])
def test_train_segmentation_trains_a_zoo_model(name, tmp_path):
    """`train_segmentation(packed=False)` runs one epoch of a zoo model on
    `SyntheticVolumes` blobs (a validation epoch, a train epoch, a
    validation epoch, a checkpoint): finite losses, one step a batch."""
    _, v, size = jax_zoo(name)
    seg = SyntheticVolumes(n=4, img_shape=(size,) * 3, kind="blobs",
                           seed=1).as_segmentation()
    batches = []
    for i in range(0, 4, 2):
        img, mask = zip(*(seg[j] for j in (i, i + 1)))
        batches.append((np.moveaxis(np.stack(img), 1, -1),
                        np.moveaxis(np.stack(mask), 1, -1)))
    model = torch_zoo(name, v)
    state = create_train_state(model, TO.torch_adamw())
    state, tr, va = TS.train_segmentation(
        1, batches, batches[:1], state, None, "zoo", verbose=False,
        weights_dir=str(tmp_path), packed=False)
    assert state.step == len(batches)
    assert len(tr) == len(va) == 1 and np.isfinite(tr + va).all()
    assert (tmp_path / "zoo_epoch_1.ckpt").exists()
