"""Port parity: classification training (`train/classification.py`,
`train/accum.py::class_train_step_accum`, `metrics/classification.py`)
against the JAX package and, for the metrics and the folds, sklearn (which
only this test imports: the port has its own metrics).

The steps run a VoxResNet at 32^3 (n_filters 2, batch 4) from the same
JAX-initialised variables on both sides, with SGD at lr 1, so that the
updated parameters p - g hold the gradient at full weight (the epoch's
second step runs at lr 0.05: after a step of lr 1 the net is far from
where it started, and the two packages' float32 noise grows through the
next loss).  float32, JAX
at "highest" precision.  Tolerances: losses and probabilities 1e-5
relative; parameters and BatchNorm statistics 5e-5 x max|ref| per leaf
plus a floor of 1e-6 x the largest leaf, for the conv biases before
BatchNorm (true gradient 0, float32 noise on both sides).  5e-5, not the
1e-5 of the fader steps: in this 26-layer residual net the JAX package's
float32 step lies 2.0e-5 x max|ref| from a float64 step of the port, and
the port's own float32 step 7e-7 (`test_f32_step_against_a_float64_step`,
which holds the port to 1e-5 and JAX to 5e-5 and prints both readings),
so that the two packages agree only to JAX's noise: up to 1.6e-5 in the
steps below."""
import numpy as np
import optax
import pytest
import torch
from sklearn import metrics as skm
from sklearn.model_selection import StratifiedKFold

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.metrics import classification as TM
from mri_epilepsy_diagnosis_torch.models import cnn as TCnn
from mri_epilepsy_diagnosis_torch.ops import functional as TFn
from mri_epilepsy_diagnosis_torch.train import accum as TA
from mri_epilepsy_diagnosis_torch.train import classification as TC
from mri_epilepsy_diagnosis_torch.train.state import TrainState
from mri_epilepsy_diagnosis_tpu.models import cnn as JCnn
from mri_epilepsy_diagnosis_tpu.train import accum as JA
from mri_epilepsy_diagnosis_tpu.train import classification as JC
from mri_epilepsy_diagnosis_tpu.train.state import create_train_state
from test_torch_fader import randomized

torch.set_num_threads(2)

REL_TOL = 1e-5
STATE_TOL = 5e-5
FLOOR = 1e-6
SIZE = 32
KW = dict(input_shape=(SIZE,) * 3, n_filters=2)


def _batches(seed, n_batches, batch=4):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(batch, SIZE, SIZE, SIZE, 1)).astype(np.float32),
             rng.permutation(np.arange(batch) % 2).astype(np.int32))
            for _ in range(n_batches)]


@pytest.fixture(scope="module")
def variables():
    x = np.zeros((1, SIZE, SIZE, SIZE, 1), np.float32)
    return randomized(jax.jit(JCnn.VoxResNet(**KW).init)(
        jax.random.key(0), jnp.asarray(x)), seed=1)


def _jstate(variables, lr=1.0):
    return create_train_state(
        JCnn.VoxResNet(**KW), optax.sgd(lr), None,
        variables=jax.tree_util.tree_map(jnp.asarray, variables))


def _tstate(variables, lr=1.0):
    model = TCnn.VoxResNet(device="cpu", **KW)
    model.load_state_dict(variables_to_state_dict(variables, device="cpu"),
                          strict=True)
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=lr))


def _assert_state_close(model, jstate):
    ref = variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}), device="cpu")
    got = model.state_dict()
    assert got.keys() == ref.keys()
    floor = FLOOR * max(float(v.abs().max()) for v in ref.values())
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = float((got[k] - r).abs().max())
        assert err <= STATE_TOL * float(r.abs().max()) + floor, (k, err)


def _state_err(got, ref):
    """The largest error of any leaf beyond the floor, x max|ref| of the
    leaf: the reading that `_assert_state_close` holds to STATE_TOL."""
    floor = FLOOR * max(float(v.abs().max()) for v in ref.values())
    return max(max(0.0, float((got[k].double() - r).abs().max()) - floor)
               / float(r.abs().max()) for k, r in ref.items()
               if not k.endswith("num_batches_tracked"))


def _f64_moments(x):
    axes = tuple(range(x.ndim - 1))
    mean = x.mean(dim=axes)
    return mean, (x - mean).square().mean(dim=axes)


def _f64_batch_norm(x, mean, var, gamma, beta, eps=1e-5):
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def _f64_cross_entropy(outputs, targets, weight=None):
    assert weight is None
    logp = torch.log_softmax(outputs, dim=-1)
    return -logp.gather(-1, targets.long()[:, None]).mean()


@pytest.mark.parametrize("side,tol", [("port", REL_TOL), ("jax", STATE_TOL)])
def test_f32_step_against_a_float64_step(variables, monkeypatch, side, tol):
    """A float32 train step of each package against the port's step in
    float64 throughout (BatchNorm's moments and reciprocal square root and
    the loss, which the port takes in float32, kept in float64 here): the
    port within 1e-5 x max per leaf, JAX within STATE_TOL."""
    x, y = _batches(3, 1)[0]
    with monkeypatch.context() as m:
        m.setattr(TFn, "batch_moments", _f64_moments)
        m.setattr(TFn, "batch_norm", _f64_batch_norm)
        m.setattr(TC, "cross_entropy", _f64_cross_entropy)
        ref = _tstate(variables)
        ref.model.double()
        TC._class_step(ref, torch.from_numpy(x).double(),
                       torch.from_numpy(y), None, True)
    ref = ref.model.state_dict()
    if side == "port":
        state, _, _ = TC._class_step(_tstate(variables), torch.from_numpy(x),
                                     torch.from_numpy(y), None, True)
        got = state.model.state_dict()
    else:
        jstate, _, _ = JC._class_step(_jstate(variables), jnp.asarray(x),
                                      jnp.asarray(y), jax.random.key(0), True)
        got = variables_to_state_dict(jax.tree_util.tree_map(
            np.asarray, {"params": jstate.params,
                         "batch_stats": jstate.batch_stats}), device="cpu")
    err = _state_err(got, ref)
    print(f"{side} float32 step vs float64: {err:.2e} x max|ref|")
    assert err <= tol


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(weighted):
    rng = np.random.default_rng(2)
    out = rng.normal(size=(7, 3)).astype(np.float32) * 3
    y = rng.integers(0, 3, 7)
    w = [1.0, 2.0, 0.5] if weighted else None
    ref = JC.cross_entropy(jnp.asarray(out), jnp.asarray(y),
                           None if w is None else jnp.asarray(w))
    got = TC.cross_entropy(torch.from_numpy(out), torch.from_numpy(y), w)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    torch_ref = torch.nn.CrossEntropyLoss(
        weight=None if w is None else torch.tensor(w))(
        torch.from_numpy(out), torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), torch_ref.item(), rtol=1e-6)


def test_cross_entropy_takes_weights_as_a_tensor_or_a_list():
    """A list and a tensor of weights give one value, as torch's loss
    takes either."""
    rng = np.random.default_rng(3)
    out = torch.from_numpy(rng.normal(size=(9, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 9))
    w = [1.0, 2.0, 0.5]
    assert torch.equal(TC.cross_entropy(out, y, w),
                       TC.cross_entropy(out, y, torch.tensor(w)))


@pytest.mark.parametrize("labels", [
    [0, 0, 0, 1, 1, 0, 0, 1, 0, 0], [1, 1, 1, 0, 1, 1, 1, 1],
    [0, 1, 0, 1, 0, 1], [0] * 9 + [1] * 3])
def test_stratified_batch_indices_equal_jax(labels):
    idx = np.arange(100, 100 + len(labels))
    np.testing.assert_array_equal(
        TC.stratified_batch_indices(idx, labels),
        JC.stratified_batch_indices(idx, labels))


@pytest.mark.parametrize("train", [True, False])
def test_class_step_matches_jax(variables, train):
    x, y = _batches(3, 1)[0]
    jstate, jloss, jprobs = JC._class_step(
        _jstate(variables), jnp.asarray(x), jnp.asarray(y),
        jax.random.key(0), train)
    state = _tstate(variables)
    state, loss, probs = TC._class_step(state, torch.from_numpy(x),
                                        torch.from_numpy(y), None, train)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL_TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                               rtol=0, atol=REL_TOL)
    assert state.step == int(train)
    _assert_state_close(state.model, jstate)


def test_run_one_epoch_matches_jax(variables):
    batches = _batches(4, 2)
    jstate, jl, jp, jt = JC.run_one_epoch(_jstate(variables, 0.05),
                                          batches, True)
    state, losses, probs, targets = TC.run_one_epoch(
        _tstate(variables, 0.05), batches, True)
    np.testing.assert_allclose(losses, jl, rtol=REL_TOL)
    np.testing.assert_allclose(probs, jp, rtol=0, atol=REL_TOL)
    assert targets == jt
    _assert_state_close(state.model, jstate)
    # eval: nothing moves
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    TC.run_one_epoch(state, batches, False)
    assert all(torch.equal(before[k], v)
               for k, v in state.model.state_dict().items())


def test_class_train_step_accum_matches_jax(variables):
    x, y = _batches(5, 1)[0]
    jstate, jloss, jprobs = JA.class_train_step_accum(
        _jstate(variables), jnp.asarray(x), jnp.asarray(y),
        jax.random.key(0), micro=2)
    state, loss, probs = TA.class_train_step_accum(
        _tstate(variables), torch.from_numpy(x), torch.from_numpy(y), None,
        micro=2)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL_TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0,
                               atol=REL_TOL)
    _assert_state_close(state.model, jstate)
    with pytest.raises(ValueError, match="not divisible"):
        TA.class_train_step_accum(state, torch.from_numpy(x[:3]),
                                  torch.from_numpy(y[:3]), None, micro=2)


def test_create_model_opt_is_seeded_and_transfers(tmp_path):
    """Seeded draws; in transfer mode every parameter outside the head is
    frozen at the loaded values and left out of the optimizer, and the
    head is drawn anew from seed + 1; a train step moves only the head;
    the plateau scheduler halves the rate."""
    model = TCnn.VoxResNet(device="cpu", **KW)
    s1, _ = TC.create_model_opt(model, None, seed=3, device="cpu")
    a = {k: v.clone() for k, v in model.state_dict().items()}
    TC.create_model_opt(model, None, seed=3, device="cpu")
    assert all(torch.equal(a[k], v) for k, v in model.state_dict().items())
    TC.create_model_opt(model, None, seed=4, device="cpu")
    assert not torch.equal(a["model.conv3d_1.weight"],
                           model.state_dict()["model.conv3d_1.weight"])

    loaded = {k: v + 0.5 if v.is_floating_point() else v
              for k, v in a.items()}
    path = str(tmp_path / "pretrained.pth")
    torch.save(loaded, path)
    state, sched = TC.create_model_opt(model, None, model_load_path=path,
                                       transfer=True, seed=3, device="cpu")
    fresh = TC.seeded_state_dict(model, 4)
    head = "model.fully_conn_2."
    for name, p in model.named_parameters():
        want = fresh[name] if name.startswith(head) else loaded[name]
        assert torch.equal(p.detach(), want), name
        assert p.requires_grad == name.startswith(head)
    opt_params = {id(p) for g in state.optimizer.param_groups
                  for p in g["params"]}
    assert opt_params == {id(p) for n, p in model.named_parameters()
                          if n.startswith(head)}
    before = {k: v.clone() for k, v in model.named_parameters()}
    x, y = _batches(6, 1)[0]
    TC._class_step(state, torch.from_numpy(x), torch.from_numpy(y), None,
                   True)
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]) != name.startswith(head), name
    for _ in range(4):
        sched.step(1.0)
    assert state.optimizer.param_groups[0]["lr"] == 0.5e-5


class _Volumes:
    """Channel-first volumes with binary targets and patient ids."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(n, 1, SIZE, SIZE, SIZE)).astype(np.float32)
        self.target = np.arange(n) % 2
        self.pids = np.arange(n)

    def __len__(self):
        return len(self.target)

    def __getitem__(self, i):
        return self.x[i], int(self.target[i])


def test_cross_val_score_runs_sklearn_folds(monkeypatch):
    """Each fold trains on its stratified train split and validates on
    exactly its held-out split of sklearn's StratifiedKFold."""
    data = _Volumes(12, 7)
    cv = StratifiedKFold(n_splits=3)
    seen = []
    train = TC.train

    def rec(state, train_loader, val_loader, *a, **kw):
        seen.append((sorted(train_loader.dataset.indices.tolist()),
                     val_loader.dataset.indices.tolist()))
        return train(state, train_loader, val_loader, *a, **kw)

    monkeypatch.setattr(TC, "train", rec)
    scores = TC.cross_val_score(
        TCnn.VoxResNet(device="cpu", **KW), data, cv, TM.roc_auc_score,
        None, batch_size=4, max_epoch=1, device="cpu")
    folds = list(cv.split(np.arange(12), data.target))
    assert len(scores) == 3 and all(0.0 <= s <= 1.0 for s in scores)
    assert seen == [(sorted(tr.tolist()), va.tolist()) for tr, va in folds]


def test_train_stops_and_checkpoints(tmp_path, variables):
    """`train` checkpoints the best epoch and stops on a train loss below
    eps; its `dashboard` gets one update per epoch with JAX's keys (the
    validation values None without a validation loader;
    `test_torch_obs.py` holds the values to JAX's)."""
    batches = _batches(8, 1)
    path = str(tmp_path / "best.ckpt")
    state, tl, tm, vl, vm = TC.train(
        _tstate(variables), batches, batches, lambda t, p: 0.5,
        model_save_path=path, max_epoch=3, eps=1e9)
    assert (tm, vm) == (0.5, 0.5) and state.step == 1
    assert torch.load(path, weights_only=True)["step"] == 1

    class Dashboard:
        calls = []

        def update(self, **kw):
            self.calls.append(kw)

    dash = Dashboard()
    TC.train(state, batches, None, TM.accuracy_score, max_epoch=2, eps=0.0,
             dashboard=dash)
    assert [sorted(c) for c in dash.calls] == [
        ["train_loss", "train_metric", "val_loss", "val_metric"]] * 2
    assert all(c["val_loss"] is None and c["val_metric"] is None
               and np.isfinite(c["train_loss"]) for c in dash.calls)


@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 30)
    scores = rng.integers(0, 6, 30) / 5.0      # many ties
    assert TM.roc_auc_score(y, scores) == pytest.approx(
        skm.roc_auc_score(y, scores), abs=1e-12)
    pred = (scores > 0.5).astype(int)
    assert TM.accuracy_score(y, pred) == skm.accuracy_score(y, pred)
    assert TM.roc_auc_score(2 * y + 3, scores) == pytest.approx(
        skm.roc_auc_score(2 * y + 3, scores), abs=1e-12)


def test_roc_auc_refuses_one_class():
    """A ValueError, as sklearn raised until it turned this into a warning
    and NaN; the loops catch it and record NaN, as the JAX package's do
    around sklearn's."""
    with pytest.raises(ValueError, match="Only one class"):
        TM.roc_auc_score([1, 1, 1], [0.2, 0.4, 0.9])
