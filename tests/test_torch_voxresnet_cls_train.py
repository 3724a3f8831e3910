"""The packed VoxResNet on the classification loop's normal path
(`train/classification.py::run_one_epoch(..., packed=True)`), float32 on
the CPU at 64^3 (4 filters, 4 stages, stride 2, batch 4, Dropout 0.5):

- three train steps against the plain reference of the benchmark
  (`portbench/reference/voxresnet.py`, which imports neither package),
  given the program's Dropout generator state: the losses, the first
  gradient of every leaf (read from Adam's first moment after step 1),
  the parameters and running statistics after step 3;
- every train-mode BatchNorm through `ops/packed.py::BnActTrainPacked`
  against the plain composition it replaced (`zero_shifted_pads`,
  `models/unet_packed.py::_bn_train_packed`, ReLU, `zero_shifted_pads`,
  differentiated by autograd): logits, running statistics, gradients;
- the packed eval pass against the fine model's, and the loop's other
  routes: the fine default, and a refusal of any other model;
- the `cls::` spans of a profiled epoch, one `cls::step` per step.

Tolerances, each from what float32 on the CPU can reach at these sizes:
the program and the reference sum in other orders (packed sub-positions
against cuDNN-free plain convs), so a gradient tensor is held to 1e-4 of
its own max|ref| (the runs showed at most a few 1e-6), the losses and
logits to 1e-5, the running statistics to 1e-5 of max(1, max|ref|); the
conv biases directly under a train-mode BatchNorm (`conv3d_1`,
`conv3d_2`) have a true gradient of 0 and are held to 1e-4 of the
largest gradient.  After three Adam steps (lr 1e-3) a parameter is held
to 1e-5 of max(1, max|ref|): each step moves it by about lr, so that is
1% of its change; the pre-BN biases, whose gradient is float32 noise
beside the small decay term, to 2 lr a step (Adam moves them by up to lr
a step whichever way the noise points)."""
import copy

import numpy as np
import pytest
import torch

from mri_epilepsy_diagnosis_torch import obs
from mri_epilepsy_diagnosis_torch.models import cnn as TC
from mri_epilepsy_diagnosis_torch.models import unet_packed as TU
from mri_epilepsy_diagnosis_torch.models import voxresnet_packed as TV
from mri_epilepsy_diagnosis_torch.obs import trace_summary as TS
from mri_epilepsy_diagnosis_torch.ops import functional as TF
from mri_epilepsy_diagnosis_torch.ops import packed as TP
from mri_epilepsy_diagnosis_torch.train import classification as C
from mri_epilepsy_diagnosis_torch.train.optim import torch_adam
from mri_epilepsy_diagnosis_torch.train.state import create_train_state
from portbench.reference import voxresnet as R

torch.set_num_threads(2)

SIZE, BATCH, STEPS = 64, 4, 3
CFG = {"input_shape": [SIZE] * 3, "num_classes": 2, "n_filters": 4,
       "stride": 2, "n_blocks": 4, "dropout": 0.5, "n_fc_units": 16,
       "optimizer": {"lr": 1e-3, "betas": [0.9, 0.999], "eps": 1e-8,
                     "weight_decay": 0.01}}
PRE_BN_BIASES = ("model.conv3d_1.bias", "model.conv3d_2.bias")
DROP_SEED = 17


def _batches(seed, n=STEPS):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(BATCH, SIZE, SIZE, SIZE, 1)).astype(np.float32),
             np.asarray([0, 1, 1, 0][:BATCH], np.int64)) for _ in range(n)]


def _weights(seed=3):
    return R.make_weights(CFG, torch.Generator().manual_seed(seed),
                          torch.device("cpu"))


def _model(weights):
    model = TC.VoxResNet(input_shape=(SIZE,) * 3, n_filters=CFG["n_filters"],
                         stride=CFG["stride"], n_blocks=CFG["n_blocks"],
                         dropout=CFG["dropout"],
                         n_fc_units=CFG["n_fc_units"], device="cpu")
    model.load_state_dict(weights)
    return model


def _state(model):
    opt = CFG["optimizer"]
    return create_train_state(model, torch_adam(
        opt["lr"], tuple(opt["betas"]), opt["eps"], opt["weight_decay"]))


class _FirstGrad:
    """The loop's logger: after step 1 it reads each leaf's gradient from
    Adam's first moment, (1 - beta1) (g + decay w0)."""

    def __init__(self, state, weights):
        self.state, self.weights, self.grads, self.steps = state, weights, \
            None, 0

    def log_metric(self, name, value, step=None):
        self.steps += 1
        if self.steps != 1:
            return
        opt, b1 = CFG["optimizer"], CFG["optimizer"]["betas"][0]
        st = self.state.optimizer.state
        self.grads = {k: st[p]["exp_avg"] / (1 - b1)
                      - opt["weight_decay"] * self.weights[k]
                      for k, p in self.state.model.named_parameters()}


def _close(got, ref, tol, what):
    err = float((got.double() - ref.double()).abs().max())
    assert err <= tol, (what, err, tol)


def _replay_by_calling(fn, pool=None):
    """`GraphedTrainStep.capture` on the CPU, which has no CUDA graphs:
    replaying calls the captured function again, so the step's plumbing
    (static inputs, the Dropout draws made before the replay, the update
    captured again when the rate changes) runs as on the card."""
    _replay_by_calling.captures.append(fn.func.__name__)
    return fn, None


@pytest.fixture(params=["eager", "graphed"])
def route(request, monkeypatch):
    """The packed train step as on the CPU (eager) or as on the card
    (`GraphedTrainStep`, replaying by calling)."""
    _replay_by_calling.captures = []
    if request.param == "graphed":
        monkeypatch.setattr(C, "_captures_steps", lambda state: True)
        monkeypatch.setattr(TV.GraphedTrainStep, "capture",
                            staticmethod(_replay_by_calling))
    return request.param


def test_packed_loop_follows_the_reference(route):
    weights = _weights()
    model = _model(weights)
    state = _state(model)
    batches = _batches(5)
    log = _FirstGrad(state, weights)
    state, losses, probs, targets = C.run_one_epoch(
        state, batches, True, rng_stream=torch.Generator().manual_seed(
            DROP_SEED), experiment=log, prefetch=0, packed=True)
    assert state.step == STEPS and targets == [0, 1, 1, 0] * STEPS
    ref = R.train_steps(weights, CFG, [tuple(map(torch.from_numpy, b))
                                       for b in batches],
                        torch.Generator().manual_seed(DROP_SEED))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    d = ref["logits"][:, 1] - ref["logits"][:, 0]
    p = np.asarray(probs[:BATCH], np.float64)
    np.testing.assert_allclose(np.log(p / (1 - p)), d.numpy(), rtol=1e-5,
                               atol=1e-5)
    largest = max(float(g.abs().max()) for g in ref["grads"].values())
    assert set(log.grads) == set(ref["grads"])
    for k, g in ref["grads"].items():
        scale = largest if k in PRE_BN_BIASES else float(g.abs().max())
        _close(log.grads[k], g, 1e-4 * scale, k)
    sd = model.state_dict()
    for k, v in {**ref["params"], **ref["stats"]}.items():
        tol = (2 * STEPS * CFG["optimizer"]["lr"] if k in PRE_BN_BIASES
               else 1e-5 * max(1.0, float(v.abs().max())))
        _close(sd[k], v, tol, k)
    for k in R.stat_keys(CFG):
        name = k.rsplit(".", 1)[0]
        assert int(sd[f"{name}.num_batches_tracked"]) == STEPS, name
    assert _replay_by_calling.captures == (
        ["_forward_backward", "_update"] if route == "graphed" else [])


def _halving(state):
    from mri_epilepsy_diagnosis_torch.train.optim import ReduceLROnPlateau

    return ReduceLROnPlateau(state.optimizer, mode="min", factor=0.5,
                             patience=0, threshold=10.0)


def test_graphed_steps_follow_the_eager_ones(monkeypatch):
    """A scheduler that halves the rate on every step: the graphed route
    captures its update again at each new rate, and a last batch of
    another size takes the eager step; parameters, statistics, losses and
    probabilities come out as the eager route's, bit for bit (one
    intra-op thread: the packed CPU step is not bit-reproducible at
    two)."""
    monkeypatch.setattr(TV.GraphedTrainStep, "capture",
                        staticmethod(_replay_by_calling))
    _replay_by_calling.captures = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _graphed_against_eager()
    finally:
        torch.set_num_threads(threads)
    assert _replay_by_calling.captures == ["_forward_backward"] + \
        ["_update"] * 2


def _graphed_against_eager():
    weights = _weights()
    batches = _batches(21, 4)
    batches[-1] = tuple(a[:2] for a in batches[-1])

    def epoch():
        state = _state(_model(weights))
        out = C.run_one_epoch(state, batches, True, rng_stream=torch
                              .Generator().manual_seed(DROP_SEED),
                              scheduler=_halving(state), prefetch=0,
                              packed=True)
        return out[0].model.state_dict(), out[1:], \
            state.optimizer.param_groups[0]["lr"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C, "_captures_steps", lambda state: True)
        got = epoch()
    want = epoch()
    assert got[1] == want[1] and got[2] == want[2]
    # halved on each of the 4 losses, the last read after the loop
    assert got[2] == CFG["optimizer"]["lr"] * 0.5 ** 4
    for k, v in want[0].items():
        assert torch.equal(got[0][k], v), k


def test_dropout_draws_are_the_forwards_own():
    """`dropout_draws` made before the forward give the mask that the
    forward draws from the same generator state; at rate 0 nothing is
    drawn."""
    x, _ = (torch.from_numpy(a) for a in _batches(5, 1)[0])
    model = _model(_weights())
    want, _ = TV.voxresnet_apply_packed(
        model, x, train=True,
        generator=torch.Generator().manual_seed(DROP_SEED))
    gen = torch.Generator().manual_seed(DROP_SEED)
    u = TV.dropout_draws(model, BATCH, x.device, gen)
    assert u.shape == (BATCH, CFG["n_fc_units"])
    got, _ = TV.voxresnet_apply_packed(model, x, train=True, dropout_u=u)
    assert torch.equal(got, want)
    model.dropout = 0.0
    state = gen.get_state()
    assert TV.dropout_draws(model, BATCH, x.device, gen) is None
    assert torch.equal(gen.get_state(), state)


@pytest.mark.cuda
def test_graphed_steps_match_the_eager_ones_on_the_card():
    """On the card, at the cell's widths on 64^3 in bf16: an epoch whose
    steps from the second on replay CUDA graphs (the update captured
    again at each new rate) against the same steps taken eagerly with
    the same capturable Adam.  Both launch the same kernels; cuBLAS may
    pick other algorithms on the capture's stream, so the parameters are
    held to 1e-3 of each tensor's max|w| and the losses to 1e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs")
    cfg = {**CFG, "n_filters": 32, "n_fc_units": 192}
    weights = {k: v.cuda() for k, v in R.make_weights(
        cfg, torch.Generator().manual_seed(3), torch.device("cpu")).items()}
    batches = [(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
               for x, y in _batches(23, 5)]

    def epoch(graphed):
        model = TC.VoxResNet(input_shape=(SIZE,) * 3, n_filters=32,
                             stride=2, n_blocks=4, dropout=0.5,
                             n_fc_units=192, device="cuda")
        model.load_state_dict(weights)
        state = _state(model)
        for group in state.optimizer.param_groups:
            group["capturable"] = True
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(C, "_captures_steps", lambda state: graphed)
            _, losses, probs, _ = C.run_one_epoch(
                state, batches, True, rng_stream=torch.Generator()
                .manual_seed(DROP_SEED), scheduler=_halving(state),
                prefetch=0, input_dtype=torch.bfloat16, packed=True)
        torch.cuda.synchronize()
        return model.state_dict(), losses, probs

    got, want = epoch(True), epoch(False)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-2)
    np.testing.assert_allclose(got[2], want[2], atol=1e-2)
    for k, v in want[0].items():
        tol = 1e-3 * max(1.0, float(v.double().abs().max()))
        _close(got[0][k], v, tol, k)


def _composed_bn(y, bn, *, train, shifted, relu, fine_size, batch):
    """The train-mode tail as the packed VoxResNet composed it before
    `BnActTrainPacked`: pads zeroed, `_bn_train_packed`, ReLU
    (`maximum0`), pads zeroed again."""
    if shifted:
        y = TP.zero_shifted_pads(y)
    out, new = TU._bn_train_packed(y, bn, valid=float(batch * fine_size ** 3))
    if relu:
        out = TF.maximum0(out)
    if shifted:
        out = TP.zero_shifted_pads(out)
    return out, new


def _train_forward(model, x, y):
    logits, stats = TV.voxresnet_apply_packed(
        model, x, train=True,
        generator=torch.Generator().manual_seed(DROP_SEED))
    C.cross_entropy(logits, y).backward()
    return logits.detach(), stats, {n: p.grad for n, p in
                                    model.named_parameters()}


def test_function_route_matches_the_composition(monkeypatch):
    x, y = (torch.from_numpy(a) for a in _batches(7, 1)[0])
    model = _model(_weights(11))
    got = _train_forward(copy.deepcopy(model), x, y)
    calls = []
    orig = TV._bn_packed

    def composed(y_, bn, *, train, **kw):
        if not train:
            return orig(y_, bn, train=train, **kw)
        calls.append(kw["shifted"])
        return _composed_bn(y_, bn, train=train, **kw)

    monkeypatch.setattr(TV, "_bn_packed", composed)
    ref = _train_forward(copy.deepcopy(model), x, y)
    # 22 sites: the stem's and 8 block bn1s shifted, the rest aligned
    assert len(calls) == 22 and sum(calls) == 9
    _close(got[0], ref[0], 1e-5, "logits")
    assert set(got[1]) == set(ref[1])
    for k, v in ref[1].items():
        _close(got[1][k], v, 1e-5 * max(1.0, float(v.abs().max())), k)
    largest = max(float(g.abs().max()) for g in ref[2].values())
    for k, g in ref[2].items():
        scale = largest if k in PRE_BN_BIASES else float(g.abs().max())
        _close(got[2][k], g, 1e-4 * scale, k)


def test_packed_eval_matches_the_fine_eval():
    """Eval goes through the packed eval forward (B2's epilogue and the
    running statistics, no `BnActTrainPacked`), and gives the fine
    model's losses and probabilities."""
    weights = _weights(13)
    gen = torch.Generator().manual_seed(2)
    for k in R.stat_keys(CFG):   # running statistics away from (0, 1)
        weights[k] = (weights[k] + 0.3 * torch.rand(weights[k].shape,
                                                    generator=gen))
    batches = _batches(9, 2)
    runs = []
    for packed in (True, False):
        model = _model(weights)
        _, losses, probs, _ = C.run_one_epoch(_state(model), batches, False,
                                              prefetch=0, packed=packed)
        runs.append((losses, probs))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=1e-4, atol=1e-6)


def test_packed_routes_voxresnet_only_and_fine_stays_the_default(
        monkeypatch):
    model = TC.CNN(input_shape=(16, 16, 16), n_filters=2, n_blocks=2,
                   device="cpu")
    state = create_train_state(model, torch_adam(1e-3))
    with pytest.raises(ValueError, match="VoxResNet only"):
        C.run_one_epoch(state, [], True, packed=True)

    def refuse(*args, **kw):
        raise AssertionError("the packed step ran")

    monkeypatch.setattr(TV, "voxresnet_class_step_packed", refuse)
    monkeypatch.setattr(TV, "voxresnet_eval_step_packed", refuse)
    model = _model(_weights())
    state, losses, _, _ = C.run_one_epoch(_state(model), _batches(3, 1),
                                          True, prefetch=0)
    assert state.step == 1 and np.isfinite(losses).all()


def _ranges(events, prefix):
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(prefix)]


def _end(e):
    return float(e["ts"]) + float(e["dur"])


def _children(step, spans):
    inside = [e for e in spans if e is not step and e["tid"] == step["tid"]
              and float(e["ts"]) >= float(step["ts"])
              and _end(e) <= _end(step)]
    return [e["name"] for e in sorted(inside, key=lambda e: float(e["ts"]))]


@pytest.mark.parametrize("train,packed,input_dtype", [
    (True, True, torch.float32), (True, False, None), (False, True, None)])
def test_run_one_epoch_emits_one_step_span_per_step(tmp_path, train, packed,
                                                    input_dtype):
    """One `cls::step` per step on the loop's thread, holding in order
    `cls::next_batch`, `cls::cast` (with `input_dtype`), `cls::forward`,
    in training `cls::backward`, then the previous step's `cls::loss_sync`
    and `cls::log` (from the second step on), in training
    `cls::optimizer` and (packed) `cls::stats`, then `cls::collect`; the
    pull that finds the loader empty ends the loop in one more step, and
    the last step's `cls::loss_sync` and `cls::log` follow it."""
    state = _state(_model(_weights()))
    with obs.profile_trace(str(tmp_path), device="cpu"):
        C.run_one_epoch(state, _batches(4, 2), train, prefetch=2,
                        packed=packed, input_dtype=input_dtype)
    spans = _ranges(TS.load_events(str(tmp_path)), "cls::")
    steps = sorted((e for e in spans if e["name"] == "cls::step"),
                   key=lambda e: float(e["ts"]))
    assert len(steps) == 3 and len({e["tid"] for e in spans}) == 1
    head = ["cls::next_batch"] + (["cls::cast"] if input_dtype else []) \
        + ["cls::forward"] + (["cls::backward"] if train else [])
    tail = (["cls::optimizer"] + (["cls::stats"] if packed else [])
            if train else []) + ["cls::collect"]
    read = ["cls::loss_sync", "cls::log"]
    assert _children(steps[0], spans) == head + tail
    assert _children(steps[1], spans) == head + read + tail
    assert _children(steps[2], spans) == ["cls::next_batch"]
    after = sorted((e["name"] for e in spans
                    if float(e["ts"]) >= _end(steps[2])))
    assert after == sorted(read)


def test_scheduler_and_logger_see_each_loss_before_the_next_update():
    """The loop reads a step's loss during the next step: the plateau
    scheduler still steps on each loss before the following update, so a
    scheduler that halves the rate on every step gives the parameters of
    a loop that reads every loss at its step's end."""
    from mri_epilepsy_diagnosis_torch.train.optim import ReduceLROnPlateau

    weights, batches = _weights(), _batches(6, 3)

    def halving(state):
        return ReduceLROnPlateau(state.optimizer, mode="min", factor=0.5,
                                 patience=0, threshold=10.0)

    state = _state(_model(weights))
    gen = torch.Generator().manual_seed(DROP_SEED)
    sched = halving(state)
    seen = []
    for x, y in batches:
        state, loss, _ = C._class_step(state, torch.from_numpy(x),
                                       torch.from_numpy(y), gen, True)
        seen.append(float(loss))
        sched.step(seen[-1])
    want = {k: v.clone() for k, v in state.model.state_dict().items()}

    state = _state(_model(weights))
    sched = halving(state)
    state, losses, _, _ = C.run_one_epoch(
        state, batches, True, rng_stream=torch.Generator().manual_seed(
            DROP_SEED), scheduler=sched, prefetch=0)
    assert losses == seen
    assert state.optimizer.param_groups[0]["lr"] == \
        CFG["optimizer"]["lr"] * 0.5 ** 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_launch_split_reads_the_counters():
    TV.reset_launch_counts()
    assert TV.launch_split() == {
        "b1_stride1": 0, "b1_stride2": 0, "b1_dx": 0, "bn_train_stats": 0,
        "bn_train_apply": 0, "bn_train_reduce": 0, "bn_train_dx": 0}
