"""Port parity: resilient training (`train/resilience.py`, the `manager`
and `max_failures` of `train_segmentation`), the reader of the JAX
package's checkpoints (`train/checkpoint.py::load_jax_checkpoint`,
`interop/flax_msgpack.py`) and the JAX signatures of the training entry
points, on the CPU.

The resilience cases are those of `tests/test_resilience.py`, run on the
port's fine UNet3D (out_channels_first_layer 4, 2 encoding blocks) at
16^3.  The checkpoint reader is held to the JAX package: JAX takes a step
and saves, the port loads, then both take one more step on the same
batch."""
import inspect
import os

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp
import ml_dtypes

from mri_epilepsy_diagnosis_torch.interop import flax_msgpack as TM
from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import UNet3D
from mri_epilepsy_diagnosis_torch.train import checkpoint as TC
from mri_epilepsy_diagnosis_torch.train import optim as TO
from mri_epilepsy_diagnosis_torch.train import resilience as TR
from mri_epilepsy_diagnosis_torch.train import seg as TS
from mri_epilepsy_diagnosis_torch.train.state import (TrainState,
                                                      create_train_state)
from mri_epilepsy_diagnosis_tpu.train import checkpoint as JC
from mri_epilepsy_diagnosis_tpu.train import optim as JO
from mri_epilepsy_diagnosis_tpu.train import resilience as JR
from mri_epilepsy_diagnosis_tpu.train import seg as JS
from mri_epilepsy_diagnosis_tpu.train.state import (
    create_train_state as j_create_train_state)
from test_torch_bridge import jax_unet_variables, torch_unet

torch.set_num_threads(2)

SIZE = 16


def _make_state(seed=0):
    torch.manual_seed(seed)
    model = UNet3D(out_channels_first_layer=4, num_encoding_blocks=2,
                   device="cpu")
    return create_train_state(model, TO.torch_adamw(1e-3))


class _Loader:
    """Two batches of two 16^3 blob volumes with FreeSurfer-style labels.
    `poison` passes serve one NaN volume in the first batch; `on_pass`
    runs at the start of every pass."""

    def __init__(self, seed=0, poison=0, on_pass=None):
        rng = np.random.default_rng(seed)
        self.batches = []
        for _ in range(2):
            x = rng.normal(size=(2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
            blob = np.zeros((2, SIZE, SIZE, SIZE, 1), bool)
            blob[:, 4:11, 3:12, 5:10] = True
            x[blob] += 2.0
            self.batches.append((x, np.where(blob, 1002, 41).astype(np.int16)))
        self.poison = poison
        self.on_pass = on_pass

    def __iter__(self):
        if self.on_pass is not None:
            self.on_pass()
        poison, self.poison = self.poison > 0, max(self.poison - 1, 0)
        for i, (x, y) in enumerate(self.batches):
            if poison and i == 0:
                x = x.copy()
                x[0] = np.nan
            yield x, y


def _train(num_epochs, loader, state, mgr, scheduler=None, **kw):
    return TR.train_segmentation_resilient(
        num_epochs, loader, _Loader(seed=1), state, scheduler, mgr,
        verbose=False, **kw)


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()} for i, s in
             state.optimizer.state_dict()["state"].items()}, state.step)


def _assert_equal_snapshots(a, b):
    (ma, oa, sa), (mb, ob, sb) = a, b
    assert sa == sb and ma.keys() == mb.keys() and oa.keys() == ob.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)


# ---------------------------------------------------------------------------
# the cases of tests/test_resilience.py on the port
# ---------------------------------------------------------------------------


def test_checkpoint_manager_rolls_and_restores(tmp_path):
    state = _make_state()
    mgr = TR.CheckpointManager(str(tmp_path), stem="t", keep=2)
    assert mgr.latest_epoch() is None
    for ep in (1, 2, 3):
        state.step = ep
        mgr.save(state, ep)
    assert mgr.latest_epoch() == 3
    assert sorted(os.listdir(tmp_path)) == ["t_epoch_2.ckpt", "t_epoch_3.ckpt"]
    restored, ep = mgr.restore_latest(_make_state(seed=1))
    assert ep == 3 and restored.step == 3
    assert mgr.load_extra(3) == {"epoch": 3}


def test_resilient_resume_continues_run(tmp_path):
    mgr = TR.CheckpointManager(str(tmp_path), stem="r")
    state, tr1, _, done1 = _train(2, _Loader(), _make_state(), mgr)
    assert done1 == 2 and len(tr1) == 2 and state.step == 4
    # a fresh process (a fresh state) resumes at epoch 2 and trains 3-4
    state2, tr2, _, done2 = _train(4, _Loader(), _make_state(seed=1), mgr)
    assert done2 == 4 and len(tr2) == 2 and state2.step == 8
    assert mgr.latest_epoch() == 4 and np.isfinite(tr1 + tr2).all()


def test_resilient_rolls_back_on_nonfinite(tmp_path):
    """One clean epoch, then a poisoned one: it rolls back, and the retry
    starts from the checkpoint bit for bit (every parameter, Adam moment,
    running statistic and the step); the run ends finite."""
    mgr = TR.CheckpointManager(str(tmp_path), stem="n")
    state, *_ = _train(1, _Loader(), _make_state(), mgr)
    passes = []
    loader = _Loader(poison=1,
                     on_pass=lambda: passes.append(_snapshot(state)))
    state, tr, va, done = _train(3, loader, state, mgr, max_failures=3)
    assert done == 3 and len(passes) == 3  # epoch 2 twice, epoch 3
    assert np.isfinite(tr).all() and np.isfinite(va).all()
    assert len(tr) == 2
    for p in state.model.parameters():
        assert torch.isfinite(p).all()
    ckpt = TC.load_checkpoint(str(tmp_path / "n_epoch_1.ckpt"),
                              _make_state(seed=2))
    _assert_equal_snapshots(passes[1], _snapshot(ckpt))
    _assert_equal_snapshots(passes[0], passes[1])


def test_resilient_raises_past_max_failures(tmp_path):
    mgr = TR.CheckpointManager(str(tmp_path), stem="m")
    state, *_ = _train(1, _Loader(), _make_state(), mgr)
    with pytest.raises(RuntimeError, match="2 non-finite epochs"):
        _train(3, _Loader(poison=5), state, mgr, max_failures=1)
    assert mgr.latest_epoch() == 1


def test_resilient_restores_scheduler_state(tmp_path):
    """Auto-resume restores the plateau scheduler's state and the decayed
    learning rate (a fresh scheduler would reset both)."""
    mgr = TR.CheckpointManager(str(tmp_path), stem="s")
    state = _make_state()
    sched = TO.ReduceLROnPlateau(state.optimizer, factor=0.5, patience=0)
    sched.step(1.0)
    sched.step(2.0)  # worse with patience 0: decay
    state, *_ = _train(1, _Loader(), state, mgr, sched)
    saved = {k: v for k, v in sched.state_dict().items()}
    saved_lr = state.optimizer.param_groups[0]["lr"]
    assert saved_lr < 1e-3
    fresh_state = _make_state(seed=1)
    fresh = TO.ReduceLROnPlateau(fresh_state.optimizer, factor=0.5,
                                 patience=0)
    _train(1, _Loader(), fresh_state, mgr, fresh)  # nothing left to train
    assert fresh.state_dict() == saved
    assert fresh_state.optimizer.param_groups[0]["lr"] == saved_lr
    _train(2, _Loader(), fresh_state, mgr, fresh)
    assert fresh_state.optimizer.param_groups[0]["lr"] <= saved_lr


def test_checkpoint_manager_glob_metachar_stem(tmp_path):
    state = _make_state()
    mgr = TR.CheckpointManager(str(tmp_path), stem="run[1]")
    mgr.save(state, 1)
    mgr.save(state, 2)
    assert mgr.latest_epoch() == 2


def test_resilient_stops_at_the_epoch_boundary_on_sigterm(tmp_path):
    """SIGTERM sent from inside the training loader: the epoch finishes,
    is checkpointed, and the loop returns before the next one."""
    import signal

    mgr = TR.CheckpointManager(str(tmp_path), stem="p")
    state, *_ = _train(1, _Loader(), _make_state(), mgr)
    loader = _Loader(on_pass=lambda: os.kill(os.getpid(), signal.SIGTERM))
    before = signal.getsignal(signal.SIGTERM)
    state, tr, _, done = _train(5, loader, state, mgr)
    assert done == 2 and len(tr) == 1 and mgr.latest_epoch() == 2
    assert signal.getsignal(signal.SIGTERM) == before


# ---------------------------------------------------------------------------
# the JAX package's checkpoints in the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_resume(tmp_path_factory):
    """JAX: one packed step (f32 HIGHEST) from JAX-initialised weights,
    `save_checkpoint` (the plateau state in the extras), then a second
    step on the same batch.  Returns the file, the batch, the JAX state
    after the second step and the scheduler state that was saved."""
    jmodel, variables = jax_unet_variables(ocfl=4, nb=3, seed=21)
    rng = np.random.default_rng(22)
    x = rng.normal(size=(2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    labels = np.where(rng.random(x.shape) > 0.6, 1002, 41).astype(np.float32)
    jstate = j_create_train_state(jmodel, JO.torch_adamw(1e-3),
                                  jnp.zeros((1, 8, 8, 8, 1)),
                                  variables=jax.tree_util.tree_map(
                                      jnp.asarray, variables))
    jsched = JO.ReduceLROnPlateau(1e-3, factor=0.5, patience=1)
    for metric in (1.0, 1.5, 1.6):
        jsched.step(metric, jstate.opt_state)   # decays once
    jstate, _ = JS.packed_seg_train_step(jstate, jnp.asarray(x),
                                         jnp.asarray(labels))
    path = str(tmp_path_factory.mktemp("jax") / "jax_epoch_1.ckpt")
    JC.save_checkpoint(path, jstate, scheduler=jsched.state_dict())
    jstate, jloss = JS.packed_seg_train_step(jstate, jnp.asarray(x),
                                             jnp.asarray(labels))
    return path, x, labels, jstate, float(jloss), jsched.state_dict()


def _port_state(variables_seed=0):
    _, variables = jax_unet_variables(ocfl=4, nb=3, seed=variables_seed)
    model = torch_unet(variables, ocfl=4)
    return TrainState(model, TO.torch_adamw(1e-3)(model.parameters()))


def _adam_sd(tree):
    return variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, tree)}, device="cpu")


def test_load_jax_checkpoint_then_step_matches_jax(jax_resume):
    """The port loads the JAX file into a state with other weights, then
    both take the same step: loss 1e-5; parameters at the tolerance of
    `test_torch_train.py`'s step test (rtol 5e-3, atol 5e-4; pre-BN conv
    biases, whose true gradient is 0, 2 lr); each leaf of Adam's moments
    at 1e-3 x the largest value of that moment in the network (small
    leaves are f32 sums over every voxel that cancel heavily, as in
    `test_torch_accum.py`); running statistics rtol 1e-4, atol 1e-5; the
    step and the decayed learning rate exactly."""
    path, x, labels, jstate, jloss, _ = jax_resume
    state = TC.load_checkpoint(path, _port_state())
    assert state.step == 1
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4,
                                                                  rel=1e-6)
    for k, v in state.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1
    state, loss = TS.packed_seg_train_step(state, torch.from_numpy(x),
                                           torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert state.step == int(jstate.step) == 2
    ref = variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               jstate.batch_stats)},
        device="cpu")
    got = state.model.state_dict()
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 2
        elif "running" in k:
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=1e-4,
                                       atol=1e-5)
        elif (k.endswith("conv_layer.bias") and k.replace(
                "conv_layer.bias", "norm_layer.weight") in ref):
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=0,
                                       atol=2e-3)
        else:
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=5e-3,
                                       atol=5e-4)
    adam = jstate.opt_state.inner_state[0]
    names = {p: n for n, p in state.model.named_parameters()}
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        ref = _adam_sd(tree)
        tol = 1e-3 * max(v.abs().max().item() for v in ref.values())
        for p, st in state.optimizer.state.items():
            err = (st[key] - ref[names[p]]).abs().max().item()
            assert err <= tol, (key, names[p], err)
            assert float(st["step"]) == 2


def test_load_jax_checkpoint_is_exact_before_a_step(jax_resume):
    """Loaded, the port's parameters, statistics and moments are the JAX
    file's arrays bit for bit, in the torch layout."""
    path = jax_resume[0]
    payload = flax.serialization.msgpack_restore(open(path, "rb").read())
    state = TC.load_jax_checkpoint(path, _port_state())
    ref = variables_to_state_dict({"params": payload["params"],
                                   "batch_stats": payload["batch_stats"]},
                                  device="cpu")
    for k, v in state.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k
    adam = payload["opt_state"]["inner_state"]["0"]
    mu, nu = _adam_sd(adam["mu"]), _adam_sd(adam["nu"])
    names = {p: n for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        assert torch.equal(st["exp_avg"], mu[names[p]])
        assert torch.equal(st["exp_avg_sq"], nu[names[p]])
        assert st["exp_avg"].dtype == torch.float32


def test_jax_scheduler_state_maps_to_torch(jax_resume):
    """The plateau state saved by JAX restores the torch scheduler: best,
    num_bad_epochs and cooldown_counter carry over, the decay arrives as
    the learning rate, and the next learning rates of the two agree.
    Deliberately not mapped: torch's `last_epoch` (JAX counts no epochs)
    keeps the value the scheduler was built with."""
    path, *_, jsched_sd = jax_resume
    state = TC.load_checkpoint(path, _port_state())
    sched = TO.ReduceLROnPlateau(state.optimizer, factor=0.5, patience=1)
    TC.load_scheduler_state(sched, TC.load_checkpoint_extra(path)
                            ["scheduler"])
    assert (sched.best, sched.num_bad_epochs, sched.cooldown_counter) == (
        jsched_sd["best"], jsched_sd["num_bad_epochs"],
        jsched_sd["cooldown_counter"])
    assert sched.last_epoch == 0
    jsched = JO.ReduceLROnPlateau(1e-3, factor=0.5, patience=1)
    jsched.load_state_dict(jsched_sd)
    got, ref = [], []
    for metric in (1.2, 1.3, 1.0, 1.1, 1.2, 1.3):
        ref.append(jsched.step(metric))
        sched.step(metric)
        got.append(state.optimizer.param_groups[0]["lr"])
    # the learning rate came through JAX's optimizer state, in float32
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -23)
    assert len(set(ref)) > 1


def test_jax_step_lr_state_maps_to_torch():
    opt = TO.torch_adam(1e-3)([torch.nn.Parameter(torch.zeros(1))])
    jsched = JO.StepLR(1e-3, 2, 0.5)
    for _ in range(3):
        jsched.step()
    for g in opt.param_groups:
        g["lr"] = jsched.lr          # as the JAX optimizer state carries it
    sched = TO.StepLR(opt, 2, 0.5)
    TC.load_scheduler_state(sched, jsched.state_dict())
    assert sched.last_epoch == 3
    got, ref = [], []
    for _ in range(5):
        ref.append(jsched.step())
        opt.step()
        sched.step()
        got.append(opt.param_groups[0]["lr"])
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_manager_resumes_from_a_jax_checkpoint(tmp_path, jax_resume):
    """A directory that the JAX package's `CheckpointManager` filled: the
    port's manager finds it and resumes from it (the scheduler too)."""
    path, x, labels, *_ = jax_resume
    jstate_file = tmp_path / "run_epoch_4.ckpt"
    jstate_file.write_bytes(open(path, "rb").read())
    mgr = TR.CheckpointManager(str(tmp_path))
    assert mgr.latest_epoch() == 4
    state, epoch = mgr.restore_latest(_port_state())
    assert epoch == 4 and state.step == 1


def test_flax_msgpack_decoder_matches_flax(monkeypatch):
    """Every type the decoder supports, against
    `flax.serialization.msgpack_restore`, including flax's chunked form
    of a large array (the chunk limit lowered so that a small array takes
    it)."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    rng = np.random.default_rng(3)
    payload = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
                 -2 ** 63],
        "floats": [0.0, -1.5, 1e300, float("inf"), float("-inf")],
        "nil": None, "yes": True, "no": False,
        "str": ["", "a", "x" * 31, "y" * 32, "z" * 300, "ü" * 40000],
        "bin": [b"", b"\x00\x01", b"q" * 300, b"r" * 70000],
        "long_list": list(range(20)),
        "wide_map": {f"k{i}": i for i in range(20)},
        "arrays": {
            "f32": rng.normal(size=(3, 4)).astype(np.float32),
            "f64": rng.normal(size=(5,)),
            "i32": np.arange(7, dtype=np.int32).reshape(7, 1),
            "u8": np.arange(3, dtype=np.uint8),
            "bool": rng.random((2, 3)) > 0.5,
            "scalar0d": np.asarray(np.float32(2.5)),
            "bf16": rng.normal(size=(4, 2)).astype(ml_dtypes.bfloat16),
            "big": rng.normal(size=(40, 30)).astype(np.float32),
            "huge": rng.normal(size=(20000,)).astype(np.float32),
        },
        "npscalars": [np.float32(1.25), np.int64(-7), np.uint8(3)],
        "nested": {"a": {"b": {"c": [1, {"d": np.ones(2)}]}}},
    }
    data = flax.serialization.msgpack_serialize(payload)
    got = TM.msgpack_restore(data)
    ref = flax.serialization.msgpack_restore(data)
    assert "__msgpack_chunked_array__" not in str(got)

    def walk(g, r, path=""):
        if isinstance(r, dict):
            assert isinstance(g, dict) and g.keys() == r.keys(), path
            for k in r:
                walk(g[k], r[k], f"{path}/{k}")
        elif isinstance(r, list):
            assert isinstance(g, list) and len(g) == len(r), path
            for i, (a, b) in enumerate(zip(g, r)):
                walk(a, b, f"{path}/{i}")
        elif isinstance(r, (np.ndarray, np.generic)):
            rd = np.asarray(r)
            gd = np.asarray(g)
            if rd.dtype == ml_dtypes.bfloat16:
                assert gd.dtype == np.float32, path
                rd = rd.astype(np.float32)
            assert gd.dtype == rd.dtype and gd.shape == rd.shape, path
            np.testing.assert_array_equal(gd, rd, err_msg=path)
            assert isinstance(g, np.ndarray) == isinstance(r, np.ndarray)
        else:
            assert type(g) is type(r) and g == r, (path, g, r)

    walk(got, ref)


def test_checkpoint_formats_are_told_apart(tmp_path, jax_resume):
    port = tmp_path / "port.ckpt"
    TC.save_checkpoint(str(port), _port_state())
    assert not TM.is_flax_msgpack(port.read_bytes()[:1])
    assert TM.is_flax_msgpack(open(jax_resume[0], "rb").read(1))
    with pytest.raises(ValueError, match="truncated"):
        TM.msgpack_restore(open(jax_resume[0], "rb").read()[:-3])


# ---------------------------------------------------------------------------
# the JAX signatures (positional calls bind as in JAX)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["run_epoch", "train_segmentation",
                                  "get_model_and_optimizer",
                                  "train_segmentation_resilient"])
def test_signatures_take_the_jax_parameters_in_order(name):
    jfn = getattr(JR if name.endswith("resilient") else JS, name)
    tfn = getattr(TR if name.endswith("resilient") else TS, name)
    jparams = list(inspect.signature(jfn).parameters)
    tparams = list(inspect.signature(tfn).parameters.values())
    assert [p.name for p in tparams[:len(jparams)]] == jparams
    assert all(p.kind == p.KEYWORD_ONLY for p in tparams[len(jparams):])


def test_positional_factory_call_binds_as_in_jax():
    model, state, _ = TS.get_model_and_optimizer(None, 2, 4, device="cpu")
    assert len(model.encoder.encoding_blocks) + 1 == 2
    assert model.state_dict()[
        "encoder.encoding_blocks.0.conv1.conv_layer.weight"].shape[0] == 4


@pytest.mark.parametrize("name", ["sharding", "dashboard"])
def test_unported_arguments_raise_by_name(tmp_path, name):
    """`sharding` refuses, by name, anything but a `core.mesh.Sharding`;
    `dashboard` is ported: both loops update it once per completed epoch
    with JAX's keys (`test_torch_obs.py` holds the values to JAX's)."""
    state = _make_state()
    if name == "dashboard":
        class Dashboard:
            def __init__(self):
                self.calls = []

            def update(self, **kw):
                self.calls.append(kw)

        for run in (lambda d: TS.train_segmentation(
                        2, _Loader(), _Loader(seed=1), state, None, "x",
                        weights_dir=str(tmp_path), verbose=False,
                        dashboard=d),
                    lambda d: _train(2, _Loader(), state,
                                     TR.CheckpointManager(str(tmp_path)),
                                     dashboard=d)):
            dash = Dashboard()
            run(dash)
            assert [sorted(c) for c in dash.calls] == [
                ["train_loss", "val_loss"]] * 2
            assert all(np.isfinite(list(c.values())).all()
                       for c in dash.calls)
        return
    with pytest.raises(TypeError, match=name):
        TS.train_segmentation(1, _Loader(), _Loader(), state, None, "x",
                              weights_dir=str(tmp_path), verbose=False,
                              sharding=object())
    with pytest.raises(TypeError, match=name):
        _train(1, _Loader(), state, TR.CheckpointManager(str(tmp_path)),
               sharding=object())
    with pytest.raises(TypeError, match=name):
        TS.run_epoch(0, TS.Action.VALIDATE, _Loader(), state,
                     sharding=object())
