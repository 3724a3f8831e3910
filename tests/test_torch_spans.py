"""The port's spans (`obs.span`) in the segmentation loop and the
prefetcher, on the CPU: which ranges a profiled `run_epoch` and
`DevicePrefetcher` write, on which thread and in what order; that a span
costs no `record_function` when no profiler records and survives a
profiler starting or stopping while it is open; and that training with
spans recording gives the same bits as training without them."""
import copy
import threading
import time

import numpy as np
import pytest
import torch

from mri_epilepsy_diagnosis_torch import obs
from mri_epilepsy_diagnosis_torch.data.pipeline import DevicePrefetcher
from mri_epilepsy_diagnosis_torch.obs import trace_summary as TS
from mri_epilepsy_diagnosis_torch.train import seg as S

torch.set_num_threads(2)

SIZE = 16
OCFL = 4
N_BATCHES = 3
OUTER = "test::run_epoch"


def _loader(seed, n=N_BATCHES):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
        blob = rng.random((2, SIZE, SIZE, SIZE, 1)) > 0.7
        out.append((x, np.where(blob, 1002, 41).astype(np.int16)))
    return out


def _state():
    _, state, _ = S.get_model_and_optimizer(out_channels_first_layer=OCFL,
                                            device="cpu")
    return state


class _Log:
    def __init__(self):
        self.values = []

    def log_metric(self, name, value, step=None):
        self.values.append(value)


def _ranges(events, prefix):
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(prefix)]


def _end(e):
    return float(e["ts"]) + float(e["dur"])


def _children(step, spans):
    """Names of the `seg::` spans inside `step` on its thread, in order."""
    inside = [e for e in spans if e is not step and e["tid"] == step["tid"]
              and float(e["ts"]) >= float(step["ts"])
              and _end(e) <= _end(step)]
    return [e["name"] for e in sorted(inside, key=lambda e: float(e["ts"]))]


def _profiled_epoch(tmp_path, action, packed, input_dtype, prefetch):
    state = _state()
    with obs.profile_trace(str(tmp_path), device="cpu"):
        with obs.span(OUTER):
            S.run_epoch(0, action, _loader(1), state, experiment=_Log(),
                        prefetch=prefetch, packed=packed,
                        input_dtype=input_dtype)
    return TS.load_events(str(tmp_path))


CASES = [(S.Action.TRAIN, False, None, 2), (S.Action.TRAIN, True, None, 2),
         (S.Action.TRAIN, True, torch.float32, 0),
         (S.Action.TRAIN, False, torch.float32, 2),
         (S.Action.VALIDATE, False, None, 0),
         (S.Action.VALIDATE, True, torch.float32, 2)]


@pytest.mark.parametrize("action,packed,input_dtype,prefetch", CASES)
def test_run_epoch_emits_one_step_span_per_step(tmp_path, action, packed,
                                                input_dtype, prefetch):
    """One `seg::step` per step on the thread that called `run_epoch`,
    each holding the table's children in order: `seg::cast` only with
    `input_dtype`, `seg::stats` only in the packed train step, no
    backward, optimizer or stats in validation.  The pull that finds the
    loader empty ends the loop inside one more `seg::step`, which holds
    only its `seg::next_batch`."""
    events = _profiled_epoch(tmp_path, action, packed, input_dtype,
                             prefetch)
    outer, = _ranges(events, OUTER)
    spans = _ranges(events, "seg::")
    assert spans and {e["tid"] for e in spans} == {outer["tid"]}
    steps = sorted((e for e in spans if e["name"] == "seg::step"),
                   key=lambda e: float(e["ts"]))
    assert len(steps) == N_BATCHES + 1
    want = ["seg::next_batch"]
    if input_dtype is not None:
        want.append("seg::cast")
    want.append("seg::forward")
    if action == S.Action.TRAIN:
        want += ["seg::backward", "seg::optimizer"]
        if packed:
            want.append("seg::stats")
    want += ["seg::loss_sync", "seg::log"]
    for step in steps[:-1]:
        assert _children(step, spans) == want
    assert _children(steps[-1], spans) == ["seg::next_batch"]
    # every leaf span lies in a step
    leaves = [e for e in spans if e["name"] != "seg::step"]
    assert sum(len(_children(s, spans)) for s in steps) == len(leaves)


def test_span_enters_no_range_without_a_profiler(monkeypatch, tmp_path):
    """Without a profiler a span only checks the flag: a packed training
    epoch calls `record_function` not once; under one it does, once a
    span."""
    real = torch.profiler.record_function
    calls = []

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    S.run_epoch(0, S.Action.TRAIN, _loader(2), _state(), experiment=_Log(),
                packed=True)
    assert calls == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        S.run_epoch(0, S.Action.TRAIN, _loader(2, 1), _state(),
                    experiment=_Log(), packed=True, prefetch=0)
    assert calls.count("seg::step") == 2 and "seg::stats" in calls


def test_span_left_cleanly_when_a_profiler_starts_or_stops_inside():
    """A span open when a profiler starts leaves no range (it entered
    none); a span open when it stops ends with the profile.  The loop's
    logger starting and stopping a profiler, as the benchmark's does,
    leaves the loop's own spans balanced."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with obs.span("test::before"):
        prof.start()
        with obs.span("test::inside"):
            torch.ones(3).sum()
        late = obs.span("test::late")
        late.__enter__()
    prof.stop()
    late.__exit__(None, None, None)
    names = [e.name for e in prof.events()]
    assert "test::inside" in names and "test::before" not in names
    assert "test::late" in names

    class Starter(_Log):
        def __init__(self):
            super().__init__()
            self.prof = None

        def log_metric(self, name, value, step=None):
            super().log_metric(name, value)
            if len(self.values) == 1:
                self.prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU])
                self.prof.start()
            elif len(self.values) == 3:
                self.prof.stop()

    log = Starter()
    S.run_epoch(0, S.Action.TRAIN, _loader(3, 4), _state(), experiment=log,
                packed=True)
    assert len(log.values) == 4
    names = [e.name for e in log.prof.events()]
    # step 2 ran whole under the profiler; step 3's began under it
    assert names.count("seg::step") == 2
    assert names.count("seg::forward") == 2
    assert not torch.autograd.profiler._is_profiler_enabled


def _snapshot(state, losses):
    opt = state.optimizer.state_dict()
    return {"losses": torch.as_tensor(losses),
            **{f"model.{k}": v.detach().clone()
               for k, v in state.model.state_dict().items()},
            **{f"opt.{i}.{k}": v.clone() for i, st in opt["state"].items()
               for k, v in st.items()}}


@pytest.fixture
def one_thread():
    """The packed step on the CPU differs in its last bits from run to run
    at two intra-op threads, with or without a profiler; at one it does
    not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("packed", [False, True])
def test_training_is_bit_equal_with_spans_recording(tmp_path, one_thread,
                                                    packed):
    """Losses, parameters, BatchNorm buffers and AdamW state after a
    train epoch and a validation epoch are the same bits with the spans
    recording under `profile_trace` and with no profiler."""
    start = _state()
    got = []
    for profiled in (False, True):
        state = copy.deepcopy(start)
        loader = _loader(4)
        if profiled:
            with obs.profile_trace(str(tmp_path), device="cpu"):
                state, tr = S.run_epoch(0, S.Action.TRAIN, loader, state,
                                        experiment=_Log(), packed=packed)
                _, va = S.run_epoch(0, S.Action.VALIDATE, loader[:1], state,
                                    packed=packed)
        else:
            state, tr = S.run_epoch(0, S.Action.TRAIN, loader, state,
                                    experiment=_Log(), packed=packed)
            _, va = S.run_epoch(0, S.Action.VALIDATE, loader[:1], state,
                                packed=packed)
        got.append(_snapshot(state, np.concatenate([tr, va])))
    assert _ranges(TS.load_events(str(tmp_path)), "seg::forward")
    plain, traced = got
    assert plain.keys() == traced.keys()
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k


def test_prefetcher_spans_on_its_own_thread(tmp_path):
    """The producer of a prefetcher started before `profile_trace` opens
    (so only the all-threads profile records it) shows `data::draw`,
    `data::stage` and `data::queue_full` on its own thread."""
    n = 8
    started = threading.Event()

    def batches():
        started.set()
        for i in range(n):
            yield (np.full((2, 4), i, np.float32),)

    pf = DevicePrefetcher(batches(), size=1, device="cpu")
    started.wait(5.0)
    got = []
    with obs.profile_trace(str(tmp_path), device="cpu"):
        with obs.span(OUTER):
            while (batch := pf.get()) is not None:
                got.append(int(batch[0][0, 0]))
                time.sleep(0.01)
    assert got == list(range(n))
    events = TS.load_events(str(tmp_path))
    outer, = _ranges(events, OUTER)
    data = _ranges(events, "data::")
    names = {e["name"] for e in data}
    assert names == {"data::draw", "data::stage", "data::queue_full"}
    tids = {e["tid"] for e in data}
    assert len(tids) == 1 and outer["tid"] not in tids
