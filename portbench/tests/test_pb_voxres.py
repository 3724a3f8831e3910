"""The VoxResNet cell (`voxresnet_packed_192_b10`) on the CPU at a small
size (64^3, 4 filters, batch 4): a sound run agrees with the plain
reference and is correct; the float8 control, the faults a training cell
can have (half of each batch left out, a step that leaves the state
unchanged) and a wrong weight gradient at one conv come out not correct
under the cell's own limits; `grad_bias_gap` reads the conv biases that
take a gradient and no other leaf; its work counts match a hand count;
its new readers read synthetic traces as computed by hand; a traced run
lists the cell's metrics and no device metric without a card."""
from types import SimpleNamespace

import pytest
import torch

from portbench.drivers import cls_train as D
from portbench.lib import compare, harness
from portbench.lib import trace as T
from portbench.lib import work_voxresnet as W

CELL = "voxresnet_packed_192_b10"
# the CPU dry run: 64^3 is the smallest input 4 stride-2 stages take
# (S / stride divisible by 2^5)
TINY_MIX = {"size": 64, "batch": 4, "pool": 8}
TINY_CFG = {"input_shape": [64, 64, 64], "n_filters": 4, "n_fc_units": 16,
            "dtype": "float32"}
CFG = harness.load_config(harness.benchmark(), "voxresnet_nf32_s2_4stage")
PER_LAYER = {"mfu.voxres", "idle_pct.voxres", "b1_roofline_pct.voxres",
             "torch_tail_ms.voxres", "bn_tail_roofline_pct.voxres",
             "loop_idle_ms.voxres", "launch_idle_ms.voxres"}


def dry_run(seed=2 ** 31 + 7, seconds=2.5, trace=False, calibrate=False,
            mix=None):
    """One run of the cell on the CPU at its tiny size."""
    return harness.run_cell(CELL, seed, seconds, trace, device="cpu",
                            mix_overrides={**TINY_MIX, **(mix or {})},
                            cfg_overrides=TINY_CFG, calibrate=calibrate)


def _limits():
    return harness.load_mix("cls_whole192_b10")["limits"]


def test_sound_run_is_correct_and_near_the_reference():
    result, lines = dry_run()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(_limits())
    for c in result["checks"].values():
        assert c["value"] < 1e-3
    assert set(result["metrics"]) == {"train_samples_s",
                                      "train_step_p95_ms", "setup_s"}


def test_control_and_half_batch_reference_are_not_correct():
    result, _ = dry_run(calibrate=True)
    ex = result["extra"]
    for side in ("control", "half_batch"):
        checks = compare.training_checks(ex[side], ex["ref"], _limits())
        gaps = [c["value"] > c["limit"] for c in checks]
        for name in ("logit_gap", "grad_bias_gap"):
            gaps.append(ex[name][side] > _limits()[name])
        assert any(gaps), (side, checks, ex["logit_gap"],
                           ex["grad_bias_gap"])


def _patch_step(monkeypatch, fault):
    from mri_epilepsy_diagnosis_torch.models import voxresnet_packed as VP
    orig = VP.voxresnet_class_step_packed

    def step(state, x, y, generator, **kw):
        if fault == "half_batch":
            n = x.shape[0] // 2
            return orig(state, x[:n], y[:n], generator, **kw)
        state.optimizer.zero_grad(set_to_none=True)
        logits, _ = VP.voxresnet_apply_packed(state.model, x, train=True,
                                              generator=generator)
        return state, torch.zeros(()), torch.softmax(logits.detach(), -1)

    monkeypatch.setattr(VP, "voxresnet_class_step_packed", step)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_faults_are_not_correct(fault, monkeypatch):
    _patch_step(monkeypatch, fault)
    result, _ = dry_run()
    assert not result["correct"], result["checks"]


def test_a_wrong_gradient_at_one_conv_is_not_correct(monkeypatch):
    """The weight gradient of the last conv of each backward (the deepest
    block's conv2, the first that autograd reaches) doubled: the
    worst conv kernel's leaf reads it."""
    from mri_epilepsy_diagnosis_torch.ops import packed as P
    orig, calls = P._dw_packed_qgroup, []

    def dw(x_padded, g):
        calls.append(1)
        out = orig(x_padded, g)
        return out * 2.0 if len(calls) % 22 == 1 else out

    monkeypatch.setattr(P, "_dw_packed_qgroup", dw)
    result, _ = dry_run()
    assert not result["correct"], result["checks"]
    checks = result["checks"]
    assert checks["grad_conv_gap"]["value"] > checks["grad_conv_gap"]["limit"]
    assert checks["grad_median_gap"]["value"] < 1e-3


def test_work_matches_a_hand_count():
    n, s = 2, 64
    cfg = {**CFG, "input_shape": [s] * 3, "n_filters": 4}
    sites = {x.name: x for x in W.conv_sites(cfg, n, s, "bfloat16", True)}
    # 22 convs forward and 21 input gradients (none for the stem)
    assert len(sites) == 43 and "model.conv3d_1.dx" not in sites
    b = 2
    hand = {  # name: (c_in, c_out, fine input, fine output)
        "model.conv3d_1": (1, 4, 64, 32),
        "model.conv3d_2": (4, 4, 32, 32),
        "model.conv3d_3": (4, 8, 32, 16),
        "model.block_1.conv1": (8, 8, 16, 16),
        "model.conv3d_6": (16, 16, 4, 2),
        "model.block_8.conv2": (16, 16, 2, 2)}
    for name, (ci, co, fi, fo) in hand.items():
        site = sites[name]
        assert site.flops == 2 * 27 * ci * co * n * fo ** 3, name
        assert site.nbytes == (n * fi ** 3 * ci + 27 * ci * co
                               + n * fo ** 3 * co) * b, name
    bn = {x.name: x for x in W.bn_sites(cfg, n, s, "bfloat16")}
    assert len(bn) == 22
    assert bn["model.batch_norm_1"].nbytes == 8 * n * 32 ** 3 * 4 * b
    assert bn["model.block_8.bn2"].nbytes == 8 * n * 2 ** 3 * 16 * b
    assert bn["model.batch_norm_6"].flops == 0
    # the reference's conv FLOPs under FlopCounterMode: the forward, as
    # many for the weight gradients, and the input gradients but the stem's
    fwd = sum(x.flops for k, x in sites.items() if not k.endswith(".dx"))
    dx = sum(x.flops for k, x in sites.items() if k.endswith(".dx"))
    assert W.step_flops(cfg, n, s, True, conv_only=True) == 2 * fwd + dx
    assert W.step_flops(cfg, n, s, False, conv_only=True) == fwd


def test_published_configuration_counts():
    assert W.step_flops(CFG, 1, 192, False, conv_only=True) == \
        pytest.approx(183.5e9, rel=0.01)
    from portbench.reference import voxresnet as R
    assert R.parameter_count(CFG) == CFG["parameters"]
    assert R.flatten_units(CFG) == CFG["flatten_units"]


def _x(name, ts, end, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": float(ts), "dur": float(end - ts), "args": {}}


def _view(events, steps, work=None):
    span = T.stretches(events)[0]
    return SimpleNamespace(plain=events, stack=events, span=span,
                           stack_span=span, steps=steps, work=work or {},
                           devs=T.device_events(events, span), lost=0)


def _read(name, view):
    return harness.reader(name).read(view)


def test_new_readers_on_a_synthetic_trace():
    ev = [_x(T.STRETCH, 0, 1000),
          _x("cls::step", 0, 1000), _x("cls::next_batch", 0, 100),
          _x("cls::forward", 100, 400), _x("cls::backward", 400, 700),
          _x("cls::optimizer", 700, 750), _x("cls::loss_sync", 750, 900),
          _x("cls::collect", 900, 950), _x("cls::log", 950, 1000)]
    # kernels busy 150-350 and 450-800: idle 0-150 (loop 100, launch 50),
    # 350-450 (launch 100), 800-1000 (loop 200)
    for name, a, b in (("void mri::bn_train_apply_kernel<float>(int)", 150,
                        250),
                       ("void mri::bn_train_dx_kernel<float>(int)", 250,
                        350),
                       ("void mri::tc::conv2_packed_tc_kernel<64>(int)", 450,
                        800)):
        ev.append(_x(name, a, b, tid=7, cat="kernel"))
    work = {"kind": "train", "dtype": "bfloat16",
            "bn_sites": lambda: [W.Site("a", 0.0, 3.35e12 * 50e-6)]}
    view = _view(ev, steps=1, work=work)
    assert _read("loop_idle_ms.voxres", view) == pytest.approx(0.3)
    assert _read("launch_idle_ms.voxres", view) == pytest.approx(0.15)
    # a bound of 50 us over 200 us of the tail's kernels
    assert _read("bn_tail_roofline_pct.voxres", view) == pytest.approx(25.0)
    # the segmentation loop's readers see no `seg::` span here
    assert _read("loop_idle_ms.train", view) is None


def test_new_readers_find_nothing_without_spans_or_kernels():
    ev = [_x(T.STRETCH, 0, 1000), _x("void k<1>(int)", 0, 10, tid=7,
                                     cat="kernel")]
    view = _view(ev, steps=1, work={"kind": "train", "dtype": "bfloat16",
                                    "bn_sites": lambda: []})
    for name in ("loop_idle_ms.voxres", "launch_idle_ms.voxres",
                 "bn_tail_roofline_pct.voxres"):
        assert _read(name, view) is None


def test_grad_bias_gap_reads_the_conv_biases_that_take_a_gradient():
    """The downsample conv's bias (no BatchNorm after it) is read; a conv
    bias under a BatchNorm (a gradient of round-off: not a moved leaf),
    BatchNorm and head parameters are not."""
    ref = {"convs": ["c1.weight", "c2.weight"],
           "grads": {"c1.weight": 1.0, "c1.bias": 1e-6, "bn1.weight": 0.5,
                     "bn1.bias": 0.5, "c2.weight": 2.0, "c2.bias": 0.25,
                     "fc.weight": 1.0, "fc.bias": 0.25}}
    prog = {"grads": {**ref["grads"], "c1.bias": 0.3, "bn1.weight": 0.9,
                      "fc.bias": 0.5}}
    assert D.grad_bias_gap(prog, ref) == 0.0
    prog["grads"]["c2.bias"] = 0.5
    # |0.5 - 0.25| over the moved leaves' median, 0.5
    assert D.grad_bias_gap(prog, ref) == pytest.approx(0.5)


def test_traced_dry_run_lists_the_cells_metrics():
    result, _ = dry_run(seed=2 ** 31 + 11, seconds=3.0, trace=True,
                        mix={"profile_start": 1, "profile_steps": 2})
    assert result["correct"], result["checks"]
    names = {m["name"] for m in harness.cell_metrics(
        harness.benchmark(), CELL, "per_layer")}
    assert names == PER_LAYER
    # a CPU trace has no device events: no device metric is reported
    assert not set(result["metrics"]) & names


def test_the_cell_is_in_the_benchmark():
    """The cell, its configuration and its metrics: one chip, the cell's
    driver, every per-layer metric read in this cell alone and moving
    `train_samples_s`, and both end-to-end metrics listing it."""
    bench = harness.benchmark()
    w = harness.cell(bench, CELL)
    assert w["chips"] == 1 and w["config"] == "voxresnet_nf32_s2_4stage"
    assert harness.load_mix(w["traffic"])["driver"] == "cls_train"
    ends = {m["name"]: m for m in bench["end_to_end"]}
    for name in ("train_samples_s", "train_step_p95_ms"):
        assert CELL in ends[name]["workloads"]
    mine = [m for m in bench["per_layer"] if CELL in m.get("workloads", [])]
    assert {m["name"] for m in mine} == PER_LAYER
    for m in mine:
        assert m["workloads"] == [CELL] and m["moves"] == "train_samples_s"
        harness.reader(m["name"])
