"""The benchmark's FLOP and roofline counts against FlopCounterMode, and
the metric readers on small synthetic traces."""
import json
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.lib import harness, trace, work
from portbench.reference import unet3d as RU

UNET = json.loads((harness.HERE / "configs/unet3d_fepegar_ocfl8.json")
                  .read_text())


def _conv_flops(counter):
    return sum(v for op, v in counter.get_flop_counts()["Global"].items()
               if "convolution" in str(op))


def test_unet_sites_match_flop_counter_at_32():
    n, s = 2, 32
    sites = work.unet_conv_sites(UNET, n, s, "bfloat16", backward=True)
    fwd = sum(x.flops for x in sites if not x.name.endswith(".dx"))
    dx = sum(x.flops for x in sites if x.name.endswith(".dx"))
    meta = torch.device("meta")
    w = RU.make_weights(UNET, torch.Generator(), meta)
    keys = RU.param_keys(UNET)
    for k in keys:
        w[k].requires_grad_(True)
    with FlopCounterMode(display=False) as c:
        logits, _ = RU.forward(w, UNET, torch.empty((n, 1, s, s, s),
                                                    device=meta), True)
        torch.autograd.grad(logits.sum(), [w[k] for k in keys])
    classifier = 2 * 16 * 2 * n * s ** 3
    # forward, weight gradients (as many operations) and input gradients,
    # the 1x1 classifier's among them
    assert _conv_flops(c) == 3 * classifier + 2 * fwd + dx
    assert work.unet_step_flops(UNET, n, s, True, conv_only=True) \
        == _conv_flops(c)


def test_unet_forward_flops_by_hand():
    # 2 * 27 * Ci * Co a voxel over the ten 3x3x3 convs, plus the 1x1 head
    s = 32
    per = {1: 2 * 27 * (1 * 8 + 8 * 16 + 48 * 16 + 16 * 16) + 2 * 16 * 2,
           2: 2 * 27 * (16 * 16 + 16 * 32 + 96 * 32 + 32 * 32),
           4: 2 * 27 * (32 * 32 + 32 * 64)}
    want = sum(v * (s // k) ** 3 for k, v in per.items())
    assert work.unet_step_flops(UNET, 1, s, False) == want


def test_bound_takes_the_larger_time():
    s = [work.Site("a", 989e12, 0.0), work.Site("b", 0.0, 3.35e12)]
    assert work.bound_s(s, "bfloat16") == pytest.approx(2.0)


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _view(events, steps, work_extra=None):
    spans = trace.stretches(events)
    span = spans[0]
    w = {"kind": "train", "steps": 10, "wall_s": 2.0, "dtype": "bfloat16",
         "batch": 2, "step_flops": lambda: 989e12 * 5e-5}
    w.update(work_extra or {})
    return SimpleNamespace(plain=events, stack=events, span=span,
                           stack_span=span, steps=steps, work=w,
                           devs=trace.device_events(events, span), lost=0)


def _synthetic():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
           "ts": 0.0, "dur": 1000.0, "tid": 1, "pid": 1}]
    ev.append(_kernel("void mri::tc::conv2_packed_tc_kernel<64>(int)", 0,
                      100, 1))
    ev.append(_kernel("void mri::conv2_packed_kernel<float>(int)", 100, 50,
                      2))
    ev.append(_kernel("void at::native::elementwise_kernel<128, 4>(int)",
                      200, 200, 3))
    ev.append(_kernel("sm90_xmma_gemm_bf16bf16_f32", 500, 100, 4))
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
               "ts": 650, "dur": 50, "args": {"correlation": 5}})
    ev.append({"ph": "X", "cat": "python_function", "tid": 2, "pid": 1,
               "name": "mri_epilepsy_diagnosis_torch/ops/packed.py(294): "
                       "_dw_packed_qgroup", "ts": 400, "dur": 200})
    ev.append({"ph": "X", "cat": "cuda_runtime", "tid": 2, "pid": 1,
               "name": "cudaLaunchKernel", "ts": 450, "dur": 5,
               "args": {"correlation": 4}})
    return ev


def _read(name, view):
    return harness.reader(name).read(view)


def test_readers_on_a_synthetic_trace():
    view = _view(_synthetic(), steps=2, work_extra={
        "b1_sites": lambda: [work.Site("x", 989e12 * 15e-6, 0.0)]})
    # busy: 0-150, 200-400, 500-600, 650-700 of 1000 us
    assert _read("idle_pct.train", view) == pytest.approx(50.0)
    assert _read("torch_tail_ms.train", view) == pytest.approx(0.1)
    assert _read("dw_gemm_ms.train", view) == pytest.approx(0.05)
    # bound 15 us a step over 150 us of B1 in 2 steps
    assert _read("b1_roofline_pct.train", view) == pytest.approx(20.0)
    assert _read("mfu.train", view) == pytest.approx(10.0)


def test_readers_find_nothing_in_an_empty_trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
           "ts": 0.0, "dur": 1000.0, "tid": 1, "pid": 1}]
    view = _view(ev, steps=2, work_extra={"b1_sites": lambda: []})
    for name in ("idle_pct.train", "b1_roofline_pct.train",
                 "dw_gemm_ms.train", "torch_tail_ms.train"):
        assert _read(name, view) is None


def test_lost_launches_and_op_kind():
    ev = _synthetic() + [{"ph": "X", "cat": "cuda_runtime",
                          "name": "cudaLaunchKernel", "ts": 1, "dur": 1,
                          "args": {"correlation": 99}}]
    assert len(trace.lost_launches(ev)) == 1
    assert trace.op_kind("void mri::(anonymous namespace)::k<1, 2>(int)") \
        == "mri::anonymous_namespace::k"


def test_every_seed_holds_the_same_subjects_in_its_own_order():
    from portbench.lib import gen
    cpu = torch.device("cpu")
    fg = []
    for seed in (3, 2 ** 31 + 11):
        x, lab = gen.seg_pool(gen.generator(seed, cpu), 4, 32, cpu)
        fg.append(gen.binarize(lab).mean(dim=(1, 2, 3, 4)))
        assert x.shape == (4, 32, 32, 32, 1)
    a = gen.ladder(gen.generator(5, cpu), 8, 1.0, 8.0, cpu)
    b = gen.ladder(gen.generator(6, cpu), 8, 1.0, 8.0, cpu)
    assert torch.equal(a.sort().values, b.sort().values)
    # the labelled share differs from subject to subject
    for f in fg:
        assert f.max() > 1.5 * f.min()
