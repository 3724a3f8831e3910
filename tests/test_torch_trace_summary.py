"""Port parity: `obs/trace_summary.py`, the reader of torch.profiler
(Kineto) traces, and `obs/profile.py::profile_trace`, on the CPU.

The rollups are held on a fixture of Kineto events (kernels, copies and
memsets on the card, host ops with shapes, Python frames, collective
ranges), as `tests/test_trace_summary.py` holds the JAX package's reader
on a synthetic TPU trace, and on a real CPU trace written by
`profile_trace`, whose host-op counts must equal the profiler's own
`key_averages()` exactly.  No tolerance: the reader counts and adds the
trace's own numbers."""
import gzip
import json
import os

import numpy as np
import pytest
import torch

from mri_epilepsy_diagnosis_torch.obs import profile_trace
from mri_epilepsy_diagnosis_torch.obs import trace_summary as TS
from mri_epilepsy_diagnosis_torch.ops import packed as P
from mri_epilepsy_diagnosis_tpu.obs import trace_summary as JTS

torch.set_num_threads(2)

PKG = "/src/mri_epilepsy_diagnosis_torch/"


def _kernel(name, ts, dur, device=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": device, "tid": 7,
            "ts": ts, "dur": dur, "args": {"device": device}}


def _op(name, ts, dur, dims, types, tid=1, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 100, "tid": tid,
            "ts": ts, "dur": dur,
            "args": {"Input Dims": dims, "Input type": types}}


def _frame(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "python_function", "name": name, "pid": 100,
            "tid": tid, "ts": ts, "dur": dur, "args": {}}


def _fixture():
    tc = ("void conv2_packed_tc_kernel<false, (int)64>(CUtensorMap, "
          "float const*, int)")
    tc_fused = ("void conv2_packed_tc_kernel<true, (int)64>(CUtensorMap, "
                "float const*, int)")
    ew = ("void at::native::elementwise_kernel<128, 4, at::native::"
          "gpu_kernel_impl<at::native::AddFunctor<float>>(at::"
          "TensorIteratorBase&, at::native::AddFunctor<float> const&)::"
          "{lambda(int)#1}>(int, at::native::AddFunctor<float>)")
    ew2 = ew.replace("128, 4", "128, 2")
    return [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python3"}},
        _kernel(tc, 10.0, 100.0), _kernel(tc, 120.0, 50.0),
        _kernel(tc_fused, 200.0, 40.0),
        _kernel(ew, 300.0, 5.0), _kernel(ew2, 310.0, 7.0),
        _kernel("Memcpy HtoD (Pageable -> Device)", 0.0, 30.0,
                cat="gpu_memcpy"),
        _kernel("Memset (Device)", 400.0, 2.0, cat="gpu_memset"),
        _kernel(tc, 500.0, 1000.0, device=1),
        # a range projected onto the card's timeline: not a launch
        _kernel("nccl:all_reduce", 600.0, 9.0, cat="gpu_user_annotation"),
        # host side: Python frames, copy ops (one nested in another),
        # collectives
        _frame(PKG + "ops/packed.py(57): pack2", 1000.0, 100.0),
        _frame(PKG + "models/unet.py(10): forward", 990.0, 400.0),
        _frame("torch/nn/modules/module.py(1): _call_impl", 995.0, 300.0),
        _op("aten::contiguous", 1010.0, 50.0, [[2, 8, 8, 8, 4], []],
            ["float", "Scalar"]),
        _op("aten::clone", 1011.0, 40.0, [[2, 8, 8, 8, 4], []],
            ["float", ""]),
        _op("aten::copy_", 1012.0, 30.0, [[2, 8, 8, 8, 4], [2, 8, 8, 8, 4],
                                          []], ["float", "float", "Scalar"]),
        _op("aten::copy_", 1200.0, 10.0, [[16, 16], [16, 16], []],
            ["c10::BFloat16", "float", "Scalar"]),
        _op("aten::copy_", 5000.0, 10.0, [[3], [3], []],
            ["long int", "long int", "Scalar"], tid=2),
        _op("aten::add", 1300.0, 3.0, [[4], [4], []],
            ["float", "float", "Scalar"]),
        _op("nccl:all_reduce", 2000.0, 5.0, [[1024]], ["float"],
            cat="user_annotation"),
        _op("nccl:all_reduce", 2100.0, 5.0, [[8, 8]], ["c10::BFloat16"],
            cat="user_annotation"),
        _op("nccl:broadcast", 2200.0, 5.0, [[2]], ["long int"],
            cat="user_annotation"),
        _op("c10d::allreduce_", 1990.0, 20.0, [[[1024]], []],
            ["TensorList", ""]),
    ]


def test_summarize_rolls_up_kernel_kinds():
    """Kinds drop the return type, template arguments and parameters, so
    both instantiations of B1 and both elementwise kernels roll up; the
    selection is by category, and `cuda:N` picks device N."""
    rollup, total = TS.summarize(_fixture())
    assert rollup["conv2_packed_tc_kernel"] == (1190.0, 4)
    assert rollup["at::native::elementwise_kernel"] == (12.0, 2)
    assert rollup["Memcpy HtoD"] == (30.0, 1)
    assert rollup["Memset"] == (2.0, 1)
    assert total == 1234.0
    assert "nccl:all_reduce" not in rollup
    rollup0, total0 = TS.summarize(_fixture(), "cuda:0")
    assert rollup0["conv2_packed_tc_kernel"] == (190.0, 3)
    assert total0 == 234.0
    host, _ = TS.summarize(_fixture(), "cpu")
    assert host["aten::copy_"][1] == 3 and "nccl:all_reduce" not in host


def test_top_ops_keep_full_names_and_kind():
    rows = TS.top_ops(_fixture(), "cuda:0", top=3)
    assert rows[0][0].startswith("void conv2_packed_tc_kernel<false")
    assert rows[0][1:] == (150.0, 2)
    assert [r[2] for r in rows] == [2, 1, 1]
    assert TS.op_kind("aten::copy_") == "aten::copy_"
    assert TS.op_kind("void (anonymous namespace)::k<1>(int)") == (
        "anonymous_namespace::k")
    assert TS.op_kind("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"


def test_summarize_within_follows_correlation_to_frames():
    """Kernels launched from inside a frame (by the correlation id of their
    host launch), whatever thread launched them."""
    def launch(ts, corr, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "pid": 100, "tid": tid, "ts": ts, "dur": 1.0,
                "args": {"correlation": corr}}

    def kernel(name, corr, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                "tid": 7, "ts": 50.0 + corr, "dur": dur,
                "args": {"device": 0, "correlation": corr}}

    events = [
        _frame(PKG + "ops/cuda_kernels.py(445): conv2_packed_dx", 10.0,
               10.0, tid=3),
        _frame(PKG + "ops/cuda_kernels.py(400): conv2_packed", 30.0, 10.0),
        launch(12.0, 1, tid=3), launch(14.0, 2, tid=3), launch(32.0, 3),
        launch(12.0, 4),                 # another thread at the same time
        kernel("void conv2_packed_tc_kernel<false>(int)", 1, 5.0),
        kernel("void conv2_packed_tc_kernel<false>(int)", 2, 6.0),
        kernel("void conv2_packed_tc_kernel<false>(int)", 3, 7.0),
        kernel("void conv2_packed_kernel<float>(int)", 4, 8.0)]
    dx, total = TS.summarize_within(events, "): conv2_packed_dx")
    assert dx == {"conv2_packed_tc_kernel": (11.0, 2)} and total == 11.0
    fwd, _ = TS.summarize_within(events, "): conv2_packed")
    assert fwd == {"conv2_packed_tc_kernel": (18.0, 3)}
    # a launch whose kernel record the profiler dropped
    assert TS.lost_launches(events) == []
    events.append(launch(16.0, 5, tid=3))
    assert [e["args"]["correlation"] for e in TS.lost_launches(events)] == [5]
    assert TS.summarize_within(events, "): conv2_packed_dx")[0] == dx


def test_load_events_finds_gz(tmp_path, capsys):
    with gzip.open(tmp_path / "host_1.1.pt.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": _fixture()}, fh)
    events = TS.load_events(str(tmp_path))
    assert TS.summarize(events)[1] == 1234.0
    with pytest.raises(FileNotFoundError):
        TS.load_events(str(tmp_path / "missing"))
    # the per-step report of the JAX package, with the copies
    total = TS.print_trace_report(str(tmp_path), 2,
                                  copies=TS.copy_rows(events))
    out = capsys.readouterr().out
    assert total == 1234.0 and "0.6 ms/step" in out
    assert "conv2_packed_tc_kernel" in out and "3 copy ops" in out


def test_copy_rows_attribute_bytes_to_package_frames(capsys):
    """Outermost copies only (the clone and copy_ inside `contiguous` are
    its own work), bytes from the first input's shape and dtype, source
    the innermost package frame; the JAX package's report format."""
    rows = TS.copy_rows(_fixture())
    assert rows == [
        (2 * 8 * 8 * 8 * 4 * 4, "aten::contiguous", "float[2, 8, 8, 8, 4]",
         "mri_epilepsy_diagnosis_torch/ops/packed.py(57): pack2"),
        (16 * 16 * 2, "aten::copy_", "c10::BFloat16[16, 16]",
         "mri_epilepsy_diagnosis_torch/models/unet.py(10): forward"),
        (3 * 8, "aten::copy_", "long int[3]", "?")]
    TS.print_copy_report(rows, top=5, by_src_top=5)
    out = capsys.readouterr().out
    assert "3 copy ops" in out and "pack2" in out and "forward" in out
    # the byte helper agrees with the JAX package's HLO one
    assert TS.shape_bytes([2, 4, 8], "c10::BFloat16") == (
        JTS.hlo_shape_bytes("bf16[2,4,8]{2,1,0}"))
    assert TS.shape_bytes([10], "float") == JTS.hlo_shape_bytes("f32[10]")


def test_collective_rows_count_backend_ranges():
    rows = TS.collective_rows(_fixture())
    assert [(r[0], r[1]) for r in rows] == [(4096, "all_reduce"),
                                            (128, "all_reduce"),
                                            (16, "broadcast")]
    # without backend ranges: c10d's record_param_comms events
    comms = [{"ph": "X", "cat": "cpu_op", "name": "record_param_comms",
              "pid": 1, "tid": 1, "ts": 0.0, "dur": 1.0,
              "args": {"Collective name": "allreduce", "dtype": "Float",
                       "In msg nelems": 10}},
             {"ph": "X", "cat": "cpu_op", "name": "record_param_comms",
              "pid": 1, "tid": 1, "ts": 2.0, "dur": 1.0,
              "args": {"Collective name": "allgather", "dtype": "BFloat16",
                       "In msg nelems": 100}}]
    assert TS.collective_rows(comms) == [
        (200, "all_gather", "record_param_comms", "BFloat16[100]"),
        (40, "all_reduce", "record_param_comms", "Float[10]")]


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """A real CPU trace of a few packed-layout ops and copies written by
    `profile_trace`, with the profiler's own `key_averages()`."""
    logdir = str(tmp_path_factory.mktemp("trace"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 8, 4)).astype(np.float32))
    with profile_trace(logdir, device="cpu") as prof:
        packed = P.pack2(x)
        y = x.permute(0, 4, 1, 2, 3).contiguous()
        z = (y.to(torch.bfloat16) + 1).sum()
    assert packed.shape[1] == 4 and bool(torch.isfinite(z))
    counts = {}
    for e in prof.key_averages():
        counts[e.key] = counts.get(e.key, 0) + e.count
    return logdir, counts


def test_profile_trace_writes_a_trace_the_reader_counts(cpu_trace):
    logdir, counts = cpu_trace
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json.gz")]
    assert len(files) == 1
    events = TS.load_events(logdir)
    host = TS.top_ops(events, "cpu", top=1000)
    assert host and all(counts[name] == c for name, _, c in host)
    assert {n for n, _, _ in host} == {k for k in counts
                                       if k.startswith("aten::")}
    # on the CPU there is no device activity, and the copies come with
    # their package frames (with_stack) and shapes (record_shapes)
    assert TS.summarize(events) == ({}, 0.0)
    sources = {r[3] for r in TS.copy_rows(events)}
    assert any(s.startswith("mri_epilepsy_diagnosis_torch/ops/packed.py")
               for s in sources), sources


def test_cli_prints_the_summary(cpu_trace, capsys):
    TS.main([cpu_trace[0], "--device-substr", "cpu", "--top", "5"])
    out = capsys.readouterr().out
    assert "op kinds" in out and "copy ops" in out and "aten::" in out
