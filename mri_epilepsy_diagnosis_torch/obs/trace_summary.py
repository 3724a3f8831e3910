"""Profiler-trace rollups without TensorBoard (counterpart of the JAX
package's `obs/trace_summary.py`, for torch.profiler's Kineto traces).

`obs.profile.profile_trace` writes one gzipped Chrome trace,
`<logdir>/*.pt.trace.json.gz`.  This module reads it directly:

- `summarize` / `top_ops`: device time and launches by kernel kind (the
  name without template arguments and parameter list, so the
  instantiations of one kernel roll up together) or by full name.  Device
  events are picked by their category (`kernel`, `gpu_memcpy`,
  `gpu_memset`); `device_substr="cpu"` rolls up the host's ops instead.
  `summarize_within` keeps the device events launched from inside given
  Python frames (matched through the trace's correlation ids);
  `lost_launches` finds the launches whose kernel record the profiler
  dropped.
- `copy_rows`: the host's copy ops (`aten::copy_`, `aten::contiguous`,
  `aten::clone`, outermost only) with their bytes from the recorded shapes
  and dtypes, each mapped to the innermost Python frame of
  `mri_epilepsy_diagnosis_torch` that encloses it (the trace's
  `python_function` events, recorded with `with_stack=True`): the
  counterpart of the JAX package's `hlo_copy_rows` over optimized HLO.
- `collective_rows`: the c10d collectives the process groups ran (the
  backends' `nccl:*` / `gloo:*` ranges, else `record_param_comms`), with
  their bytes and kind: the counterpart of `hlo_collective_rows`.
- `span_rows`: the host's named ranges (`obs.span`'s `seg::` and `data::`
  spans, any `record_function`) with their count, host time and the
  device idle time inside them: which host work the card waited on.

CLI:
    python -m mri_epilepsy_diagnosis_torch.obs.trace_summary LOGDIR \\
        [--top 25] [--iters 10] [--device-substr cuda]
"""
from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
PACKAGE = "mri_epilepsy_diagnosis_torch/"
COPY_OPS = ("aten::copy_", "aten::contiguous", "aten::clone")
BACKENDS = ("nccl:", "gloo:")
HOST_LAUNCHES = ("cuda_runtime", "cuda_driver")
# the profiler's dtype names (c10 scalar types as recorded with shapes)
ELEM_BYTES = {"float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2,
              "long int": 8, "int": 4, "short int": 2, "signed char": 1,
              "unsigned char": 1, "bool": 1, "c10::complex<float>": 8,
              "c10::complex<double>": 16, "c10::Float8_e4m3fn": 1,
              "c10::Float8_e5m2": 1,
              # record_param_comms' dtype names
              "Float": 4, "Double": 8, "Half": 2, "BFloat16": 2, "Long": 8,
              "Int": 4, "Short": 2, "Char": 1, "Byte": 1, "Bool": 1}
_COLLECTIVE_NAMES = {"allreduce": "all_reduce", "allgather": "all_gather",
                     "all_gather_into_tensor": "all_gather",
                     "reduce_scatter_tensor": "reduce_scatter",
                     "alltoall": "all_to_all", "alltoall_base": "all_to_all"}


def _find_trace_file(path: str) -> str:
    """Accept a trace file or a `profile_trace` logdir; return the newest
    `*.pt.trace.json[.gz]` in it."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "*.pt.trace.json.gz"))
                  + glob.glob(os.path.join(path, "*.pt.trace.json")),
                  key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {path}")
    return hits[-1]


def load_events(path: str) -> List[dict]:
    f = _find_trace_file(path)
    opener = gzip.open if f.endswith(".gz") else open
    with opener(f, "rt") as fh:
        return json.load(fh)["traceEvents"]


def op_kind(name: str) -> str:
    """Canonical kind: a kernel's name without its return type, template
    arguments and parameter list (`void k<128, 4, ...>(int, ...)` -> `k`);
    names without them (`aten::copy_`) are kept."""
    name = name.replace("(anonymous namespace)", "anonymous_namespace")
    out, depth = [], 0
    for ch in name.replace("->", "\0"):     # an arrow closes no bracket
        if ch in "<(":
            depth += 1
        elif ch in ">)" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    kind = "".join(out).replace("\0", "->").strip()
    if kind.startswith("void "):
        kind = kind[5:].strip()
    return kind or name


def _host_ops(events: List[dict]):
    """The host's ops as the profiler's `key_averages()` counts them: an op
    whose enclosing op on its thread has the same name and no other child
    (an overload calling itself, `aten::sum` -> `aten::sum`) is not
    counted apart."""
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    ops.sort(key=lambda e: (e.get("pid"), e.get("tid"), float(e["ts"]),
                            -float(e.get("dur", 0.0))))
    parent, children, stack = {}, {}, []
    for e in ops:
        end = float(e["ts"]) + float(e.get("dur", 0.0))
        while stack and (stack[-1][0] != (e.get("pid"), e.get("tid"))
                         or stack[-1][1] < end):
            stack.pop()
        if stack:
            p = stack[-1][2]
            parent[id(e)] = p
            children[id(p)] = children.get(id(p), 0) + 1
        stack.append(((e.get("pid"), e.get("tid")), end, e))
    for e in ops:
        p = parent.get(id(e))
        if not (p is not None and p.get("name") == e.get("name")
                and children[id(p)] == 1):
            yield e


def _selected(events: List[dict], device_substr: str):
    """Complete events of the selected device: kernels and copies of the
    CUDA devices (`cuda`; `cuda:N` for device N alone), or the host's ops
    (`cpu`, counted as `_host_ops`)."""
    sel = device_substr.lower()
    if sel.startswith("cpu"):
        yield from _host_ops(events)
        return
    index = int(sel.split(":", 1)[1]) if ":" in sel else None
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        if index is not None and e.get("args", {}).get("device") != index:
            continue
        yield e


def summarize(events: List[dict], device_substr: str = "cuda",
              ) -> Tuple[Dict[str, Tuple[float, int]], float]:
    """Roll the selected device's events up by `op_kind`.  Returns
    ({kind: (total_us, count)}, total_us)."""
    rollup: Dict[str, Tuple[float, int]] = {}
    total = 0.0
    for e in _selected(events, device_substr):
        dur = float(e.get("dur", 0.0))
        kind = op_kind(e.get("name", "?"))
        t, c = rollup.get(kind, (0.0, 0))
        rollup[kind] = (t + dur, c + 1)
        total += dur
    return rollup, total


def top_ops(events: List[dict], device_substr: str = "cuda", top: int = 25,
            ) -> List[Tuple[str, float, int]]:
    """(full name, total us, count) of the selected device's events, by
    total time."""
    agg: Dict[str, Tuple[float, int]] = {}
    for e in _selected(events, device_substr):
        name = e.get("name", "?")
        t, c = agg.get(name, (0.0, 0))
        agg[name] = (t + float(e.get("dur", 0.0)), c + 1)
    rows = sorted(((n, t, c) for n, (t, c) in agg.items()),
                  key=lambda r: -r[1])
    return rows[:top]


def lost_launches(events: List[dict]) -> List[dict]:
    """The host's kernel launches (`cudaLaunchKernel`, `cuLaunchKernel`,
    ...) whose kernel the trace holds no record of.  The profiler drops a
    kernel's record now and then (on an H100, about one launch in a few
    thousand), and every count over such a trace falls short by as many."""
    kernels = {e.get("args", {}).get("correlation") for e in events
               if e.get("cat") == "kernel"}
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_LAUNCHES
            and "Launch" in e.get("name", "") and "Kernel" in e["name"]
            and e.get("args", {}).get("correlation") not in kernels]


def summarize_within(events: List[dict], frame_substr: str,
                     device_substr: str = "cuda",
                     ) -> Tuple[Dict[str, Tuple[float, int]], float]:
    """`summarize` over the device events launched from inside a Python
    frame whose name holds `frame_substr` (`"): conv2_packed_dx"`): each
    kernel or copy is tied to its host launch by the trace's correlation
    id, and the launch to the frames that enclose it on its thread."""
    frames = _by_thread(events, lambda e: e.get("cat") == "python_function"
                        and frame_substr in e.get("name", ""))
    inside = set()
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in HOST_LAUNCHES
                and _encloser(frames, e) is not None):
            inside.add(e.get("args", {}).get("correlation"))
    return summarize([e for e in _selected(events, device_substr)
                      if e.get("args", {}).get("correlation") in inside],
                     device_substr)


# ---------------------------------------------------------------------------
# copies and collectives of the host's ops, with their bytes and sources
# ---------------------------------------------------------------------------


def shape_bytes(dims, dtype: str) -> int:
    """Bytes of a tensor of shape `dims` and profiler dtype name `dtype`
    (4 bytes an element for a name it does not know)."""
    n = 1
    for d in dims:
        n *= int(d)
    return n * ELEM_BYTES.get(dtype, 4)


def _tensor_inputs(e: dict):
    """(dims, dtype) of the recorded tensor inputs of a host op; a tensor
    list contributes each of its tensors."""
    args = e.get("args", {})
    for dims, dtype in zip(args.get("Input Dims", []),
                           args.get("Input type", [])):
        if dims and isinstance(dims[0], list):        # a TensorList
            yield from ((d, dtype) for d in dims if d)
        elif dims or dtype in ELEM_BYTES:
            yield dims, dtype


def _shape_str(dims, dtype) -> str:
    return f"{dtype}[{', '.join(str(d) for d in dims)}]"


def _by_thread(events, keep):
    """{(pid, tid): (start times, events)} of the complete events `keep`
    accepts, sorted by start."""
    lanes: Dict[tuple, list] = {}
    for e in events:
        if e.get("ph") == "X" and keep(e):
            lanes.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = {}
    for k, evs in lanes.items():
        evs.sort(key=lambda e: float(e["ts"]))
        out[k] = ([float(e["ts"]) for e in evs], evs)
    return out


def _encloser(lanes, e) -> Optional[dict]:
    """The innermost event of `lanes` on `e`'s thread that encloses `e`."""
    lane = lanes.get((e.get("pid"), e.get("tid")))
    if lane is None:
        return None
    starts, evs = lane
    ts = float(e["ts"])
    end = ts + float(e.get("dur", 0.0))
    for f in reversed(evs[:bisect.bisect_right(starts, ts)]):
        if f is not e and float(f["ts"]) + float(f.get("dur", 0.0)) >= end:
            return f
    return None


def _source(frame: Optional[dict]) -> str:
    """`path(line): function` of a package frame, from the package on."""
    if frame is None:
        return "?"
    name = frame.get("name", "?")
    return name[name.find(PACKAGE):] if PACKAGE in name else name


def copy_rows(events: List[dict]) -> List[Tuple[int, str, str, str]]:
    """The outermost host copy ops (`COPY_OPS`) as (bytes, op name, shape,
    source), largest first; bytes are the first tensor input's (what the
    op writes), source the innermost enclosing Python frame of the port's
    package ('?' without one)."""
    copies = _by_thread(events, lambda e: e.get("cat") == "cpu_op"
                        and e.get("name") in COPY_OPS)
    frames = _by_thread(events, lambda e: e.get("cat") == "python_function"
                        and PACKAGE in e.get("name", ""))
    rows = []
    for _, evs in copies.values():
        for e in evs:
            if _encloser(copies, e) is not None:
                continue                  # part of an outer copy op
            inputs = list(_tensor_inputs(e))
            dims, dtype = inputs[0] if inputs else ([], "?")
            rows.append((shape_bytes(dims, dtype), e["name"],
                         _shape_str(dims, dtype),
                         _source(_encloser(frames, e))))
    rows.sort(key=lambda r: (-r[0], r[1:]))
    return rows


def collective_rows(events: List[dict]) -> List[Tuple[int, str, str, str]]:
    """Every collective a process group ran as (bytes, kind, event name,
    shapes), largest first.  The backends' ranges (`nccl:all_reduce`,
    `gloo:all_reduce`, ...) on the host come first (their projections on
    the card's timeline are not counted); a trace without them falls back on
    c10d's `record_param_comms` events (`In msg nelems` x `dtype`)."""
    rows = []
    for e in events:
        name = e.get("name", "")
        if (e.get("ph") == "X" and name.startswith(BACKENDS)
                and e.get("cat") in ("user_annotation", "cpu_op")):
            inputs = list(_tensor_inputs(e))
            rows.append((sum(shape_bytes(d, t) for d, t in inputs),
                         name.split(":", 1)[1], name,
                         " ".join(_shape_str(d, t) for d, t in inputs)))
    if not rows:
        for e in events:
            args = e.get("args", {})
            if e.get("ph") != "X" or e.get("name") != "record_param_comms":
                continue
            kind = str(args.get("Collective name", "?"))
            n = int(args.get("In msg nelems", 0) or 0)
            dtype = str(args.get("dtype", "?"))
            rows.append((shape_bytes([n], dtype),
                         _COLLECTIVE_NAMES.get(kind, kind),
                         "record_param_comms", f"{dtype}[{n}]"))
    rows.sort(key=lambda r: (-r[0], r[1:]))
    return rows


def _busy_intervals(events: List[dict]) -> List[Tuple[float, float]]:
    """The union of the device events' intervals, sorted."""
    ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    out: List[List[float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def span_rows(events: List[dict]
              ) -> List[Tuple[str, int, float, Optional[float]]]:
    """Every host range (`user_annotation`: `obs.span`, `record_function`)
    by name as (name, count, host us, device idle us), by host time: the
    idle us are the time inside the name's ranges in which no kernel, copy
    or memset ran on any card (None in a trace without device events).  A
    range inside another counts in both names' rows."""
    busy = _busy_intervals(events)
    starts = [a for a, _ in busy]
    rows: Dict[str, List[float]] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        covered = 0.0
        for s, t in busy[max(bisect.bisect_right(starts, a) - 1, 0):]:
            if s >= b:
                break
            covered += max(0.0, min(t, b) - max(s, a))
        row = rows.setdefault(e.get("name", "?"), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += b - a
        row[2] += (b - a) - covered
    out = [(name, int(c), t, idle if busy else None)
           for name, (c, t, idle) in rows.items()]
    out.sort(key=lambda r: (-r[2], r[0]))
    return out


def print_copy_report(rows: List[Tuple[int, str, str, str]], top: int = 25,
                      by_src_top: int = 20) -> None:
    """Top copies by bytes, and a rollup by source frame."""
    tot = sum(r[0] for r in rows)
    print(f"\n== {len(rows)} copy ops; total {tot / 1e9:.2f} GB ==")
    for b, name, shp, src in rows[:top]:
        print(f"{b/1e6:9.1f} MB  {name:18s} {shp:44.44s} {src[:90]}")
    by_src: Dict[str, Tuple[int, int]] = {}
    for b, _, _, src in rows:
        t, c = by_src.get(src, (0, 0))
        by_src[src] = (t + b, c + 1)
    print("\n== copy bytes by source frame ==")
    for k, (b, c) in sorted(by_src.items(),
                            key=lambda kv: -kv[1][0])[:by_src_top]:
        print(f"{b/1e6:9.1f} MB {c:4d}x  {k[:90]}")


def print_trace_report(trace_dir: str, iters: int,
                       copies: Optional[List[Tuple[int, str, str, str]]]
                       = None, kinds_top: int = 16, ops_top: int = 25,
                       header_extra: str = "") -> float:
    """Per-step kind rollup and top individual device ops, then the copy
    report when `copies` (`copy_rows` of the same trace) is given.
    Returns the total device us."""
    events = load_events(trace_dir)
    rollup, total = summarize(events)
    print(f"\n== trace rollup ({total / iters / 1e3:.1f} ms/step"
          f"{header_extra}) ==")
    for kind, (t, c) in sorted(rollup.items(),
                               key=lambda kv: -kv[1][0])[:kinds_top]:
        print(f"{kind[:40]:40s} {t/iters/1e3:8.2f} ms/step "
              f"{100*t/max(total, 1e-12):5.1f}% {c:6d}")
    print("\n== top individual device ops ==")
    for name, t, _ in top_ops(events, top=ops_top):
        print(f"{name:60.60s} {t/iters/1e3:8.2f} ms/step")
    if copies is not None:
        print_copy_report(copies)
    return total


def print_summary(path: str, top: int = 25, iters: Optional[int] = None,
                  device_substr: str = "cuda") -> None:
    events = load_events(path)
    rollup, total = summarize(events, device_substr)
    div = iters or 1
    unit = "ms/iter" if iters else "ms"
    print(f"device total: {total / div / 1e3:.2f} {unit}"
          f"  ({len(rollup)} op kinds)")
    lost = lost_launches(events)
    if lost:
        print(f"the profiler dropped the records of {len(lost)} kernel "
              "launches: counts fall short by as many")
    print(f"{'op kind':42s} {'time':>12s} {'share':>7s} {'count':>7s}")
    for kind, (t, c) in sorted(rollup.items(),
                               key=lambda kv: -kv[1][0])[:top]:
        print(f"{kind:42.42s} {t / div / 1e3:9.2f} {unit} "
              f"{100 * t / max(total, 1e-12):6.1f}% {c:7d}")
    print("\ntop individual ops:")
    for name, t, c in top_ops(events, device_substr, top=min(top, 15)):
        print(f"{name:42.42s} {t / div / 1e3:9.2f} {unit} "
              f"{100 * t / max(total, 1e-12):6.1f}% {c:7d}")
    copies = copy_rows(events)
    if copies:
        print_copy_report(copies, top=min(top, 15))
    spans = span_rows(events)
    if spans:
        print(f"\n== host spans: {unit}, and the device idle inside ==")
        for name, c, t, idle in spans[:top]:
            idle_s = ("-" if idle is None
                      else f"{idle / div / 1e3:9.2f} {unit} idle")
            print(f"{name:42.42s} {t / div / 1e3:9.2f} {unit} {c:7d}  "
                  f"{idle_s}")
    collectives = collective_rows(events)
    if collectives:
        kinds: Dict[str, Tuple[int, int]] = {}
        for b, kind, _, _ in collectives:
            t, c = kinds.get(kind, (0, 0))
            kinds[kind] = (t + b, c + 1)
        print("\n== collectives ==")
        for kind, (b, c) in sorted(kinds.items()):
            print(f"{kind:20s} {c:6d}x {b / 1e6:10.3f} MB")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", help="trace file or profile_trace logdir")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--iters", type=int, default=None,
                   help="divide times by this (per-step numbers)")
    p.add_argument("--device-substr", default="cuda",
                   help="cuda (every card), cuda:N, or cpu (host ops)")
    args = p.parse_args(argv)
    print_summary(args.path, args.top, args.iters, args.device_substr)


if __name__ == "__main__":
    main()
