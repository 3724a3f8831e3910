"""Reading a `torch.profiler` Chrome trace: a frozen copy of the arithmetic
of the port's trace reader (`op_kind`, the attribution of device events to
the Python frames that launched them, `lost_launches`), plus the device's
busy time and idle gaps over a marked stretch.  The program may change its
reader; the benchmark keeps this one.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_LAUNCHES = ("cuda_runtime", "cuda_driver")
STRETCH = "portbench::stretch"


def op_kind(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list (`void k<128, 4>(int)` -> `k`); other names are kept."""
    name = name.replace("(anonymous namespace)", "anonymous_namespace")
    out, depth = [], 0
    for ch in name.replace("->", "\0"):
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


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e.get("dur", 0.0))


def stretches(events: List[dict]) -> List[Tuple[float, float]]:
    """(start, end) in trace microseconds of each marked stretch."""
    return sorted((float(e["ts"]), _end(e)) for e in events
                  if e.get("ph") == "X" and e.get("name") == STRETCH)


def device_events(events: List[dict], span: Optional[Tuple[float, float]]
                  = None) -> List[dict]:
    """Kernels, copies and sets on the card, those starting inside `span`
    if given."""
    out = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    if span is not None:
        out = [e for e in out if span[0] <= float(e["ts"]) < span[1]]
    return out


def busy_intervals(devs: Iterable[dict], span: Tuple[float, float]
                   ) -> List[Tuple[float, float]]:
    """The union of the device events' intervals, clipped to `span`."""
    ivs = sorted((max(float(e["ts"]), span[0]), min(_end(e), span[1]))
                 for e in devs)
    out: List[List[float]] = []
    for a, b in ivs:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(devs: Iterable[dict], span: Tuple[float, float]) -> float:
    return sum(b - a for a, b in busy_intervals(devs, span))


def idle_gaps(devs: Iterable[dict], span: Tuple[float, float]
              ) -> List[Tuple[float, float]]:
    """The stretches of `span` in which no device event ran."""
    gaps, t = [], span[0]
    for a, b in busy_intervals(devs, span):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if span[1] > t:
        gaps.append((t, span[1]))
    return gaps


def summarize(devs: Iterable[dict]) -> Dict[str, Tuple[float, int]]:
    """{op_kind: (total us, count)} of device events."""
    out: Dict[str, Tuple[float, int]] = {}
    for e in devs:
        k = op_kind(e.get("name", "?"))
        t, c = out.get(k, (0.0, 0))
        out[k] = (t + float(e.get("dur", 0.0)), c + 1)
    return out


def lost_launches(events: List[dict]) -> List[dict]:
    """Host kernel launches whose kernel record the profiler dropped."""
    kernels = {e.get("args", {}).get("correlation") for e in events
               if e.get("cat") == "kernel"}
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_LAUNCHES
            and "Launch" in e.get("name", "") and "Kernel" in e["name"]
            and e.get("args", {}).get("correlation") not in kernels]


def _by_thread(events, keep):
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
    lane = lanes.get((e.get("pid"), e.get("tid")))
    if lane is None:
        return None
    starts, evs = lane
    ts, end = float(e["ts"]), _end(e)
    for f in reversed(evs[:bisect.bisect_right(starts, ts)]):
        if f is not e and _end(f) >= end:
            return f
    return None


def launched_within(events: List[dict], frame_substr: str) -> set:
    """Correlation ids of the host launches made inside a Python frame whose
    name holds `frame_substr`, on any thread (the autograd thread too)."""
    frames = _by_thread(events, lambda e: e.get("cat") == "python_function"
                        and frame_substr in e.get("name", ""))
    return {e.get("args", {}).get("correlation") for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_LAUNCHES
            and _encloser(frames, e) is not None}


def host_activity(host: List[dict], t: float) -> str:
    """The innermost of the host events `host` (one thread's frames, ops and
    runtime calls) running at trace time `t`; "python (no op)" when none
    is."""
    best = None
    for e in host:
        if float(e["ts"]) <= t <= _end(e) and (
                best is None or float(e.get("dur", 0.0))
                < float(best.get("dur", 0.0))):
            best = e
    return "python (no op)" if best is None else best.get("name", "?")


def main_thread(events: List[dict]):
    """The thread that recorded the stretch marker."""
    for e in events:
        if e.get("name") == STRETCH:
            return e.get("tid")
    return None
