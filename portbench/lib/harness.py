"""Runs one cell once: finds its configuration, traffic and per-layer
metrics by name, drives the traffic's driver, reads the profiled
stretches, and builds the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own: `configs/<name>.json` (named by
BENCHMARK.json), `mixes/<traffic>.json` (whose `driver` names a module of
`drivers/`), `metrics/<metric>.py` (a `read(view)` that returns a number
or None).  A quantity that cells with different end-to-end metrics report
under names of their own (`mfu.train`, `mfu.patch`) has one reader,
`metrics/<name before its first dot>.py`, unless a name has its own file.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from . import trace as T
from .window import Stretches

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mri_epilepsy_diagnosis_tpu")


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise SystemExit(f"no config named {name!r} in BENCHMARK.json")


def load_mix(name: str) -> dict:
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The reader module of per-layer metric `name`: `metrics/<name>.py`,
    else `metrics/<name before its first dot>.py`."""
    here = root / "portbench" / "metrics"
    path = here / f"{name}.py"
    if not path.is_file():
        path = here / f"{name.split('.')[0]}.py"
    return load_module(path)


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The end-to-end or per-layer metric entries that cell `name`
    reports: those that list it, or list no cells and move (or are) an
    end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules
                   if k.split(".")[0] in FORBIDDEN})


def device_of(device: Optional[str], chips: int) -> torch.device:
    """The card, after checking that there are `chips` NVIDIA cards; or the
    CPU when asked for by name (the tests' dry runs)."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device is available")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} found")
    name = torch.cuda.get_device_name(0)
    if torch.version.cuda is None or "NVIDIA" not in name:
        raise SystemExit(f"portbench: {name} is not an NVIDIA card")
    return torch.device("cuda", 0)


def p95(values) -> float:
    return float(np.percentile(values, 95)) if len(values) else math.nan


def _pick(files, kind):
    """The trace of `kind` that lost no kernel records (else the one that
    lost fewest): (events, lost launches)."""
    best = None
    for k, path in files:
        if k != kind:
            continue
        events = json.loads(Path(path).read_text())["traceEvents"]
        lost = len(T.lost_launches(events))
        if best is None or lost < best[1]:
            best = (events, lost)
        if lost == 0:
            break
    return best if best is not None else ([], 0)


def trace_view(stretches: Stretches, out: dict) -> SimpleNamespace:
    plain, lost = _pick(stretches.files, "plain")
    stack, lost_stack = _pick(stretches.files, "stack")
    spans = T.stretches(plain)
    span = spans[0] if spans else (0.0, 0.0)
    work = dict(out["work"])
    return SimpleNamespace(
        plain=plain, stack=stack, span=span, lost=lost,
        lost_stack=lost_stack, stack_span=(T.stretches(stack) or [span])[0],
        steps=stretches.steps, work=work,
        devs=T.device_events(plain, span))


def breakdown(view) -> dict:
    rollup = T.summarize(view.devs)
    ops = sorted(rollup.items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(T.idle_gaps(view.devs, view.span),
                  key=lambda g: g[0] - g[1])[:10]
    tid = T.main_thread(view.plain)
    host = [e for e in view.plain if e.get("ph") == "X"
            and e.get("tid") == tid and e.get("name") != T.STRETCH
            and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver",
                                 "python_function", "user_annotation")]
    return {"device_ops": [[k, t / 1e6] for k, (t, _) in ops],
            "idle_gaps": [[T.host_activity(host, (a + b) / 2),
                           (b - a) / 1e6] for a, b in gaps]}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: Optional[str] = None, t_start: Optional[float] = None,
             root: Path = ROOT, mix_overrides: Optional[dict] = None,
             cfg_overrides: Optional[dict] = None, calibrate: bool = False):
    """Run cell `name` once; returns (result dict, check lines).  The
    result's keys are those of the benchmark's last line."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark(root)
    w = cell(bench, name)
    dev = device_of(device, w["chips"])
    cfg = {**load_config(bench, w["config"], root), **(cfg_overrides or {})}
    mix = {**load_mix(w["traffic"]), **(mix_overrides or {})}
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    stretches = (Stretches(mix["profile_start"], mix["profile_steps"])
                 if trace else None)
    state = {}

    def window_closed():
        state["t_closed"] = time.perf_counter()
        state["peak"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()

    marks = [("imports", time.perf_counter() - t_start)]

    def mark(what):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append((what, time.perf_counter() - t_start))

    ctx = SimpleNamespace(cfg=cfg, mix=mix, seed=int(seed), seconds=seconds,
                          device=dev, stretches=stretches, p95=p95,
                          window_closed=window_closed, free=free, mark=mark)
    ctx.calibrate = calibrate
    out = driver.run(ctx)
    checks = out["checks"]
    # a mix that gives no limit decides nothing: its runs are not correct
    correct = (bool(checks) and all(c["value"] <= c["limit"] for c in checks)
               and out["failed"] == 0 and out["attempted"] > 0)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {}}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": w["chips"], "memory_peak_bytes": state.get("peak", 0)}
    extra_trace = {}
    if not trace:
        e2e = dict(out["metrics"])
        e2e["setup_s"] = (out["t0"] - t_start, "s")
        for m in cell_metrics(bench, name, "end_to_end"):
            value, unit = e2e[m["name"]]
            result["metrics"][m["name"]] = {"value": value, "unit": unit}
    else:
        view = trace_view(stretches, out)
        for m in cell_metrics(bench, name, "per_layer"):
            value = reader(m["name"], root).read(view)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        span_s = (view.span[1] - view.span[0]) / 1e6
        dev_info["busy_s"] = T.busy_us(view.devs, view.span) / 1e6
        dev_info["window_s"] = span_s
        extra_trace = {"breakdown": breakdown(view),
                       "lost_kernel_records": view.lost}
        stretches.cleanup()
    result["device"] = dev_info
    result.update(extra_trace)
    if calibrate:
        result["extra"] = out.get("extra", {})
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    marks.append(("window_open", out["t0"] - t_start))
    lines = [f"seed {seed}"]
    lines += [f"setup {what} {t:.3f} s" for what, t in marks]
    lines += [f"check {c['name']} {c['value']!r} limit {c['limit']!r}"
              for c in checks]
    return result, lines
