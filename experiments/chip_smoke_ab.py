#!/usr/bin/env python3
"""Parent against change on one card: `chip_smoke.py` of two checkouts of
the PyTorch/CUDA port, run in turns (P C C P by default), and the
end-to-end numbers of each run side by side.

    python3 experiments/chip_smoke_ab.py PARENT_DIR CHANGE_DIR [--order PCCP]

Each directory holds a full checkout (for example unpacked from `git
archive`).  Each run writes its `chiprun_out/chip_smoke.json` and log
inside its own directory; this script reads them and writes one summary,
`chiprun_out/chip_smoke_ab.json` in the current directory (with a copy
of each run's `chip_smoke.json`), and prints it.  Runs on the card only:
`chip_smoke.py` exits nonzero without one, and so does this script.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time


def _get(d, *path):
    for k in path:
        if not isinstance(d, dict) or k not in d:
            return None
        d = d[k]
    return d


def _kernel(data, name, key="ms", sub=None):
    for e in data.get("kernels", []):
        if e["name"] == name:
            return e.get(key) if sub is None else _get(e, sub, key)
    return None


def _sites(rows, key="ms"):
    return {r["site"]: r.get(key) for r in rows or []}


def summary(data: dict) -> dict:
    """The end-to-end numbers of one `chip_smoke.json`, the B3 recompute
    row (the `conv_axis` entry of the kernels line, under either of its
    names), B1's phase-3 serving times, and int8 serving: K1 and K2 summed
    over their sites of one batch-8 forward and per site, their bf16
    yardsticks, vol/s and device ms of a served batch; the zoo's 192^3 and
    64^3 step times, eval time, peak memory and profiled device time."""
    fader = data.get("fader", {})
    k1 = data.get("int8_k1_sites") or []
    k2 = data.get("int8_k2_sites") or []
    int8 = data.get("int8_serving", {})
    recompute = {}
    for name in ("conv_axis_tc", "conv_axis"):
        if _kernel(data, name) is not None:
            recompute = {"entry": name, "ms": _kernel(data, name),
                         "bound_ms": _kernel(data, name, "bound_ms"),
                         "ae_step_ms": _kernel(data, name, "ms", "ae_step")}
            break
    return {
        "alternation_ms": fader.get("ms_per_alternation_batch"),
        "alternation_device_only_ms": _get(fader, "profile_device_only",
                                           "device_ms"),
        "alternation_device_only_idle": _get(fader, "profile_device_only",
                                             "idle_share"),
        "alternation_conv_axis_ms": _get(fader, "profile_device_only",
                                         "conv_axis_ms"),
        "recompute_row": recompute,
        "b1_tc_serving_ms": _kernel(data, "conv2_packed_tc"),
        "b1_tc_bn_act_serving_ms": _kernel(data, "conv2_packed_tc_bn_act"),
        "k1_ms": sum(r["ms"] for r in k1) if k1 else None,
        "k1_raw_int32_ms": sum(r["raw_int32_ms"] for r in k1) if k1 else None,
        "k1_sites_ms": _sites(k1),
        "k1_bf16_b1_ms": sum(r["bf16_b1_ms"] for r in k1) if k1 else None,
        "k2_ms": sum(r["ms"] for r in k2) if k2 else None,
        "k2_sites_ms": _sites(k2),
        "k2_bf16_composed_cudnn_ms": (sum(r["bf16_composed_cudnn_ms"]
                                          for r in k2) if k2 else None),
        "int8_vol_per_s": int8.get("vol_per_s"),
        "int8_ms_per_batch": int8.get("ms_per_batch"),
        "int8_device_ms_per_batch": _get(int8, "profile", "device_ms"),
        "int8_idle_share": _get(int8, "profile", "idle_share"),
        "ae_step_ms": _get(data, "ae_train", "ms_per_step"),
        "serving_int16_vol_per_s": _get(data, "serving", "int16_vol_per_s"),
        "serving_uint8_vol_per_s": _get(data, "serving", "uint8_vol_per_s"),
        "ensemble_vol_per_s": _get(data, "ensemble", "int16_vol_per_s"),
        "train_step_ms": _get(data, "training", "ms_per_step"),
        "accumulated_step_ms": _get(data, "accumulation", "ms_per_step"),
        "patch_step_ms": _get(data, "from_files", "patches", "ms_per_step"),
        "sliding_window_ms": _get(data, "sliding_window", "ms_per_volume"),
        "dilated_cnn_ms": _get(data, "classification", "dilated_cnn",
                               "ms_per_step"),
        "voxresnet_ms": _get(data, "classification", "voxresnet",
                             "ms_per_step"),
        "zoo": {name: {
            "volume_step_ms": _get(z, "timing", "volume", "ms_per_step"),
            "patch_step_ms": _get(z, "timing", "patch", "ms_per_step"),
            "eval_ms": _get(z, "timing", "volume", "eval_ms"),
            "peak_memory_gb": _get(z, "timing", "volume", "peak_memory_gb"),
            "device_ms": _get(z, "timing", "volume", "profile", "device_ms"),
            "idle_share": _get(z, "timing", "volume", "profile",
                               "idle_share")}
            for name, z in (data.get("zoo") or {}).items()
            if name != "launches"},
        "phase12_s": data.get("phase12_s"),
        "seconds": data.get("seconds"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", default="PCCP")
    args = ap.parse_args()
    dirs = {"P": os.path.abspath(args.parent),
            "C": os.path.abspath(args.change)}
    runs = []
    for i, which in enumerate(args.order):
        d = dirs[which]
        log = os.path.join(d, "chiprun_out", f"ab_run{i}.log")
        os.makedirs(os.path.dirname(log), exist_ok=True)
        t0 = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=d,
                                stdout=f, stderr=subprocess.STDOUT).returncode
        wall = time.perf_counter() - t0
        path = os.path.join(d, "chiprun_out", "chip_smoke.json")
        data = json.load(open(path)) if rc == 0 else {}
        if rc == 0:
            os.makedirs("chiprun_out", exist_ok=True)
            shutil.copy(path, os.path.join("chiprun_out",
                                           f"ab_run{i}_{which}.json"))
        row = {"run": i, "tree": which, "rc": rc, "wall_s": wall,
               **(summary(data) if rc == 0 else {})}
        print(json.dumps(row), flush=True)
        runs.append(row)
        if rc != 0:
            print(open(log).read()[-4000:], file=sys.stderr)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_ab.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "order": args.order, "runs": runs}, f,
                  indent=1)
    print(smi)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
