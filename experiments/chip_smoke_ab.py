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


def summary(data: dict) -> dict:
    """The end-to-end numbers of one `chip_smoke.json`, and the B3
    recompute row (the `conv_axis` entry of the kernels line, under
    either of its names)."""
    fader = data.get("fader", {})
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
