"""Readings that the limits of a training cell are set from, on the card
at the cell's own size: for each seed, the numbers of a sound run of the
program, of the control (the plain reference computed in float8 in
the program's place) and of a fault (the reference stepping on half of
each batch), each against the float32 reference.  A short window per
seed: the readings need none.

    python3 portbench/tools/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 1] [--repeat-worst K] [--out calibrate_<cell>.json]

`--repeat-worst K` runs again, twice each, the seeds on which the program
read its largest number of each of the first K of `REPEAT_ON`: a
reading that a seed repeats belongs to its inputs, one that it does not
is noise of the run.

This is not part of a benchmark run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import compare, harness  # noqa: E402

# the numbers whose worst seeds `--repeat-worst` runs again, in this order
REPEAT_ON = ("grad_shape_gap", "grad_median_gap", "stats_gap", "grad_conv_gap")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    p.add_argument("--dtype", default=None,
                   help="run the program in this dtype (a witness run)")
    p.add_argument("--repeat-worst", type=int, default=0)
    args = p.parse_args(argv)
    rows = []
    for seed in args.seeds:
        rows.append(_row(args, seed))
    worst = []
    for name in REPEAT_ON[:args.repeat_worst]:
        seed = max(rows, key=lambda r: r["prog"][name])["seed"]
        if seed not in worst:
            worst.append(seed)
    for seed in worst:
        for _ in range(2):
            rows.append(_row(args, seed))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    for side in ("prog", "control", "half_batch"):
        for name in rows[0][side]:
            vals = [r[side][name] for r in rows]
            print(f"{side:10s} {name:10s} min {min(vals):.6g} "
                  f"max {max(vals):.6g}")


def _row(args, seed):
    """One seed's readings and numbers."""
    t = time.perf_counter()
    result, _ = harness.run_cell(
        args.workload, seed, args.seconds, False, calibrate=True,
        cfg_overrides={"dtype": args.dtype} if args.dtype else None)
    ex = result["extra"]
    row = {"seed": seed, "seconds": time.perf_counter() - t,
           "metrics": result["metrics"], "readings": ex}
    for side in ("prog", "control", "half_batch"):
        row[side] = compare.training_numbers(ex[side], ex["ref"])
        row[side + "_worst"] = {
            k: compare.worst_leaves(ex[side], ex["ref"], k)
            for k in ("grads", "change", "stats")}
    print(json.dumps({k: row[k] for k in
                      ("seed", "seconds", "prog", "control",
                       "half_batch")}), flush=True)
    return row


if __name__ == "__main__":
    main()
