"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the NVIDIA cards the cell
asks for; without them it exits with an error and prints no result.  The
last line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` also `breakdown`, and last
`checks`: each number compared with its limit); the last lines of
standard error repeat the checks.  With `--trace 0` the metrics are the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read
from profiled stretches of the same window.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.lib import harness

    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
