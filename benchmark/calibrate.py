"""Readings for the check's limits: for each seed, a short window of a
cell as a run makes it, the program's numbers against the reference, and
the control's (the reference with its nets' operands in float8 put in the
program's place), in one process.  Benchmark runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 10

Prints one JSON line per seed.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import closed_loop, spec

    cell = spec.load(args.workload)
    path = os.path.join(tempfile.gettempdir(), "bench_calibrate_trace.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        out = closed_loop.run(cell, seed, args.seconds, False, time.perf_counter(), path,
                         control=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "numbers": out.numbers,
                          "control": out.control, "checked": out.checked,
                          "attempted": out.attempted, "setup_s": out.setup_s,
                          "window_s": out.window_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
