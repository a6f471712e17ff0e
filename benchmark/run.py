"""The benchmark of the PyTorch/CUDA port (``truely_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the cards of this machine: set-up
(weights and content from the seed, the detector warmed at the cell's
shapes), a measured window of ``--seconds``, then the check of what the
window produced against the plain reference.  Prints the check's numbers
beside their limits as the last lines of standard error, and one JSON
result line last on standard output: the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics from a traced run.  Exits 2
without a result when CUDA is missing or has fewer cards than the cell
asks for, and 3 when a JAX module or the JAX package was loaded by the
time the result is ready (its metrics read).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout, so that only
# the first run of a checkout builds (the port's own kernels build into
# its package's ``_build/``).
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from benchmark import closed_loop, outcome, spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    trace_path = os.path.join(tempfile.gettempdir(), f"bench_trace_{os.getpid()}.json")
    out = closed_loop.run(cell, args.seed, args.seconds, bool(args.trace), T_START, trace_path)
    line, checks = outcome.report(cell, out, bool(args.trace))
    # After the readers ran: what they or the model's counts load counts too.
    bad = outcome.forbidden_modules()
    if bad:
        print(f"loaded in the result's process: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("\n".join(checks), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
