"""Per-stage timing and device profiling (counterpart of
``truely_tpu/utils/profiling.py``).

- ``StageTimer`` accumulates named host-side stage durations and reports a
  breakdown.
- ``measure_forced`` times a step on the card: CUDA events around chains
  of ``n_lo`` and ``n_hi`` calls, after ``torch.cuda.synchronize``, and the
  slope between them, so a constant cost per chain cancels.  The JAX
  version chains each call's input to the previous output and forces the
  chain with a scalar fetch, because ``block_until_ready`` on its remote
  TPU runtime did not wait for the device.  That does not hold on CUDA:
  calls on one stream run in order, and an event recorded after them
  completes only when they have, so the calls need no data dependency.
- ``measure_ingraph`` captures the chain as a CUDA graph and replays it
  (in place of the JAX ``fori_loop``), for steps so short that the host's
  cost of issuing them would be measured instead of the device.
- ``device_op_table`` and ``top_device_ops`` read a ``torch.profiler``
  Chrome trace into device time per kernel name.
- ``profile_trace`` wraps ``torch.profiler`` around a section and writes
  its Chrome trace.  Unlike the JAX version it raises when the profiler
  fails.

The timers take an injectable ``timer`` (and ``measure_ingraph`` a
``capture``), so the arithmetic runs without a card.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch

# Kineto's categories of the events that ran on the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class StageTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, float]:
        return dict(self.totals)

    def summary(self) -> str:
        total = sum(self.totals.values())
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            lines.append(
                f"{name:>10}: {t * 1000:9.1f} ms ({pct:4.1f}%) over "
                f"{self.counts[name]} calls"
            )
        return "\n".join(lines)


def cuda_event_seconds(fn: Callable[[], Any]) -> float:
    """Seconds of device time from an event before ``fn()``'s launches to
    one after them, the device synchronised first and last."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def _slope(run: Callable[[int], float], n_lo: int, n_hi: int, trials: int) -> float:
    return min((run(n_hi) - run(n_lo)) / (n_hi - n_lo) for _ in range(trials))


def measure_forced(
    step: Callable[[Any], Any],
    arg: Any,
    *,
    n_lo: int = 2,
    n_hi: int = 5,
    trials: int = 3,
    warmup: int = 2,
    timer: Callable[[Callable[[], Any]], float] = cuda_event_seconds,
) -> float:
    """Seconds per call of ``step(arg)`` on the card: the best slope
    ``(t(n_hi) - t(n_lo)) / (n_hi - n_lo)`` over ``trials`` trials, where
    ``t(n)`` is ``timer`` around ``n`` calls (CUDA events by default)."""

    def chain(n: int) -> float:
        def calls():
            for _ in range(n):
                step(arg)
        return timer(calls)

    for _ in range(warmup):
        chain(1)
    return _slope(chain, n_lo, n_hi, trials)


def cuda_graph(fn: Callable[[], Any]) -> Callable[[], None]:
    """``fn``'s launches captured as a CUDA graph; returns its replay.
    ``fn`` runs once on a side stream first, so that what it sets up on
    first use (allocations, library handles) is not captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def measure_ingraph(
    step: Callable[..., Any],
    *args: Any,
    n_lo: int = 2,
    n_hi: int = 10,
    trials: int = 3,
    carry_init: Any = None,
    timer: Callable[[Callable[[], Any]], float] = cuda_event_seconds,
    capture: Callable[[Callable[[], Any]], Callable[[], Any]] = cuda_graph,
) -> float:
    """Seconds per call of ``step(carry, *args) -> carry``, with chains of
    ``n_lo`` and ``n_hi`` calls each captured once (``capture``, a CUDA
    graph by default) and replayed under ``timer``: one launch per chain,
    so the host's cost per call drops out.  ``args`` and ``carry_init``
    must stay at their addresses (a graph replays on the tensors it
    captured).  Returns the best slope over ``trials`` trials.  The JAX
    version threads a token through every heavy input so that XLA cannot
    hoist loop-invariant work out of its ``fori_loop``; a captured graph
    runs every launch it recorded, so ``step`` needs no token."""

    def chain(n: int) -> Callable[[], Any]:
        def calls():
            carry = carry_init
            for _ in range(n):
                carry = step(carry, *args)
            return carry
        return capture(calls)

    replays = {n: chain(n) for n in (n_lo, n_hi)}
    for n in (n_lo, n_hi):
        timer(replays[n])  # warm
    return _slope(lambda n: timer(replays[n]), n_lo, n_hi, trials)


def _trace_files(trace_dir: str) -> List[str]:
    if os.path.isfile(trace_dir):
        return [trace_dir]
    found = []
    for pattern in ("*.json", "*.json.gz"):
        found += glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)
    return sorted(found)


def _load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def device_op_table(
    trace_dir: str, *, categories: Sequence[str] = DEVICE_CATEGORIES
) -> List[Tuple[str, float, int]]:
    """Device time per op name from ``torch.profiler`` Chrome traces.

    Reads ``trace_dir`` (a trace file, or a directory searched recursively
    for ``*.json`` and ``*.json.gz``), keeps complete ("X") events whose
    category is one of ``categories`` (by default what ran on the device:
    kernels, copies and memsets), and returns ``[(name, total_ms, count),
    ...]`` sorted by total time, longest first."""
    agg: Dict[str, List[float]] = {}
    for path in _trace_files(trace_dir):
        for e in _load_trace(path).get("traceEvents", []):
            if e.get("ph") != "X" or e.get("cat") not in categories:
                continue
            bucket = agg.setdefault(e.get("name", "?"), [0.0, 0])
            bucket[0] += e.get("dur", 0) / 1e3
            bucket[1] += 1
    return sorted(
        ((name, ms, int(n)) for name, (ms, n) in agg.items()),
        key=lambda row: -row[1],
    )


def top_device_ops(
    trace_dir: str, top: int = 20, *, categories: Sequence[str] = DEVICE_CATEGORIES
) -> str:
    """Human-readable top-N table from :func:`device_op_table`."""
    rows = device_op_table(trace_dir, categories=categories)
    total = sum(ms for _, ms, _ in rows)
    lines = [f"total device op time: {total:.1f} ms over {len(rows)} op names"]
    lines += [
        f"  {ms:9.2f} ms  x{n:4d}  {name[:90]}" for name, ms, n in rows[:top]
    ]
    return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: str, *, cuda: bool = True) -> Iterator[Any]:
    """``torch.profiler`` around the block, its Chrome trace written to
    ``log_dir/trace.json`` at the end; yields the profiler.  ``cuda=True``
    traces the card's kernels too and raises when there is no CUDA device;
    any failure of the profiler raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("profile_trace(cuda=True): no CUDA device")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
