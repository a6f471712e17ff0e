"""The program's span recorder, and device timing (counterpart of
``truely_tpu/utils/profiling.py``).

- ``StageTimer`` is one analysis's recorder, kept by the thread that runs
  the analysis: ``stage(name)`` times a span on ``time.perf_counter``, and
  the timer keeps each name's total, self time (the span less what the
  spans nested in it cover) and count.  ``span(name)`` is a span with no
  timer, for code that has none (the free frame-step functions and the
  encode worker): inside a timer's span on the same thread it counts
  towards that timer.  Spans nest by a per-thread stack.
- While ``torch.profiler`` runs (``torch.autograd._profiler_enabled()``),
  every span also opens ``record_function(name)``, so the program's spans
  land in the profiler's trace on the clock of its device ops.  With no
  profiler running a span makes no dispatcher call.  The profiler records
  the thread that started it, so the spans of other threads (the encode
  worker's) reach ``collect()`` but not the trace.
- ``collect()`` keeps the finished spans (``Span``: name, start, end) while
  it is open; otherwise no span is kept, so a long-running server holds
  none.
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

The timers take an injectable ``timer`` (and ``measure_ingraph`` a
``capture``), so the arithmetic runs without a card.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function


class Span(NamedTuple):
    """One finished span, as ``collect()`` keeps it."""

    name: str
    start: float   # time.perf_counter() seconds
    end: float


_local = threading.local()
# The lists of the open ``collect()`` blocks; replaced whole, under the lock.
_collectors: tuple = ()
_collectors_lock = threading.Lock()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span in progress: the context manager of ``span``/``stage``."""

    __slots__ = ("name", "timer", "parent", "start", "covered", "rf")

    def __init__(self, name: str, timer: Optional["StageTimer"]):
        self.name = name
        self.timer = timer

    def __enter__(self) -> "_Open":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.timer is None and self.parent is not None:
            self.timer = self.parent.timer
        self.covered = 0.0  # seconds of the spans nested in this one
        self.rf = None
        if _profiler_enabled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        seconds = end - self.start
        parent = self.parent
        if parent is not None:
            parent.covered += seconds
        timer = self.timer
        if timer is not None:
            timer._add(self.name, seconds, seconds - self.covered)
        if _collectors:
            done = Span(self.name, self.start, end)
            for spans in _collectors:
                spans.append(done)


def span(name: str) -> _Open:
    """A span with no timer of its own: it counts towards the timer of the
    span it is nested in on this thread, if any."""
    return _Open(name, None)


@contextlib.contextmanager
def collect() -> Iterator[List[Span]]:
    """Yields a list to which every span that finishes while the block is
    open is appended, on any thread."""
    global _collectors
    spans: List[Span] = []
    with _collectors_lock:
        _collectors = _collectors + (spans,)
    try:
        yield spans
    finally:
        with _collectors_lock:
            _collectors = tuple(c for c in _collectors if c is not spans)


class StageTimer:
    """One analysis's spans, on the thread that runs it: per name the total
    seconds (``report()``), the self seconds (``self_report()``) and the
    count."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.self_totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def stage(self, name: str) -> _Open:
        return _Open(name, self)

    def _add(self, name: str, seconds: float, self_seconds: float) -> None:
        self.totals[name] += seconds
        self.self_totals[name] += self_seconds
        self.counts[name] += 1

    def report(self) -> Dict[str, float]:
        return dict(self.totals)

    def self_report(self) -> Dict[str, float]:
        return dict(self.self_totals)

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
