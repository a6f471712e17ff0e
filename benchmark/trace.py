"""The device trace of a ``--trace 1`` run: ``torch.profiler`` around part
of the window, its Chrome trace read back into the device's busy time per
card, device time per kernel name, the idle gaps labelled by what the
host was doing, and the table of the program's own ranges
(``program_spans.ranges``).

A device event is a complete event whose category ran on the device
(``DEVICE_CATEGORIES``); ``device_events`` and ``busy_and_gaps`` are the
one reading of them that ``summarize`` and ``program_spans`` share.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

# Kineto's categories of the events that ran on the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Host events that can say what the host was doing in a gap.
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "bench.window"
SPAN_PREFIX = "bench."
TOP = 10


class TraceSummary(NamedTuple):
    window_s: float                       # length of the traced window
    busy_s: float                         # device-busy seconds, mean over the cards
    cards: int
    device_ops: List[Tuple[str, float, int]]   # (name, seconds, count), longest first
    idle_gaps: List[Tuple[str, float]]    # (what the host did, idle seconds), longest first
    ranges: Optional[object] = None       # program_spans.Table of the program's ranges


class Tracer:
    """torch.profiler (host and CUDA activity) from ``start()`` to
    ``stop()``, inside a ``bench.window`` range; ``span(name)`` marks a
    benchmark span on the host.  ``stop()`` waits for the device and
    writes the Chrome trace to ``path``; ``summary()`` reads it back, with
    the table of the program's ranges, and deletes it."""

    def __init__(self, path: str):
        self.path = path
        self.on = False
        self._prof = self._window = None

    def start(self) -> None:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        self.on = True

    @staticmethod
    def span(name: str):
        from torch.autograd.profiler import record_function

        return record_function(name)

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        self._prof.export_chrome_trace(self.path)
        self._prof = self._window = None
        self.on = False

    def summary(self, cards: int) -> Optional[TraceSummary]:
        from benchmark import program_spans  # which imports this module

        if self.on:
            self.stop()
        try:
            events = load_events(self.path)
            s = summarize(events, cards)
            return s._replace(ranges=program_spans.ranges(events)) if s is not None else None
        finally:
            remove(self.path)


def load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def device_events(events: List[dict], lo: float, hi: float
                  ) -> Iterator[Tuple[dict, float, float, object]]:
    """(event, start, end, card) of each device event that overlaps the
    window [lo, hi) (microseconds)."""
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0))
        if s + d <= lo or s >= hi:
            continue
        yield e, s, s + d, (e.get("args") or {}).get("device", e.get("pid"))


def busy_and_gaps(per_card: Dict[object, List[Tuple[float, float]]], lo: float, hi: float
                  ) -> Tuple[Dict[object, List[Tuple[float, float]]], List[Tuple[float, float]]]:
    """Each card's busy intervals in the window (the union of its device
    events' intervals, cut to [lo, hi)) and the idle gaps of the first
    card."""
    busy = {c: _union(_clip(iv, lo, hi)) for c, iv in per_card.items()}
    first = busy[sorted(busy, key=str)[0]]
    gaps, t = [], lo
    for s, e in first + [(hi, hi)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    return busy, gaps


def _labels(gaps: List[Tuple[float, float]], host: List[dict]) -> Dict[str, float]:
    """Idle seconds by what the host was doing when each gap began: the
    innermost benchmark span and the innermost host event open then, as
    "span > op" (one sweep over the host events in start order)."""
    host = sorted(host, key=lambda e: e["ts"])
    out: Dict[str, float] = {}
    active: List[dict] = []
    i = 0
    for s, e in sorted(gaps):
        while i < len(host) and host[i]["ts"] <= s:
            active.append(host[i])
            i += 1
        active = [h for h in active if h["ts"] + h["dur"] > s]
        spans = [h for h in active if h["name"].startswith(SPAN_PREFIX) and h["name"] != WINDOW]
        ops = [h for h in active if not h["name"].startswith(SPAN_PREFIX)]
        span = min(spans, key=lambda h: h["dur"])["name"] if spans else WINDOW
        op = min(ops, key=lambda h: h["dur"])["name"] if ops else "no host op"
        label = f"{span} > {op}"
        out[label] = out.get(label, 0.0) + (e - s) / 1e6
    return out


def summarize(events: List[dict], cards: Optional[int] = None) -> Optional[TraceSummary]:
    """The traced window's busy time per card (the union of its device
    events), device time per name, and the idle gaps of the first card
    grouped by what the host (any thread of the traced process) was
    doing.  None when the trace holds no window or no device event."""
    windows = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not windows:
        return None
    w = max(windows, key=lambda e: e.get("dur", 0))
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    per_card: Dict[object, List[Tuple[float, float]]] = {}
    ops: Dict[str, List[float]] = {}
    for e, s, end, card in device_events(events, lo, hi):
        per_card.setdefault(card, []).append((s, end))
        bucket = ops.setdefault(e.get("name", "?"), [0.0, 0])
        bucket[0] += (min(end, hi) - max(s, lo)) / 1e6
        bucket[1] += 1
    if not per_card:
        return None
    n = max(cards or 0, len(per_card))
    busy, gaps = busy_and_gaps(per_card, lo, hi)
    busy_s = sum(e - s for iv in busy.values() for s, e in iv) / 1e6 / n
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES
            and e.get("pid") == w.get("pid")]
    host = [dict(e, ts=float(e["ts"]), dur=float(e.get("dur", 0))) for e in host]
    by_label = _labels(gaps, host)
    return TraceSummary(
        window_s=(hi - lo) / 1e6, busy_s=busy_s, cards=n,
        device_ops=sorted(((k, v[0], int(v[1])) for k, v in ops.items()), key=lambda r: -r[1]),
        idle_gaps=sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP])


def remove(path: str) -> None:
    with contextlib.suppress(FileNotFoundError):
        os.unlink(path)
