"""The program's own spans in a ``--trace 1`` run: each range that the
port opens with ``record_function`` (``truely_tpu_torch.utils.profiling``:
``detector.stage``, ``mtcnn.pyramid``, ``tracks.fold`` ...) is given the
device work it launched and the device idle time it was open for.

``ranges(events)`` reads a Chrome trace's events and gives, per range name:

- ``device_s`` and ``launches``: every kernel, copy and memset of the
  traced window whose runtime call (matched by ``correlation``) started
  while that range was the innermost program range open on its thread;
- ``idle_s``: the part of each idle gap of the first card during which
  that range was the innermost program range open on the thread of the
  window (``OUTSIDE``: no program range open);
- ``calls``: the range's events that start in the window.

In a ``--trace 1`` run ``trace.Tracer.summary`` keeps the table as
``TraceSummary.ranges`` and ``closed_loop.run`` puts the seconds of the
spans that the program records after the trace (``profiling.collect()``)
into ``Outcome.spans``.  A reader under ``metrics/`` names its span and
takes one of four readings of a run's ``Outcome``: ``host_ms_per_frame``,
``device_ms_per_frame``, ``idle_share`` and ``launches_per_call``; each is
None where the span is absent.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Tuple

from benchmark.trace import SPAN_PREFIX, WINDOW, _union, busy_and_gaps, device_events

RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
OUTSIDE = ""  # idle time with no program range open


class Range(NamedTuple):
    device_s: float
    launches: int
    idle_s: float
    calls: int


class Table(NamedTuple):
    window_s: float
    idle_s: float                 # the first card's idle seconds in the window
    ranges: Dict[str, Range]      # by range name; OUTSIDE holds idle time in no range


def _innermost(spans: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """Nested (start, end, name) intervals of one thread as the sorted,
    disjoint pieces in which each was the innermost one open.  A child that
    outlasts its parent by the trace's rounding is cut at the parent's end."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, float, str]] = []
    t = 0.0

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for s, e, name in sorted(spans, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][1] <= s:
            _, end, top = stack.pop()
            emit(t, end, top)
            t = end
        if stack:
            emit(t, s, stack[-1][2])
            e = min(e, stack[-1][1])
        stack.append((s, e, name))
        t = s
    while stack:
        _, end, top = stack.pop()
        emit(t, end, top)
        t = end
    return out


class _Lookup:
    """The innermost program range open at a time, on one thread."""

    def __init__(self, pieces: List[Tuple[float, float, str]]):
        self.pieces = pieces
        self.starts = [p[0] for p in pieces]

    def at(self, ts: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, ts) - 1
        if i >= 0 and ts < self.pieces[i][1]:
            return self.pieces[i][2]
        return None


def _overlap(gaps: List[Tuple[float, float]], pieces: List[Tuple[float, float, str]]
             ) -> Dict[str, float]:
    """Seconds of the sorted disjoint ``gaps`` covered by each name of the
    sorted disjoint ``pieces``."""
    out: Dict[str, float] = {}
    j = 0
    for s, e in gaps:
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, name = pieces[k]
            cut = min(b, e) - max(a, s)
            if cut > 0:
                out[name] = out.get(name, 0.0) + cut / 1e6
            k += 1
    return out


def _is_range(e: dict) -> bool:
    return (e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and not e.get("name", "").startswith(SPAN_PREFIX))


def ranges(events: List[dict]) -> Optional[Table]:
    """The table of the trace's program ranges; None when it holds no
    window, no device event in it or no program range."""
    windows = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        return None
    w = max(windows, key=lambda e: e.get("dur", 0))
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    pid, main = w.get("pid"), w.get("tid")
    by_thread: Dict[object, List[Tuple[float, float, str]]] = {}
    calls: Dict[str, int] = {}
    for e in events:
        if _is_range(e) and e.get("pid") == pid:
            s = float(e["ts"])
            by_thread.setdefault(e.get("tid"), []).append((s, s + float(e.get("dur", 0)),
                                                           e["name"]))
            if lo <= s < hi:
                calls[e["name"]] = calls.get(e["name"], 0) + 1
    if not by_thread:
        return None
    lookup = {tid: _Lookup(_innermost(spans)) for tid, spans in by_thread.items()}
    launched: Dict[object, Optional[str]] = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if (e.get("ph") == "X" and e.get("cat") in RUNTIME_CATEGORIES and corr is not None
                and e.get("pid") == pid and e.get("tid") in lookup):
            launched[corr] = lookup[e["tid"]].at(float(e["ts"]))
    device: Dict[str, List[float]] = {}
    per_card: Dict[object, List[Tuple[float, float]]] = {}
    for e, s, end, card in device_events(events, lo, hi):
        per_card.setdefault(card, []).append((s, end))
        sec = (min(end, hi) - max(s, lo)) / 1e6
        name = launched.get((e.get("args") or {}).get("correlation"))
        if name is not None:
            row = device.setdefault(name, [0.0, 0])
            row[0] += sec
            row[1] += 1
    if not per_card:
        return None
    _, gaps = busy_and_gaps(per_card, lo, hi)
    idle = _overlap(gaps, lookup[main].pieces if main in lookup else [])
    # The idle time outside every range, from the ranges' union: with the
    # ranges' idle seconds it adds up to the window's idle time only if the
    # innermost pieces cover each idle instant once.
    covered_by_any = [(s, e, OUTSIDE) for s, e in _union(
        [(s, e) for s, e, _ in by_thread.get(main, [])])]
    inside = _overlap(gaps, covered_by_any).get(OUTSIDE, 0.0)
    idle_s = sum(e - s for s, e in gaps) / 1e6
    idle[OUTSIDE] = idle_s - inside
    names = set(device) | set(idle) | set(calls)
    table = {n: Range(device.get(n, [0.0, 0])[0], int(device.get(n, [0.0, 0])[1]),
                      idle.get(n, 0.0), calls.get(n, 0)) for n in names}
    return Table(window_s=(hi - lo) / 1e6, idle_s=idle_s, ranges=table)


def _row(out, span: str) -> Tuple[Optional[Table], Optional[Range]]:
    """The table of a run's ``Outcome`` and its row of ``span``."""
    table = out.trace_summary.ranges if out.trace_summary is not None else None
    return table, table.ranges.get(span) if table is not None else None


def host_ms_per_frame(out, span: str) -> Optional[float]:
    """Host milliseconds of the program's ``span`` spans collected after
    the trace, per sampled frame of the clips after it."""
    seconds = out.spans.get(span) or []
    frames = sum(u.frames for u in out.units[out.traced_units:])
    return 1e3 * sum(seconds) / frames if seconds and frames else None


def device_ms_per_frame(out, span: str) -> Optional[float]:
    """Device milliseconds launched while ``span`` was the innermost range,
    per sampled frame of the traced clips."""
    _, row = _row(out, span)
    frames = sum(u.frames for u in out.units[:out.traced_units])
    return 1e3 * row.device_s / frames if row is not None and row.launches and frames else None


def idle_share(out, span: str) -> Optional[float]:
    """The share (%) of the traced window in which the first card was idle
    while ``span`` was the innermost range open on the window's thread."""
    table, row = _row(out, span)
    if row is None or not row.calls or table.window_s <= 0:
        return None
    return 100.0 * row.idle_s / table.window_s


def launches_per_call(out, span: str) -> Optional[float]:
    """Device operations launched while ``span`` was the innermost range,
    per call of it in the traced window."""
    _, row = _row(out, span)
    return row.launches / row.calls if row is not None and row.calls else None
