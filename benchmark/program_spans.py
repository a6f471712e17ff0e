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

``readings(...)`` turns the table, the spans the program recorded after
the trace (``profiling.collect()``) and the frames of the run into the
per-layer readings named in ``READINGS``; a reading whose span is absent
is None.

The harness does not call this module yet: ``trace.summarize`` deletes the
trace before a reader could see it, and ``closed_loop.run`` opens no
``collect()``.  Until they do, ``python3 -m benchmark.program_spans
--workload <cell> --seed <n> --seconds <s>`` makes one traced run of a cell
as ``run.py --trace 1`` does, with those two wrapped from outside, and
prints the readings in one JSON line (none for a program without spans),
with the traced run's end-to-end metrics.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from benchmark.trace import DEVICE_CATEGORIES, SPAN_PREFIX, WINDOW, _clip, _union

RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
OUTSIDE = ""  # idle time with no program range open
# Device ops that the readings' coverage counts besides the three stages'.
K1_KERNEL = "i420_to_bgr_kernel"
STAGES = ("mtcnn.pyramid", "mtcnn.cascade", "detector.embed")


class Range(NamedTuple):
    device_s: float
    launches: int
    idle_s: float
    calls: int


class Table(NamedTuple):
    window_s: float
    idle_s: float                 # the first card's idle seconds in the window
    busy_s: float                 # the first card's busy seconds in the window
    covered_s: float              # device seconds of the stages, K1 and the copies
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
    covered = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0))
        if s + d <= lo or s >= hi:
            continue
        per_card.setdefault((e.get("args") or {}).get("device", e.get("pid")), []).append(
            (s, s + d))
        sec = (min(s + d, hi) - max(s, lo)) / 1e6
        name = launched.get((e.get("args") or {}).get("correlation"))
        if (name in STAGES or e.get("cat") == "gpu_memcpy"
                or K1_KERNEL in e.get("name", "")):
            covered += sec
        if name is not None:
            row = device.setdefault(name, [0.0, 0])
            row[0] += sec
            row[1] += 1
    if not per_card:
        return None
    first = _union(_clip(per_card[sorted(per_card, key=str)[0]], lo, hi))
    gaps, t = [], lo
    for s, e in first + [(hi, hi)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
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
    return Table(window_s=(hi - lo) / 1e6, idle_s=idle_s,
                 busy_s=sum(e - s for s, e in first) / 1e6, covered_s=covered, ranges=table)


# name: (unit, what it reads)
READINGS = {
    "stage_host_ms.batch": ("ms", "detector.stage host ms per sampled frame after the trace"),
    "stage_idle.batch": ("%", "idle share of the traced window with detector.stage innermost"),
    "sync_host_ms.batch": ("ms", "detector.sync host ms per sampled frame after the trace"),
    "pyramid_device_ms.batch": ("ms", "device ms launched in mtcnn.pyramid per traced frame"),
    "cascade_device_ms.batch": ("ms", "device ms launched in mtcnn.cascade per traced frame"),
    "embed_device_ms.batch": ("ms", "device ms launched in detector.embed per traced frame"),
    "fold_launches": ("count", "device ops launched in tracks.fold per call"),
    "fold_idle.batch": ("%", "idle share of the traced window with tracks.fold innermost"),
}


def readings(table: Optional[Table], traced_frames: int, host_spans: Iterable,
             host_frames: int) -> Dict[str, Optional[float]]:
    """``READINGS`` from the trace's table (``traced_frames``: the sampled
    frames of the traced clips) and the spans recorded after the trace
    (``host_spans``: ``profiling.Span``; ``host_frames``: their clips'
    sampled frames).  None where the reading's span is absent."""
    host: Dict[str, float] = {}
    for sp in host_spans:
        host[sp.name] = host.get(sp.name, 0.0) + (sp.end - sp.start)
    rows = table.ranges if table is not None else {}

    def per_host_frame(name):
        return 1e3 * host[name] / host_frames if name in host and host_frames else None

    def per_traced_frame(name):
        return (1e3 * rows[name].device_s / traced_frames
                if name in rows and rows[name].launches and traced_frames else None)

    def idle_share(name):
        return (100.0 * rows[name].idle_s / table.window_s
                if name in rows and rows[name].calls and table.window_s > 0 else None)

    fold = rows.get("tracks.fold")
    return {
        "stage_host_ms.batch": per_host_frame("detector.stage"),
        "stage_idle.batch": idle_share("detector.stage"),
        "sync_host_ms.batch": per_host_frame("detector.sync"),
        "pyramid_device_ms.batch": per_traced_frame("mtcnn.pyramid"),
        "cascade_device_ms.batch": per_traced_frame("mtcnn.cascade"),
        "embed_device_ms.batch": per_traced_frame("detector.embed"),
        "fold_launches": fold.launches / fold.calls if fold and fold.calls else None,
        "fold_idle.batch": idle_share("tracks.fold"),
    }


def main(argv=None) -> int:
    import argparse
    import contextlib
    import json
    import os
    import sys
    import tempfile
    import time

    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description="one traced run of a cell, with the program's "
                                "spans read from its trace")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from benchmark import run as bench_run

    for var, sub in bench_run.CACHES.items():
        os.environ[var] = os.path.join(bench_run.ROOT, ".bench_cache", sub)

    import torch

    from benchmark import closed_loop, outcome, spec, trace
    from truely_tpu_torch.utils import profiling

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    kept: Dict[str, object] = {}
    load_events, stop = trace.load_events, trace.Tracer.stop

    def keep_events(path):
        kept["events"] = load_events(path)
        return kept["events"]

    def note_stop(self):
        stop(self)
        kept["stopped_at"] = time.perf_counter()

    trace.load_events, trace.Tracer.stop = keep_events, note_stop
    path = os.path.join(tempfile.gettempdir(), f"bench_trace_{os.getpid()}.json")
    # A program without spans (the parent commit) records none.
    collect = getattr(profiling, "collect", lambda: contextlib.nullcontext([]))
    try:
        with collect() as spans:
            out = closed_loop.run(cell, args.seed, args.seconds, True, t_start, path)
    finally:
        trace.load_events, trace.Tracer.stop = load_events, stop
    table = ranges(kept.get("events", []))
    after = [s for s in spans if s.start >= kept.get("stopped_at", float("inf"))]
    traced = sum(u.frames for u in out.units[:out.traced_units])
    host_frames = sum(u.frames for u in out.units[out.traced_units:])
    line, _ = outcome.report(cell, out, True)
    line["end_to_end_traced"] = {m["name"]: spec.metric_reader(m["name"])(cell, out)
                                 for m in cell.end_to_end}
    got = readings(table, traced, after, host_frames)
    line["program_spans"] = {n: {"value": v, "unit": READINGS[n][0]}
                             for n, v in got.items() if v is not None}
    if table is not None:
        line["program_ranges"] = {n: r._asdict() for n, r in sorted(table.ranges.items())}
        line["coverage"] = {"covered_s": table.covered_s, "busy_s": table.busy_s,
                            "idle_s": table.idle_s, "window_s": table.window_s,
                            "idle_in_ranges_s": sum(r.idle_s for r in table.ranges.values())}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
