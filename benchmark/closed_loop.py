"""Closed-loop cells: one caller analyses in-memory packed I420 clips one
after another through the entry that the cell's model gives (the port's
``analyze_i420``, or ``analyze_i420_tracks`` for a multi-face
configuration), on one card or on a data mesh of ``dp`` cards
(``Detector(mesh=)``).

The window opens after set-up and closes at the first clip that finishes
at or after ``seconds``: every clip in it is whole, and the rate is its
sampled frames over its length.  With tracing, the profiler covers the
window's first clips, up to the first that finishes at or after
``TRACE_SECONDS``; the readings taken on the host's clock (the fold's
spans, the program's spans, the step's share of the peak) come from the
clips after it, which run without the profiler's overhead.  The program's
spans are collected (``profiling.collect()``) only there, from the trace's
end to the window's end, so an untraced run collects none.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from benchmark import check, content, spec, traffic, trace
from benchmark.outcome import Outcome, kernel_launches
from benchmark.reference.layers import fp8_matmuls

TRACE_SECONDS = 6.0


class Unit(NamedTuple):
    """One clip analysed in the window."""

    start: int
    frames: int            # sampled frames (every frame at the mixes' fps)
    t0: float              # seconds from the window's start
    t1: float
    fallback: int          # segments the propagate fallback re-ran
    steps: Dict[str, int]  # frame steps run, by kind
    result: object         # the program's answer


def steps_of(n: int, batch: int, k: int, fallback: int) -> Dict[str, int]:
    """Frame steps of a clip of ``n`` sampled frames: a full step per
    batch at K = 1; else a seed step per cycle of K batches, a propagate
    step per batch, and a full step per segment that fell back."""
    s = -(-n // batch)
    if k == 1:
        return {"full": s, "detect": 0, "propagate": 0}
    return {"full": fallback, "detect": -(-s // k), "propagate": s}


def frame_rows(n: int, batch: int, k: int) -> Dict[str, int]:
    """Sampled frames of a clip of ``n`` that each kind of frame step
    analyses, padding left out: every frame by the full step at K = 1;
    else each batch's every k-th frame by the seed step and every frame by
    the propagate step (a fallback's re-run is not counted)."""
    if k == 1:
        return {"full": n}
    sizes = [min(batch, n - i) for i in range(0, n, batch)]
    return {"detect": sum(-(-m // k) for m in sizes), "propagate": n}


def _cards(dp: int) -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(dp)]


def build(cell: spec.Cell, seed: int, device: Optional[torch.device] = None):
    """(detector, entry, param trees) of a cell, from its model:
    weights drawn from ``seed``; ``device`` replaces the card (the CPU
    tests)."""
    from truely_tpu_torch.parallel.mesh import make_mesh

    conf = cell.config
    model = spec.model(conf)
    dp = conf["dp"]
    first = device or torch.device("cuda", 0)
    trees = model.seeded_trees(seed, first, conf)
    devices = [first] * dp if device is not None else _cards(dp)
    mesh = make_mesh((dp, 1), ("data", "model"), devices=devices) if dp > 1 else None
    det = model.detector(conf, trees, first, mesh)
    return det, model.entry(det, conf), trees


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, t_start: float,
        trace_path: str, device: Optional[torch.device] = None, control: bool = False
        ) -> Outcome:
    conf, mix = cell.config, cell.traffic
    h, w, fps = mix["height"], mix["width"], mix["fps"]
    multi = conf["detector"]["multi_face"]
    batch, k = conf["detector"]["frame_batch"], conf["detector"]["detect_interval"]
    sizes = traffic.lengths(mix)
    ring = content.Ring(content.distinct_frames(mix["content"], h, w, seed), max(sizes))
    clips = traffic.closed_clips(mix, seed)
    det, entry, trees = build(cell, seed, device)
    cards = [det.device] if device is not None else _cards(conf["dp"])
    folds: List[float] = []
    if multi:  # the benchmark's span around the track fold, on its own instance
        fold = det.track_fold

        def timed_fold(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fold(*a, **kw)
            finally:
                folds.append(time.perf_counter() - t0)

        det.track_fold = timed_fold
    on_card = det.device.type == "cuda"
    det.warmup(h, w)
    for n in sorted(set(sizes)):  # the timed path once at each of the mix's lengths
        entry(ring.clip(0, n), fps)
    if on_card:
        torch.cuda.synchronize()
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
    folds.clear()
    setup_s = time.perf_counter() - t_start

    units: List[Unit] = []
    tracer = trace.Tracer(trace_path) if traced else None
    traced_units, host_from, host_folds = 0, 0.0, 0
    launches: Dict[str, int] = {}
    collected: list = []  # the program's spans from the trace's end to the window's end
    if tracer:  # the profiler's own start-up stays out of the window
        from truely_tpu_torch.utils import profiling

        tracer.start()
        before = kernel_launches()
    after_trace = contextlib.ExitStack()
    w0 = time.perf_counter()
    with after_trace:
        while True:
            clip = next(clips)
            fb0 = det.fallback_segments
            t0 = time.perf_counter() - w0
            with tracer.span("bench.clip") if tracer and tracer.on else contextlib.nullcontext():
                res = entry(ring.clip(clip.start, clip.frames), fps)
            t1 = time.perf_counter() - w0
            fb = det.fallback_segments - fb0
            units.append(Unit(clip.start, clip.frames, t0, t1, fb,
                              steps_of(clip.frames, batch, k, fb), res))
            done = t1 >= seconds
            if tracer and tracer.on and (t1 >= TRACE_SECONDS or done):
                tracer.stop()
                after = kernel_launches()
                launches = {n: after[n] - before[n] for n in after}
                traced_units, host_folds = len(units), len(folds)
                host_from = time.perf_counter() - w0
                collected = after_trace.enter_context(profiling.collect())
            if done:
                break
    window_s = units[-1].t1
    peak = max(torch.cuda.max_memory_allocated(c) for c in cards) if on_card else 0
    spans: Dict[str, List[float]] = {"track_fold": folds[host_folds:]}
    for sp in collected:
        spans.setdefault(sp.name, []).append(sp.end - sp.start)

    # The reference, once the window has closed and the program is freed.
    del det, entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    chosen = [units[i] for i in check.sample(units, seed, conf["check_frames"])]
    found, controlled = check_units(cell, chosen, trees, ring, cards[0], control)
    return Outcome(
        setup_s=setup_s, window_s=window_s, units=units, traced_units=traced_units,
        host_from=host_from, launches=launches, spans=spans,
        trace_summary=tracer.summary(len(cards)) if tracer else None,
        numbers=found, limits=conf["limits"],
        attempted=len(units), failed=0,
        memory_peak_bytes=peak, cards=len(cards), checked=len(chosen), control=controlled)


def check_units(cell: spec.Cell, units: List[Unit], trees, ring: content.Ring, device,
                control: bool) -> Tuple[Dict[str, float], Optional[Dict[str, float]]]:
    """The check's numbers of the program's answers for ``units`` against
    the model's reference; with ``control``, also those of the control
    (the reference with its nets' operands in float8 put in the program's
    place)."""
    conf = cell.config
    model = spec.model(conf)
    reference = model.reference(conf, trees, device, cell.traffic["fps"],
                                conf["detector"]["frame_batch"] // conf["dp"])
    got, want, low = [], [], []
    for u in units:
        frames = ring.clip(u.start, u.frames)
        got.append(model.answer(u.result))
        want.append(reference(frames))
        if control:
            with fp8_matmuls():
                low.append(reference(frames))
    return model.check(conf, got, want), model.check(conf, low, want) if control else None
