"""The port's profiling utilities (``truely_tpu_torch/utils/profiling.py``)
on the CPU: the span recorder (``StageTimer``, ``span``, ``collect``) on an
injected clock, across threads and under a CPU ``torch.profiler``; the
detector's spans in the profiler's trace and its ``timings`` made of them;
and the timers' slope arithmetic with an injected timer (and, for
``measure_ingraph``, an injected capture in place of the CUDA graph).  Only
the slow-writer test reads the wall clock, with seconds of margin.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
from truely_tpu_torch.media.rawavi import RawAviWriter
from truely_tpu_torch.pipeline import detector as detector_module
from truely_tpu_torch.pipeline.detector import Detector, analysis_timings
from truely_tpu_torch.utils import StageTimer as ExportedStageTimer
from truely_tpu_torch.utils import profiling
from truely_tpu_torch.utils.profiling import (
    StageTimer, collect, measure_forced, measure_ingraph, span,
)

torch.set_num_threads(2)


class FakeClock:
    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def __call__(self):
        return next(self.ticks)


def test_stage_timer_accumulates(monkeypatch):
    assert ExportedStageTimer is StageTimer
    monkeypatch.setattr(profiling.time, "perf_counter", FakeClock([0.0, 0.5, 1.0, 1.25, 2.0, 4.0]))
    timer = StageTimer()
    with timer.stage("decode"):
        pass
    with timer.stage("decode"):
        pass
    with pytest.raises(KeyError), timer.stage("device"):
        raise KeyError("the stage still counts")
    assert timer.report() == {"decode": 0.75, "device": 2.0}
    assert dict(timer.counts) == {"decode": 2, "device": 1}
    lines = timer.summary().splitlines()
    assert lines[0].split() == ["device:", "2000.0", "ms", "(72.7%)", "over", "1", "calls"]
    assert lines[1].split()[:2] == ["decode:", "750.0"]


class CountingTimer:
    """A timer that runs the timed function and reports ``base + per_call``
    seconds for every call of ``step`` that the function made."""

    def __init__(self, base=0.25, per_call=0.004):
        self.base, self.per_call = base, per_call
        self.calls = 0
        self.windows = []

    def step(self, *args):
        self.calls += 1
        return args[0] if args else None

    def __call__(self, fn):
        before = self.calls
        fn()
        n = self.calls - before
        self.windows.append(n)
        return self.base + self.per_call * n


def test_measure_forced_is_the_slope():
    t = CountingTimer()
    got = measure_forced(t.step, torch.zeros(3), n_lo=2, n_hi=5, trials=3, warmup=2, timer=t)
    assert got == pytest.approx(0.004)
    # two warm-up chains of 1, then per trial one chain of n_hi and one of n_lo
    assert t.windows == [1, 1, 5, 2, 5, 2, 5, 2]


def test_measure_forced_takes_the_best_trial():
    t = CountingTimer()
    slow = iter([0.0, 0.0, 1.0, 0.1, 0.5, 0.2, 0.9, 0.0])  # extra seconds per window
    timer = lambda fn: t(fn) + next(slow)  # noqa: E731
    got = measure_forced(t.step, None, n_lo=2, n_hi=5, trials=3, warmup=2, timer=timer)
    # slopes: (1.0 - 0.1 + 0.012) / 3, (0.5 - 0.2 + 0.012) / 3, (0.9 - 0.0 + 0.012) / 3
    assert got == pytest.approx((0.3 + 0.012) / 3)


def test_measure_ingraph_captures_each_chain_once():
    t = CountingTimer(per_call=0.001)
    captured = []

    def capture(fn):
        captured.append(fn)
        return fn

    def step(carry, x):
        t.step()
        return carry + x

    got = measure_ingraph(step, torch.tensor(2.0), n_lo=2, n_hi=10, trials=2,
                          carry_init=torch.tensor(1.0), timer=t, capture=capture)
    assert got == pytest.approx(0.001)
    assert len(captured) == 2
    assert captured[0]() == 1.0 + 2 * 2.0 and captured[1]() == 1.0 + 10 * 2.0  # carry threads
    # warm-up of each chain, then per trial the chain of n_hi and of n_lo
    assert t.windows == [2, 10, 10, 2, 10, 2]


class Ticks:
    """A clock that advances one second at every reading."""

    def __init__(self):
        self.now = -1.0

    def __call__(self):
        self.now += 1.0
        return self.now


@pytest.fixture
def ticks(monkeypatch):
    clock = Ticks()
    monkeypatch.setattr(profiling.time, "perf_counter", clock)
    return clock


def test_spans_nest_with_parents_and_self_time(ticks):
    """A timer's span, a free span inside it and one inside that: totals,
    self times (each span less its children, so the free spans count
    towards the timer of the span they are nested in) and the collected
    spans in the order they closed."""
    timer = StageTimer()
    with collect() as spans:
        with timer.stage("detector.analyze"):          # reads 0 .. 7
            with span("mtcnn.cascade"):                # 1 .. 4
                with span("mtcnn.pyramid"):            # 2 .. 3
                    pass
            with timer.stage("detector.fetch"):        # 5 .. 6
                pass
    assert timer.report() == {"mtcnn.pyramid": 1.0, "mtcnn.cascade": 3.0,
                              "detector.fetch": 1.0, "detector.analyze": 7.0}
    assert timer.self_report() == {"mtcnn.pyramid": 1.0, "mtcnn.cascade": 2.0,
                                   "detector.fetch": 1.0, "detector.analyze": 3.0}
    assert spans == [("mtcnn.pyramid", 2.0, 3.0), ("mtcnn.cascade", 1.0, 4.0),
                     ("detector.fetch", 5.0, 6.0), ("detector.analyze", 0.0, 7.0)]
    assert profiling._stack() == []


def test_free_spans_and_nested_timers(ticks):
    """A free span outside any timer counts nowhere (but is collected); a
    second timer's spans inside the first's count towards the second, and
    so do the free spans inside them."""
    outer, inner = StageTimer(), StageTimer()
    with collect() as spans:
        with span("tracks.fold"):
            pass
        with outer.stage("serve.analysis"):
            with inner.stage("detector.analyze"):
                with span("detector.upload"):
                    pass
    assert spans[0] == ("tracks.fold", 0.0, 1.0)
    assert outer.report() == {"serve.analysis": 5.0}
    assert outer.self_report() == {"serve.analysis": 2.0}
    assert inner.report() == {"detector.upload": 1.0, "detector.analyze": 3.0}
    assert inner.self_report() == {"detector.upload": 1.0, "detector.analyze": 2.0}


def test_spans_raise_through_and_still_count(ticks):
    timer = StageTimer()
    with pytest.raises(KeyError), timer.stage("detector.analyze"):
        with span("detector.stage"):
            raise KeyError("both spans still close")
    assert timer.report() == {"detector.stage": 1.0, "detector.analyze": 3.0}
    assert dict(timer.counts) == {"detector.stage": 1, "detector.analyze": 1}
    assert profiling._stack() == []


def test_each_thread_has_its_own_stack():
    """A free span opened on a worker thread while the caller's timer span
    is open is not nested in it: it counts towards no timer and takes
    nothing from the caller's self time (the encode worker of an
    analysis), and it is still collected."""
    timer = StageTimer()
    opened, closed = threading.Event(), threading.Event()

    def worker():
        opened.wait(10)
        with span("detector.encode"):
            with span("inner"):
                pass
        closed.set()

    t = threading.Thread(target=worker)
    with collect() as spans:
        t.start()
        with timer.stage("detector.analyze"):
            opened.set()
            assert closed.wait(10)
        t.join(10)
    assert not t.is_alive()
    assert [s.name for s in spans] == ["inner", "detector.encode", "detector.analyze"]
    assert dict(timer.counts) == {"detector.analyze": 1}
    assert timer.self_report() == timer.report()


def test_collect_keeps_spans_only_while_open():
    with span("before"):
        pass
    with collect() as outer:
        with span("a"):
            pass
        with collect() as inner:
            with collect() as empty:
                pass
            with span("b"):
                pass
        with span("c"):
            pass
    with span("after"):
        pass
    assert [s.name for s in outer] == ["a", "b", "c"]
    assert [s.name for s in inner] == ["b"] and empty == []
    assert profiling._collectors == ()


class CountingRecord:
    calls = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        CountingRecord.calls.append(self.name)

    def __exit__(self, *exc):
        pass


def test_record_function_only_under_a_profiler(monkeypatch):
    """Without a profiler a span makes no ``record_function`` call; under
    one, one per span."""
    monkeypatch.setattr(profiling, "record_function", CountingRecord)
    CountingRecord.calls = []
    timer = StageTimer()
    with timer.stage("detector.analyze"), span("detector.stage"):
        pass
    assert CountingRecord.calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.stage("detector.analyze"), span("detector.stage"):
            pass
    assert CountingRecord.calls == ["detector.analyze", "detector.stage"]


def test_analysis_timings_from_the_spans():
    """``upload`` is staging plus copy; ``device`` the self time of the
    analysis and of the spans that issue or wait on the frame steps,
    nested ones counted once; the host spans stay out of it."""
    timer = StageTimer()
    for name, seconds, own in (("detector.analyze", 10.0, 1.0), ("detector.stage", 1.0, 1.0),
                               ("detector.upload", 0.5, 0.5), ("detector.decode", 2.0, 2.0),
                               ("detector.temporal", 0.25, 0.25),
                               ("detector.encode", 1.0, 1.0), ("mtcnn.cascade", 3.0, 2.0),
                               ("mtcnn.pyramid", 1.0, 1.0), ("detector.embed", 0.25, 0.25),
                               ("detector.fetch", 1.0, 1.0)):
        timer._add(name, seconds, own)
    keys = ("decode", "upload", "temporal", "encode")
    assert analysis_timings(timer, keys) == {
        "decode": 2.0, "upload": 1.5, "device": 5.25, "temporal": 0.25, "encode": 1.0,
        "total": 10.0}
    assert sum(analysis_timings(timer, keys).values()) == 2 * 10.0
    assert analysis_timings(timer, ("upload",)) == {"upload": 1.5, "device": 5.25,
                                                    "total": 10.0}
    assert list(analysis_timings(StageTimer(), ("upload",)).values()) == [0.0, 0.0, 0.0]


# The detector on the CPU: random nets at 72x96 with permissive thresholds.
H, W = 72, 96
DETECTOR_RANGES = {"detector.analyze", "detector.stage", "detector.upload", "detector.fetch",
                   "mtcnn.pyramid", "mtcnn.cascade", "detector.embed"}
TRACK_RANGES = DETECTOR_RANGES | {"detector.sync", "tracks.fold"}
FILE_RANGES = {"detector.analyze", "detector.decode", "detector.upload", "detector.temporal",
               "detector.encode", "detector.fetch", "mtcnn.pyramid", "mtcnn.cascade",
               "detector.embed"}


def detector(**kw):
    cfg = DetectorConfig(frame_batch=4, compute_dtype="float32",
                         mtcnn=MTCNNConfig(pnet_topk_total=32, rnet_capacity=8, onet_capacity=4,
                                           thresholds=(0.3, 0.3, 0.3)), **kw)
    return Detector(cfg, device="cpu")


@pytest.fixture(scope="module")
def packed():
    return np.random.default_rng(5).integers(0, 256, (10, H * 3 // 2, W), dtype=np.uint8)


def trace_ranges(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def by_name(spans):
    totals = {}
    for s in spans:
        totals[s.name] = totals.get(s.name, 0.0) + s.end - s.start
    return totals


def test_detector_ranges_land_in_the_profiler_trace(packed, tmp_path):
    """``analyze_i420`` and ``analyze_i420_tracks`` (K=2, so the propagate
    syncs run) under a CPU profiler: its trace holds every range of the
    detector, and the collected spans of each analysis lie inside its
    ``detector.analyze``."""
    single, tracks = detector(), detector(multi_face=True, max_tracks=2, detect_interval=2)
    with collect() as spans, profile(activities=[ProfilerActivity.CPU]) as prof:
        single.analyze_i420(packed, 10)
        tracks.analyze_i420_tracks(packed, 10)
    assert TRACK_RANGES <= trace_ranges(prof, tmp_path / "trace.json")
    roots = [s for s in spans if s.name == "detector.analyze"]
    assert len(roots) == 2
    inside = [[s.name for s in spans if r.start <= s.start and s.end <= r.end] for r in roots]
    assert sum(map(len, inside)) == len(spans)
    assert set(inside[0]) == DETECTOR_RANGES and set(inside[1]) == TRACK_RANGES


def test_analyze_i420_timings_are_its_spans(packed):
    det = detector()
    with collect() as spans:
        got = det.analyze_i420(packed, 10)
    totals = by_name(spans)
    assert set(totals) == DETECTOR_RANGES
    assert list(got.timings) == ["upload", "device", "total"]
    assert got.timings["upload"] == pytest.approx(totals["detector.stage"]
                                                  + totals["detector.upload"])
    assert got.timings["total"] == pytest.approx(totals["detector.analyze"])
    assert got.timings["device"] == pytest.approx(got.timings["total"] - got.timings["upload"])
    assert got.timings["device"] >= totals["mtcnn.cascade"] + totals["detector.fetch"]
    assert sum(s.name == "detector.stage" for s in spans) == 3   # one per batch of 4


def write_avi(path, packed):
    out = RawAviWriter(str(path), 10, W, H)
    for p in packed:
        out.write_i420(p)
    out.close()
    return str(path)


def test_analyze_video_timings_are_its_spans(packed, tmp_path):
    """A file analysis with an output: every timing is a sum of the caller's
    spans, and they add up to ``total``; the worker's ``detector.encode``
    spans (annotating and writing) are collected, but stay out of the
    timings and of the trace of a profiler started on the caller's
    thread."""
    src = write_avi(tmp_path / "in.avi", packed)
    det = detector()
    with collect() as spans, profile(activities=[ProfilerActivity.CPU]) as prof:
        got = det.analyze_video(src, str(tmp_path / "out.avi"))
    # The profiler records the thread that started it: not the encode worker.
    assert FILE_RANGES <= trace_ranges(prof, tmp_path / "trace.json")
    totals = by_name(spans)
    assert set(totals) == FILE_RANGES
    t = got.timings
    assert list(t) == ["decode", "upload", "device", "temporal", "encode", "total"]
    for key, name in (("decode", "detector.decode"), ("upload", "detector.upload"),
                      ("temporal", "detector.temporal"), ("total", "detector.analyze")):
        assert t[key] == pytest.approx(totals[name])
    # Collected: per segment (batches of 4 sampled frames) the worker's
    # annotate and write and the caller's hand-on, and the writer's open
    # and close.
    segments = -(-got.total_processed // 4)
    assert segments == 3
    assert sum(s.name == "detector.encode" for s in spans) == 2 * segments + 2
    assert 0 < t["encode"] < totals["detector.encode"]
    assert sum(t.values()) == pytest.approx(2 * t["total"])


class SlowWriter:
    """A writer that takes ``per_frame`` seconds a frame and ``close``
    seconds to close."""

    def __init__(self, path, fps, width, height, per_frame=0.0, close=0.0):
        self.per_frame, self.closing = per_frame, close
        self.frames = 0

    def write(self, frame):
        self.frames += 1
        time.sleep(self.per_frame)

    write_i420 = write

    def close(self):
        time.sleep(self.closing)


def test_analyze_video_device_leaves_out_a_slow_writer(packed, tmp_path, monkeypatch):
    """An analysis bound by its writer: the caller's wait on the encode
    worker and the writer's close are ``encode``, and ``device`` does not
    grow with them."""
    src = write_avi(tmp_path / "in.avi", packed)
    det = detector()
    fast = det.analyze_video(src, str(tmp_path / "out.avi"))
    monkeypatch.setattr(detector_module, "VideoWriter",
                        lambda *a: SlowWriter(*a, per_frame=0.3, close=3.0))
    slow = det.analyze_video(src, str(tmp_path / "out.avi"))
    assert [r.flagged for r in slow.records] == [r.flagged for r in fast.records]
    # The 3 s close, and the writes (0.3 s a frame) the caller waits for.
    assert slow.timings["encode"] >= 3.0
    assert slow.timings["device"] < fast.timings["device"] + 2.0
    assert sum(slow.timings.values()) == pytest.approx(2 * slow.timings["total"])
