"""The program's ranges read from hand-built Chrome events: device work
put down to the innermost range open on the launching thread when its
runtime call started (matched by ``correlation``), idle gaps split by the
innermost range open on the window's thread, and the four readings of a
named span, each None without its span, through the readers that name
them."""

from typing import NamedTuple

import pytest

from benchmark import program_spans, spec
from benchmark.outcome import Outcome
from benchmark.program_spans import OUTSIDE, ranges
from benchmark.trace import TraceSummary

PID, MAIN, OTHER = 1, 10, 11


def x(cat, name, ts, dur, tid=MAIN, pid=PID, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid,
            "args": args}


def launch(ts, corr, name="cudaLaunchKernel", tid=MAIN):
    return x("cuda_runtime", name, ts, 1, tid=tid, correlation=corr)


def kernel(ts, dur, corr, name="k", cat="kernel"):
    return x(cat, name, ts, dur, pid=0, tid=7, correlation=corr, device=0)


def events():
    """A window of 100 us.  Ranges on the main thread: analyze 2-100,
    stage 10-30, cascade 40-80 with pyramid 45-55 inside, fold 85-95.
    Device work: K1 5-8 (from analyze), a copy 21-25 (stage), a kernel
    50-60 (pyramid), one 60-70 (cascade), one 92-94 (fold)."""
    return [
        x("user_annotation", "bench.window", 0, 100),
        x("user_annotation", "bench.clip", 0, 100),
        x("user_annotation", "detector.analyze", 2, 98),
        x("user_annotation", "detector.stage", 10, 20),
        x("user_annotation", "mtcnn.cascade", 40, 40),
        x("user_annotation", "mtcnn.pyramid", 45, 10),
        x("user_annotation", "tracks.fold", 85, 10),
        x("gpu_user_annotation", "mtcnn.cascade", 50, 20, pid=0, tid=7),
        x("cpu_op", "aten::copy_", 20, 2),
        launch(5, 4), kernel(5, 3, 4, name="i420_to_bgr_kernel"),
        launch(20, 5, name="cudaMemcpyAsync"), kernel(21, 4, 5, "Memcpy HtoD", "gpu_memcpy"),
        launch(46, 1), kernel(50, 10, 1),
        launch(60, 2), kernel(60, 10, 2),
        launch(90, 3), kernel(92, 2, 3),
        launch(120, 6), kernel(150, 5, 6),                     # after the window
        x("user_annotation", "detector.stage", 30, 50, pid=2),   # another process
    ]


def test_device_and_idle_go_to_the_innermost_range():
    t = ranges(events())
    us = 1e-6
    assert t.window_s == pytest.approx(100 * us)
    assert t.idle_s == pytest.approx(71 * us)  # busy 5-8, 21-25, 50-70, 92-94
    got = {n: (r.device_s / us, r.launches, r.idle_s / us, r.calls) for n, r in t.ranges.items()}
    want = {
        "detector.analyze": (3, 1, 25, 1),   # K1; idle 2-5, 8-10, 30-40, 80-85, 95-100
        "detector.stage": (4, 1, 16, 1),     # the copy; idle 10-21, 25-30
        "mtcnn.cascade": (10, 1, 15, 1),     # idle 40-45, 70-80
        "mtcnn.pyramid": (10, 1, 5, 1),      # idle 45-50
        "tracks.fold": (2, 1, 8, 1),         # idle 85-92, 94-95
        OUTSIDE: (0, 0, 2, 0),               # idle 0-2: no range open
    }
    assert set(got) == set(want)
    for name, row in want.items():
        assert got[name] == pytest.approx(row), name
    # every idle second is put down once: the ranges' and the rest add up
    assert sum(r.idle_s for r in t.ranges.values()) == pytest.approx(t.idle_s)


def test_launches_from_another_thread_use_its_ranges():
    """A kernel launched on a second thread goes to that thread's range;
    idle time follows only the window's thread."""
    ev = events() + [x("user_annotation", "detector.encode", 70, 20, tid=OTHER),
                     launch(75, 8, tid=OTHER), kernel(96, 1, 8)]
    t = ranges(ev)
    assert t.ranges["detector.encode"].device_s == pytest.approx(1e-6)
    assert t.ranges["detector.encode"].idle_s == 0.0
    assert t.ranges["tracks.fold"].idle_s == pytest.approx(8e-6)


def test_a_child_cut_at_its_parents_end():
    pieces = program_spans._innermost([(0.0, 10.0, "a"), (4.0, 10.5, "b"), (10.5, 12.0, "c")])
    assert pieces == [(0.0, 4.0, "a"), (4.0, 10.0, "b"), (10.5, 12.0, "c")]


def test_nothing_to_read():
    assert ranges([]) is None
    no_ranges = [e for e in events() if not e["name"].startswith(("detector.", "mtcnn.",
                                                                  "tracks."))]
    assert ranges(no_ranges) is None
    no_device = [e for e in events() if e["cat"] not in ("kernel", "gpu_memcpy")]
    assert ranges(no_device) is None


class Clip(NamedTuple):
    frames: int


def outcome(table, host_spans, traced_frames=10, host_frames=4):
    """A run's ``Outcome`` with ``table`` as its trace's ranges, one traced
    clip of ``traced_frames`` and one after the trace of ``host_frames``
    whose program spans were ``host_spans``."""
    summary = TraceSummary(window_s=table.window_s if table else 0.0, busy_s=0.0, cards=1,
                           device_ops=[], idle_gaps=[], ranges=table)
    return Outcome(setup_s=1.0, window_s=1.0, units=[Clip(traced_frames), Clip(host_frames)],
                   traced_units=1, host_from=0.5, launches={}, spans=host_spans,
                   trace_summary=summary, numbers={}, limits={}, attempted=2, failed=0,
                   memory_peak_bytes=0, cards=1, checked=0)


HOST = {"detector.stage": [0.002, 0.004], "detector.sync": [0.001], "track_fold": [0.5]}
# Each span reader's metric and what it reads from ``events()`` and ``HOST``.
READERS = {
    "stage_host_ms.batch": 1.5,        # 6 ms over the 4 frames after the trace
    "sync_host_ms.batch": 0.25,
    "stage_idle.batch": 16.0,          # 16 of the window's 100 us
    "fold_idle.batch": 8.0,
    "pyramid_device_ms.batch": 1e-3,   # 10 us over the 10 traced frames
    "cascade_device_ms.batch": 1e-3,
    "embed_device_ms.batch": None,     # no detector.embed range
    "fold_launches": 1.0,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_readings(name):
    cell = spec.load("multiface_1080p_k4")
    got = spec.metric_reader(name)(cell, outcome(ranges(events()), HOST))
    assert got == (None if READERS[name] is None else pytest.approx(READERS[name]))


def test_a_span_that_no_reader_names_is_read_alike():
    """The four readings take any span by name: ``detector.analyze``'s K1
    (3 us), idle 25 us and one call; its host spans 2 ms."""
    out = outcome(ranges(events()), {"detector.analyze": [0.002]})
    assert program_spans.device_ms_per_frame(out, "detector.analyze") == pytest.approx(3e-4)
    assert program_spans.idle_share(out, "detector.analyze") == pytest.approx(25.0)
    assert program_spans.launches_per_call(out, "detector.analyze") == 1.0
    assert program_spans.host_ms_per_frame(out, "detector.analyze") == pytest.approx(0.5)


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reading_is_none_without_its_span(name):
    """The parent commit's trace holds no program range and it records no
    span: every reading is None there."""
    cell = spec.load("multiface_1080p_k4")
    read = spec.metric_reader(name)
    assert read(cell, outcome(None, {})._replace(trace_summary=None)) is None
    bare = [e for e in events() if not e["name"].startswith(("detector.", "mtcnn.", "tracks."))]
    bare.append(x("user_annotation", "other.range", 40, 40))
    assert read(cell, outcome(ranges(bare), {"other.range": [1.0]})) is None


def test_a_traced_run_keeps_the_ranges_and_the_spans(monkeypatch, tmp_path):
    """A traced tiny CPU run keeps the table of the program's ranges in its
    trace summary and the spans after the trace in ``Outcome.spans``, and
    the readings read them; an untraced run has neither.  The CPU's
    operations stand in for the device's, and the trace covers the first
    clip only, so that the clips after it are the spans' clips."""
    import time

    import torch

    from benchmark import check, closed_loop, spec, trace
    from benchmark.tests.conftest import tiny

    monkeypatch.setattr(trace, "DEVICE_CATEGORIES", ("cpu_op",))
    monkeypatch.setattr(closed_loop, "TRACE_SECONDS", 0.0)
    cell = tiny(spec.load("multiface_1080p_k4"))
    cell.traffic["lengths"].update(low=24, high=24, strata=1)
    path = tmp_path / "trace.json"
    on, off = (closed_loop.run(cell, 2**32 + 9, 6.0, traced, time.perf_counter(), str(path),
                               device=torch.device("cpu")) for traced in (True, False))
    assert check.judge(on.numbers, on.limits) and check.judge(off.numbers, off.limits)
    assert len(on.units) > on.traced_units >= 1
    assert {"detector.analyze", "detector.stage", "mtcnn.cascade",
            "tracks.fold"} <= set(on.trace_summary.ranges.ranges)
    assert {"track_fold", "detector.stage", "mtcnn.cascade", "tracks.fold"} <= set(on.spans)
    read = {name: spec.metric_reader(name) for name in READERS}
    assert read["stage_host_ms.batch"](cell, on) > 0
    assert read["stage_idle.batch"](cell, on) is not None
    assert off.trace_summary is None and set(off.spans) == {"track_fold"}
    assert {name: r(cell, off) for name, r in read.items()} == dict.fromkeys(READERS)
    assert not path.exists()  # the summary deleted the trace
