"""The program's ranges read from hand-built Chrome events: device work
put down to the innermost range open on the launching thread when its
runtime call started (matched by ``correlation``), idle gaps split by the
innermost range open on the window's thread, and the readings, each None
without its span."""

from typing import NamedTuple

import pytest

from benchmark import program_spans
from benchmark.program_spans import OUTSIDE, ranges, readings

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
    assert t.busy_s == pytest.approx(29 * us) and t.idle_s == pytest.approx(71 * us)
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
    # the stages (10 + 10), K1 (3) and the copy (4); not the fold
    assert t.covered_s == pytest.approx(27 * us)


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


class Span(NamedTuple):
    name: str
    start: float
    end: float


def test_readings():
    t = ranges(events())
    host = [Span("detector.stage", 0.0, 0.002), Span("detector.stage", 1.0, 1.004),
            Span("detector.sync", 2.0, 2.001)]
    got = readings(t, traced_frames=10, host_spans=host, host_frames=4)
    assert got["stage_host_ms.batch"] == pytest.approx(1.5)
    assert got["sync_host_ms.batch"] == pytest.approx(0.25)
    assert got["stage_idle.batch"] == pytest.approx(16.0)
    assert got["fold_idle.batch"] == pytest.approx(8.0)
    assert got["pyramid_device_ms.batch"] == pytest.approx(1e-3)
    assert got["cascade_device_ms.batch"] == pytest.approx(1e-3)
    assert got["embed_device_ms.batch"] is None            # no detector.embed range
    assert got["fold_launches"] == 1.0
    assert set(got) == set(program_spans.READINGS)


@pytest.mark.parametrize("name", sorted(program_spans.READINGS))
def test_each_reading_is_none_without_its_span(name):
    """The parent commit's trace holds no program range and it records no
    span: every reading is None there."""
    assert readings(None, 10, [], 4)[name] is None
    bare = [e for e in events() if not e["name"].startswith(("detector.", "mtcnn.", "tracks."))]
    bare.append(x("user_annotation", "other.range", 40, 40))
    assert readings(ranges(bare), 10, [Span("other.range", 0.0, 1.0)], 4)[name] is None
