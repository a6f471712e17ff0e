"""The port's profiling utilities (``truely_tpu_torch/utils/profiling.py``)
on the CPU: ``StageTimer`` on an injected clock, the timers' slope
arithmetic with an injected timer (and, for ``measure_ingraph``, an
injected capture in place of the CUDA graph), and the trace parsers on a
``torch.profiler`` trace of CPU ops and on a written trace of device
events.  No assertion reads the wall clock.
"""

import gzip
import json

import pytest
import torch

from truely_tpu_torch.utils import StageTimer as ExportedStageTimer
from truely_tpu_torch.utils import profiling
from truely_tpu_torch.utils.profiling import (
    StageTimer, device_op_table, measure_forced, measure_ingraph, profile_trace, top_device_ops,
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


def write_trace(path, events, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_device_op_table_from_written_traces(tmp_path):
    """Device events (kernels, copies, memsets) summed by name across the
    trace files of a directory; CPU events and other phases left out."""
    (tmp_path / "run").mkdir()
    write_trace(tmp_path / "run" / "a.json", [
        {"ph": "X", "cat": "kernel", "name": "k_nms", "dur": 1500.0},
        {"ph": "X", "cat": "kernel", "name": "k_crop", "dur": 250.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 9000.0},
        {"ph": "M", "cat": "kernel", "name": "process_name"},
    ])
    write_trace(tmp_path / "run" / "b.pt.trace.json.gz", [
        {"ph": "X", "cat": "kernel", "name": "k_crop", "dur": 750.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 100.0},
    ], gz=True)
    rows = device_op_table(str(tmp_path))
    assert rows == [("k_nms", 1.5, 1), ("k_crop", 1.0, 2), ("Memcpy HtoD", 0.1, 1)]
    assert device_op_table(str(tmp_path / "run" / "a.json")) == [("k_nms", 1.5, 1),
                                                                 ("k_crop", 0.25, 1)]
    text = top_device_ops(str(tmp_path), top=2).splitlines()
    assert text[0] == "total device op time: 2.6 ms over 3 op names"
    assert len(text) == 3 and text[1].split() == ["1.50", "ms", "x", "1", "k_nms"]


def test_profile_trace_writes_a_readable_trace(tmp_path):
    """profile_trace around CPU work: the Chrome trace lands in the
    directory and its CPU ops parse with the same reader."""
    a = torch.ones(64, 64)
    with profile_trace(str(tmp_path), cuda=False) as prof:
        for _ in range(3):
            a = torch.mm(a, a) * 0.01
    assert prof is not None
    rows = dict((name, n) for name, _, n in device_op_table(str(tmp_path),
                                                            categories=("cpu_op",)))
    assert rows["aten::mm"] == 3
    assert device_op_table(str(tmp_path)) == []  # no device ran


def test_profile_trace_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profile_trace(str(tmp_path)):
            pass


def test_profile_trace_does_not_swallow_errors(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profile_trace(str(tmp_path), cuda=False):
            1 / 0
