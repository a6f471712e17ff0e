"""The metric arithmetic: a rate over the whole window, the traffic's
fixed work per seed, the readings on the host's clock taken only after
the trace, the upload read from the trace, and the trace's busy time and
idle gaps."""

import pytest

from benchmark import check, spec, trace, traffic
from benchmark.closed_loop import Unit, frame_rows, steps_of
from benchmark.outcome import Outcome
from benchmark.trace import TraceSummary


def outcome(**kw):
    base = dict(setup_s=1.0, window_s=10.0, units=[], traced_units=0, host_from=0.0,
                launches={}, spans={}, trace_summary=None, numbers={}, limits={}, attempted=0,
                failed=0, memory_peak_bytes=0, cards=1, checked=0)
    base.update(kw)
    return Outcome(**base)


def unit(frames, t0, t1, **kw):
    base = dict(start=0, frames=frames, t0=t0, t1=t1, fallback=0,
                steps=steps_of(frames, 32, 1, 0), result=None)
    base.update(kw)
    return Unit(**base)


def test_rate_is_all_frames_over_the_whole_window():
    out = outcome(units=[unit(100, 0.0, 4.0), unit(300, 4.0, 10.5)], window_s=10.5)
    assert spec.metric_reader("sampled_fps")(None, out) == pytest.approx(400 / 10.5)


def test_every_seed_gets_the_same_lengths():
    mix = {"order_seed": 7, "lengths": {"dist": "uniform", "low": 105, "high": 420, "strata": 8}}
    runs = []
    for seed in (1, 2, 2**31 + 5):
        gen = traffic.closed_clips(mix, seed)
        runs.append([next(gen) for _ in range(16)])
    lengths = [[c.frames for c in clips] for clips in runs]
    assert lengths[0] == lengths[1] == lengths[2]  # the mix's order, whatever the seed
    assert sorted(lengths[0][:8]) == sorted(lengths[0][8:]) and lengths[0][:8] != lengths[0][8:]
    assert [c.start for c in runs[0]] != [c.start for c in runs[1]]  # the seed's content


@pytest.mark.parametrize("name", ["i420_1080p_pool", "i420_1080p_stable"])
def test_mixes_send_ten_second_clips(name):
    cell = spec.make("x", 1, spec.BENCH / "configs" / "facenet_single.json", name, [], [])
    mix = cell.traffic
    assert traffic.lengths(mix) == [10 * mix["fps"]]
    gen = traffic.closed_clips(mix, 2**33 + 1)
    assert {next(gen).frames for _ in range(5)} == {70}


def test_frame_rows_leave_out_padding():
    assert frame_rows(70, 32, 1) == {"full": 70}
    # segments of 32, 32 and 6 frames: keyframes 8 + 8 + 2
    assert frame_rows(70, 32, 4) == {"detect": 18, "propagate": 70}
    assert frame_rows(64, 32, 4) == {"detect": 16, "propagate": 64}


def test_host_readings_come_from_after_the_trace():
    from benchmark.counts.nets import row_flops
    from benchmark.counts import BF16_FLOPS_PER_S

    cell = spec.load("single_1080p_i420")
    units = [unit(70, 0.0, 1.0), unit(70, 1.0, 2.5), unit(70, 3.0, 4.0), unit(70, 4.0, 5.0)]
    out = outcome(units=units, traced_units=2, host_from=3.0, window_s=5.0)
    per = row_flops(cell.config["detector"], 1080, 1920)["full"]
    got = spec.metric_reader("step_mfu")(cell, out)
    assert got == pytest.approx(100 * 2 * 70 * per / 2.0 / BF16_FLOPS_PER_S)
    assert spec.metric_reader("step_mfu")(cell, out._replace(traced_units=4)) is None
    fold = spec.metric_reader("fold_host_ms")
    assert fold(cell, outcome(spans={"track_fold": [0.1, 0.3]})) == pytest.approx(200.0)
    assert fold(cell, outcome()) is None


def test_upload_is_the_device_time_of_host_to_device_copies():
    units = [unit(70, 0.0, 1.0), unit(70, 1.0, 2.0), unit(70, 2.0, 3.0)]
    ops = [("Memcpy HtoD (Pageable -> Device)", 0.07, 6), ("Memcpy DtoH (Device -> Pageable)",
                                                            0.5, 9),
           ("Memcpy HtoD (Pinned -> Device)", 0.0014, 2), ("gemm", 2.0, 30)]
    s = TraceSummary(3.0, 2.5, 1, ops, [])
    read = spec.metric_reader("upload_ms.batch")
    got = read(None, outcome(units=units, traced_units=2, trace_summary=s))
    assert got == pytest.approx(1e3 * 0.0714 / 140)
    assert read(None, outcome(units=units, traced_units=0, trace_summary=s)) is None
    assert read(None, outcome(units=units, traced_units=2,
                              trace_summary=s._replace(device_ops=ops[1:2]))) is None


def test_sample_takes_the_longest_and_stays_within_the_frames():
    units = [unit(n, 0, 1) for n in (100, 400, 150, 300, 120)]
    for seed in range(5):
        chosen = check.sample(units, seed, 600)
        assert 1 in chosen
        assert sum(units[i].frames for i in chosen) <= 600


def test_trace_busy_and_gaps():
    ev = [{"ph": "X", "name": trace.WINDOW, "cat": "user_annotation", "ts": 0, "dur": 100,
           "pid": 1, "tid": 1},
          {"ph": "X", "name": "bench.clip", "cat": "user_annotation", "ts": 0, "dur": 100,
           "pid": 1, "tid": 1},
          {"ph": "X", "name": "aten::copy_", "cat": "cpu_op", "ts": 25, "dur": 30, "pid": 1,
           "tid": 1},
          {"ph": "X", "name": "k1", "cat": "kernel", "ts": 10, "dur": 10, "args": {"device": 0}},
          {"ph": "X", "name": "k2", "cat": "kernel", "ts": 15, "dur": 10, "args": {"device": 0}},
          {"ph": "X", "name": "k1", "cat": "kernel", "ts": 60, "dur": 20, "args": {"device": 0}},
          {"ph": "X", "name": "k1", "cat": "kernel", "ts": 90, "dur": 30, "args": {"device": 0}}]
    s = trace.summarize(ev, cards=1)
    # busy [10, 25) + [60, 80) + [90, 100): 45 us of 100
    assert s.window_s == pytest.approx(100e-6) and s.busy_s == pytest.approx(45e-6)
    assert s.device_ops[0][0] == "k1" and s.device_ops[0][1] == pytest.approx(40e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["bench.clip > aten::copy_"] == pytest.approx(35e-6)       # [25, 60)
    assert gaps["bench.clip > no host op"] == pytest.approx(20e-6)        # [0, 10), [80, 90)
    idle = spec.metric_reader("device_idle.batch")(None, outcome(trace_summary=s))
    assert idle == pytest.approx(55.0)
    # two cards: the busy time is their mean
    ev2 = ev + [{"ph": "X", "name": "k1", "cat": "kernel", "ts": 0, "dur": 100,
                 "args": {"device": 1}}]
    assert trace.summarize(ev2, cards=2).busy_s == pytest.approx(72.5e-6)
