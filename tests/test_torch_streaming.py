"""The port's ``StreamScheduler`` (``truely_tpu_torch/pipeline/streaming.py``)
against the JAX package's, fed the same pushes, and against the port's own
solo analysis of each stream, at float32 on the CPU with the same seeded
JAX weights.

Content and cascade settings are those of ``tests/test_torch_propagate.py``
(blurred 64x96 frames, small capacities, permissive thresholds).  Event
decisions (has_face, flagged, annotated, counters; per track: updated,
flagged, active), stats, scores, keyframe steps and the "auto" rung are
equal; boxes within 1 px, similarities within 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.test_auto_interval import blurred, flat_gray
from tests.test_torch_propagate import CASCADE, trees  # noqa: F401  (trees: a fixture)

from truely_tpu.config import DetectorConfig as JDetectorConfig
from truely_tpu.config import MTCNNConfig as JMTCNNConfig
from truely_tpu.ops import yuv as jyuv
from truely_tpu.pipeline.detector import Detector as JDetector
from truely_tpu.pipeline.streaming import StreamScheduler as JStreamScheduler
from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
from truely_tpu_torch.pipeline.detector import Detector
from truely_tpu_torch.pipeline.streaming import MultiFaceStreamEvent, StreamScheduler

torch.set_num_threads(2)

MF = dict(multi_face=True, max_tracks=3, similarity_threshold=0.9999, run_length_threshold=3)


def configs(**kw):
    common = dict(frame_batch=8, compute_dtype="float32", **kw)
    return (JDetectorConfig(mtcnn=JMTCNNConfig(**CASCADE), **common),
            DetectorConfig(mtcnn=MTCNNConfig(**CASCADE), **common))


@pytest.fixture(scope="module")
def dets(trees):
    """(JAX detector, port detector) of the single-face settings."""
    jcfg, cfg = configs()
    return JDetector(jcfg), Detector(cfg, params=trees, device="cpu")


@pytest.fixture(scope="module")
def mdets(trees):
    """(JAX detector, port detector) of the multi-face settings."""
    jcfg, cfg = configs(**MF)
    return JDetector(jcfg), Detector(cfg, params=trees, device="cpu")


def streams(*lengths, seed=0):
    return [blurred(seed + i, n) for i, n in enumerate(lengths)]


def feed(sched, content, every=8, sampled=None):
    """Push the streams frame by frame, round robin, stepping whenever
    ``every`` sampled frames are queued; then drain.  ``sampled``: push
    only every ``sampled``-th frame with ``push_sampled``."""
    events = []
    for t in range(max(len(c) for c in content)):
        for i, c in enumerate(content):
            if t >= len(c):
                continue
            if sampled is None:
                sched.push(i, c[t])
            elif t % sampled == 0:
                sched.push_sampled(i, c[t], t, t + 1)
        if sched.pending() >= every:
            events.extend(sched.step())
    events.extend(sched.drain())
    return events


def run_both(dets, content, **kw):
    """The JAX scheduler and the port's, fed alike; returns both."""
    jdet, det = dets
    feed_kw = {k: kw.pop(k) for k in ("every", "sampled") if k in kw}
    jsched = JStreamScheduler(jdet, **kw)
    with jax.default_matmul_precision("highest"):
        jev = feed(jsched, content, **feed_kw)
    sched = StreamScheduler(det, **kw)
    ev = feed(sched, content, **feed_kw)
    return (jsched, jev), (sched, ev)


def assert_events_match(got, ref):
    assert len(got) == len(ref)
    multi = isinstance(got[0], MultiFaceStreamEvent)
    keys = (("stream_id", "frame_index", "track_updated", "track_flagged", "track_active")
            if multi else ("stream_id", "frame_index", "has_face", "flagged", "annotated",
                           "counter"))
    for a, b in zip(got, ref):
        assert [getattr(a, k) for k in keys] == [getattr(b, k) for k in keys]
    boxes, sims = ("track_boxes", "track_sim") if multi else ("box", "similarity")
    np.testing.assert_allclose([getattr(e, boxes) for e in got], [getattr(e, boxes) for e in ref],
                               atol=1)
    np.testing.assert_allclose([getattr(e, sims) for e in got], [getattr(e, sims) for e in ref],
                               atol=1e-4)


def assert_schedulers_match(jpair, pair):
    (jsched, jev), (sched, ev) = jpair, pair
    assert_events_match(ev, jev)
    for i in range(sched.n_streams):
        assert sched.score(i) == jsched.score(i)
        assert sched.stream_counter(i) == jsched.stream_counter(i)
        assert dataclasses.astuple(sched.stats[i]) == dataclasses.astuple(jsched.stats[i])
        if sched.multi_face:
            np.testing.assert_array_equal(sched.track_scores_for(i), jsched.track_scores_for(i))
    counters = ("steps_run", "frames_stepped", "frames_padded", "keyframe_steps")
    assert [getattr(sched, c) for c in counters] == [getattr(jsched, c) for c in counters]


def test_unbalanced_streams_match_jax_and_solo(dets):
    """Three streams of 24, 10 and 17 frames: the scheduler's events equal
    the JAX scheduler's and each stream's solo analysis."""
    content = streams(24, 10, 17)
    jpair, pair = run_both(dets, content, n_streams=3, frames_per_stream=4, fps=10)
    assert_schedulers_match(jpair, pair)
    sched, ev = pair
    assert sched.frames_padded > 0 and any(e.has_face for e in ev)
    for i, c in enumerate(content):
        solo = dets[1].analyze_frames(c, fps=10)
        mine = sorted((e for e in ev if e.stream_id == i), key=lambda e: e.frame_index)
        assert [(e.frame_index, e.has_face, e.flagged, e.annotated, e.counter) for e in mine] == \
            [(r.frame_index, r.has_face, r.flagged, r.annotated, r.counter) for r in solo.records]
        np.testing.assert_allclose([e.similarity for e in mine],
                                   [r.similarity for r in solo.records], atol=1e-4)
        assert sched.score(i) == solo.fake_score
        assert sched.stats[i].flagged_count == solo.flagged_count


def test_push_sampled_and_sampling(dets):
    """push_sampled with the caller's own sampling (every 3rd frame), and
    push's own sampling at fps 30 (every 4th frame)."""
    content = streams(20, 13, seed=5)
    assert_schedulers_match(*run_both(dets, content, n_streams=2, frames_per_stream=4, fps=30,
                                      sampled=3))
    jpair, pair = run_both(dets, content, n_streams=2, frames_per_stream=4, fps=30)
    assert_schedulers_match(jpair, pair)
    assert [e.frame_index for e in pair[1] if e.stream_id == 1] == [0, 4, 8, 12]


def test_reset_stream_recycles_slot_exactly(dets):
    _, det = dets
    first, second = streams(16, 16, seed=20)
    sched = StreamScheduler(det, n_streams=2, frames_per_stream=4, fps=10)
    feed(sched, [first, second[:8]])
    assert sched.stats[0].processed == 16
    sched.reset_stream(0)
    fresh = StreamScheduler(det, n_streams=2, frames_per_stream=4, fps=10)
    for a, b in zip(sched._states, fresh._states):
        assert torch.equal(a[0], b[0])
    assert sched.stats[0].processed == 0 and sched.stream_counter(0) == 0
    for t in range(16):
        sched.push(0, second[t])
    sched.drain()
    solo = det.analyze_frames(second, fps=10)
    assert sched.score(0) == solo.fake_score
    assert sched.stream_counter(0) == solo.final_counter
    assert sched.stats[0].processed == 16


def test_fixed_interval_cadence_and_promotion_match_jax(dets):
    """K=4 over two streams: keyframe steps every 4th step once seeds hold,
    refine steps between; on flat content no seed survives, so every step
    is promoted to a keyframe step."""
    content = streams(32, 28, seed=30)
    jpair, pair = run_both(dets, content, n_streams=2, frames_per_stream=4, fps=10,
                           detect_interval=4)
    assert_schedulers_match(jpair, pair)
    sched = pair[0]
    assert 1 <= sched.keyframe_steps < sched.steps_run
    np.testing.assert_array_equal(sched._seed_valid, jpair[0]._seed_valid)
    np.testing.assert_allclose(sched._seed_box, jpair[0]._seed_box, atol=1)
    flat = run_both(dets, [flat_gray(16)] * 2, n_streams=2, frames_per_stream=4, fps=10,
                    detect_interval=4)
    assert_schedulers_match(*flat)
    assert flat[1][0].keyframe_steps == flat[1][0].steps_run == 4


def test_auto_ladder_matches_jax(dets, monkeypatch):
    """Single-face "auto": the rung after every step equals the JAX
    scheduler's, and it climbs on stable content, then collapses on flat."""
    content = [np.concatenate([c, flat_gray(16)]) for c in streams(40, 40, seed=40)]
    rungs = {}
    for cls in (JStreamScheduler, StreamScheduler):
        real = cls.step

        def step(self, real=real, cls=cls):
            out = real(self)
            rungs.setdefault(cls, []).append(self._cur_k)
            return out

        monkeypatch.setattr(cls, "step", step)
    jpair, pair = run_both(dets, content, n_streams=2, frames_per_stream=4, fps=10,
                           detect_interval="auto")
    assert_schedulers_match(jpair, pair)
    assert rungs[StreamScheduler] == rungs[JStreamScheduler]
    assert max(rungs[StreamScheduler]) > 2 and rungs[StreamScheduler][-1] == 1


def test_multiface_matches_jax_and_solo(mdets):
    content = streams(24, 16, seed=50)
    jpair, pair = run_both(mdets, content, n_streams=2, frames_per_stream=4, fps=10)
    assert_schedulers_match(jpair, pair)
    sched, ev = pair
    assert all(isinstance(e, MultiFaceStreamEvent) for e in ev) and len(ev) == 40
    assert any(e.has_face for e in ev)
    for i, c in enumerate(content):
        agg, per_track, state = mdets[1].analyze_frames_tracks(c, fps=10)
        assert sched.score(i) == agg
        np.testing.assert_array_equal(sched.track_scores_for(i), per_track)
        for name, a, b in zip(state._fields, state, sched._states):
            if name in ("box", "embedding"):
                torch.testing.assert_close(b[i], a, atol=1e-4, rtol=0)
            else:
                assert torch.equal(b[i], a), name
    assert max(sched.score(i) for i in range(2)) > 0


def test_multiface_propagate_and_auto_matches_jax(mdets):
    """Multi-face at K=2 refines every stream's track seeds between
    keyframe steps; with "auto" the multi-face scheduler runs full
    detection every step (its events equal K=1's)."""
    content = streams(24, 20, seed=60)
    jpair, pair = run_both(mdets, content, n_streams=2, frames_per_stream=4, fps=10,
                           detect_interval=2)
    assert_schedulers_match(jpair, pair)
    assert 1 <= pair[0].keyframe_steps < pair[0].steps_run
    auto = run_both(mdets, content, n_streams=2, frames_per_stream=4, fps=10,
                    detect_interval="auto")
    assert_schedulers_match(*auto)
    sched = auto[1][0]
    assert not sched.auto_interval and sched.detect_interval == 1 and sched.keyframe_steps == 0
    full = StreamScheduler(mdets[1], n_streams=2, frames_per_stream=4, fps=10, detect_interval=1)
    assert feed(full, content) == auto[1][1]


@pytest.mark.parametrize("multi", [False, True])
def test_yuv_equals_bgr_feeding(dets, mdets, multi):
    h, w, n = 64, 96, 16
    packed = np.empty((2, n, h * 3 // 2, w), np.uint8)
    for i in range(2):
        packed[i, :, :h] = blurred(70 + i, n)[..., 1]
        packed[i, :, h:] = blurred(72 + i, n, h // 2, w)[..., 0] // 2 + 64
    bgr = [np.asarray(jyuv.i420_to_bgr(jnp.asarray(p))) for p in packed]
    det = (mdets if multi else dets)[1]
    kw = dict(n_streams=2, frames_per_stream=4, fps=10, detect_interval=2)
    a = StreamScheduler(det, yuv=True, **kw)
    b = StreamScheduler(det, **kw)
    ev_yuv, ev_bgr = feed(a, list(packed)), feed(b, bgr)
    assert ev_yuv == ev_bgr and any(e.has_face for e in ev_bgr)
    assert [a.score(i) for i in range(2)] == [b.score(i) for i in range(2)]
