"""The port's file streams (``pipeline/stream_files.stream_videos``) and batch
analysis (``pipeline/batch.analyze_videos[_annotated]``) against the JAX
package's on the same files, and against the port's solo runs, at float32
on the CPU with the same seeded JAX weights.

The files are uncompressed I420 AVIs of blurred 64x96 frames: the port
reads them through ``rawavi`` (packed I420, or BGR with ``yuv=False``), the
JAX package through cv2.  Event decisions, stats and scores are equal,
boxes within 1 px, similarities within 1e-4; each stream's summary equals
the solo ``analyze_video`` (``analyze_video_multiface``) of its file.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_auto_interval import blurred
from tests.test_torch_analyze_video import write_clip
from tests.test_torch_analyze_video_tracks import Capture
from tests.test_torch_propagate import configs, trees  # noqa: F401
from tests.test_torch_streaming import assert_events_match

from truely_tpu.media import encode as jencode
from truely_tpu.pipeline.batch import analyze_videos as janalyze_videos
from truely_tpu.pipeline.batch import analyze_videos_annotated as janalyze_videos_annotated
from truely_tpu.pipeline.detector import Detector as JDetector
from truely_tpu.pipeline.stream_files import stream_videos as jstream_videos
from truely_tpu_torch.media.decode import VideoReader
from truely_tpu_torch.pipeline import batch, stream_files
from truely_tpu_torch.pipeline.detector import Detector
from truely_tpu_torch.pipeline.stream_files import stream_videos

torch.set_num_threads(2)

MF = dict(multi_face=True, max_tracks=3, similarity_threshold=0.9999, run_length_threshold=3)
SUMMARY = ("fake_score", "frame_count", "fps", "processed", "flagged_count",
           "suspicious_frames", "track_scores")


@pytest.fixture(scope="module")
def dets(trees):
    jcfg, cfg = configs()
    return JDetector(jcfg), Detector(cfg, params=trees, device="cpu")


@pytest.fixture(scope="module")
def mdets(trees):
    jcfg, cfg = configs(**MF)
    return JDetector(jcfg), Detector(cfg, params=trees, device="cpu")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Three files of 10, 13 and 16 blurred frames at fps 10."""
    d = tmp_path_factory.mktemp("clips")
    return [write_clip(str(d / f"v{i}.avi"), blurred(40 + i, 10 + 3 * i), 10) for i in range(3)]


def jax_streams(jdet, paths, **kw):
    events = []
    with jax.default_matmul_precision("highest"):
        summaries = jstream_videos(jdet, paths, on_event=events.append, **kw)
    return summaries, events


def summary(s):
    return tuple(getattr(s, k) for k in SUMMARY)


def test_stream_matches_jax_and_solo(dets, clips):
    jdet, det = dets
    ref, jev = jax_streams(jdet, clips, frames_per_stream=2)
    events = []
    got = stream_videos(det, clips, frames_per_stream=2, on_event=events.append)
    assert [summary(s) for s in got] == [summary(s) for s in ref]
    assert_events_match(events, jev)
    assert all(s.yuv_ingest for s in got) and not any(s.yuv_ingest for s in ref)
    assert len(events) == sum(s.processed for s in got) == 39
    assert any(e.has_face for e in events)
    for s, path in zip(got, clips):
        solo = det.analyze_video(path)
        assert (s.fake_score, s.frame_count, s.processed, s.flagged_count,
                s.suspicious_frames) == (solo.fake_score, solo.frame_count,
                                         solo.total_processed, solo.flagged_count,
                                         solo.suspicious_frames)
        assert s.wall_s > 0 and s.sampled_fps > 0
        assert s.max_lag_s >= s.p95_lag_s >= s.p50_lag_s >= 0 and s.max_lag_s >= s.mean_lag_s


def test_stream_yuv_and_bgr_agree(dets, clips):
    _, det = dets
    a = stream_videos(det, clips[:2], frames_per_stream=2, yuv=True)
    b = stream_videos(det, clips[:2], frames_per_stream=2, yuv=False)
    assert [summary(s) for s in a] == [summary(s) for s in b]
    assert a[0].yuv_ingest and not b[0].yuv_ingest


def test_stream_rejects_mixed_resolutions(dets, tmp_path):
    _, det = dets
    a = write_clip(str(tmp_path / "a.avi"), blurred(1, 4), 10)
    b = write_clip(str(tmp_path / "b.avi"), blurred(2, 4, h=48, w=64), 10)
    with pytest.raises(ValueError, match="equal resolutions"):
        stream_videos(det, [a, b])


def test_stream_closes_readers_when_one_fails(dets, clips, tmp_path, monkeypatch):
    """A file that cannot be opened raises, and the readers opened before
    it are closed (the JAX package leaks them: ROADMAP.md §C)."""
    _, det = dets
    opened = []

    class Tracking(stream_files.VideoReader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            opened.append(self)

    monkeypatch.setattr(stream_files, "VideoReader", Tracking)
    with pytest.raises(IOError, match="could not open video"):
        stream_videos(det, [clips[0], str(tmp_path / "missing.avi")])
    assert len(opened) == 1 and opened[0]._avi is None


def test_stream_lag_percentiles_and_efficiency(dets, clips):
    _, det = dets
    eff: dict = {}
    s = stream_videos(det, [clips[2]], frames_per_stream=2, scheduler_stats=eff)[0]
    assert s.processed == 16
    assert 0 <= s.p50_lag_s <= s.p95_lag_s <= s.max_lag_s
    assert eff["frames_scored"] == s.processed
    assert eff["frames_padded"] == eff["steps"] * 2 - s.processed
    assert 0 < eff["batch_utilization"] <= 1


def test_stream_realtime_and_partial_step_budget(dets, tmp_path):
    """Paced at fps 30 (interval 4: frames 0 and 4 of 6), the realtime loop
    steps frame 0 alone on its first idle gap; a large budget waits for a
    full batch.  Decisions are equal either way, and equal the JAX
    package's."""
    jdet, det = dets
    path = write_clip(str(tmp_path / "rt.avi"), blurred(11, 6), 30)
    eager, lazy = {}, {}
    s0 = stream_videos(det, [path], frames_per_stream=2, realtime=True,
                       scheduler_stats=eager)[0]
    s1 = stream_videos(det, [path], frames_per_stream=2, realtime=True,
                       partial_step_budget=1e9, scheduler_stats=lazy)[0]
    ref, _ = jax_streams(jdet, [path], frames_per_stream=2, realtime=True,
                         partial_step_budget=1e9)
    assert summary(s0) == summary(s1) == summary(ref[0])
    assert s0.frame_count == 6 and s0.processed == 2 and s0.wall_s >= 0.1
    assert lazy["steps"] == 1 and lazy["batch_utilization"] == 1.0
    assert lazy["steps"] <= eager["steps"]


def test_stream_multiface_matches_jax_and_solo(mdets, clips):
    jdet, det = mdets
    ref, jev = jax_streams(jdet, clips[1:], frames_per_stream=4)
    events = []
    got = stream_videos(det, clips[1:], frames_per_stream=4, on_event=events.append)
    assert [summary(s) for s in got] == [summary(s) for s in ref]
    assert_events_match(events, jev)
    for s, path in zip(got, clips[1:]):
        agg, per_track, _ = det.analyze_video_multiface(path)
        assert s.fake_score == agg and s.track_scores == [int(v) for v in per_track]
    assert any(any(e.track_updated) for e in events)


def test_analyze_videos_matches_jax_and_solo(dets, clips):
    jdet, det = dets
    with jax.default_matmul_precision("highest"):
        ref = janalyze_videos(jdet, clips, frames_per_video=3)
    got = batch.analyze_videos(det, clips, frames_per_video=3)
    keys = ("path", "fake_score", "frame_count", "fps", "total_processed", "flagged_count",
            "suspicious_frames")
    assert [[getattr(r, k) for k in keys] for r in got] == [[getattr(r, k) for k in keys]
                                                           for r in ref]
    for r, path in zip(got, clips):
        solo = det.analyze_video(path)
        assert (r.fake_score, r.total_processed, r.suspicious_frames) == (
            solo.fake_score, solo.total_processed, solo.suspicious_frames)


@pytest.mark.parametrize("multi", [False, True])
def test_analyze_videos_annotated_matches_jax(dets, mdets, clips, tmp_path, monkeypatch, multi):
    """Results, and the frames each side's re-render hands its writer."""
    jdet, det = mdets if multi else dets
    outs = [str(tmp_path / f"o{i}.avi") for i in range(2)]
    Capture.made = {}
    with monkeypatch.context() as m:
        m.setattr(jencode, "VideoWriter", Capture)
        with jax.default_matmul_precision("highest"):
            ref = janalyze_videos_annotated(jdet, clips[:2], outs)
    ref_frames, Capture.made = Capture.made, {}
    with monkeypatch.context() as m:
        m.setattr(batch, "VideoWriter", Capture)
        got = batch.analyze_videos_annotated(det, clips[:2], outs)
    keys = ("fake_score", "frame_count", "total_processed", "flagged_count",
            "suspicious_frames", "output_path", "track_scores")
    assert [[getattr(r, k) for k in keys] for r in got] == [[getattr(r, k) for k in keys]
                                                           for r in ref]
    drawn = 0
    for o in outs:
        assert len(Capture.made[o]) == len(ref_frames[o])
        for a, b in zip(Capture.made[o], ref_frames[o]):
            np.testing.assert_array_equal(a, b)
    for o, path in zip(outs, clips):
        with VideoReader(path) as r:
            drawn += sum(int((a != f).any()) for a, (_, f) in zip(Capture.made[o], r.frames()))
    assert drawn > 0


def test_analyze_videos_annotated_writes_files(dets, clips, tmp_path):
    """The real writer: I420 AVI outputs with every frame of each input."""
    _, det = dets
    outs = [str(tmp_path / f"w{i}.avi") for i in range(2)]
    res = batch.analyze_videos_annotated(det, clips[:2], outs)
    for r, o in zip(res, outs):
        with VideoReader(o, yuv=True) as rd:
            assert rd.meta.frame_count == r.frame_count
