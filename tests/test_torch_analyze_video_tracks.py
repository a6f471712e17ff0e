"""The port's annotated outputs and its propagate and multi-face paths from
files, against the JAX package's on the same I420 AVI files, at float32 on
the CPU with the same seeded JAX weights (the settings of
``tests/test_torch_analyze_video.py``).

The frames each side hands its video writer (``VideoWriter`` replaced in
each detector module by ``Capture``) are equal: the port's drawn frames as
BGR, its other frames as the decoded I420 pictures, converted for the
comparison; the JAX package's all as BGR from cv2.  Decisions are equal,
boxes within 1 px, similarities within 1e-4.
"""

import numpy as np
import pytest
import torch

from tests.test_auto_interval import blurred
from tests.test_torch_analyze_video import clip, jax_video, write_clip  # noqa: F401
from tests.test_torch_propagate import assert_records_match, configs, trees  # noqa: F401

from truely_tpu.pipeline import detector as jdetector_mod
from truely_tpu.pipeline.detector import Detector as JDetector
from truely_tpu_torch.media import native
from truely_tpu_torch.media.decode import VideoReader
from truely_tpu_torch.pipeline import detector as tdetector_mod
from truely_tpu_torch.pipeline.detector import Detector

torch.set_num_threads(2)

MF = dict(multi_face=True, max_tracks=3, similarity_threshold=0.9999, run_length_threshold=3)
# Thresholds under which the blurred content flags frames.
FLAGGING = dict(similarity_threshold=0.9999, run_length_threshold=3)


class Capture:
    """A stand-in video writer that keeps the BGR picture of every frame,
    by output path."""

    made = {}

    def __init__(self, path, fps, width, height, **_):
        self.frames = Capture.made.setdefault(path, [])

    def write(self, frame):
        self.frames.append(np.array(frame))

    def write_i420(self, packed):
        self.frames.append(native.i420_to_bgr_host(packed))

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def captured(monkeypatch, module, run):
    """The result of ``run()`` and the frames it hands the one video writer
    of ``module``."""
    Capture.made = {}
    with monkeypatch.context() as m:
        m.setattr(module, "VideoWriter", Capture)
        result = run()
    (frames,) = Capture.made.values()
    return result, frames


@pytest.mark.parametrize("draw_mode", ["all", "flagged-only"])
def test_annotated_output_matches_jax(trees, clip, tmp_path, monkeypatch, draw_mode):
    """The frames each side hands its writer are equal: drawn frames as
    BGR, the port's others as the decoded I420 pictures."""
    jcfg, cfg = configs(draw_mode=draw_mode, **FLAGGING)
    out = str(tmp_path / "out.avi")
    ref, ref_frames = captured(monkeypatch, jdetector_mod,
                               lambda: jax_video(JDetector(jcfg), clip, out))
    got, frames = captured(monkeypatch, tdetector_mod,
                           lambda: Detector(cfg, params=trees, device="cpu").analyze_video(clip, out))
    assert_records_match(got, ref)
    assert got.output_path == out
    drawn = [r for r in got.records if r.annotated and (draw_mode == "all" or r.flagged)]
    assert drawn and any(r.flagged for r in got.records)
    if draw_mode == "flagged-only":
        assert any(r.annotated and not r.flagged for r in got.records)
    assert len(frames) == len(ref_frames) == 30
    for k, (a, b) in enumerate(zip(frames, ref_frames)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")


@pytest.mark.parametrize("interval", [4, "auto"])
def test_propagate_from_file_matches_jax(trees, tmp_path, interval):
    """K=4 and "auto" over a file: the one-deep pipeline feeds the keyframe
    cycles and the ladder from the reader's segments."""
    path = write_clip(str(tmp_path / "stable.avi"), blurred(0, 40), 10)
    jcfg, cfg = configs(detect_interval=interval, auto_interval_max=4)
    det = Detector(cfg, params=trees, device="cpu")
    jdet = JDetector(jcfg)
    ref = jax_video(jdet, path)
    got = det.analyze_video(path)
    assert_records_match(got, ref)
    assert sum(r.has_face for r in got.records) > 20
    if interval == "auto":
        assert (det.auto_interval_current, det.auto_keyframe_segments,
                det.auto_refine_segments) == (jdet.auto_interval_current,
                                              jdet.auto_keyframe_segments,
                                              jdet.auto_refine_segments)
        assert det.auto_refine_segments > 0


def test_multiface_with_output_matches_jax(trees, clip, tmp_path, monkeypatch):
    jcfg, cfg = configs(**MF)
    out = str(tmp_path / "mf.avi")
    (jagg, jper, jstate), ref_frames = captured(
        monkeypatch, jdetector_mod, lambda: jax_video(JDetector(jcfg), clip, out, multiface=True))
    det = Detector(cfg, params=trees, device="cpu")
    (agg, per, state), frames = captured(
        monkeypatch, tdetector_mod, lambda: det.analyze_video_multiface(clip, out))
    assert agg == jagg and np.array_equal(per, np.asarray(jper))
    for name in ("active", "counter", "flagged_count", "processed"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)))
    assert int(state.processed.sum()) > 0
    assert len(frames) == len(ref_frames) == 30
    with VideoReader(clip) as r:
        assert any((a != f).any() for a, (_, f) in zip(frames, r.frames())), "no box drawn"
    for k, (a, b) in enumerate(zip(frames, ref_frames)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    # The score-only run gives the same result.
    agg2, per2, _ = det.analyze_video_multiface(clip)
    assert agg2 == agg and np.array_equal(per2, per)


def test_draw_landmarks_matches_jax(trees, clip, tmp_path, monkeypatch):
    """Landmark dots on the drawn frames: equal to the JAX drawing, except
    where a dot's float position rounds to the neighbouring pixel."""
    jcfg, cfg = configs(draw_landmarks=True)
    out = str(tmp_path / "lm.avi")
    _, ref_frames = captured(monkeypatch, jdetector_mod,
                             lambda: jax_video(JDetector(jcfg), clip, out))
    _, frames = captured(monkeypatch, tdetector_mod,
                         lambda: Detector(cfg, params=trees, device="cpu").analyze_video(clip, out))
    _, plain = captured(monkeypatch, tdetector_mod,
                        lambda: Detector(configs()[1], params=trees,
                                         device="cpu").analyze_video(clip, out))
    dots = sum(int((a != b).any(axis=-1).sum()) for a, b in zip(frames, plain))
    differ = sum(int((a != b).any(axis=-1).sum()) for a, b in zip(frames, ref_frames))
    assert dots > 0
    assert differ <= dots // 100
