"""The port's file entry points (``Detector.analyze_video``,
``analyze_video_multiface``, ``run``) against the JAX package's on the same
files, at float32 on the CPU with the same seeded JAX weights, and the bf16
drift gate (the port's bf16 defaults against the JAX package's).  The
annotated outputs, the propagate paths and the multi-face path from files
are in ``tests/test_torch_analyze_video_tracks.py``.

The port reads an uncompressed I420 AVI through its own ``rawavi`` reader
and kernel K1's plain version; the JAX package reads it through cv2.  An
mp4v file goes through the port's native ``videodec`` where it is built
(cv2 with ``yuv_ingest=False``), and through cv2 in the JAX package.  Content and cascade settings
are those of ``tests/test_torch_propagate.py`` (blurred 64x96 frames, small
capacities, permissive thresholds).  Decisions (has_face, annotated,
flagged, counters, score) are equal, boxes within 1 px, similarities within
1e-4, and the frames each side hands its video writer are equal.
"""

import dataclasses
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from chip_smoke import DRIFT_BOUNDS, drift
from tests.clip import bundled_clip_path
from tests.rawavi import write_i420_avi
from tests.test_auto_interval import blurred
from tests.test_torch_propagate import assert_records_match, configs, trees  # noqa: F401

from truely_tpu.config import DetectorConfig as JDetectorConfig
from truely_tpu.pipeline.detector import Detector as JDetector
from truely_tpu_torch.config import DetectorConfig
from truely_tpu_torch.media import videodec
from truely_tpu_torch.media.decode import VideoReader
from truely_tpu_torch.pipeline import detector as tdetector_mod
from truely_tpu_torch.pipeline.detector import Detector

torch.set_num_threads(2)

def write_clip(path, bgr, fps):
    """BGR frames as an uncompressed I420 AVI (cv2's conversion)."""
    h, w = bgr.shape[1:3]
    write_i420_avi(path, [cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420).ravel() for f in bgr],
                   w, h, fps=fps)
    return path


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """30 blurred frames at fps 14: sample interval 2, 15 sampled frames,
    two batches of 8."""
    return write_clip(str(tmp_path_factory.mktemp("clip") / "clip.avi"), blurred(0, 30), 14)


@pytest.fixture(scope="module")
def fixture_cut(tmp_path_factory):
    """The bundled clip's first 64 frames, re-encoded as mp4v, so that both
    sides read the same compressed bytes through cv2."""
    src = bundled_clip_path()
    if src is None:
        pytest.skip("bundled clip not present")
    path = str(tmp_path_factory.mktemp("cut") / "cut.mp4")
    cap = cv2.VideoCapture(src)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (640, 360))
    for _ in range(64):
        ok, frame = cap.read()
        assert ok
        out.write(frame)
    out.release()
    cap.release()
    return path


@pytest.fixture(scope="module")
def dets(trees):
    """(JAX detector, port detector) of the default test settings."""
    jcfg, cfg = configs()
    return JDetector(jcfg), Detector(cfg, params=trees, device="cpu")


def jax_video(jdet, *args, multiface=False):
    with jax.default_matmul_precision("highest"):
        if multiface:
            return jdet.analyze_video_multiface(*args)
        return jdet.analyze_video(*args)


@pytest.mark.parametrize("yuv", [True, False])
def test_analyze_video_matches_jax(dets, trees, clip, yuv):
    jdet, det = dets
    if not yuv:
        det = Detector(dataclasses.replace(det.config, yuv_ingest=False), params=trees,
                       device="cpu")
    ref = jax_video(jdet, clip)
    got = det.analyze_video(clip)
    assert got.yuv_ingest == yuv and not ref.yuv_ingest
    assert (got.frame_count, got.fps, got.total_processed) == (30, 14, 15)
    assert (got.frame_count, got.fps) == (ref.frame_count, ref.fps)
    assert [r.frame_index for r in got.records] == list(range(0, 30, 2))
    assert_records_match(got, ref)
    assert any(r.has_face for r in got.records)
    assert set(got.timings) == {"decode", "upload", "device", "temporal", "encode", "total"}


def test_analyze_video_fixture_cut_matches_jax(dets, fixture_cut):
    """The mp4v cut is eligible for packed-I420 ingest: where the libav
    headers let the port's ``videodec`` be built it reads the cut (the JAX
    package reads it through cv2), else cv2 does."""
    jdet, det = dets
    ref = jax_video(jdet, fixture_cut)
    got = det.analyze_video(fixture_cut)
    with VideoReader(fixture_cut, yuv=True) as reader:
        decoder = reader.decoder
    assert decoder == ("videodec" if videodec.available() else "cv2")
    assert got.yuv_ingest == (decoder == "videodec") and not ref.yuv_ingest
    assert (got.frame_count, got.total_processed) == (ref.frame_count, ref.total_processed) == (64, 16)
    assert_records_match(got, ref)
    assert any(r.has_face for r in got.records)


def test_analyze_video_fixture_cut_bgr_matches_jax(dets, trees, fixture_cut):
    """The same cut with ``yuv_ingest=False``: cv2's BGR decode on both
    sides."""
    jdet, det = dets
    det = Detector(dataclasses.replace(det.config, yuv_ingest=False), params=trees, device="cpu")
    ref = jax_video(jdet, fixture_cut)
    got = det.analyze_video(fixture_cut)
    assert not got.yuv_ingest
    assert (got.frame_count, got.total_processed) == (64, 16)
    assert_records_match(got, ref)


def test_frames_after_a_full_last_batch_cost_no_step(dets, tmp_path, monkeypatch):
    """32 frames at fps 14: 16 sampled frames fill two batches of 8, and
    frame 31 follows the last one.  The JAX detector runs a third device
    step, on a batch without a valid row; the port gives frame 31 to the
    second segment and runs two.  Records and counts are equal."""
    jdet, det = dets
    path = write_clip(str(tmp_path / "c32.avi"), blurred(3, 32), 14)
    steps = []
    step = tdetector_mod.frame_step_yuv
    monkeypatch.setattr(tdetector_mod, "frame_step_yuv",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    ref = jax_video(jdet, path)
    got = det.analyze_video(path)
    assert len(steps) == 2
    assert (got.frame_count, got.total_processed) == (ref.frame_count, ref.total_processed) == (32, 16)
    assert_records_match(got, ref)


def test_analyze_video_equals_analyze_i420(dets, clip):
    """The file path and the in-memory path agree exactly on the same
    frames (the file's own pictures, read back through ``rawavi``)."""
    _, det = dets
    with VideoReader(clip, yuv=True) as r:
        packed = np.stack([p for _, p in r.yuv_frames()])
    a, b = det.analyze_video(clip), det.analyze_i420(packed, fps=14)
    assert a.records == b.records
    assert (a.fake_score, a.frame_count, a.total_processed, a.flagged_count, a.final_counter) == (
        b.fake_score, b.frame_count, b.total_processed, b.flagged_count, b.final_counter)


def test_annotated_output_file(dets, clip, tmp_path):
    """A real .avi output: every frame the port did not draw on is the
    source picture byte for byte, a drawn frame is the source converted,
    boxes aside, and cv2 reads the file."""
    _, det = dets
    out = str(tmp_path / "out.avi")
    res = det.analyze_video(clip, out)
    with VideoReader(clip, yuv=True) as r:
        src = [p for _, p in r.yuv_frames()]
    with VideoReader(out, yuv=True) as r:
        assert r.meta.frame_count == 30 and r.meta.fps == 14
        written = [p for _, p in r.yuv_frames()]
    drawn = {r.frame_index for r in res.records if r.annotated}
    assert drawn
    for k, (a, b) in enumerate(zip(written, src)):
        if k not in drawn:
            np.testing.assert_array_equal(a, b)
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 30
    cap.release()


def test_writer_failure_propagates_without_hanging(dets, clip, tmp_path, monkeypatch):
    """An encoder failure mid-run surfaces as the analyze exception,
    promptly, and the detector stays usable (single- and multi-face)."""
    _, det = dets
    from truely_tpu_torch.media.encode import VideoWriter

    def failing_write(self, frame):
        raise IOError("simulated encoder failure")

    monkeypatch.setattr(VideoWriter, "write", failing_write)
    monkeypatch.setattr(VideoWriter, "write_i420", failing_write)
    with pytest.raises(IOError, match="simulated encoder failure"):
        det.analyze_video(clip, str(tmp_path / "o.avi"))
    with pytest.raises(IOError, match="simulated encoder failure"):
        det.analyze_video_multiface(clip, str(tmp_path / "m.avi"))
    monkeypatch.undo()
    assert det.analyze_video(clip).frame_count == 30
    assert det.analyze_video_multiface(clip)[1].shape == (det.config.max_tracks,)


def test_run_contract(dets, clip, tmp_path):
    """``run`` gives 0 for a missing, an empty and an unreadable file, and
    the score otherwise."""
    _, det = dets
    out = str(tmp_path / "o.avi")
    empty = str(tmp_path / "empty.avi")
    open(empty, "wb").close()
    bad = str(tmp_path / "bad.avi")
    with open(bad, "wb") as f:
        f.write(b"RIFF\x10\0\0\0AVI this is not a video")
    assert det.run(str(tmp_path / "nope.avi"), out) == 0
    assert det.run(empty, out) == 0
    assert det.run(bad, out) == 0
    assert det.run(clip, out) == det.analyze_video(clip).fake_score
    assert os.path.getsize(out) > 0


def test_draw_mode_invalid_rejected():
    with pytest.raises(ValueError, match="draw_mode"):
        Detector(DetectorConfig(frame_batch=2, draw_mode="nope"), device="cpu")


def test_bf16_drift_gate(trees, fixture_cut):
    """A9b: the port and the JAX package at their bf16 defaults on the
    fixture cut.  bf16 flips are knife-edge with random weights, so the
    gate is not equality: selection flips, has_face mismatches and the
    matched frames' |dsim| must stay within the "full fast (default)" row
    of PERFORMANCE.md's drift table (each bf16 path against f32)."""
    # frame_batch 16 holds the 16 sampled frames in one batch, as the
    # default 32 does; the batch size changes no result.
    ref = JDetector(JDetectorConfig(frame_batch=16)).analyze_video(fixture_cut)
    got = Detector(DetectorConfig(frame_batch=16), params=trees,
                   device="cpu").analyze_video(fixture_cut)
    assert len(got.records) == len(ref.records) == 16
    d = drift(ref.records, got.records)
    print("bf16 drift, port vs JAX on the fixture cut:", d)
    assert d["both_face"] >= 8
    for key, bound in DRIFT_BOUNDS.items():
        assert d[key] <= bound, (key, d[key], bound)
