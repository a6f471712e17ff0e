"""The port's cascade, frame step and detector against the JAX package at
float32 on the CPU, with the same seeded JAX weights on both sides, and
the port's golden gate on the bundled clip.

The JAX side runs its own defaults (the width-folded P-Net trunk, XLA's
summation order), so float outputs agree to float32 rounding: scores to
1e-5, boxes and landmarks to 1e-2 px, embeddings to 1e-4; decisions
(validity, has_face, flags, counters) must be equal.  The checks share one
process's seeded JAX weights, which take seconds to build.
"""

import json

import cv2
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.clip import bundled_clip_path
from tests.test_golden_clip import GOLDEN, SIM_ATOL, reference_loop

from truely_tpu.config import DetectorConfig as JDetectorConfig
from truely_tpu.config import MTCNNConfig as JMTCNNConfig
from truely_tpu.models import (
    init_inception_resnet_v1, init_landmark68, init_onet, init_pnet, init_rnet,
)
from truely_tpu.models.weights import load_or_init
from truely_tpu.ops import yuv as jyuv
from truely_tpu.pipeline.detector import Detector as JDetector
from truely_tpu.pipeline.mtcnn import MTCNNParams, detect_faces as j_detect_faces
from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
from truely_tpu_torch.models.weights import params_from_numpy
from truely_tpu_torch.pipeline.detector import Detector
from truely_tpu_torch.pipeline.mtcnn import MTCNNNets, detect_faces

torch.set_num_threads(2)

# Permissive thresholds so the seeded random nets "find" faces.
THRESHOLDS = (0.6, 0.5, 0.4)


@pytest.fixture(scope="module")
def trees():
    """The JAX package's seeded param trees of all five nets, as numpy."""
    inits = {"pnet": init_pnet, "rnet": init_rnet, "onet": init_onet,
             "facenet": init_inception_resnet_v1, "landmark68": init_landmark68}
    return {n: jax.tree_util.tree_map(np.asarray, load_or_init(n, f)[0]) for n, f in inits.items()}


def smooth_frames(seed, n, h, w):
    """Blocky random frames (a 4x4-px noise upsampled), so the area pyramid
    keeps structure at every level."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (n, h // 4, w // 4, 3), np.uint8)
    return np.repeat(np.repeat(small, 4, axis=1), 4, axis=2)


def matched(det_valid, det_scores, b):
    idx = np.nonzero(det_valid[b])[0]
    return idx[np.argsort(-det_scores[b, idx], kind="stable")]


def test_detect_faces_matches_jax_production_capacities(trees):
    frames = np.random.default_rng(0).integers(0, 256, (2, 120, 160, 3), np.uint8)
    jparams = MTCNNParams(*(jax.tree_util.tree_map(jnp.asarray, trees[n])
                            for n in ("pnet", "rnet", "onet")))
    jcfg = JMTCNNConfig(thresholds=(0.6, 0.7, 0.7))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda f: j_detect_faces(jparams, f, jcfg, dtype=jnp.float32))(
            jnp.asarray(frames))
    nets = MTCNNNets(*(params_from_numpy(n, trees[n]) for n in ("pnet", "rnet", "onet")))
    with torch.no_grad():
        got = detect_faces(nets, torch.from_numpy(frames), MTCNNConfig(thresholds=(0.6, 0.7, 0.7)),
                           dtype=torch.float32)
    rv, rs = np.asarray(ref.valid), np.asarray(ref.scores)
    gv, gs = got.valid.numpy(), got.scores.numpy()
    assert rv.sum() > 4  # the check has detections to compare
    for b in range(frames.shape[0]):
        assert gv[b].sum() == rv[b].sum()
        og, orf = matched(gv, gs, b), matched(rv, rs, b)
        np.testing.assert_allclose(gs[b, og], rs[b, orf], atol=1e-5)
        np.testing.assert_allclose(got.boxes.numpy()[b, og], np.asarray(ref.boxes)[b, orf],
                                   atol=1e-2)
        np.testing.assert_allclose(got.landmarks.numpy()[b, og],
                                   np.asarray(ref.landmarks)[b, orf], atol=1e-2)


def test_exact_bf16_pyramid_is_jax_resize_area_u8(monkeypatch):
    """bf16 without the cascade (``--exact-pyramid``): P-Net sees, level by
    level, the JAX package's ``resize_area_u8`` of the frames (its
    ``use_i8_resize`` branch of ``_stage1``) run op by op, bit for bit; the
    float32 averaging cast to bf16 differs in the last bit of some values."""
    from truely_tpu.ops.resize import resize_area_u8 as j_resize_area_u8
    from truely_tpu_torch.models.weights import init_params
    from truely_tpu_torch.pipeline import mtcnn as tmtcnn
    from truely_tpu_torch.pipeline.pyramid import pyramid_schedule

    frames = smooth_frames(3, 2, 96, 128) + np.random.default_rng(3).integers(
        0, 3, (2, 96, 128, 3), np.uint8)
    nets = MTCNNNets(*(init_params(n) for n in ("pnet", "rnet", "onet")))
    seen = []
    trunk = nets.pnet.trunk
    monkeypatch.setattr(nets.pnet, "trunk", lambda x, dtype: seen.append(x) or trunk(x, dtype))
    with torch.no_grad():
        tmtcnn._stage1(nets, torch.from_numpy(frames), MTCNNConfig(pyramid_cascade=False),
                       torch.bfloat16)
    levels = pyramid_schedule(96, 128)
    assert len(seen) == len(levels) == 5
    for x, lvl in zip(seen, levels):
        ref = j_resize_area_u8(jnp.asarray(frames), (lvl.height, lvl.width))
        want = (np.asarray(ref.astype(jnp.float32)) - np.float32(127.5)) * np.float32(0.0078125)
        np.testing.assert_array_equal(x.numpy(), want)


@pytest.fixture(scope="module")
def detectors(trees):
    jcfg = JDetectorConfig(frame_batch=4, compute_dtype="float32",
                           mtcnn=JMTCNNConfig(thresholds=THRESHOLDS))
    cfg = DetectorConfig(frame_batch=4, compute_dtype="float32",
                         mtcnn=MTCNNConfig(thresholds=THRESHOLDS))
    jdet = JDetector(jcfg)
    return jdet, Detector(cfg, params=trees, device="cpu")


def assert_outputs_close(got, ref):
    has_face = np.asarray(ref.has_face)
    np.testing.assert_array_equal(got.has_face.numpy(), has_face)
    assert has_face.any()
    np.testing.assert_allclose(got.box.numpy(), np.asarray(ref.box), atol=1e-2)
    np.testing.assert_allclose(got.crop_bounds.numpy(), np.asarray(ref.crop_bounds), atol=1)
    np.testing.assert_allclose(got.embedding.numpy()[has_face],
                               np.asarray(ref.embedding)[has_face], atol=1e-4)
    np.testing.assert_allclose(got.landmarks68.numpy()[has_face],
                               np.asarray(ref.landmarks68)[has_face], atol=1e-4)


def test_yuv_frame_step_matches_jax(detectors):
    jdet, det = detectors
    rng = np.random.default_rng(1)
    h, w = 64, 96
    packed = np.empty((4, h * 3 // 2, w), np.uint8)
    packed[:, :h] = smooth_frames(1, 4, h, w)[..., 1]
    packed[:, h:] = rng.integers(96, 160, (4, h // 2, w), np.uint8)
    with jax.default_matmul_precision("highest"):
        ref = jdet._ensure_yuv_step()(jdet.params, jnp.asarray(packed))
    assert_outputs_close(det.step_yuv(torch.from_numpy(packed)), ref)


def test_analyze_frames_matches_jax(detectors):
    jdet, det = detectors
    frames = smooth_frames(2, 22, 64, 96)
    frames[6:12] = frames[5]  # a static stretch: sims near 1, the counter resets
    with jax.default_matmul_precision("highest"):
        ref = jdet.analyze_frames(frames, fps=10)
    got = det.analyze_frames(frames, fps=10)
    assert got.total_processed == ref.total_processed == 22
    assert [r.frame_index for r in got.records] == [r.frame_index for r in ref.records]
    assert [r.has_face for r in got.records] == [r.has_face for r in ref.records]
    assert [r.annotated for r in got.records] == [r.annotated for r in ref.records]
    np.testing.assert_allclose([r.box for r in got.records], [r.box for r in ref.records], atol=1)
    sims = np.array([r.similarity for r in got.records])
    ref_sims = np.array([r.similarity for r in ref.records])
    np.testing.assert_allclose(sims, ref_sims, atol=1e-4)
    # Decisions equal unless a sim sits within the tolerance of the threshold.
    assert np.abs(ref_sims - 0.99).min() > 1e-4
    assert [r.flagged for r in got.records] == [r.flagged for r in ref.records]
    assert [r.counter for r in got.records] == [r.counter for r in ref.records]
    assert (got.fake_score, got.flagged_count, got.final_counter) == (
        ref.fake_score, ref.flagged_count, ref.final_counter)


def test_analyze_i420_matches_jax_on_converted_frames(detectors):
    """analyze_i420 is the analyze_video ingest loop on frames in memory:
    it samples every sample_interval(fps)-th frame, pads the last batch,
    and gives the records of the JAX detector on the same frames decoded
    to BGR."""
    jdet, det = detectors
    h, w = 64, 96
    packed = np.empty((13, h * 3 // 2, w), np.uint8)
    packed[:, :h] = smooth_frames(3, 13, h, w)[..., 0]
    packed[:, h:] = np.random.default_rng(3).integers(96, 160, (13, h // 2, w), np.uint8)
    bgr = np.asarray(jyuv.i420_to_bgr(jnp.asarray(packed)))
    with jax.default_matmul_precision("highest"):
        ref = jdet.analyze_frames(bgr, fps=20)
    got = det.analyze_i420(packed, fps=20)
    assert got.yuv_ingest and got.total_processed == ref.total_processed == 7
    assert [r.frame_index for r in got.records] == list(range(0, 13, 2))
    assert [r.has_face for r in got.records] == [r.has_face for r in ref.records]
    assert any(r.has_face for r in got.records)
    np.testing.assert_allclose([r.box for r in got.records], [r.box for r in ref.records], atol=1)
    np.testing.assert_allclose([r.similarity for r in got.records],
                               [r.similarity for r in ref.records], atol=1e-4)
    assert [r.counter for r in got.records] == [r.counter for r in ref.records]
    assert (got.fake_score, got.frame_count) == (ref.fake_score, ref.frame_count)


@pytest.mark.skipif(not bundled_clip_path(), reason="bundled clip not present")
def test_port_meets_golden_file(trees):
    """The golden gate: the bundled Veo-3 clip's first 200 frames under
    GOLDEN_CONFIG (float32, frame_batch 16) with the converted seeded JAX
    weights, held to tests/golden/veo3_first200_seeded.json by the checks
    of tests/test_golden_clip.py: face presence equal, boxes within 1 px,
    sims within 2e-4, and flags, counters and score equal to the
    reference loop restated on the measured sims."""
    cap = cv2.VideoCapture(bundled_clip_path())
    frames = []
    while len(frames) < 200:
        ret, f = cap.read()
        if not ret:
            break
        frames.append(f)
    cap.release()
    frames = np.stack(frames)
    assert frames.shape == (200, 360, 640, 3)

    golden_config = DetectorConfig(frame_batch=16, compute_dtype="float32")
    res = Detector(golden_config, params=trees, device="cpu").analyze_frames(frames, fps=30)
    with open(GOLDEN) as f:
        golden = json.load(f)

    assert [r.has_face for r in res.records] == golden["has_face"]
    assert [r.annotated for r in res.records] == golden["annotated"]
    np.testing.assert_allclose([list(r.box) for r in res.records], golden["boxes"], atol=1.0)
    sims = [r.similarity for r in res.records]
    np.testing.assert_allclose(sims, golden["sims"], atol=SIM_ATOL)
    assert res.total_processed == golden["total_processed"]

    flags, counters, final_counter, flagged_count, score = reference_loop(
        sims, [r.annotated for r in res.records], res.total_processed, res.frame_count,
        res.fps, thr=golden_config.similarity_threshold,
        run_len=golden_config.run_length_threshold,
        long_seconds=golden_config.long_video_seconds)
    assert [r.flagged for r in res.records] == flags
    assert [r.counter for r in res.records] == counters
    assert res.final_counter == final_counter
    assert res.flagged_count == flagged_count
    assert res.fake_score == score
    if golden.get("min_sim_margin", 0.0) > 10 * SIM_ATOL:
        assert res.fake_score == golden["fake_score"]
        assert res.suspicious_frames == golden["suspicious_frames"]
