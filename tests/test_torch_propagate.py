"""The port's track-propagated detection (``detect_interval`` K > 1 and
"auto") against the JAX package at float32 on the CPU, with the same seeded
JAX weights on both sides.

Content and cascade settings are those of ``tests/test_auto_interval.py``:
blurred 64x96 noise frames, small capacities and permissive thresholds, so
that the seeded random nets find "faces" and refinement keeps them.  The
JAX side runs its own defaults (width-folded P-Net trunk, XLA's summation
order), so floats agree to float32 rounding: boxes within 1 px, sims within
1e-4; decisions (has_face, annotated, flagged, counters, score) and the
"auto" rung telemetry must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.test_auto_interval import blurred, flat_gray

from truely_tpu.config import DetectorConfig as JDetectorConfig
from truely_tpu.config import MTCNNConfig as JMTCNNConfig
from truely_tpu.models import (
    init_inception_resnet_v1, init_landmark68, init_onet, init_pnet, init_rnet,
)
from truely_tpu.models.weights import load_or_init
from truely_tpu.ops import yuv as jyuv
from truely_tpu.pipeline.detector import Detector as JDetector
from truely_tpu.pipeline.mtcnn import MTCNNParams, refine_faces as j_refine_faces
from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
from truely_tpu_torch.models.weights import params_from_numpy
from truely_tpu_torch.ops import crop_area_fused
from truely_tpu_torch.pipeline import detector as tdetector
from truely_tpu_torch.pipeline.detector import Detector
from truely_tpu_torch.pipeline.mtcnn import MTCNNNets, refine_faces

torch.set_num_threads(2)

CASCADE = dict(pnet_topk_total=64, rnet_capacity=16, onet_capacity=8,
               thresholds=(0.5, 0.3, 0.2))


def configs(**kw):
    """The same detector settings for the JAX package and the port."""
    common = dict(frame_batch=8, compute_dtype="float32", **kw)
    return (JDetectorConfig(mtcnn=JMTCNNConfig(**CASCADE), **common),
            DetectorConfig(mtcnn=MTCNNConfig(**CASCADE), **common))


@pytest.fixture(scope="module")
def trees():
    """The JAX package's seeded param trees of all five nets, as numpy."""
    inits = {"pnet": init_pnet, "rnet": init_rnet, "onet": init_onet,
             "facenet": init_inception_resnet_v1, "landmark68": init_landmark68}
    return {n: jax.tree_util.tree_map(np.asarray, load_or_init(n, f)[0]) for n, f in inits.items()}


@pytest.fixture(scope="module")
def stable():
    return blurred(0, 40)


def port(trees, cfg):
    return Detector(cfg, params=trees, device="cpu")


def jax_run(jdet, frames, fps=10):
    with jax.default_matmul_precision("highest"):
        return jdet.analyze_frames(frames, fps=fps)


def assert_records_match(got, ref):
    assert [r.frame_index for r in got.records] == [r.frame_index for r in ref.records]
    for key in ("has_face", "annotated", "flagged", "counter"):
        assert [getattr(r, key) for r in got.records] == [getattr(r, key) for r in ref.records], key
    np.testing.assert_allclose([r.box for r in got.records], [r.box for r in ref.records], atol=1)
    np.testing.assert_allclose([r.similarity for r in got.records],
                               [r.similarity for r in ref.records], atol=1e-4)
    assert (got.fake_score, got.flagged_count, got.final_counter, got.total_processed) == (
        ref.fake_score, ref.flagged_count, ref.final_counter, ref.total_processed)


def refined_faces(res, k):
    """Frames between keyframes that hold a face."""
    return sum(r.has_face for i, r in enumerate(res.records) if i % k)


@pytest.mark.parametrize("fused", [0, 1])
def test_refine_faces_matches_jax(trees, stable, fused):
    frames = stable[:8]
    seeds = np.array([[20, 10, 60, 50], [30, 12, 62, 44], [10, 5, 80, 60], [40, 20, 70, 50],
                      [-10, -8, 30, 30], [60, 30, 110, 80], [25, 15, 55, 45],
                      [0, 0, 96, 64]], np.float32)
    seed_valid = np.array([True, True, True, False, True, True, False, True])
    jparams = MTCNNParams(*(jax.tree_util.tree_map(jnp.asarray, trees[n])
                            for n in ("pnet", "rnet", "onet")))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda f, s, v: j_refine_faces(jparams, f, s, v, JMTCNNConfig(**CASCADE),
                                                     dtype=jnp.float32))(
            jnp.asarray(frames), jnp.asarray(seeds), jnp.asarray(seed_valid))
    nets = MTCNNNets(*(params_from_numpy(n, trees[n]) for n in ("pnet", "rnet", "onet")))
    with torch.no_grad():
        got = refine_faces(nets, torch.from_numpy(frames), torch.from_numpy(seeds),
                           torch.from_numpy(seed_valid),
                           MTCNNConfig(use_fused_crops=fused, **CASCADE), dtype=torch.float32)
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), rv)
    assert rv.any() and not rv[[3, 6]].any()  # unseeded frames never detect
    np.testing.assert_allclose(got.scores.numpy()[rv], np.asarray(ref.scores)[rv], atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[rv], np.asarray(ref.boxes)[rv], atol=1e-2)
    np.testing.assert_allclose(got.landmarks.numpy()[rv], np.asarray(ref.landmarks)[rv],
                               atol=1e-2)


def test_frame_step_detect_equals_full_step(trees, stable):
    _, cfg = configs(detect_interval=2)
    det = port(trees, cfg)
    frames = torch.from_numpy(stable[:8])
    full = det.step(frames)
    box, has_face = det._run(tdetector.frame_step_detect, frames)
    assert has_face.any()
    assert torch.equal(box, full.box) and torch.equal(has_face, full.has_face)


def test_detect_interval_one_is_full_detection(trees, stable, monkeypatch):
    """K=1 runs the full step on every segment, never the seed or refine
    steps, and gives the JAX detector's full-detection records."""
    def never(*args, **kwargs):
        raise AssertionError("propagation ran at detect_interval=1")

    monkeypatch.setattr(tdetector, "refine_faces", never)
    monkeypatch.setattr(tdetector, "frame_step_detect", never)
    jcfg, cfg = configs(detect_interval=1)
    ref = jax_run(JDetector(jcfg), stable)
    got = port(trees, cfg).analyze_frames(stable, fps=10)
    assert_records_match(got, ref)
    assert any(r.has_face for r in got.records)


@pytest.fixture(scope="module")
def jax_k4():
    return JDetector(configs(detect_interval=4)[0])


@pytest.mark.parametrize("fallback", [True, False])
def test_fixed_interval_matches_jax(trees, stable, jax_k4, fallback):
    """40 sampled frames at frame_batch 8 and K=4: one full keyframe cycle
    and a short one (1 of 4 segments), whose seed batch is zero-padded."""
    jcfg, cfg = configs(detect_interval=4, propagate_fallback=fallback)
    ref = jax_run(jax_k4 if fallback else JDetector(jcfg), stable)
    got = port(trees, cfg).analyze_frames(stable, fps=10)
    assert_records_match(got, ref)
    assert refined_faces(got, 4) > 0


@pytest.mark.parametrize("fallback", [True, False])
def test_fallback_reruns_counted(trees, stable, monkeypatch, fallback):
    """With refinement forced to lose every seed, the fallback re-runs each
    seeded segment through the full step (the records become full
    detection's) and counts it; with the fallback off nothing is re-run."""
    frames = stable[:16]                               # one short cycle of 2 segments
    _, cfg = configs(detect_interval=4, propagate_fallback=fallback)
    full = port(trees, configs(detect_interval=1)[1]).analyze_frames(frames, fps=10)
    assert all(r.has_face for r in full.records[::4])  # every segment is seeded
    real = tdetector.refine_faces

    def losing(*args, **kwargs):
        det = real(*args, **kwargs)
        return det._replace(valid=torch.zeros_like(det.valid))

    monkeypatch.setattr(tdetector, "refine_faces", losing)
    det = port(trees, cfg)
    got = det.analyze_frames(frames, fps=10)
    if fallback:
        assert det.fallback_segments == 2
        assert_records_match(got, full)
    else:
        assert det.fallback_segments == 0
        assert refined_faces(got, 4) == 0


@pytest.fixture(scope="module")
def jax_auto():
    jcfg, _ = configs(detect_interval="auto", auto_interval_max=4)
    return JDetector(jcfg)


@pytest.mark.parametrize("content", ["stable", "stable_then_flat"])
def test_auto_matches_jax(trees, stable, jax_auto, content):
    frames = stable if content == "stable" else np.concatenate([stable[:24], flat_gray(32)])
    jax_auto.auto_keyframe_segments = jax_auto.auto_refine_segments = 0
    ref = jax_run(jax_auto, frames)
    _, cfg = configs(detect_interval="auto", auto_interval_max=4)
    det = port(trees, cfg)
    got = det.analyze_frames(frames, fps=10)
    assert_records_match(got, ref)
    telemetry = ("auto_interval_current", "auto_keyframe_segments", "auto_refine_segments")
    assert [getattr(det, t) for t in telemetry] == [getattr(jax_auto, t) for t in telemetry]
    assert det.auto_refine_segments > 0
    if content == "stable":
        assert det.auto_interval_current > 1
    else:
        assert det.auto_interval_current == 1  # the featureless tail collapses the ladder


def test_analyze_i420_fixed_interval_matches_jax(trees, jax_k4):
    h, w, n = 64, 96, 40
    packed = np.empty((n, h * 3 // 2, w), np.uint8)
    packed[:, :h] = blurred(3, n)[..., 1]
    packed[:, h:] = blurred(4, n, h // 2, w)[..., 0] // 2 + 64
    bgr = np.asarray(jyuv.i420_to_bgr(jnp.asarray(packed)))
    _, cfg = configs(detect_interval=4)
    ref = jax_run(jax_k4, bgr, fps=20)
    got = port(trees, cfg).analyze_i420(packed, fps=20)
    assert got.yuv_ingest and got.total_processed == 20
    assert any(r.has_face for r in got.records)
    assert_records_match(got, ref)


@pytest.mark.parametrize("kw, match", [
    (dict(detect_interval=3), "divisible"),
    (dict(detect_interval=0), ">= 1"),
    (dict(detect_interval="four"), "auto"),
    (dict(detect_interval="auto", frame_batch=6), "divisible"),
    (dict(detect_interval="auto", auto_interval_max=3), "power of two"),
])
def test_interval_validation(kw, match):
    cfg = dict(frame_batch=8, compute_dtype="float32")
    cfg.update(kw)
    with pytest.raises(ValueError, match=match):
        Detector(DetectorConfig(**cfg), device="cpu")


def test_fused_crops_give_identical_records(trees, stable, monkeypatch):
    """use_fused_crops=1 takes K5's path (its plain version here) on the
    exact crops of the keyframe and refine steps; the records are equal to
    K3's."""
    _, cfg = configs(detect_interval=4)
    a = port(trees, cfg).analyze_frames(stable, fps=10)
    sizes = []
    plain = crop_area_fused.crop_resize_area_fused_plain

    def counted(frames_p, bounds, out_size, **kw):
        sizes.append((bounds.shape[1], out_size))
        return plain(frames_p, bounds, out_size, **kw)

    monkeypatch.setattr(crop_area_fused, "crop_resize_area_fused_plain", counted)
    fused = dataclasses.replace(cfg, mtcnn=MTCNNConfig(use_fused_crops=1, **CASCADE))
    b = port(trees, fused).analyze_frames(stable, fps=10)
    # keyframe steps (K = 16, 8) and refine steps (K = 4)
    assert set(sizes) == {(16, 24), (8, 48), (4, 24), (4, 48)}
    assert [(r.has_face, r.box, r.similarity, r.flagged, r.counter) for r in a.records] == \
        [(r.has_face, r.box, r.similarity, r.flagged, r.counter) for r in b.records]
