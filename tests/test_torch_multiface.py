"""The port's multi-face path (``refine_faces_multi``, the multi-face steps,
``Detector.analyze_frames_tracks`` and ``analyze_i420_tracks``) against the
JAX package at float32 on the CPU, with the same seeded JAX weights.

Content and cascade settings are those of ``tests/test_torch_propagate.py``
(blurred 64x96 frames, small capacities, permissive thresholds), with
three tracks, a similarity threshold of 0.9999 and a run-length threshold
of 3, so that tracks flag and score.  Decisions (valid, active, misses,
counters, processed, per-track scores, the "auto" telemetry) are equal;
boxes within 1 px (1e-2 for ``refine_faces_multi``'s own outputs),
embeddings within 1e-4.
"""

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
from truely_tpu.pipeline.mtcnn import MTCNNParams, refine_faces_multi as j_refine_faces_multi
from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
from truely_tpu_torch.models.weights import params_from_numpy
from truely_tpu_torch.pipeline import detector as tdetector
from truely_tpu_torch.pipeline.detector import Detector
from truely_tpu_torch.pipeline.mtcnn import MTCNNNets, refine_faces_multi

torch.set_num_threads(2)

MF = dict(multi_face=True, max_tracks=3, similarity_threshold=0.9999, run_length_threshold=3)
DISCRETE = ("active", "has_prev", "counter", "flagged_count", "processed", "misses",
            "final_counter")


def configs(**kw):
    """The same multi-face settings for the JAX package and the port."""
    common = dict(frame_batch=8, compute_dtype="float32", **MF, **kw)
    return (JDetectorConfig(mtcnn=JMTCNNConfig(**CASCADE), **common),
            DetectorConfig(mtcnn=MTCNNConfig(**CASCADE), **common))


@pytest.fixture(scope="module")
def stable():
    return blurred(0, 40)


def port(trees, cfg):
    return Detector(cfg, params=trees, device="cpu")


def jax_tracks(jdet, frames, fps=10):
    with jax.default_matmul_precision("highest"):
        return jdet.analyze_frames_tracks(frames, fps=fps)


def assert_tracks_match(got, ref):
    """(aggregate, per-track scores, final TrackState) of a port run and a
    JAX run."""
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    for name in DISCRETE:
        np.testing.assert_array_equal(getattr(got[2], name).numpy(),
                                      np.asarray(getattr(ref[2], name)), err_msg=name)
    np.testing.assert_allclose(got[2].box.numpy(), np.asarray(ref[2].box), atol=1)
    np.testing.assert_allclose(got[2].embedding.numpy(), np.asarray(ref[2].embedding),
                               atol=1e-4)


@pytest.mark.parametrize("fused", [0, 1])
def test_refine_faces_multi_matches_jax(trees, stable, fused):
    rng = np.random.default_rng(3)
    frames = stable[:8]
    xy = rng.uniform(-10, 60, (8, 3, 2)).astype(np.float32)
    side = rng.uniform(15, 50, (8, 3, 1)).astype(np.float32)
    seeds = np.concatenate([xy, xy + side], -1)
    seeds[2, 1] = seeds[2, 0]                           # two seeds on one face
    seed_valid = rng.random((8, 3)) > 0.3
    seed_valid[5] = False                               # a frame with no seed
    seed_valid[6] = [False, True, False]
    jparams = MTCNNParams(*(jax.tree_util.tree_map(jnp.asarray, trees[n])
                            for n in ("pnet", "rnet", "onet")))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda f, s, v: j_refine_faces_multi(
            jparams, f, s, v, JMTCNNConfig(**CASCADE), dtype=jnp.float32))(
            jnp.asarray(frames), jnp.asarray(seeds), jnp.asarray(seed_valid))
    nets = MTCNNNets(*(params_from_numpy(n, trees[n]) for n in ("pnet", "rnet", "onet")))
    with torch.no_grad():
        got = refine_faces_multi(nets, torch.from_numpy(frames), torch.from_numpy(seeds),
                                 torch.from_numpy(seed_valid),
                                 MTCNNConfig(use_fused_crops=fused, **CASCADE),
                                 dtype=torch.float32)
    rv = np.asarray(ref.valid)
    assert got.valid.shape == (8, 12)
    np.testing.assert_array_equal(got.valid.numpy(), rv)
    assert rv.sum() >= 8 and not rv[5].any()          # an unseeded frame never detects
    np.testing.assert_allclose(got.scores.numpy()[rv], np.asarray(ref.scores)[rv], atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[rv], np.asarray(ref.boxes)[rv], atol=1e-2)
    np.testing.assert_allclose(got.landmarks.numpy()[rv], np.asarray(ref.landmarks)[rv],
                               atol=1e-2)


def test_multiface_detect_equals_full_step(trees, stable):
    _, cfg = configs(detect_interval=2)
    det = port(trees, cfg)
    frames = torch.from_numpy(stable[:8])
    boxes, valid, emb = det._run(tdetector.multiface_step, frames)
    sboxes, svalid = det._run(tdetector.multiface_detect, frames)
    assert valid.any() and emb.shape == (8, 3, det.embedding_dim)
    assert torch.equal(boxes, sboxes) and torch.equal(valid, svalid)


def test_full_detection_matches_jax(trees, stable, monkeypatch):
    """K=1 runs the full multi-face step on every segment and never the
    seed or refine steps."""
    def never(*args, **kwargs):
        raise AssertionError("propagation ran at detect_interval=1")

    monkeypatch.setattr(tdetector, "refine_faces_multi", never)
    monkeypatch.setattr(tdetector, "multiface_detect", never)
    jcfg, cfg = configs()
    ref = jax_tracks(JDetector(jcfg), stable)
    got = port(trees, cfg).analyze_frames_tracks(stable, fps=10)
    assert_tracks_match(got, ref)
    assert got[0] > 0 and int(got[2].processed.sum()) >= 10


@pytest.fixture(scope="module")
def jax_k4():
    return JDetector(configs(detect_interval=4)[0])


@pytest.mark.parametrize("fallback", [True, False])
def test_fixed_interval_matches_jax(trees, stable, jax_k4, fallback, monkeypatch):
    """40 sampled frames at frame_batch 8 and K=4: one full keyframe cycle
    and a short one whose seed batch is zero-padded."""
    refined = []
    real = tdetector.refine_faces_multi

    def counted(*args, **kwargs):
        det = real(*args, **kwargs)
        refined.append(int(det.valid.any(1).sum()))
        return det

    monkeypatch.setattr(tdetector, "refine_faces_multi", counted)
    jcfg, cfg = configs(detect_interval=4, propagate_fallback=fallback)
    ref = jax_tracks(jax_k4 if fallback else JDetector(jcfg), stable)
    det = port(trees, cfg)
    got = det.analyze_frames_tracks(stable, fps=10)
    assert_tracks_match(got, ref)
    assert len(refined) == 5 and sum(refined) > 0 and det.fallback_segments == 0


@pytest.mark.parametrize("fallback", [True, False])
def test_forced_refine_loss_reruns_every_segment(trees, stable, monkeypatch, fallback):
    """With refinement forced to lose every seed, the fallback re-runs each
    seeded segment through the full step (the result is full detection's)
    and counts it; with the fallback off nothing is re-run."""
    frames = stable[:16]                               # one short cycle of 2 segments
    full = port(trees, configs()[1]).analyze_frames_tracks(frames, fps=10)
    real = tdetector.refine_faces_multi

    def losing(*args, **kwargs):
        det = real(*args, **kwargs)
        return det._replace(valid=torch.zeros_like(det.valid))

    monkeypatch.setattr(tdetector, "refine_faces_multi", losing)
    det = port(trees, configs(detect_interval=4, propagate_fallback=fallback)[1])
    got = det.analyze_frames_tracks(frames, fps=10)
    if fallback:
        assert det.fallback_segments == 2
        for a, b in zip(got[2], full[2]):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(got[1], full[1])
    else:
        assert det.fallback_segments == 0
        assert int(got[2].processed.sum()) < int(full[2].processed.sum())


@pytest.fixture(scope="module")
def jax_auto():
    return JDetector(configs(detect_interval="auto", auto_interval_max=4)[0])


@pytest.mark.parametrize("content", ["stable", "stable_then_flat"])
def test_auto_matches_jax(trees, stable, jax_auto, content):
    frames = stable if content == "stable" else np.concatenate([stable[:16], flat_gray(40)])
    jax_auto.auto_keyframe_segments = jax_auto.auto_refine_segments = 0
    ref = jax_tracks(jax_auto, frames)
    det = port(trees, configs(detect_interval="auto", auto_interval_max=4)[1])
    got = det.analyze_frames_tracks(frames, fps=10)
    assert_tracks_match(got, ref)
    telemetry = ("auto_interval_current", "auto_keyframe_segments", "auto_refine_segments")
    assert [getattr(det, t) for t in telemetry] == [getattr(jax_auto, t) for t in telemetry]
    assert det.auto_refine_segments > 0
    if content == "stable":
        assert det.auto_interval_current > 1
    else:
        assert det.auto_interval_current == 1  # the featureless tail collapses the ladder


def test_analyze_i420_tracks_matches_jax(trees, jax_k4):
    h, w, n = 64, 96, 40
    packed = np.empty((n, h * 3 // 2, w), np.uint8)
    packed[:, :h] = blurred(3, n)[..., 1]
    packed[:, h:] = blurred(4, n, h // 2, w)[..., 0] // 2 + 64
    bgr = np.asarray(jyuv.i420_to_bgr(jnp.asarray(packed)))
    ref = jax_tracks(jax_k4, bgr, fps=20)
    det = port(trees, configs(detect_interval=4)[1])
    got = det.analyze_i420_tracks(packed, fps=20)
    assert_tracks_match(got, ref)
    assert int(got[2].processed.sum()) > 0
    same = det.analyze_frames_tracks(bgr, fps=20)      # I420 ingest equals BGR feeding
    for a, b in zip(got[2], same[2]):
        assert torch.equal(a, b)
