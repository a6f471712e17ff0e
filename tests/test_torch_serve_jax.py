"""The port's API server against the JAX package's, each on its own
detector with the same weights (the JAX package's seeded trees, carried
into the port with ``params=``), at float32 with the small cascade of
``tests/test_torch_propagate.py``, on the CPU.

The clips are mp4v files, which the JAX package reads through cv2 and the
port through its native ``videodec`` where that is built (else cv2).  The same
``/analyze-video`` and ``/analyze-combined`` bodies give the same JSON,
``resultId`` aside.  Three ``/jobs/analyze-video`` jobs queued together run
as one group in one device step at ``frame_batch=96`` and score as the
JAX server's group and the port's solo runs do; multi-face groups give the
JAX server's ``trackScores``; a multi-face "auto" group completes through
the scheduler's fall-back to full cadence.  ``Detector.warmup`` runs the
steps of the paths its config takes and leaves later analyses unchanged.
"""

import dataclasses
import json
import shutil
import threading

import cv2
import numpy as np
import pytest
import torch

from tests.test_auto_interval import blurred
from tests.test_serve import FakeAgents
from tests.test_torch_propagate import CASCADE, trees  # noqa: F401

from truely_tpu.config import DetectorConfig as JDetectorConfig
from truely_tpu.config import MTCNNConfig as JMTCNNConfig
from truely_tpu.pipeline.detector import Detector as JDetector
from truely_tpu.serve.app import TruelyServer as JTruelyServer
from truely_tpu.serve.http import Request as JRequest
from truely_tpu.serve.results import ResultStore as JResultStore
from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
from truely_tpu_torch.media import videodec
from truely_tpu_torch.pipeline.detector import Detector
from truely_tpu_torch.serve.app import TruelyServer
from truely_tpu_torch.serve.http import Request
from truely_tpu_torch.serve.results import ResultStore

torch.set_num_threads(2)

# Sample interval 1: every frame is a sampled frame.  Three clips of
# different lengths fit one batch of 96 (32 rows a stream).
N_FRAMES, FPS = (24, 20, 18), 10
# The seeded nets embed every crop of these clips within 0.998-0.9995 of the
# previous one: above the default threshold of 0.99, so nothing would ever
# flag.  At 0.9995 every frame with a face drifts, and a clip flags from its
# 15th sampled frame on, so the scores differ by length.  Multi-face tracks
# of noise live a few frames (boxes jump), so the multi-face runs flag from a
# run of 3.
SIMILARITY = 0.9995
MULTI_FACE = dict(multi_face=True, max_tracks=3, run_length_threshold=3)


def configs(**kw):
    """The same detector settings for the JAX package and the port."""
    common = dict(frame_batch=96, compute_dtype="float32", similarity_threshold=SIMILARITY,
                  **kw)
    return (JDetectorConfig(mtcnn=JMTCNNConfig(**CASCADE), **common),
            DetectorConfig(mtcnn=MTCNNConfig(**CASCADE), **common))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Three mp4v clips of blurred noise (64x96), each its own content and
    length."""
    d = tmp_path_factory.mktemp("src")
    paths = []
    for i, n in enumerate(N_FRAMES):
        path = str(d / f"clip{i}.mp4")
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (96, 64))
        assert out.isOpened()
        for frame in blurred(20 + i, n):
            out.write(frame)
        out.release()
        paths.append(path)
    return paths


def copies(clips, d, tag):
    """Fresh copies of the clips: each server deletes the inputs it is
    handed (they lie in the temp dir)."""
    out = []
    for i, src in enumerate(clips):
        dst = str(d / f"{tag}{i}.mp4")
        shutil.copy(src, dst)
        out.append(dst)
    return out


def jax_server(jcfg):
    return JTruelyServer(detector=JDetector(jcfg), agents=FakeAgents(), store=JResultStore(),
                         tavily_api_key="tvly-test", gemini_api_key="gm-test")


def port_server(det):
    return TruelyServer(detector=det, agents=FakeAgents(), store=ResultStore(),
                        tavily_api_key="tvly-test", gemini_api_key="gm-test")


def post(server, request_cls, path, body):
    resp = server.router.dispatch(request_cls("POST", path, {}, body=json.dumps(body).encode()))
    return resp.status, json.loads(resp.content)


def run_group(server, request_cls, paths):
    """Queue one job per path behind a gate job, release the gate, and
    return the finished jobs."""
    gate = threading.Event()
    server.jobs.submit("gate", lambda: gate.wait(60) and {})
    ids = []
    for p in paths:
        status, payload = post(server, request_cls, "/jobs/analyze-video", {"videoPath": p})
        assert status == 202, payload
        ids.append(payload["jobId"])
    gate.set()
    jobs = [server.jobs.wait(j, timeout=600) for j in ids]
    assert [j.status for j in jobs] == ["done"] * len(paths), [j.error for j in jobs]
    assert len({j.started_at for j in jobs}) == 1   # one group
    return jobs


def ingest(step):
    """The name of ``step`` as the port runs it on the mp4v clips: the
    packed-I420 step where its native ``videodec`` is built and reads
    them, else the BGR step (cv2)."""
    return step + "_yuv" if videodec.available() else step


def count_steps(det):
    """Record (step name, rows) of every frame step ``det`` runs."""
    seen = []
    run = det._run

    def counting(fn, *args, **kw):
        seen.append((fn.__name__, int(args[0].shape[0])))
        return run(fn, *args, **kw)

    det._run = counting
    return seen


@pytest.fixture(scope="module")
def single(trees):
    jcfg, cfg = configs()
    return jax_server(jcfg), port_server(Detector(cfg, params=trees, device="cpu"))


def without_id(payload):
    return {k: v for k, v in payload.items() if k != "resultId"}


@pytest.mark.parametrize("route,audio", [("/analyze-video", False),
                                         ("/analyze-combined", False),
                                         ("/analyze-combined", True)])
def test_sync_requests_match_jax(single, clips, tmp_path, route, audio):
    jserver, server = single
    got = {}
    for tag, srv, request_cls in (("jax", jserver, JRequest), ("port", server, Request)):
        body = {"videoPath": copies(clips[:1], tmp_path, tag)[0]}
        if audio:
            body["audioPath"] = str(tmp_path / f"{tag}.mp3")
            with open(body["audioPath"], "wb") as f:
                f.write(b"audio")
        status, payload = post(srv, request_cls, route, body)
        assert status == 200, payload
        assert srv.store.get(payload["resultId"])["fake_score"] == payload["fakeScore"]
        got[tag] = without_id(payload)
    assert got["port"] == got["jax"]
    assert got["port"]["fakeScore"] > 0
    if audio:
        assert got["port"]["verdict"] == "Fake"


def test_grouped_jobs_match_jax_and_solo(single, clips, tmp_path):
    jserver, server = single
    det = server.detector
    solo = [det.analyze_video(p).fake_score for p in clips]
    jjobs = run_group(jserver, JRequest, copies(clips, tmp_path, "jax"))
    steps = count_steps(det)
    try:
        jobs = run_group(server, Request, copies(clips, tmp_path, "port"))
    finally:
        del det._run
    assert steps == [(ingest("frame_step"), 96)]   # one device step for the three videos
    assert [j.result["fakeScore"] for j in jobs] == [j.result["fakeScore"] for j in jjobs] == solo
    assert len(set(solo)) > 1 and all(s > 0 for s in solo)
    for j in jobs:
        resp = server.router.dispatch(Request("GET", f"/video/{j.result['resultId']}", {}))
        assert resp.status == 200 and resp.content_type == "video/mp4"
    metrics = json.loads(server.router.dispatch(Request("GET", "/metrics", {})).content)
    assert metrics["analyses_total"] >= 3 and metrics["job_wait_seconds_p50"] > 0


def test_grouped_multiface_jobs_match_jax(trees, clips, tmp_path):
    jcfg, cfg = configs(**MULTI_FACE)
    jserver = jax_server(jcfg)
    server = port_server(Detector(cfg, params=trees, device="cpu"))
    solo = [server.detector.analyze_video_multiface(p)[1].tolist() for p in clips]
    jjobs = run_group(jserver, JRequest, copies(clips, tmp_path, "jax"))
    steps = count_steps(server.detector)
    jobs = run_group(server, Request, copies(clips, tmp_path, "port"))
    assert steps == [(ingest("multiface_step"), 96)]
    got = [(j.result["fakeScore"], j.result["trackScores"]) for j in jobs]
    assert got == [(j.result["fakeScore"], j.result["trackScores"]) for j in jjobs]
    assert [t for _, t in got] == solo and any(max(t) > 0 for t in solo)


def test_multiface_auto_group_degrades_to_full_cadence(trees, clips, tmp_path):
    """At "auto" a multi-face scheduler runs full detection on every step,
    so the group completes and each job scores as a solo multi-face run at
    K=1 does."""
    _, cfg = configs(**MULTI_FACE, detect_interval="auto", auto_interval_max=4)
    server = port_server(Detector(cfg, params=trees, device="cpu"))
    full = Detector(dataclasses.replace(cfg, detect_interval=1), params=trees, device="cpu")
    solo = [full.analyze_video_multiface(p) for p in clips[:2]]
    steps = count_steps(server.detector)
    jobs = run_group(server, Request, copies(clips[:2], tmp_path, "auto"))
    assert steps == [(ingest("multiface_step"), 96)]
    assert [(j.result["fakeScore"], j.result["trackScores"]) for j in jobs] == [
        (s[0], s[1].tolist()) for s in solo]
    assert any(s[0] > 0 for s in solo)


YUV = ("frame_step_yuv", "frame_step_detect_yuv", "frame_step_propagate_yuv")
BGR = ("frame_step", "frame_step_detect", "frame_step_propagate")
MF_YUV = ("multiface_step_yuv", "multiface_detect_yuv", "multiface_step_propagate_yuv")
MF_BGR = ("multiface_step", "multiface_detect", "multiface_step_propagate")


@pytest.mark.parametrize("kw,bucket,want", [
    ({}, (64, 96), BGR[:1] + YUV[:1]),
    ({"yuv_ingest": False}, (64, 96), BGR[:1]),
    ({}, (66, 96), BGR[:1]),                          # H % 4 != 0: no I420 step
    ({"detect_interval": 4}, (64, 96), BGR + YUV),
    ({"multi_face": True, "max_tracks": 3}, (64, 96), MF_BGR[:1] + MF_YUV[:1]),
    ({"multi_face": True, "max_tracks": 3, "detect_interval": "auto", "auto_interval_max": 4},
     (64, 96), MF_BGR + MF_YUV),
])
def test_warmup_runs_the_config_paths(trees, clips, kw, bucket, want):
    """``warmup`` runs one step of each path at the bucket (full batch
    rows), then the fold, and a later analysis equals one on a detector
    that was never warmed."""
    _, cfg = configs(**kw)
    cfg = dataclasses.replace(cfg, frame_batch=8)
    det = Detector(cfg, params=trees, device="cpu")
    steps = count_steps(det)
    folds = []
    fold_name = "track_fold" if cfg.multi_face else "temporal"
    fold = getattr(det, fold_name)
    setattr(det, fold_name, lambda *a, **k: folds.append(1) or fold(*a, **k))
    det.warmup(*bucket)
    assert [name for name, _ in steps] == list(want)
    assert all(rows == 8 for _, rows in steps) and folds == [1]
    del det._run
    delattr(det, fold_name)
    telemetry = (det.auto_keyframe_segments, det.auto_refine_segments,
                 det.auto_interval_current, det.fallback_segments)
    assert telemetry == (0, 0, 1, 0)
    fresh = Detector(cfg, params=trees, device="cpu")
    if cfg.multi_face:
        got, ref = det.analyze_video_multiface(clips[0]), fresh.analyze_video_multiface(clips[0])
        assert got[0] == ref[0] and np.array_equal(got[1], ref[1])
    else:
        got, ref = det.analyze_video(clips[0]), fresh.analyze_video(clips[0])
        assert got.records == ref.records and got.fake_score == ref.fake_score
