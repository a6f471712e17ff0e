"""The port's single-process mesh (``truely_tpu_torch/parallel/mesh.py``) and
the data-parallel detector (``Detector(mesh=)``, ``StreamScheduler(mesh=)``,
``stream_videos``/``analyze_videos`` with a mesh, the CLI's ``--dp``) on
four CPU positions, against the port's solo runs and the JAX package's
``Detector(mesh)`` on four virtual CPU devices, with the same seeded JAX
weights, on the JAX tests' own cases (``tests/test_detector.py``,
``tests/test_auto_interval.py``, ``tests/test_streaming.py``).

Against the port's solo run and against the JAX package the decisions
(has_face, annotated, flagged, counters), scores and "auto" telemetry are
equal, boxes within 1 px and similarities within 1e-4 (the tolerance of
``tests/test_torch_propagate.py``): a shard's nets see fewer rows than the
whole batch's, and on the CPU that may change their float32 rounding.  At
frame_batch 8 over 4 positions a shard holds 2 rows: fewer than the
keyframe interval of K=4 and "auto"'s rung 4, so shards start inside a
keyframe group.  The JAX meshes' compiles cost about 10-25 s each, so the
JAX package runs only the score path, "auto" and the scheduler (which
reuses the score path's compiled step); the other cases hold the port's
mesh run to its solo run, which the other ``test_torch_*`` files hold to
the JAX package.
"""

import functools
import json

import cv2
import jax
import numpy as np
import pytest
import torch

from tests.test_auto_interval import blurred
from tests.test_torch_analyze_video import write_clip
from tests.test_torch_propagate import CASCADE, assert_records_match, trees  # noqa: F401
from tests.test_torch_streaming import assert_events_match, feed

from truely_tpu.config import DetectorConfig as JDetectorConfig
from truely_tpu.config import MTCNNConfig as JMTCNNConfig
from truely_tpu.parallel.mesh import make_mesh as jmake_mesh
from truely_tpu.pipeline.detector import Detector as JDetector
from truely_tpu.pipeline.streaming import StreamScheduler as JStreamScheduler
from truely_tpu_torch.cli import main
from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
from truely_tpu_torch.parallel import mesh as tmesh
from truely_tpu_torch.parallel.mesh import Mesh, make_mesh
from truely_tpu_torch.pipeline.batch import analyze_videos
from truely_tpu_torch.pipeline.detector import Detector
from truely_tpu_torch.pipeline.stream_files import stream_videos
from truely_tpu_torch.pipeline.streaming import StreamScheduler

torch.set_num_threads(2)

MF = dict(multi_face=True, max_tracks=3, similarity_threshold=0.9999, run_length_threshold=3)


def configs(**kw):
    common = dict(frame_batch=8, compute_dtype="float32", **kw)
    return (JDetectorConfig(mtcnn=JMTCNNConfig(**CASCADE), **common),
            DetectorConfig(mtcnn=MTCNNConfig(**CASCADE), **common))


def cpu_mesh(n=4):
    return make_mesh((n, 1), ("data", "model"), devices=["cpu"] * n)


def jax_mesh():
    return jmake_mesh((4, 1), ("data", "model"), devices=jax.devices()[:4])


def jax_run(fn, *args):
    with jax.default_matmul_precision("highest"):
        return fn(*args)


def assert_same_tracks(got, ref):
    """(score, per-track scores, TrackState) of a mesh run against the solo
    run: scores and the discrete state equal; the float state (boxes,
    embeddings) within 1e-6, since FaceNet on a shard's B/4·T crops may
    round differently from the whole batch's B·T (one float32 ulp here)."""
    assert got[0] == ref[0] and np.array_equal(got[1], ref[1])
    for name, a, b in zip(got[2]._fields, got[2], ref[2]):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)
        else:
            assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def stable():
    return blurred(0, 40)


@pytest.fixture(scope="module")
def jmesh_det():
    """The JAX Detector(mesh) of the single-face K=1 settings, shared so
    that its step compiles once."""
    return JDetector(configs()[0], mesh=jax_mesh())


# ---------------------------------------------------------------------------
# make_mesh


def test_make_mesh_shapes_and_axes():
    m = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2} and m.shape["model"] == 2
    assert m.devices.shape == (2, 2) and m.size == 4
    assert m.first_device == torch.device("cpu")
    assert m.distinct_devices() == [torch.device("cpu")]
    assert m.axis_devices("model") == [torch.device("cpu")] * 2
    default = make_mesh(devices=["cpu"] * 3)  # everything on 'data'
    assert default.shape == {"data": 3, "model": 1}


def test_make_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((3, 1), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="names"):
        Mesh(np.array([["cpu"]], dtype=object), ("data",))
    monkeypatch.setattr(tmesh.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_mesh_equality_by_devices_and_axes():
    a, b = cpu_mesh(), cpu_mesh()
    assert a == b and hash(a) == hash(b) and a is not b
    assert {a: 1}[b] == 1
    assert a != make_mesh((4, 1), ("data", "stage"), devices=["cpu"] * 4)
    assert a != make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert a != cpu_mesh(2)


# ---------------------------------------------------------------------------
# Detector(mesh)


def test_mesh_detector_batch_divisibility():
    with pytest.raises(ValueError, match="divisible"):
        Detector(DetectorConfig(frame_batch=6), mesh=cpu_mesh(), device="cpu")


def test_mesh_detector_device_is_the_mesh_first_device():
    with pytest.raises(ValueError, match="first device"):
        Detector(DetectorConfig(frame_batch=4), mesh=cpu_mesh(), device="meta")
    det = Detector(DetectorConfig(frame_batch=4), mesh=cpu_mesh())  # CPU, from the mesh
    assert det.device == torch.device("cpu")


def test_mesh_detector_matches_solo_and_jax(trees, jmesh_det):
    """tests/test_detector.py::test_mesh_detector_matches_unsharded."""
    _, cfg = configs()
    frames = np.random.default_rng(11).integers(0, 256, size=(20, 64, 96, 3), dtype=np.uint8)
    solo = Detector(cfg, params=trees, device="cpu").analyze_frames(frames, fps=10)
    got = Detector(cfg, params=trees, mesh=cpu_mesh()).analyze_frames(frames, fps=10)
    assert_records_match(got, solo)
    assert_records_match(got, jax_run(jmesh_det.analyze_frames, frames, 10))


def test_mesh_detector_production_config_matches_solo(trees):
    """tests/test_detector.py::test_mesh_detector_production_config_matches:
    the defaults (capacities 256/64/32, bf16, cascaded pyramid, q=4
    crops), at 120x160 (the JAX test's 360p is marked slow there)."""
    cfg = DetectorConfig(frame_batch=8)
    frames = np.random.default_rng(7).integers(0, 256, size=(16, 120, 160, 3), dtype=np.uint8)
    solo = Detector(cfg, params=trees, device="cpu").analyze_frames(frames, fps=30)
    got = Detector(cfg, params=trees, mesh=cpu_mesh()).analyze_frames(frames, fps=30)
    assert_records_match(got, solo)


def test_mesh_detector_i420_matches_solo(trees, stable):
    """The packed-I420 steps: K1 (here its plain version) runs per shard."""
    _, cfg = configs()
    packed = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420) for f in stable[:16]])
    solo = Detector(cfg, params=trees, device="cpu").analyze_i420(packed, fps=10)
    got = Detector(cfg, params=trees, mesh=cpu_mesh()).analyze_i420(packed, fps=10)
    assert_records_match(got, solo)
    assert any(r.has_face for r in got.records)


def test_mesh_detector_multiface_matches_solo(trees):
    """tests/test_detector.py::test_mesh_detector_multiface_matches."""
    _, cfg = configs()
    frames = np.random.default_rng(12).integers(0, 256, size=(12, 64, 96, 3), dtype=np.uint8)
    solo = Detector(cfg, params=trees, device="cpu").analyze_frames_tracks(frames, fps=10)
    got = Detector(cfg, params=trees, mesh=cpu_mesh()).analyze_frames_tracks(frames, fps=10)
    assert_same_tracks(got, solo)


def telemetry(det):
    return det.auto_keyframe_segments, det.auto_refine_segments, det.auto_interval_current


@pytest.mark.parametrize("interval,multi_face,jax_too",
                         [(4, False, False), ("auto", False, True), ("auto", True, False)])
def test_mesh_propagate_matches_solo_and_jax(trees, stable, interval, multi_face, jax_too):
    """tests/test_auto_interval.py::test_auto_mesh_matches_unsharded and
    ::test_auto_multiface_mesh_matches_unsharded, and the fixed K=4: 2 rows
    a shard, so each shard takes its seeds and keyframe rows by its global
    row offset."""
    kw = dict(detect_interval=interval, auto_interval_max=4, **(MF if multi_face else {}))
    jcfg, cfg = configs(**kw)
    solo = Detector(cfg, params=trees, device="cpu")
    det = Detector(cfg, params=trees, mesh=cpu_mesh())
    if multi_face:
        got = det.analyze_frames_tracks(stable, fps=10)
        assert_same_tracks(got, solo.analyze_frames_tracks(stable, fps=10))
    else:
        got = det.analyze_frames(stable, fps=10)
        assert_records_match(got, solo.analyze_frames(stable, fps=10))
        assert sum(r.has_face for i, r in enumerate(got.records) if i % 4)  # refined faces
    assert telemetry(det) == telemetry(solo)
    if interval == "auto":
        assert det.auto_refine_segments > 0 and det.auto_interval_current > 1
    if jax_too:
        jdet = JDetector(jcfg, mesh=jax_mesh())
        assert_records_match(got, jax_run(jdet.analyze_frames, stable, 10))
        assert telemetry(det) == telemetry(jdet)


def test_sharded_step_cached_per_mesh(trees):
    """tests/test_detector.py::test_sharded_step_cached_per_mesh and
    ::test_sharded_step_equal_mesh_hits_fast_path: one replica set per
    (mesh, axis), shared by every scheduler and step on it, and the mesh
    Detector's own for an equal rebuilt mesh."""
    _, cfg = configs()
    det = Detector(cfg, params=trees, device="cpu")
    a = StreamScheduler(det, n_streams=2, frames_per_stream=2, mesh=cpu_mesh())
    b = StreamScheduler(det, n_streams=2, frames_per_stream=2, mesh=cpu_mesh())
    assert a._sharded_step is b._sharded_step
    assert a._sharded_params is b._sharded_params
    assert a._sharded_params[torch.device("cpu")] is det.nets  # one device: no copy
    mesh_det = Detector(cfg, params=trees, mesh=cpu_mesh())
    step, params, spec = mesh_det.sharded_step(cpu_mesh())
    assert params is mesh_det._replicas and spec == (cpu_mesh(), "data")
    assert mesh_det.sharded_refine_step(cpu_mesh(), rows_per_seed=2)[1] is params


def test_warmup_on_a_mesh(trees, monkeypatch):
    """Detector.warmup on a mesh runs every step of its path sharded (the
    seed and propagate steps at K=4 with their row offsets) and changes no
    state of the detector."""
    from truely_tpu_torch.parallel import sharding

    _, cfg = configs(detect_interval=4)
    det = Detector(cfg, params=trees, mesh=cpu_mesh())
    calls = []
    real = sharding.run_sharded
    monkeypatch.setattr(sharding, "run_sharded",
                        lambda spec, step, *a, **kw: calls.append(step.__name__)
                        or real(spec, step, *a, **kw))
    det.warmup(64, 96)
    assert calls == ["frame_step", "frame_step_detect", "frame_step_propagate",
                     "frame_step_yuv", "frame_step_detect_yuv", "frame_step_propagate_yuv"]
    assert (det.auto_keyframe_segments, det.auto_refine_segments, det.fallback_segments) == (0, 0, 0)


def test_mesh_scheduler_divisibility(trees):
    _, cfg = configs()
    det = Detector(cfg, params=trees, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        StreamScheduler(det, n_streams=3, frames_per_stream=1, mesh=cpu_mesh())


def assert_same_events(got, ref):
    """The keys of tests/test_streaming.py's mesh test, and the
    similarities and face frames' boxes within the module's tolerance (a
    frame without a face carries the box its refinement rejected)."""
    key = lambda e: (e.stream_id, e.frame_index, e.has_face, e.flagged, e.annotated,  # noqa: E731
                     e.counter)
    assert [key(e) for e in got] == [key(e) for e in ref]
    np.testing.assert_allclose([e.similarity for e in got], [e.similarity for e in ref],
                               atol=1e-4)
    np.testing.assert_allclose([e.box for e in got if e.has_face],
                               [e.box for e in ref if e.has_face], atol=1)


@pytest.mark.parametrize("interval", [1, 4])
def test_mesh_scheduler_matches_solo_and_jax(trees, jmesh_det, interval):
    """tests/test_streaming.py::test_mesh_sharded_streams_match_unsharded
    (and its refine steps at K=4): 2 streams x 4 frames over 4 positions;
    the mesh comes from a mesh Detector by default."""
    _, cfg = configs(detect_interval=interval)
    content = [blurred(7, 24), blurred(8, 24)]

    def run(sched):
        events = feed(sched, content)
        return events, [sched.score(i) for i in range(2)]

    solo_ev, solo_sc = run(StreamScheduler(Detector(cfg, params=trees, device="cpu"), 2,
                                           frames_per_stream=4, fps=10))
    sched = StreamScheduler(Detector(cfg, params=trees, mesh=cpu_mesh()), 2,
                            frames_per_stream=4, fps=10)
    assert sched._mesh == cpu_mesh()
    ev, sc = run(sched)
    assert sc == solo_sc
    assert_same_events(ev, solo_ev)
    assert any(e.has_face for e in ev)
    if interval == 1:  # the JAX mesh detector's own step, compiled already
        jev, jsc = jax_run(run, JStreamScheduler(jmesh_det, 2, frames_per_stream=4, fps=10))
        assert sc == jsc
        assert_events_match(ev, jev)


def test_stream_videos_and_analyze_videos_with_a_mesh(trees, tmp_path):
    _, cfg = configs()
    paths = [write_clip(str(tmp_path / f"v{i}.avi"), blurred(40 + i, 12), 10) for i in range(2)]
    det = Detector(cfg, params=trees, device="cpu")
    solo = stream_videos(det, paths, frames_per_stream=4)
    sharded = stream_videos(det, paths, frames_per_stream=4, mesh=cpu_mesh())
    key = lambda s: (s.fake_score, s.processed, s.flagged_count, s.suspicious_frames)  # noqa: E731
    assert [key(s) for s in sharded] == [key(s) for s in solo]
    batch = analyze_videos(det, paths, frames_per_video=4, mesh=cpu_mesh())
    assert [(r.fake_score, r.total_processed, r.suspicious_frames) for r in batch] == \
        [(s.fake_score, s.processed, s.suspicious_frames) for s in solo]


# ---------------------------------------------------------------------------
# CLI --dp


@pytest.mark.parametrize("command", ["analyze", "stream", "serve"])
def test_cli_dp_errors(tmp_path, capsys, monkeypatch, command):
    """The JAX CLI's checks and messages: too few devices (CUDA devices
    counted by torch), and a batch that does not divide."""
    clip = write_clip(str(tmp_path / "c.avi"), blurred(1, 4), 10)
    args = {"analyze": [clip], "stream": [clip], "serve": ["--port", "0"]}[command]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert main([command, *args, "--dp", "2"]) == 1
    assert "--dp 2 needs 2 devices, have 1" in capsys.readouterr().err
    assert main([command, *args, "--dp", "3", "--batch", "8", "--device", "cpu"]) == 1
    assert "--batch 8 must be divisible by --dp 3" in capsys.readouterr().err


def test_cli_stream_dp_batch_error_is_a_message(tmp_path, capsys):
    """The JAX CLI's ``stream`` builds its mesh Detector unguarded, so a
    batch that --dp does not divide raises out of ``main`` (a traceback);
    the port's prints the error and exits 1."""
    from truely_tpu.cli import main as jmain

    clip = write_clip(str(tmp_path / "c.avi"), blurred(1, 4), 10)
    with pytest.raises(ValueError, match="divisible"):
        jmain(["stream", clip, "--dp", "4", "--batch", "6"])
    assert main(["stream", clip, "--dp", "4", "--batch", "6", "--device", "cpu"]) == 1
    assert "--batch 6 must be divisible by --dp 4" in capsys.readouterr().err


def test_cli_dp_on_cpu_positions_matches_dp1(tmp_path, capsys, monkeypatch, trees):
    """``analyze --dp 2 --device cpu`` (two CPU positions) prints the
    payload of ``--dp 1``."""
    import truely_tpu_torch.config as tconfig
    from truely_tpu.models import weights as jweights

    for name, tree in trees.items():
        jweights.save_params(str(tmp_path / f"{name}.npz"), tree)
    monkeypatch.setattr(tconfig, "DetectorConfig",
                        functools.partial(tconfig.DetectorConfig, compute_dtype="float32"))
    monkeypatch.setattr(tconfig, "MTCNNConfig", functools.partial(tconfig.MTCNNConfig, **CASCADE))
    clip = write_clip(str(tmp_path / "c.avi"), blurred(2, 16), 10)
    payloads = []
    for dp in ("1", "2"):
        assert main(["analyze", clip, "--batch", "8", "--device", "cpu", "--compact",
                     "--weights", str(tmp_path), "--dp", dp]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        out.pop("timings")
        payloads.append(out)
    assert payloads[0] == payloads[1]
    assert payloads[0]["processedFrames"] == 16
