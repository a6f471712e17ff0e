"""The plain reference against the port at a tiny size on the CPU: both
analyse the same frames on the same weights and agree exactly, at bf16
and float32, single-face (K = 1, and in 8-row blocks as a 4-card mesh
runs them) and multi-face (K = 4 with the propagate fallback); and the
control, the reference with float8 operands, lands outside the limits."""

import json
import os

import pytest
import torch

from benchmark import check, content, spec, weights
from benchmark.reference import analysis as ref
from benchmark.reference.config import DetectorConfig as RefConfig
from benchmark.reference.layers import fp8_matmuls

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACENET = spec.model({"model": "facenet"})


def config(name, **det):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        c = json.load(f)
    c["detector"].update(det)
    return c


@pytest.fixture(scope="module")
def trees():
    c = config("facenet_single")
    return weights.seeded_trees(2**31 + 77, torch.device("cpu"), c["assumed"])


@pytest.fixture(scope="module")
def frames():
    return content.stable_i420(40, 120, 160, seed=5, n_base=2, hold=16)


def ref_config(c):
    return RefConfig(**FACENET.detector_kwargs(c["detector"], reference=True))


def port(c, trees, mesh=None):
    from truely_tpu_torch.config import DetectorConfig
    from truely_tpu_torch.pipeline.detector import Detector

    return Detector(DetectorConfig(**FACENET.detector_kwargs(c["detector"])), params=trees,
                    device="cpu", mesh=mesh)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_single_face_records_equal(trees, frames, dtype):
    c = config("facenet_single", frame_batch=8, compute_dtype=dtype)
    got = check.records_of(port(c, trees).analyze_i420(frames, 7))
    nets = ref.build_nets(trees, "cpu")
    want = ref.analyze(nets, frames, 7, ref_config(c),
                       yuv=True, device="cpu")
    assert got.has_face.any()
    assert check.record_numbers([got], [want]) == {"record_mismatch": 0.0, "score_gap": 0.0}
    assert (got.box == want.box).all() and got.score == want.score
    assert (got.similarity == want.similarity).all()


def test_mesh_rows_equal(trees, frames):
    from truely_tpu_torch.parallel.mesh import make_mesh

    c = config("facenet_single", frame_batch=32)  # 8 rows a card
    mesh = make_mesh((4, 1), ("data", "model"), devices=["cpu"] * 4)
    got = check.records_of(port(c, trees, mesh).analyze_i420(frames, 7))
    want = ref.analyze(ref.build_nets(trees, "cpu"), frames, 7,
                       ref_config(c), yuv=True,
                       device="cpu", rows=8)
    assert check.record_numbers([got], [want])["record_mismatch"] == 0.0


def test_multiface_tracks_equal(trees, frames):
    c = config("facenet_multiface_k4", frame_batch=8)
    det = port(c, trees)
    res = det.analyze_i420_tracks(frames, 7)
    got = check.tracks_of(res)
    want = ref.analyze_tracks(ref.build_nets(trees, "cpu"), frames, 7,
                              ref_config(c), yuv=True,
                              device="cpu")
    assert want.state["active"].any()
    assert check.track_numbers([got], [want]) == {
        "score_gap": 0.0, "track_mismatch": 0.0, "embedding_gap": 0.0}
    assert (got.per_track == want.per_track).all() and got.score == want.score


@pytest.mark.parametrize("name,kind", [("facenet_single", "records"),
                                       ("facenet_multiface_k4", "tracks")])
def test_control_fails_the_limits(trees, frames, name, kind):
    c = config(name, frame_batch=8)
    rc = ref_config(c)
    nets = ref.build_nets(trees, "cpu")
    run = ref.analyze_tracks if kind == "tracks" else ref.analyze
    want = run(nets, frames, 7, rc, yuv=True, device="cpu")
    with fp8_matmuls():
        low = run(nets, frames, 7, rc, yuv=True, device="cpu")
    assert not check.judge(check.numbers(kind, [low], [want]), c["limits"])


def test_fp8_operand_rounds_to_e4m3():
    from benchmark.reference.layers import operand

    x = torch.tensor([1.0, 1.0625, 448.0, -3.3])
    assert torch.equal(operand(x, torch.float32), x)
    with fp8_matmuls():
        q = operand(x, torch.float32)
    # amax 448 -> scale 1: e4m3 keeps 3 mantissa bits
    assert q.tolist() == [1.0, 1.0, 448.0, -3.25]
