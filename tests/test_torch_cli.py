"""The port's command line (``python -m truely_tpu_torch analyze|stream``)
against the JAX package's (``truely_tpu.cli``) on the same files, on the CPU
(``--device cpu``).

Both load the same weights: the JAX package's seeded trees, written with its
``save_params`` into one ``--weights`` directory.  The payloads are equal,
timings aside.  The comparisons run at float32 with the small cascade of
``tests/test_torch_propagate.py`` (patched into both CLIs' configs, so that
frames carry faces); one run takes the CLIs' own defaults (bf16).
"""

import functools
import json

import numpy as np
import pytest
import torch

from tests.test_auto_interval import blurred
from tests.test_torch_analyze_video import write_clip
from tests.test_torch_propagate import CASCADE, trees  # noqa: F401

import truely_tpu.config as jconfig
from truely_tpu.cli import main as jmain
from truely_tpu.models import weights as jweights
import truely_tpu_torch.config as tconfig
from truely_tpu_torch.cli import main

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights(trees, tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    for name, tree in trees.items():
        jweights.save_params(str(d / f"{name}.npz"), tree)
    return str(d)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    return [write_clip(str(d / f"c{i}.avi"), blurred(60 + i, 12), 14) for i in range(2)]


@pytest.fixture
def small(monkeypatch):
    """Both CLIs build float32 configs with the small cascade."""
    for mod in (jconfig, tconfig):
        monkeypatch.setattr(mod, "DetectorConfig",
                            functools.partial(mod.DetectorConfig, compute_dtype="float32"))
        monkeypatch.setattr(mod, "MTCNNConfig", functools.partial(mod.MTCNNConfig, **CASCADE))


def run(fn, argv, capsys):
    rc = fn(argv)
    out = capsys.readouterr()
    return rc, out.out.strip().splitlines(), out.err


def payloads(argv, capsys):
    """(JAX payload lines, port payload lines), each CLI's rc 0 and
    stderr free of the seeded-weights warning."""
    jrc, jout, jerr = run(jmain, argv, capsys)
    rc, out, err = run(main, argv + ["--device", "cpu"], capsys)
    assert rc == jrc == 0, (err, jerr)
    assert "seeded random weights" not in err + jerr
    return [json.loads(x) for x in jout], [json.loads(x) for x in out]


def without_timings(p):
    return {k: v for k, v in p.items() if k != "timings"}


def assert_event_lines_match(got, ref):
    """Event lines: every field equal but the rounded floats, similarities
    within 1e-4 and boxes within 1 px."""
    def split(e):
        tracks = e.get("tracks", [e])
        exact = {k: v for k, v in e.items() if k not in ("similarity", "tracks")}
        exact["tracks"] = [{k: v for k, v in t.items() if k not in ("similarity", "box")}
                           for t in e.get("tracks", [])]
        sims = [t["similarity"] for t in tracks]
        boxes = [t["box"] for t in e.get("tracks", [])]
        return exact, sims, boxes

    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        (ge, gs, gb), (re_, rs, rb) = split(g), split(r)
        assert ge == re_
        np.testing.assert_allclose(gs, rs, atol=1e-4)
        np.testing.assert_allclose(np.array(gb).reshape(-1, 4), np.array(rb).reshape(-1, 4),
                                   atol=1)


@pytest.mark.parametrize("extra", [[], ["--detect-interval", "2", "--draw", "flagged-only"]])
def test_analyze_matches_jax(weights, clips, tmp_path, capsys, small, extra):
    argv = ["analyze", clips[0], "--batch", "4", "--compact", "--weights", weights,
            "-o", str(tmp_path / "out.avi"), *extra]
    (ref,), (got,) = payloads(argv, capsys)
    assert without_timings(got) == without_timings(ref)
    assert got["frameCount"] == 12 and got["processedFrames"] == 6
    assert set(got["timings"]) == {"decode", "upload", "device", "temporal", "encode", "total"}


def test_analyze_defaults_match_jax(weights, clips, capsys):
    """The CLIs' own defaults (bf16, full capacities), score only."""
    (ref,), (got,) = payloads(["analyze", clips[1], "--compact", "--weights", weights], capsys)
    assert without_timings(got) == without_timings(ref)


def test_analyze_multi_face_matches_jax(weights, clips, capsys, small):
    argv = ["analyze", clips[0], "--batch", "4", "--compact", "--weights", weights,
            "--multi-face"]
    (ref,), (got,) = payloads(argv, capsys)
    assert got == ref and set(got) == {"fakeScore", "trackScores"}


@pytest.mark.parametrize("extra", [[], ["--multi-face"]])
def test_stream_matches_jax(weights, clips, capsys, small, extra):
    argv = ["stream", *clips, "--batch", "4", "--events", "--compact", "--weights", weights,
            *extra]
    ref, got = payloads(argv, capsys)
    assert len(got) == len(ref) == 6 * 2 + 1   # one line per sampled frame, then the summary
    assert_event_lines_match(got[:-1], ref[:-1])
    drop = ("sampledFps", "meanLagMs", "p50LagMs", "p95LagMs", "maxLagMs", "wallSeconds",
            "yuvIngest")
    assert [{k: v for k, v in s.items() if k not in drop} for s in got[-1]] == [
        {k: v for k, v in s.items() if k not in drop} for s in ref[-1]]
    assert all(s["yuvIngest"] for s in got[-1])


def test_seeded_weights_warning(clips, capsys):
    rc, out, err = run(main, ["analyze", clips[0], "--batch", "4", "--compact",
                              "--device", "cpu"], capsys)
    assert rc == 0 and "seeded random weights" in err
    assert 0 <= json.loads(out[-1])["fakeScore"] <= 100


@pytest.mark.parametrize("argv,message", [
    (["analyze", "/nonexistent/clip.avi"], "error: could not open video"),
    (["stream", "/nonexistent/clip.avi"], "error: could not open video"),
    (["analyze", "CLIP", "--batch", "6", "--detect-interval", "4"], "must be divisible"),
    (["analyze", "CLIP", "--batch", "4", "--detect-interval", "auto"], "must be divisible"),
    (["analyze", "BAD"], "error: "),
])
def test_friendly_errors(clips, tmp_path, capsys, argv, message):
    bad = tmp_path / "bad.avi"
    bad.write_bytes(b"RIFF\x10\0\0\0AVI not a video at all")
    argv = [{"CLIP": clips[0], "BAD": str(bad)}.get(a, a) for a in argv]
    rc, _, err = run(main, argv + ["--device", "cpu"], capsys)
    assert rc == 1
    assert message in err and "Traceback" not in err


def test_no_cuda_device_is_a_friendly_error(clips, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _, err = run(main, ["analyze", clips[0], "--device", "cuda"], capsys)
    assert rc == 1 and "error:" in err and "Traceback" not in err


def test_requires_command():
    with pytest.raises(SystemExit):
        main([])
