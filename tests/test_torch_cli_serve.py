"""``python -m truely_tpu_torch serve``: flags checked at parse time, the
detector built before the socket opens (no CUDA device: a friendly error
and exit 1, never the CPU, also through ``python -m
truely_tpu_torch.serve.app``), a server on the CPU that answers
``/health`` and reports its warmup, and the nets that ``chip_smoke.py``'s
serve phase hands the server through ``--weights``."""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from truely_tpu_torch.cli import main
from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
from truely_tpu_torch.pipeline.detector import Detector
from truely_tpu_torch.serve import app as serve_app

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the serve phase's nets)


@pytest.mark.parametrize("value", ["1080p", "0x640", "640x-1", "axb", "1080x", ""])
def test_bad_warmup_is_refused_at_parse_time(value, capsys):
    with pytest.raises(SystemExit) as e:
        main(["serve", "--warmup", value, "--device", "cpu"])
    assert e.value.code == 2 and "expected HxW" in capsys.readouterr().err


@pytest.fixture
def captured(monkeypatch):
    """The app ``serve`` would start, kept instead of serving."""
    apps = []
    monkeypatch.setattr(serve_app.TruelyServer, "serve", lambda self: apps.append(self))
    return apps


def test_flags_reach_the_detector_and_the_server(captured, capsys):
    rc = main(["serve", "--port", "5009", "--host", "127.0.0.1", "--batch", "16",
               "--multi-face", "--crop-quant", "8", "--detect-interval", "4",
               "--warmup", "64x96", "--warmup", "120X160", "--device", "cpu"])
    assert rc == 0
    (app,) = captured
    cfg = app.detector.config
    assert (cfg.frame_batch, cfg.multi_face, cfg.detect_interval, cfg.mtcnn.stage_crop_quant) \
        == (16, True, 4, 8)
    assert app.detector.device.type == "cpu"
    assert (app.config.host, app.config.port) == ("127.0.0.1", 5009)
    assert app.config.warmup_resolutions == ("64x96", "120X160")
    assert "seeded random weights" in capsys.readouterr().err
    deadline = time.time() + 120   # the warmup thread: both buckets, multi-face at K=4
    while len(app._warmed) < 2 and time.time() < deadline:
        time.sleep(0.05)
    assert app._warmed == ["64x96", "120X160"]


@pytest.mark.parametrize("argv", [["--batch", "30", "--detect-interval", "4"],
                                  ["--batch", "4", "--detect-interval", "auto"]])
def test_batch_must_divide_by_the_interval(captured, capsys, argv):
    assert main(["serve", "--device", "cpu", *argv]) == 1
    assert "must be divisible" in capsys.readouterr().err and not captured


@pytest.mark.parametrize("entry", [lambda argv: main(["serve", *argv]), serve_app.main],
                         ids=["cli", "serve.app"])
def test_no_cuda_device_fails_before_the_socket(monkeypatch, captured, capsys, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(serve_app, "make_server", lambda *a: pytest.fail("socket opened"))
    assert entry(["--port", "0"]) == 1
    err = capsys.readouterr().err
    assert "error:" in err and "CUDA" in err and "Traceback" not in err and not captured


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_on_cpu_answers_health():
    """A server process on the CPU answers /health and reports its warmup
    bucket done; terminating it ends it."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "truely_tpu_torch", "serve", "--device", "cpu", "--host",
         "127.0.0.1", "--port", str(port), "--batch", "4", "--warmup", "64x96"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        deadline = time.time() + 90
        health = None
        while time.time() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    health = json.loads(r.read())
                if health["warmup"]["done"]:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert proc.poll() is None, proc.stdout.read()[-3000:]
        assert health == {"status": "ok", "results": 0, "weights_pretrained": False,
                          "warmup": {"requested": ["64x96"], "done": ["64x96"]}}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode is not None


def test_serve_weights_pass_the_default_thresholds(tmp_path, captured):
    """``chip_smoke.serve_weights``, read through ``serve --weights``, give
    at the default thresholds the records of PROP_THRESHOLDS with the
    steadied regressions, and scores that are not 0 and differ by clip."""
    wdir = chip_smoke.serve_weights(str(tmp_path))
    assert main(["serve", "--weights", wdir, "--device", "cpu", "--port", "0"]) == 0
    (app,) = captured
    ref = chip_smoke.steady_regression(Detector(
        DetectorConfig(mtcnn=MTCNNConfig(thresholds=chip_smoke.PROP_THRESHOLDS)), device="cpu"))
    packed = chip_smoke.stable_i420(64, 240, 320, seed=51)
    scores = []
    for n in (64, 40):
        clip = chip_smoke.write_avi(str(tmp_path / f"clip{n}.avi"), packed[:n], 14)
        got, want = app.detector.analyze_video(clip), ref.analyze_video(clip)
        assert got.records == want.records and got.fake_score == want.fake_score
        assert sum(r.annotated for r in got.records) > 0
        scores.append(got.fake_score)
    assert 0 < scores[1] < scores[0], scores
