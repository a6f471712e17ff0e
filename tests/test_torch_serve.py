"""The port's API server (``truely_tpu_torch.serve``) on the cases of
``tests/test_serve.py`` that use a fake detector, fake agents and a fake
acquisition module: the reference's JSON contracts and status codes,
validation, 404/413/416, Range, CORS over a socket, the job lifecycle, the
result store, warmup in ``/health`` and the acquisition helpers with a fake
runner.  Then the port's pure modules against the JAX package's on the same
inputs (``parse_byte_range``, ``Router``, the rendered report page, the
acquisition helpers), the ``.avi`` output path, which the JAX app gets
wrong, and the server without ``httpx``.
"""

import http.client
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_serve import FakeAgents, FakeDetector, FailingDetector

from truely_tpu.media import acquire as jacquire
from truely_tpu.serve import app as japp
from truely_tpu.serve import http as jhttp
from truely_tpu_torch.config import DetectorConfig, ServerConfig
from truely_tpu_torch.media import acquire
from truely_tpu_torch.media.acquire import (
    AcquisitionError, CombinedDownload, get_available_formats, get_platform_and_video_id,
    parse_quality, select_best_format,
)
from truely_tpu_torch.media.rawavi import RawAviReader, RawAviWriter
from truely_tpu_torch.pipeline.detector import Detector
from truely_tpu_torch.serve import http as thttp
from truely_tpu_torch.serve.app import TruelyServer
from truely_tpu_torch.serve.http import Request, make_server, serve_forever_in_thread
from truely_tpu_torch.serve.results import ResultStore
from truely_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeAcquire:
    """Stands in for the port's media.acquire inside the server."""

    AcquisitionError = AcquisitionError

    def __init__(self, tmp_path):
        self.tmp = tmp_path

    def _make(self, name, data=b"x" * 100):
        path = str(self.tmp / name)
        with open(path, "wb") as f:
            f.write(data)
        return path

    def download_video(self, url, quality, **kw):
        return self._make("video.mp4")

    def download_audio(self, url, fmt, **kw):
        return self._make(f"audio.{fmt}")

    def download_combined(self, url, fmt, quality, **kw):
        return CombinedDownload(video_path=self._make("combined.mp4"),
                                audio_path=self._make(f"combined.{fmt}"))


def make_server_obj(tmp_path, detector=None, keys=True, **kw):
    return TruelyServer(
        kw.pop("config", ServerConfig()), detector=detector or FakeDetector(),
        agents=kw.pop("agents", FakeAgents()), acquire_module=FakeAcquire(tmp_path),
        store=ResultStore(), tavily_api_key="tvly-test" if keys else "",
        gemini_api_key="gm-test" if keys else "")


@pytest.fixture
def server(tmp_path):
    return make_server_obj(tmp_path)


def call(server, method, path, query=None, body=None, headers=None):
    req = Request(method=method, path=path, query=query or {},
                  body=json.dumps(body).encode() if body is not None else b"",
                  headers=headers or {})
    resp = server.router.dispatch(req)
    payload = None
    if resp.content_type.startswith("application/json"):
        payload = json.loads(resp.content)
    return resp, payload


def make_video(tmp_path, name="in.mp4", data=b"mp4data"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def wait_gone(path, timeout=10.0):
    deadline = time.time() + timeout
    while os.path.exists(path) and time.time() < deadline:
        time.sleep(0.02)
    return not os.path.exists(path)


# ---- analyze-video / -audio / -combined --------------------------------------


def test_analyze_video_contract(server, tmp_path):
    path = make_video(tmp_path)
    resp, payload = call(server, "POST", "/analyze-video", body={"videoPath": path})
    assert resp.status == 200
    assert payload["fakeScore"] == 42
    stored = server.store.get(payload["resultId"])
    assert stored["fake_score"] == 42
    assert stored["output_path"].endswith("_output.mp4")
    assert wait_gone(path)   # the input is deleted in the background


@pytest.mark.parametrize("body,err", [
    ({}, "Missing video path"),
    ({"videoPath": "/nope/x.mp4"}, "Video file not found at specified path"),
])
def test_analyze_video_validation(server, body, err):
    resp, payload = call(server, "POST", "/analyze-video", body=body)
    assert resp.status == 400 and payload["error"] == err


def test_analyze_video_empty_file(server, tmp_path):
    path = make_video(tmp_path, "empty.mp4", b"")
    resp, payload = call(server, "POST", "/analyze-video", body={"videoPath": path})
    assert resp.status == 400 and payload["error"] == "Video file is empty"


def test_analyze_video_directory_is_not_a_file(server, tmp_path):
    resp, payload = call(server, "POST", "/analyze-video", body={"videoPath": str(tmp_path)})
    assert resp.status == 400 and payload["error"] == "Provided path is not a file"


def test_analyze_audio_contract(server, tmp_path):
    path = make_video(tmp_path, "a.mp3")
    resp, payload = call(server, "POST", "/analyze-audio", body={"audioPath": path})
    assert resp.status == 200
    assert payload["newsScore"] == 88            # confidence wins over the verdict map
    assert payload["verdict"] == "Fake" and payload["confidence"] == 88
    assert payload["evidence"] == [{"title": "Moon landing anniversary", "url": "https://bbc.com/a"},
                                   {"title": "Fact check", "url": "https://cnn.com/b"}]
    assert server.store.get(payload["resultId"])["verdict"] == "Fake"


def test_analyze_audio_missing_keys_503(tmp_path):
    server = make_server_obj(tmp_path, keys=False)
    path = make_video(tmp_path, "a.mp3")
    resp, payload = call(server, "POST", "/analyze-audio", body={"audioPath": path})
    assert resp.status == 503 and payload["error"] == "Gemini API key not configured"


def test_analyze_audio_no_results_uncertain(server, tmp_path):
    server.agents = FakeAgents(no_results=True)
    path = make_video(tmp_path, "a.mp3")
    resp, payload = call(server, "POST", "/analyze-audio", body={"audioPath": path})
    assert resp.status == 200
    assert payload["verdict"] == "Uncertain" and payload["newsScore"] == 25


def test_analyze_audio_query_fallback(server, tmp_path):
    server.agents = FakeAgents(fail_query=True)
    path = make_video(tmp_path, "a.mp3")
    resp, payload = call(server, "POST", "/analyze-audio", body={"audioPath": path})
    assert resp.status == 200 and payload["newsScore"] == 88


def test_analyze_combined_contract(server, tmp_path):
    video, audio = make_video(tmp_path), make_video(tmp_path, "a.mp3")
    resp, payload = call(server, "POST", "/analyze-combined",
                         body={"videoPath": video, "audioPath": audio})
    assert resp.status == 200
    assert (payload["fakeScore"], payload["newsScore"], payload["verdict"]) == (42, 88, "Fake")
    stored = server.store.get(payload["resultId"])
    assert (stored["fake_score"], stored["news_score"]) == (42, 88)


def test_analyze_combined_video_only(server, tmp_path):
    resp, payload = call(server, "POST", "/analyze-combined",
                         body={"videoPath": make_video(tmp_path)})
    assert resp.status == 200
    assert payload["newsSummary"] == "No audio content provided for analysis"
    assert "verdict" not in payload


def test_analyze_combined_missing_keys_warns_not_503(tmp_path):
    server = make_server_obj(tmp_path, keys=False)
    video, audio = make_video(tmp_path), make_video(tmp_path, "a.mp3")
    resp, payload = call(server, "POST", "/analyze-combined",
                         body={"videoPath": video, "audioPath": audio})
    assert resp.status == 200
    assert "Gemini API key not configured" in payload["newsSummary"]


# ---- downloads -----------------------------------------------------------------


def test_download_video_contract(server):
    resp, payload = call(server, "GET", "/download-video",
                         query={"video_url": "https://youtube.com/watch?v=abc123"})
    assert resp.status == 200 and payload["videoPath"].endswith("video.mp4")


@pytest.mark.parametrize("path", ["/download-video", "/download-audio", "/download-combined"])
def test_download_no_url(server, path):
    resp, payload = call(server, "GET", path)
    assert resp.status == 400 and payload["error"] == "No video URL provided"


def test_download_audio_contract(server):
    resp, payload = call(server, "GET", "/download-audio",
                         query={"video_url": "https://youtu.be/abc", "format": "mp3"})
    assert resp.status == 200
    assert server.store.get(payload["resultId"])["audio_path"] == payload["audioPath"]


def test_download_combined_contract(server):
    resp, payload = call(server, "GET", "/download-combined",
                         query={"video_url": "https://youtu.be/abc"})
    assert resp.status == 200
    assert set(payload) == {"videoPath", "videoId", "audioPath", "audioId"}
    assert server.store.get(payload["videoId"])["output_path"] == payload["videoPath"]


def test_download_acquisition_error_keeps_its_status(server, tmp_path):
    class Refusing(FakeAcquire):
        def download_video(self, url, quality, **kw):
            raise AcquisitionError("Unsupported URL format", status=400)

    server.acquire = Refusing(tmp_path)
    resp, payload = call(server, "GET", "/download-video",
                         query={"video_url": "https://example.com/v"})
    assert resp.status == 400 and payload["error"] == "Unsupported URL format"


# ---- view / media serving --------------------------------------------------------


def test_view_and_video_roundtrip(server, tmp_path):
    video, audio = make_video(tmp_path), make_video(tmp_path, "a.mp3")
    _, payload = call(server, "POST", "/analyze-combined",
                      body={"videoPath": video, "audioPath": audio})
    rid = payload["resultId"]
    resp, _ = call(server, "GET", f"/view/{rid}")
    html = resp.content.decode()
    assert resp.status == 200
    assert "42" in html and "Fake" in html and "https://bbc.com/a" in html
    resp, _ = call(server, "GET", f"/video/{rid}")
    assert resp.status == 200 and resp.body_bytes() == b"fake-video-bytes"
    assert resp.content_type == "video/mp4"


@pytest.mark.parametrize("path", ["/view/deadbeef", "/video/deadbeef", "/audio/deadbeef",
                                  "/jobs/deadbeef", "/static/nope.png", "/no-such-endpoint"])
def test_missing_404(server, path):
    resp, _ = call(server, "GET", path)
    assert resp.status == 404


def view_html(server, result):
    rid = server.store.put(result)
    resp, _ = call(server, "GET", f"/view/{rid}")
    assert resp.status == 200
    return resp.content.decode()


@pytest.mark.parametrize("score,consistency,anomalies", [
    (90, "Very Low", "Very High"), (70, "Low", "High"), (50, "Medium", "Medium"),
    (30, "High", "Low"), (10, "Very High", "Very Low"),
])
def test_view_stat_bands(server, score, consistency, anomalies):
    html = view_html(server, {"fake_score": score, "news_score": 0})
    ic, ia = html.index("Facial Consistency"), html.index("Frame Anomalies")
    assert consistency in html[ic:ia] and anomalies in html[ia:ia + 600]


@pytest.mark.parametrize("score,phrases", [
    (90, ["Very high AI detection", "signs of AI-generated edits"]),
    (65, ["High AI detection", "signs of AI-generated edits"]),
    (45, ["Moderate AI detection", "signs of AI-generated edits"]),
    (20, ["Low AI detection", "minimal signs of manipulation"]),
])
def test_view_alert_copy_bands(server, score, phrases):
    html = view_html(server, {"fake_score": score, "news_score": 0})
    assert all(p in html for p in phrases)


def test_view_credibility_inversion(server):
    html = view_html(server, {"fake_score": 10, "news_score": 88, "verdict": "Fake"})
    for text in ("12%", "88%", "Content Credibility", "Confidence Level", "Fact-Check Verdict"):
        assert text in html


def test_view_sources_and_static_sections(server):
    html = view_html(server, {
        "fake_score": 10, "news_score": 40, "verdict": "Misleading",
        "news_summary": "summary text here",
        "news_evidence": [{"title": "Src A", "url": "https://bbc.com/a"}],
    })
    for text in ("Referenced Sources", "Src A", "https://bbc.com/a",
                 "External source supporting the analysis", "Key Findings", "summary text here",
                 "How Truely Detects AI Content", "Media Literacy Tips",
                 "Verify Before You Believe"):
        assert text in html


def test_view_no_fake_score_renders(server):
    html = view_html(server, {"news_score": 30, "verdict": "Uncertain", "news_summary": "s"})
    assert "No video analysis available" in html and "70%" in html


# ---- Range / streamed file serving ----------------------------------------------------


def stored_video(server, tmp_path, data=b"0123456789abcdef"):
    return server.store.put({"output_path": make_video(tmp_path, "r.mp4", data)}), data


@pytest.mark.parametrize("header,lo,hi", [("bytes=4-7", 4, 8), ("bytes=10-", 10, 16),
                                          ("bytes=-4", 12, 16), ("bytes=3-100", 3, 16)])
def test_video_range_request_206(server, tmp_path, header, lo, hi):
    rid, data = stored_video(server, tmp_path)
    resp, _ = call(server, "GET", f"/video/{rid}", headers={"range": header})
    assert resp.status == 206
    assert resp.headers["Content-Range"] == f"bytes {lo}-{hi - 1}/{len(data)}"
    assert resp.body_bytes() == data[lo:hi]


def test_video_range_unsatisfiable_416(server, tmp_path):
    rid, data = stored_video(server, tmp_path)
    resp, _ = call(server, "GET", f"/video/{rid}", headers={"range": f"bytes={len(data)}-"})
    assert resp.status == 416 and resp.headers["Content-Range"] == f"bytes */{len(data)}"


def test_video_full_response_advertises_ranges(server, tmp_path):
    rid, data = stored_video(server, tmp_path)
    resp, _ = call(server, "GET", f"/video/{rid}")
    assert resp.status == 200 and resp.headers["Accept-Ranges"] == "bytes"
    assert resp.body_bytes() == data


def test_parse_byte_range_units():
    assert thttp.parse_byte_range("bytes=0-0", 10) == (0, 0)
    assert thttp.parse_byte_range("bytes=3-100", 10) == (3, 9)
    assert thttp.parse_byte_range("bytes=-3", 10) == (7, 9)
    for bad in ("bytes=-0", "bytes=10-", "bytes=5-4", "bytes=-", "bogus"):
        assert thttp.parse_byte_range(bad, 10) is None
    assert thttp.parse_byte_range("bytes=0-", 0) is None


def test_parse_byte_range_matches_jax():
    """Every header of a grid, at every size of a grid, parses to the JAX
    package's answer."""
    ends = ["", "0", "1", "3", "7", "9", "10", "11", "100"]
    headers = [f"bytes={a}-{b}" for a, b in itertools.product(ends, ends)]
    headers += ["bytes=0-3,5-7", " bytes=2-4 ", "bytes=x-1", "items=0-1", "bytes", ""]
    for header, size in itertools.product(headers, [0, 1, 2, 9, 10, 11, 1 << 40]):
        assert thttp.parse_byte_range(header, size) == jhttp.parse_byte_range(header, size), \
            (header, size)


def test_router_matches_jax(server, tmp_path):
    """The port's routes are the JAX app's: the same (method, path) pairs
    reach the handler of the same name, with the same path params."""
    jserver = japp.TruelyServer(detector=FakeDetector(), agents=FakeAgents(),
                                acquire_module=FakeAcquire(tmp_path), store=ResultStore(),
                                tavily_api_key="", gemini_api_key="")
    paths = ["/view/abc", "/video/abc", "/audio/abc", "/download-video", "/download-audio",
             "/download-combined", "/analyze-video", "/analyze-audio", "/analyze-combined",
             "/static/icon16.png", "/health", "/metrics", "/jobs/analyze-video",
             "/jobs/analyze-combined", "/jobs/abc", "/view/abc/x", "/view/", "/", "/jobs/a/b"]
    reached = set()
    for method, path in itertools.product(["GET", "POST", "get", "PUT"], paths):
        got = server.router.route(method, path)
        want = jserver.router.route(method, path)
        assert (got is None) == (want is None), (method, path)
        if got is not None:
            assert (got[0].__name__, got[1]) == (want[0].__name__, want[1]), (method, path)
            reached.add(got[0].__name__)
    assert len(reached) == 15


@pytest.mark.parametrize("record", [
    {"fake_score": 90, "news_score": 0},
    {"fake_score": 10, "news_score": 88, "verdict": "fake"},
    {"news_score": 30, "verdict": "Uncertain", "news_summary": "s <b>x</b>"},
    {"fake_score": 45, "news_score": 40, "verdict": "Misleading", "news_summary": "t",
     "news_evidence": [{"title": "Src A", "url": "https://bbc.com/a"}, {"url": "u"}, {}]},
    {},
])
def test_view_html_matches_jax(server, tmp_path, record):
    jserver = japp.TruelyServer(detector=FakeDetector(), agents=FakeAgents(),
                                acquire_module=FakeAcquire(tmp_path), store=ResultStore(),
                                tavily_api_key="", gemini_api_key="")
    rid = "same-id"
    server.store.put(record, result_id=rid)
    jserver.store.put(record, result_id=rid)
    got = server.router.dispatch(Request("GET", f"/view/{rid}", {}))
    want = jserver.router.dispatch(jhttp.Request("GET", f"/view/{rid}", {}))
    assert got.status == want.status == 200
    assert got.content == want.content


# ---- sockets, limits, metrics ----------------------------------------------------------


@pytest.fixture
def httpd(server):
    srv = make_server(server.router, "127.0.0.1", 0)
    serve_forever_in_thread(srv)
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_range_over_real_socket(server, tmp_path, httpd):
    rid, data = stored_video(server, tmp_path)
    req = urllib.request.Request(f"{httpd}/video/{rid}", headers={"Range": "bytes=2-5"})
    with urllib.request.urlopen(req) as r:
        assert r.status == 206 and r.headers["Content-Range"] == f"bytes 2-5/{len(data)}"
        assert r.read() == data[2:6]
    with urllib.request.urlopen(f"{httpd}/video/{rid}") as r:
        assert r.status == 200 and r.read() == data


def test_oversized_body_rejected_413(httpd, monkeypatch):
    monkeypatch.setattr(thttp, "MAX_BODY_BYTES", 1024)
    req = urllib.request.Request(f"{httpd}/analyze-video", data=b"x" * 2048, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 413


def test_negative_content_length_reads_nothing(httpd):
    """A negative Content-Length reads as 0 (never rfile.read(-N), which
    would block the handler thread until the client hangs up)."""
    conn = http.client.HTTPConnection(httpd.split("//")[1], timeout=10)
    try:
        conn.putrequest("POST", "/analyze-video")
        conn.putheader("Content-Length", "-5")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert json.loads(resp.read())["error"] == "Missing video path"
    finally:
        conn.close()


def test_cors_preflight_over_socket(httpd):
    req = urllib.request.Request(f"{httpd}/analyze-video", method="OPTIONS")
    with urllib.request.urlopen(req) as r:
        assert r.status == 204
        assert r.headers["Access-Control-Allow-Origin"] == "*"
        assert r.headers["Access-Control-Allow-Methods"] == "*"


def test_http_server_over_socket(httpd):
    with urllib.request.urlopen(f"{httpd}/health") as r:
        assert r.status == 200 and json.loads(r.read())["status"] == "ok"
    req = urllib.request.Request(f"{httpd}/analyze-video", method="POST",
                                 data=json.dumps({"videoPath": "/nope.mp4"}).encode())
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400 and e.value.headers["Access-Control-Allow-Origin"] == "*"


def test_audio_media_types(server, tmp_path):
    for ext, expected in [("m4a", "audio/mp4"), ("mp3", "audio/mp3")]:
        rid = server.store.put({"audio_path": make_video(tmp_path, f"x.{ext}")})
        resp, _ = call(server, "GET", f"/audio/{rid}")
        assert resp.status == 200 and resp.content_type == expected


def test_static_and_health(server):
    resp, _ = call(server, "GET", "/static/icon16.png")
    assert resp.status == 200 and resp.content_type == "image/png"
    with open(os.path.join(ROOT, "truely_tpu", "serve", "static", "icon16.png"), "rb") as f:
        assert resp.body_bytes() == f.read()
    resp, payload = call(server, "GET", "/health")
    assert payload == {"status": "ok", "results": 0, "weights_pretrained": False}


def test_analysis_fault_surfaces_500_and_metrics(tmp_path):
    server = make_server_obj(tmp_path, detector=FailingDetector(), keys=False)
    resp, payload = call(server, "POST", "/analyze-video",
                         body={"videoPath": make_video(tmp_path)})
    assert resp.status == 500 and "injected device failure" in payload["error"]
    _, metrics = call(server, "GET", "/metrics")
    assert (metrics["analyses_total"], metrics["analyses_failed"]) == (1, 1)


def test_metrics_endpoint(server, tmp_path):
    _, payload = call(server, "GET", "/metrics")
    assert payload["analyses_total"] == 0
    call(server, "POST", "/analyze-video", body={"videoPath": make_video(tmp_path)})
    call(server, "GET", "/download-video", query={"video_url": "https://youtu.be/abc"})
    _, payload = call(server, "GET", "/metrics")
    assert (payload["analyses_total"], payload["analyses_failed"], payload["downloads_total"]) \
        == (1, 0, 1)
    assert payload["last_analysis_seconds"] is not None and payload["uptime_seconds"] >= 0
    for key in ("analysis_seconds_p50", "analysis_seconds_p95", "job_wait_seconds_p50",
                "job_wait_seconds_p95", "job_run_seconds_p50", "job_run_seconds_p95"):
        assert payload[key] >= 0


class BlockingDetector(FakeDetector):
    """Holds its first analysis until ``release`` is set."""

    def __init__(self):
        super().__init__()
        self.entered, self.release = threading.Event(), threading.Event()

    def run(self, video_in, video_out):
        if not self.entered.is_set():
            self.entered.set()
            assert self.release.wait(10)
        return super().run(video_in, video_out)


def test_lock_wait_of_two_concurrent_analyses(tmp_path):
    """The second of two concurrent /analyze-video requests waits for the
    detector lock while the first runs: ``lock_wait_seconds_p95`` reads
    that wait, ``lock_wait_seconds_p50`` the first's none,
    ``analysis_run_seconds_*`` the analyses without the wait, and each
    request records a ``serve.lock_wait`` and a ``serve.analysis`` span."""
    det = BlockingDetector()
    server = make_server_obj(tmp_path, detector=det)
    paths = [make_video(tmp_path, f"in{i}.mp4") for i in range(2)]
    codes = []

    def post(path):
        codes.append(call(server, "POST", "/analyze-video", body={"videoPath": path})[0].status)

    with profiling.collect() as spans:
        first = threading.Thread(target=post, args=(paths[0],))
        first.start()
        assert det.entered.wait(10)
        second = threading.Thread(target=post, args=(paths[1],))
        second.start()
        time.sleep(0.3)
        det.release.set()
        for t in (first, second):
            t.join(10)
            assert not t.is_alive()
    assert codes == [200, 200]
    _, payload = call(server, "GET", "/metrics")
    assert payload["lock_wait_seconds_p95"] >= 0.25
    assert 0 <= payload["lock_wait_seconds_p50"] < 0.25
    assert payload["analysis_seconds_p95"] >= payload["lock_wait_seconds_p95"]
    # The first analysis ran while the second waited; the second ran at once.
    assert payload["analysis_run_seconds_p95"] >= 0.25
    assert 0 <= payload["analysis_run_seconds_p50"] < 0.25
    names = sorted(s.name for s in spans)
    assert names == ["serve.analysis"] * 2 + ["serve.lock_wait"] * 2
    waits = sorted(s.end - s.start for s in spans if s.name == "serve.lock_wait")
    assert waits[1] >= 0.25


def test_lock_released_when_the_wait_span_fails(tmp_path, monkeypatch):
    """A span that fails to close after the detector lock was taken (the
    recorder raising) still releases the lock: the next request runs."""
    server = make_server_obj(tmp_path)
    real_add = profiling.StageTimer._add

    def failing_add(self, name, *a):
        if name == "serve.lock_wait":
            raise RuntimeError("the recorder failed")
        return real_add(self, name, *a)

    monkeypatch.setattr(profiling.StageTimer, "_add", failing_add)
    with pytest.raises(RuntimeError):
        server._run_analysis(make_video(tmp_path, "in0.mp4"), str(tmp_path / "out0.mp4"))
    assert not server._detector_lock.locked()
    monkeypatch.setattr(profiling.StageTimer, "_add", real_add)
    resp = call(server, "POST", "/analyze-video",
                body={"videoPath": make_video(tmp_path, "in1.mp4")})[0]
    assert resp.status == 200


def test_invalid_json_body(server):
    resp = server.router.dispatch(Request("POST", "/analyze-video", {}, body=b"{not json"))
    assert resp.status == 400


# ---- jobs ------------------------------------------------------------------------------


def test_async_job_lifecycle(server, tmp_path):
    resp, payload = call(server, "POST", "/jobs/analyze-video",
                         body={"videoPath": make_video(tmp_path)})
    assert resp.status == 202
    job = server.jobs.wait(payload["jobId"], timeout=30)
    assert job.status == "done"
    resp, payload = call(server, "GET", f"/jobs/{job.job_id}")
    assert resp.status == 200 and payload["status"] == "done" and payload["fakeScore"] == 42
    resp, _ = call(server, "GET", f"/video/{payload['resultId']}")
    assert resp.status == 200


def test_async_combined_job(server, tmp_path):
    resp, payload = call(server, "POST", "/jobs/analyze-combined",
                         body={"videoPath": make_video(tmp_path)})
    assert resp.status == 202
    job = server.jobs.wait(payload["jobId"], timeout=30)
    assert job.status == "done" and job.result["fakeScore"] == 42
    assert job.batch_key is None


def test_async_job_validation_is_synchronous(server):
    resp, _ = call(server, "POST", "/jobs/analyze-video", body={"videoPath": "/nope.mp4"})
    assert resp.status == 400


def test_async_job_failure_reported(tmp_path):
    server = make_server_obj(tmp_path, detector=FailingDetector(), keys=False)
    _, payload = call(server, "POST", "/jobs/analyze-video",
                      body={"videoPath": make_video(tmp_path)})
    job = server.jobs.wait(payload["jobId"], timeout=30)
    assert job.status == "failed"
    _, payload = call(server, "GET", f"/jobs/{job.job_id}")
    assert payload["status"] == "failed" and "injected device failure" in payload["error"]


def test_jobs_with_one_batch_key_run_as_one_group():
    """Jobs queued behind a busy worker with the same kind and batch_key are
    taken as one group by the kind's group runner; others run alone, in
    order."""
    from truely_tpu_torch.serve.jobs import JobRunner

    runner = JobRunner()
    groups = []
    runner.register_group_runner("k", lambda jobs: (groups.append([j.payload for j in jobs])
                                                    or {j.job_id: {"n": j.payload} for j in jobs}))
    gate = threading.Event()
    runner.submit("gate", lambda: gate.wait(30) and {})
    jobs = [runner.submit("k", lambda: {"solo": True}, batch_key=key, payload=i)
            for i, key in enumerate([(1, 2), (3, 4), (1, 2), None, (1, 2)])]
    gate.set()
    done = [runner.wait(j.job_id, timeout=30) for j in jobs]
    assert [j.status for j in done] == ["done"] * 5
    assert groups == [[0, 2, 4]]
    assert [j.result for j in done] == [{"n": 0}, {"solo": True}, {"n": 2}, {"solo": True},
                                        {"n": 4}]
    assert len({done[i].started_at for i in (0, 2, 4)}) == 1


# ---- result store ------------------------------------------------------------------------


def test_result_store_ttl_and_file_cleanup(tmp_path):
    now = [1000.0]
    store = ResultStore(ttl_seconds=10, clock=lambda: now[0])
    media = make_video(tmp_path, "old.mp4")
    rid = store.put({"output_path": media})
    assert store.sweep() == 0
    now[0] += 11
    assert store.sweep() == 1 and store.get(rid) is None and not os.path.exists(media)


def test_result_store_persistence_across_restart(tmp_path):
    snap = str(tmp_path / "results.json")
    now = [1000.0]
    store = ResultStore(ttl_seconds=100, clock=lambda: now[0], persist_path=snap)
    rid_fresh = store.put({"fake_score": 42})
    now[0] = 1050.0
    rid_old = store.put({"fake_score": 7}, result_id="old")
    now[0] = 1130.0
    store2 = ResultStore(ttl_seconds=100, clock=lambda: now[0], persist_path=snap)
    assert store2.get(rid_old) == {"fake_score": 7, "timestamp": 1050.0}
    assert store2.get(rid_fresh) is None


def test_result_store_concurrent_access():
    store = ResultStore(ttl_seconds=0.001)
    errors = []

    def loop(fn):
        try:
            for _ in range(300):
                fn()
        except Exception as e:  # noqa: BLE001 — collected and asserted below
            errors.append(e)

    threads = ([threading.Thread(target=loop, args=(lambda: store.put({"x": 1}),))
                for _ in range(4)]
               + [threading.Thread(target=loop, args=(store.sweep,)) for _ in range(2)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)


# ---- managed and unmanaged inputs, the output path ------------------------------------------


def test_analyze_video_never_touches_unmanaged_inputs(server, tmp_path, monkeypatch):
    managed = tmp_path / "managed"
    managed.mkdir()
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(managed))
    path = make_video(tmp_path, "fixture.mp4")
    resp, payload = call(server, "POST", "/analyze-video", body={"videoPath": path})
    assert resp.status == 200
    assert server.store.get(payload["resultId"])["output_path"].startswith(str(managed))
    time.sleep(0.3)
    assert os.path.exists(path)
    assert not os.path.exists(path.replace(".mp4", "_output.mp4"))


def test_analyze_video_managed_inputs_keep_reference_behavior(server, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    path = make_video(tmp_path, "dl.mp4")
    resp, payload = call(server, "POST", "/analyze-video", body={"videoPath": path})
    assert resp.status == 200
    assert server.store.get(payload["resultId"])["output_path"] == path.replace(".mp4",
                                                                                 "_output.mp4")
    assert wait_gone(path)


@pytest.mark.parametrize("name,want", [("dl.mp4", "dl_output.mp4"), ("dl.avi", "dl_output.avi"),
                                       ("a.mp4.avi", "a.mp4_output.avi"),
                                       ("dl", "dl_output.mp4"), ("x.MOV", "x_output.MOV")])
def test_output_path_is_never_the_input(server, tmp_path, monkeypatch, name, want):
    """``<stem>_output<ext>`` next to a managed input; the JAX app's
    ``.replace(".mp4", ...)`` gives an ``.avi`` input its own path."""
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    path = str(tmp_path / name)
    assert server._output_path_for(path) == str(tmp_path / want)
    jserver = japp.TruelyServer(detector=FakeDetector(), store=ResultStore())
    if name == "dl.avi":
        assert jserver._output_path_for(path) == path   # the JAX app's fault


def tiny_avi(path, n=12, h=64, w=96, fps=14, seed=3):
    rng = np.random.default_rng(seed)
    out = RawAviWriter(path, fps, w, h)
    for _ in range(n):
        out.write_i420(rng.integers(0, 256, (h * 3 // 2, w), np.uint8))
    out.close()
    return path


def test_avi_request_keeps_its_output(tmp_path, monkeypatch):
    """A managed ``.avi`` input through the port's detector: the output is
    ``<stem>_output.avi`` (raw I420, every frame), it survives the input's
    deletion, and ``/video`` serves it as ``video/x-msvideo`` with Range."""
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    det = Detector(DetectorConfig(frame_batch=4, compute_dtype="float32"), device="cpu")
    server = make_server_obj(tmp_path, detector=det, keys=False)
    path = tiny_avi(str(tmp_path / "dl.avi"))
    want = det.analyze_video(path)
    resp, payload = call(server, "POST", "/analyze-video", body={"videoPath": path})
    assert resp.status == 200, payload
    out = server.store.get(payload["resultId"])["output_path"]
    assert out == str(tmp_path / "dl_output.avi")
    assert payload["fakeScore"] == want.fake_score
    assert wait_gone(path)
    reader = RawAviReader(out)
    assert reader.frame_count == 12
    reader.close()
    resp, _ = call(server, "GET", f"/video/{payload['resultId']}", headers={"range": "bytes=0-11"})
    assert resp.status == 206 and resp.content_type == "video/x-msvideo"
    assert resp.body_bytes()[:4] == b"RIFF" and resp.body_bytes()[8:12] == b"AVI "


def test_single_job_keeps_solo_contract(tmp_path):
    """A lone groupable job (a readable video, so a batch_key) runs the
    synchronous handler: the full contract, no scheduler."""
    det = Detector(DetectorConfig(frame_batch=4, compute_dtype="float32"), device="cpu")
    server = make_server_obj(tmp_path, detector=det, keys=False)
    path = tiny_avi(str(tmp_path / "solo.avi"))
    want = det.analyze_video(path).fake_score
    resp, payload = call(server, "POST", "/jobs/analyze-video", body={"videoPath": path})
    assert resp.status == 202
    job = server.jobs.wait(payload["jobId"], timeout=120)
    assert job.status == "done" and job.batch_key == (64, 96)
    assert job.result["fakeScore"] == want
    resp, _ = call(server, "GET", f"/video/{job.result['resultId']}")
    assert resp.status == 200 and resp.content_type == "video/x-msvideo"


def test_probe_bucket_reads_the_port_reader(server, tmp_path):
    assert server._probe_bucket(tiny_avi(str(tmp_path / "a.avi"), h=120, w=160)) == (120, 160)
    assert server._probe_bucket(make_video(tmp_path, "junk.avi", b"RIFF" + b"\0" * 40)) is None
    assert server._probe_bucket(str(tmp_path / "missing.avi")) is None


# ---- warmup --------------------------------------------------------------------------------


class WarmDetector(FakeDetector):
    facenet_pretrained = True

    def __init__(self):
        super().__init__()
        self.warmed = []

    def warmup(self, h, w):
        self.warmed.append((h, w))


def wait_warm(srv, n):
    deadline = time.time() + 10
    while len(srv._warmed) < n and time.time() < deadline:
        time.sleep(0.02)


def test_warmup_reports_in_health(tmp_path):
    det = WarmDetector()
    srv = make_server_obj(tmp_path, detector=det,
                          config=ServerConfig(warmup_resolutions=("360x640", "1080x1920")))
    wait_warm(srv, 2)
    assert det.warmed == [(360, 640), (1080, 1920)]
    _, payload = call(srv, "GET", "/health")
    assert payload["warmup"] == {"requested": ["360x640", "1080x1920"],
                                 "done": ["360x640", "1080x1920"]}
    assert payload["weights_pretrained"] is True


def test_warmup_bad_entry_is_best_effort(tmp_path):
    det = WarmDetector()
    srv = make_server_obj(tmp_path, detector=det,
                          config=ServerConfig(warmup_resolutions=("garbage", "64X96", "64x96")))
    wait_warm(srv, 2)
    assert srv._warmed == ["64X96", "64x96"] and det.warmed == [(64, 96)]


# ---- acquisition ----------------------------------------------------------------------------

URLS = [
    "https://www.youtube.com/watch?v=dQw4w9WgXcQ", "https://youtu.be/abc_123",
    "https://www.youtube.com/shorts/xyz", "https://x.com/user/status/12345",
    "https://twitter.com/user/status/678", "https://www.facebook.com/watch/?v=555",
    "https://fb.watch/abcde/", "https://www.facebook.com/page/videos/999",
    "https://www.reddit.com/r/videos/comments/xyz9/title/", "https://redd.it/abc12",
    "https://example.com/video/1", "", "youtube.com/watch?v=", "https://m.youtube.com/watch?v=a&t=3",
]


def test_platform_regexes():
    assert [get_platform_and_video_id(u) for u in URLS[:11]] == [
        ("youtube", "dQw4w9WgXcQ"), ("youtube", "abc_123"), ("youtube", "xyz"),
        ("twitter", "12345"), ("twitter", "678"), ("facebook", "555"), ("facebook", "abcde"),
        ("facebook", "999"), ("reddit", "xyz9"), ("reddit", "abc12"), (None, None)]


def test_acquire_helpers_match_jax():
    assert [get_platform_and_video_id(u) for u in URLS] == [
        jacquire.get_platform_and_video_id(u) for u in URLS]
    qualities = ["720p", "1080P", "garbage", None, "-5p", "0p", "p", "360", "144p", ""]
    assert [parse_quality(q) for q in qualities] == [jacquire.parse_quality(q) for q in qualities]
    formats = [
        {"format_id": "a", "height": 1080, "vcodec": "h264"},
        {"format_id": "b", "height": 360, "vcodec": "h264"},
        {"format_id": "c", "height": 240, "vcodec": "h264"},
        {"format_id": "d", "height": 720, "vcodec": "none"},
        {"format_id": "e", "vcodec": "h264"},
        {"format_id": "f", "height": 360, "vcodec": "vp9"},
    ]
    for target in (100, 240, 359, 360, 720, 4000):
        for subset in itertools.combinations(formats, 3):
            assert select_best_format(list(subset), target) == \
                jacquire.select_best_format(list(subset), target)
    assert select_best_format(formats, 360) == "f"   # the last of the tallest <= 360
    assert select_best_format(formats[:5], 100) == "c" and select_best_format([], 360) is None


def ytdlp_runner(created, data=b"video-bytes", fail_audio=False):
    def runner(cmd, timeout):
        assert cmd[0] == "yt-dlp"
        out = cmd[cmd.index("-o") + 1]
        if fail_audio and "-x" in cmd:
            raise subprocess.CalledProcessError(1, cmd, stderr="no audio")
        with open(out, "wb") as f:
            f.write(data)
        created.append((out, cmd))
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")
    return runner


def test_download_video_with_fake_runner():
    created = []
    path = acquire.download_video("https://youtu.be/abc", "720p", runner=ytdlp_runner(created),
                                  validate=lambda p: True)
    (out, cmd), = created
    assert path == out and cmd[cmd.index("-f") + 1] == "best[height<=720]"
    os.unlink(path)


def test_download_video_is_refused_unless_the_reader_opens_it(tmp_path):
    """The default probe opens the download with the port's reader: an
    uncompressed I420 AVI passes, bytes it cannot open are deleted and
    refused."""
    created = []
    with pytest.raises(AcquisitionError, match="corrupted or in an unsupported format"):
        acquire.download_video("https://youtu.be/abc", runner=ytdlp_runner(created))
    assert not os.path.exists(created[0][0])
    avi = open(tiny_avi(str(tmp_path / "t.avi")), "rb").read()
    path = acquire.download_video("https://youtu.be/abc", runner=ytdlp_runner([], avi))
    assert open(path, "rb").read() == avi
    os.unlink(path)


def test_download_video_timeout_maps_to_504():
    def runner(cmd, timeout):
        raise subprocess.TimeoutExpired(cmd, timeout)

    with pytest.raises(AcquisitionError) as exc:
        acquire.download_video("https://youtu.be/abc", runner=runner)
    assert exc.value.status == 504


def test_download_unsupported_url_is_400():
    with pytest.raises(AcquisitionError) as exc:
        acquire.download_audio("https://example.com/v", runner=ytdlp_runner([]))
    assert exc.value.status == 400


def test_download_combined_audio_failure_degrades():
    dl = acquire.download_combined("https://youtu.be/abc",
                                   runner=ytdlp_runner([], fail_audio=True))
    assert dl.video_path and os.path.exists(dl.video_path) and dl.audio_path is None
    os.unlink(dl.video_path)


def test_download_audio_format_fallback():
    created = []
    path = acquire.download_audio("https://youtu.be/abc", "weird", runner=ytdlp_runner(created))
    assert created[0][1][created[0][1].index("--audio-format") + 1] == "mp3"
    assert path.endswith(".mp3")
    os.unlink(path)


def test_get_available_formats_with_fake_runner():
    def runner(cmd, timeout):
        assert cmd[:2] == ["yt-dlp", "--dump-json"]
        return subprocess.CompletedProcess(
            cmd, 0, stdout=json.dumps({"formats": [{"format_id": "f1"}]}), stderr="")

    assert get_available_formats("https://youtu.be/x", runner=runner) == [{"format_id": "f1"}]

    def bad_runner(cmd, timeout):
        raise subprocess.TimeoutExpired(cmd, timeout)

    assert get_available_formats("https://youtu.be/x", runner=bad_runner) == []


# ---- without httpx -----------------------------------------------------------------------------


def test_server_serves_video_without_httpx(tmp_path):
    """In a fresh process where ``import httpx`` fails, the app imports and
    ``/analyze-video`` answers over a socket; only a fact-check call reaches
    for httpx (and then fails inside its handler)."""
    path = tiny_avi(str(tmp_path / "in.avi"))
    script = f"""
import json, sys, urllib.request
from truely_tpu_torch.serve.app import TruelyServer
assert "httpx" not in sys.modules and "truely_tpu_torch.agents" not in sys.modules
sys.modules["httpx"] = None
import torch
torch.set_num_threads(2)
from truely_tpu_torch.config import DetectorConfig
from truely_tpu_torch.pipeline.detector import Detector
from truely_tpu_torch.serve.http import make_server, serve_forever_in_thread
from truely_tpu_torch.serve.results import ResultStore
det = Detector(DetectorConfig(frame_batch=4, compute_dtype="float32"), device="cpu")
srv = TruelyServer(detector=det, store=ResultStore())
httpd = make_server(srv.router, "127.0.0.1", 0)
serve_forever_in_thread(httpd)
url = f"http://127.0.0.1:{{httpd.server_address[1]}}/analyze-video"
req = urllib.request.Request(url, data=json.dumps({{"videoPath": {path!r}}}).encode(),
                             method="POST")
with urllib.request.urlopen(req) as r:
    print(json.dumps({{"status": r.status, **json.loads(r.read())}}))
try:
    srv.agents.transcribe_audio({path!r})
except ImportError:
    print("agents need httpx")
httpd.shutdown()
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    payload = json.loads(lines[0])
    assert payload["status"] == 200 and payload["fakeScore"] == 0 and "resultId" in payload
    assert lines[1] == "agents need httpx"
