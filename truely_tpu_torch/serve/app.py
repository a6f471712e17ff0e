"""The Truely API application (counterpart of ``truely_tpu/serve/app.py``):
all nine public endpoints of the reference server (server/server.py) with
matching routes, JSON contracts, and status codes, wired to the port's
detector on the card and the fact-check agents.

Differences from the reference, by design (SURVEY.md §5):
- analysis runs behind a device lock on worker threads instead of blocking
  an asyncio loop;
- the result store is lock-protected (the reference races its cleanup
  thread against handlers);
- the detector/agents/acquisition are injectable for tests.

Differences from the JAX package's app: the detector is a required
argument, the port's ``Detector``, which ``python -m truely_tpu_torch
serve`` (cli.py; ``main`` here is that command) builds on CUDA before the
socket opens, so a machine without CUDA fails at start-up; a job's
resolution bucket is read from the port's ``VideoReader``; the annotated
output keeps its input's extension (``<stem>_output<ext>``: an ``.avi``
input gets a raw I420 ``.avi`` output, never its own path), and ``/video``
names its media type by that extension.  The agents (which need ``httpx``)
are imported only when a request reaches them, so every video endpoint
works without ``httpx``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import jinja2

from truely_tpu_torch.config import ServerConfig
from truely_tpu_torch.media import acquire
from truely_tpu_torch.media.decode import VideoReader
from truely_tpu_torch.serve.http import Request, Response, Router, make_server
from truely_tpu_torch.serve.jobs import JobRunner
from truely_tpu_torch.serve.results import ResultStore

logger = logging.getLogger(__name__)

VERDICT_SCORES = {"Authentic": 100, "Misleading": 50, "Fake": 0, "Uncertain": 25}

_TEMPLATES_DIR = os.path.join(os.path.dirname(__file__), "templates")
_STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")


class DefaultAgents:
    """Thin indirection over the agent clients so tests can substitute."""

    def transcribe_audio(self, path: str) -> str:
        from truely_tpu_torch.agents.transcribe import transcribe_audio

        return transcribe_audio(path)

    def generate_search_query(self, transcript: str, api_key: str) -> str:
        from truely_tpu_torch.agents.judge import generate_search_query

        return generate_search_query(transcript, api_key)

    def perform_search(self, query: str, api_key: str) -> List[Dict[str, Any]]:
        from truely_tpu_torch.agents.search import perform_search

        return perform_search(query, api_key)

    def judge_content(self, transcript, sources, api_key) -> Dict[str, Any]:
        from truely_tpu_torch.agents.judge import judge_content

        return judge_content(transcript, sources, api_key)


class TruelyServer:
    def __init__(
        self,
        config: Optional[ServerConfig] = None,
        *,
        detector,
        agents=None,
        store: Optional[ResultStore] = None,
        acquire_module=acquire,
        tavily_api_key: Optional[str] = None,
        gemini_api_key: Optional[str] = None,
    ):
        self.config = config or ServerConfig()
        self.detector = detector
        self._detector_lock = threading.Lock()
        self.agents = agents or DefaultAgents()
        self.store = store or ResultStore(
            ttl_seconds=self.config.result_ttl_seconds,
            sweep_period_seconds=self.config.cleanup_period_seconds,
            persist_path=self.config.result_store_path or None,
        )
        self.acquire = acquire_module
        self.tavily_api_key = (
            tavily_api_key
            if tavily_api_key is not None
            else os.environ.get("TAVILY_API_KEY", "")
        )
        self.gemini_api_key = (
            gemini_api_key
            if gemini_api_key is not None
            else os.environ.get("GEMINI_API_KEY", "")
        )
        self._jinja = jinja2.Environment(
            loader=jinja2.FileSystemLoader(_TEMPLATES_DIR), autoescape=True
        )
        self._metrics_lock = threading.Lock()
        self.metrics: Dict[str, Any] = {
            "started_at": time.time(),
            "analyses_total": 0,
            "analyses_failed": 0,
            "downloads_total": 0,
            "last_analysis_seconds": None,
            "analysis_seconds_total": 0.0,
        }
        # Rolling window of per-analysis wall times for the p50/p95
        # percentiles (BASELINE.md names p50 per-video analyze latency as a
        # north-star metric); bounded so /metrics stays O(1) memory.
        self._analysis_seconds: List[float] = []
        # Queue-wait vs run split for async jobs: under concurrency every
        # job in a group shares the group's run wall, so the combined
        # latency percentile measures queue policy as much as analysis
        # speed — these two windows keep the quantities separable
        # (job_wait_* = submit→dequeue, job_run_* = the shared group run).
        self._job_wait_seconds: List[float] = []
        self._job_run_seconds: List[float] = []
        # The synchronous analyses' split (the spans ``serve.lock_wait`` and
        # ``serve.analysis``): lock_wait_* = the wait for the detector lock,
        # analysis_run_* = the analysis that holds it; analysis_seconds_*
        # time the two together.
        self._lock_wait_seconds: List[float] = []
        self._analysis_run_seconds: List[float] = []
        self.jobs = JobRunner(ttl_seconds=self.config.result_ttl_seconds)
        self.jobs.register_group_runner(
            "analyze-video", self._run_analysis_group
        )
        self.router = self._build_router()
        self._warmed: list = []
        if self.config.warmup_resolutions:
            threading.Thread(
                target=self._warmup_worker, daemon=True,
                name="truely-warmup",
            ).start()

    def _warmup_worker(self) -> None:
        """Warm the configured resolution buckets (``Detector.warmup``,
        serialized with analyses via the detector lock) so the first
        request does not pay the kernels' build and the first steps."""
        warmed = set()
        for res in self.config.warmup_resolutions:
            try:
                h, w = map(int, str(res).lower().split("x"))
                if (h, w) not in warmed:
                    with self._detector_lock:
                        self.detector.warmup(h, w)
                    warmed.add((h, w))
                    logger.info("warmup: %dx%d bucket warm", h, w)
                # Record the REQUESTED spelling so clients can compare
                # done against requested verbatim (e.g. "1080X1920");
                # duplicate spellings of one bucket warm once but each
                # still lands in done.
                self._warmed.append(str(res))
            except Exception as e:  # noqa: BLE001 — warmup is best-effort
                logger.warning("warmup %r failed: %s", res, e)

    def _record_analysis(self, seconds: float, ok: bool) -> None:
        with self._metrics_lock:
            self.metrics["analyses_total"] += 1
            if not ok:
                self.metrics["analyses_failed"] += 1
            self.metrics["last_analysis_seconds"] = round(seconds, 3)
            self.metrics["analysis_seconds_total"] = round(
                self.metrics["analysis_seconds_total"] + seconds, 3
            )
            self._analysis_seconds.append(seconds)
            if len(self._analysis_seconds) > 1000:
                del self._analysis_seconds[:-1000]

    def _record_job_split(self, wait_s: float, run_s: float) -> None:
        with self._metrics_lock:
            self._job_wait_seconds.append(max(0.0, wait_s))
            self._job_run_seconds.append(run_s)
            if len(self._job_wait_seconds) > 1000:
                del self._job_wait_seconds[:-1000]
                del self._job_run_seconds[:-1000]

    def _record_lock_split(self, wait_s: float, run_s: float) -> None:
        with self._metrics_lock:
            self._lock_wait_seconds.append(wait_s)
            self._analysis_run_seconds.append(run_s)
            if len(self._lock_wait_seconds) > 1000:
                del self._lock_wait_seconds[:-1000]
                del self._analysis_run_seconds[:-1000]

    @staticmethod
    def _percentile(sorted_vals: List[float], q: float) -> float:
        """Nearest-rank percentile of an already-sorted list."""
        if not sorted_vals:
            return 0.0
        idx = min(
            len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))),
        )
        return round(sorted_vals[idx], 3)

    # ------------------------------------------------------------------

    def _weights_pretrained(self) -> bool:
        return bool(getattr(self.detector, "facenet_pretrained", False))

    def _classifying(self) -> bool:
        """The detector runs the DFDC classifier (multi-face with
        ``DetectorConfig.classifier`` set)."""
        cfg = getattr(self.detector, "config", None)
        return (bool(getattr(cfg, "multi_face", False))
                and getattr(cfg, "classifier", None) is not None)

    def _run_analysis(self, video_path: str, output_path: str) -> Tuple[int, Optional[float]]:
        """Serialized access to the device for the visual pipeline: the
        spans ``serve.lock_wait`` (the wait for the detector lock) and
        ``serve.analysis`` (``detector.run``).  Returns the score and, where
        the detector classifies, the classifier's score (else None)."""
        # Imported at the first analysis, as the agents are at theirs: the
        # recorder imports torch, which the app itself does not.
        from truely_tpu_torch.utils.profiling import StageTimer

        timer = StageTimer()
        t0 = time.time()
        ok = locked = False
        try:
            with timer.stage("serve.lock_wait"):
                locked = self._detector_lock.acquire()
            with timer.stage("serve.analysis"):
                if self._classifying():
                    scores = self.detector.run_classified(video_path, output_path)
                else:
                    scores = self.detector.run(video_path, output_path), None
            ok = True
            return scores
        finally:
            if locked:
                self._detector_lock.release()
                self._record_lock_split(timer.totals["serve.lock_wait"],
                                        timer.totals["serve.analysis"])
            self._record_analysis(time.time() - t0, ok)

    def _run_analysis_group(self, jobs) -> Dict[str, Dict[str, Any]]:
        """Group runner for same-resolution /jobs/analyze-video batches:
        ONE StreamScheduler pass scores every video in shared device
        batches (decisions exactly equal each video's solo analysis —
        the scheduler's tested interleaving-exactness property), then the
        annotated outputs re-render host-side from the recorded events.
        N concurrent jobs no longer serialize N full analyses on the
        detector lock (the reference is strictly one-at-a-time,
        server/server.py:611)."""
        from truely_tpu_torch.pipeline.batch import analyze_videos_annotated

        paths = [j.payload["videoPath"] for j in jobs]
        outputs = [self._output_path_for(p) for p in paths]
        # Multi-face servers batch too: the scheduler's multi_face mode
        # gives each video the exact solo analyze_video_multiface
        # decisions (per-track scores, per-track annotation) while the
        # device sees shared batches (tests/test_serve.py).
        t0 = time.time()
        ok = False
        try:
            with self._detector_lock:
                results = analyze_videos_annotated(self.detector, paths, outputs)
            ok = True
        finally:
            dt = time.time() - t0
            for j in jobs:
                # combined window keeps its meaning (per-job latency ==
                # the group wall they waited through); the split windows
                # expose queue-wait vs the shared run separately so the
                # percentile that measures analysis SPEED is job_run_*.
                self._record_analysis(dt, ok)
                self._record_job_split(t0 - j.created_at, dt)
        out: Dict[str, Dict[str, Any]] = {}
        for j, r in zip(jobs, results):
            if (
                not os.path.exists(r.output_path)
                or os.path.getsize(r.output_path) == 0
            ):
                continue  # runner marks the missing job failed
            result_id = self.store.put(
                {"output_path": r.output_path, "fake_score": r.fake_score}
            )
            self._delete_input_later(j.payload["videoPath"])
            payload: Dict[str, Any] = {
                "fakeScore": r.fake_score, "resultId": result_id,
            }
            if r.track_scores is not None:
                payload["trackScores"] = r.track_scores
            out[j.job_id] = payload
        return out

    def _probe_bucket(self, path: str):
        """Resolution bucket of a local video, for job group batching
        (StreamScheduler requires one frame shape per group; fps may
        differ per video).  None = not readable -> job runs solo."""
        try:
            with VideoReader(path) as reader:
                return reader.meta.height, reader.meta.width
        except IOError:
            return None

    # ------------------------------------------------------------------

    def _build_router(self) -> Router:
        r = Router()
        r.add("GET", "/view/{result_id}", self.view_result)
        r.add("GET", "/video/{result_id}", self.get_video)
        r.add("GET", "/audio/{result_id}", self.get_audio)
        r.add("GET", "/download-video", self.download_video)
        r.add("GET", "/download-audio", self.download_audio)
        r.add("GET", "/download-combined", self.download_combined)
        r.add("POST", "/analyze-video", self.analyze_video)
        r.add("POST", "/analyze-audio", self.analyze_audio)
        r.add("POST", "/analyze-combined", self.analyze_combined)
        r.add("GET", "/static/{filename}", self.static_file)
        r.add("GET", "/health", self.health)
        r.add("GET", "/metrics", self.get_metrics)
        # Additive async surface (the sync endpoints above keep the
        # reference's blocking contract).
        r.add("POST", "/jobs/analyze-video", self.submit_analyze_video)
        r.add("POST", "/jobs/analyze-combined", self.submit_analyze_combined)
        r.add("GET", "/jobs/{job_id}", self.get_job)
        return r

    # ---- report / media ------------------------------------------------

    def view_result(self, req: Request) -> Response:
        result_id = req.path_params["result_id"]
        result = self.store.get(result_id)
        if result is None:
            return Response.error("Result not found or has expired", 404)
        verdict = result.get("verdict", "Uncertain")
        if isinstance(verdict, str):
            verdict = verdict.capitalize()
        data = {
            "fake_score": result.get("fake_score", "N/A"),
            "video_url": f"/video/{result_id}",
            "verdict": verdict,
            "news_score": result.get("news_score", "N/A"),
            "news_summary": result.get("news_summary", "No summary available"),
        }
        evidence = result.get("news_evidence") or []
        if evidence:
            data["news_evidence"] = [
                {"title": e.get("title", "Untitled"), "url": e.get("url", "#")}
                for e in evidence
            ]
        html = self._jinja.get_template("view_result.html").render(**data)
        return Response.html(html)

    def get_video(self, req: Request) -> Response:
        result = self.store.get(req.path_params["result_id"])
        if result is None:
            return Response.error("Video not found or has expired", 404)
        path = result.get("output_path")
        if not path or not os.path.exists(path):
            return Response.error("Video file not found", 404)
        media_type = "video/x-msvideo" if path.lower().endswith(".avi") else "video/mp4"
        return Response.file(path, media_type, range_header=req.headers.get("range"))

    def get_audio(self, req: Request) -> Response:
        result = self.store.get(req.path_params["result_id"])
        if result is None:
            return Response.error("Audio not found or has expired", 404)
        path = result.get("audio_path")
        if not path or not os.path.exists(path):
            return Response.error("Audio file not found", 404)
        ext = path.rsplit(".", 1)[-1].lower()
        media_type = "audio/mp4" if ext == "m4a" else f"audio/{ext}"
        return Response.file(path, media_type,
                             range_header=req.headers.get("range"))

    def static_file(self, req: Request) -> Response:
        name = os.path.basename(req.path_params["filename"])
        path = os.path.join(_STATIC_DIR, name)
        if not os.path.exists(path):
            return Response.error("Not Found", 404)
        return Response.file(path)

    def health(self, req: Request) -> Response:
        payload = {
            "status": "ok",
            "results": len(self.store),
            "weights_pretrained": self._weights_pretrained(),
        }
        if self.config.warmup_resolutions:
            payload["warmup"] = {
                "requested": [
                    str(r) for r in self.config.warmup_resolutions
                ],
                "done": list(self._warmed),
            }
        return Response.json(payload)

    def get_metrics(self, req: Request) -> Response:
        with self._metrics_lock:
            payload = dict(self.metrics)
            latencies = sorted(self._analysis_seconds)
            waits = sorted(self._job_wait_seconds)
            runs = sorted(self._job_run_seconds)
            lock_waits = sorted(self._lock_wait_seconds)
            analysis_runs = sorted(self._analysis_run_seconds)
        # analysis_seconds_* time a whole analysis request, its wait for the
        # detector lock included; for the synchronous /analyze-video
        # requests, lock_wait_* time that wait alone and analysis_run_* the
        # analysis after it.
        payload["analysis_seconds_p50"] = self._percentile(latencies, 0.50)
        payload["analysis_seconds_p95"] = self._percentile(latencies, 0.95)
        # Async-job split (grouped analyze-video jobs): wait = queue
        # policy, run = the shared device/render pass — so concurrency
        # inflates wait, never masquerades as slow analysis.
        payload["job_wait_seconds_p50"] = self._percentile(waits, 0.50)
        payload["job_wait_seconds_p95"] = self._percentile(waits, 0.95)
        payload["job_run_seconds_p50"] = self._percentile(runs, 0.50)
        payload["job_run_seconds_p95"] = self._percentile(runs, 0.95)
        payload["lock_wait_seconds_p50"] = self._percentile(lock_waits, 0.50)
        payload["lock_wait_seconds_p95"] = self._percentile(lock_waits, 0.95)
        payload["analysis_run_seconds_p50"] = self._percentile(analysis_runs, 0.50)
        payload["analysis_run_seconds_p95"] = self._percentile(analysis_runs, 0.95)
        payload["results_stored"] = len(self.store)
        payload["weights_pretrained"] = self._weights_pretrained()
        payload["uptime_seconds"] = round(time.time() - payload["started_at"], 1)
        return Response.json(payload)

    # ---- acquisition ----------------------------------------------------

    def download_video(self, req: Request) -> Response:
        video_url = req.query.get("video_url")
        quality = req.query.get("quality", self.config.default_quality)
        if not video_url:
            return Response.json({"error": "No video URL provided"}, 400)
        try:
            path = self.acquire.download_video(
                video_url, quality, timeout=self.config.video_download_timeout
            )
        except acquire.AcquisitionError as e:
            return Response.json({"error": str(e)}, e.status)
        with self._metrics_lock:
            self.metrics["downloads_total"] += 1
        return Response.json({"videoPath": path})

    def download_audio(self, req: Request) -> Response:
        video_url = req.query.get("video_url")
        audio_format = req.query.get("format", "mp3")
        if not video_url:
            return Response.json({"error": "No video URL provided"}, 400)
        try:
            path = self.acquire.download_audio(
                video_url, audio_format, timeout=self.config.audio_download_timeout
            )
        except acquire.AcquisitionError as e:
            return Response.json({"error": str(e)}, e.status)
        result_id = self.store.put({"audio_path": path})
        return Response.json({"audioPath": path, "resultId": result_id})

    def download_combined(self, req: Request) -> Response:
        video_url = req.query.get("video_url")
        audio_format = req.query.get("audio_format", "mp3")
        quality = req.query.get("quality", self.config.default_quality)
        if not video_url:
            return Response.json({"error": "No video URL provided"}, 400)
        try:
            dl = self.acquire.download_combined(
                video_url, audio_format, quality,
                video_timeout=self.config.video_download_timeout,
                audio_timeout=self.config.audio_download_timeout,
            )
        except acquire.AcquisitionError as e:
            return Response.json({"error": str(e)}, e.status)
        video_id = self.store.put({"output_path": dl.video_path})
        audio_id = (
            self.store.put({"audio_path": dl.audio_path}) if dl.audio_path else None
        )
        return Response.json(
            {
                "videoPath": dl.video_path,
                "videoId": video_id,
                "audioPath": dl.audio_path,
                "audioId": audio_id,
            }
        )

    # ---- analysis -------------------------------------------------------

    @staticmethod
    def _validate_media_path(path: Optional[str], kind: str) -> Optional[Response]:
        if not path:
            return Response.json({"error": f"Missing {kind} path"}, 400)
        if not os.path.exists(path):
            return Response.json(
                {"error": f"{kind.capitalize()} file not found at specified path"}, 400
            )
        if not os.path.isfile(path):
            return Response.json({"error": "Provided path is not a file"}, 400)
        if os.path.getsize(path) == 0:
            return Response.json({"error": f"{kind.capitalize()} file is empty"}, 400)
        return None

    @staticmethod
    def _managed_path(path: str) -> bool:
        """True iff ``path`` lives in the server's own media area (the temp
        dir where /download-* place files).  The reference deletes its
        input and writes the annotated output NEXT TO it
        (server/server.py) — safe for its own downloads, destructive for a
        caller-supplied path (an /analyze-video request pointed at a
        read-only fixture deleted it).  Both behaviors are gated on this."""
        import tempfile

        root = os.path.realpath(tempfile.gettempdir())
        return os.path.realpath(path).startswith(root + os.sep)

    def _output_path_for(self, video_path: str) -> str:
        """Reference behavior (next to the input) for managed inputs; the
        server's own media dir for everything else.  The output is
        ``<stem>_output<ext>`` (``.mp4`` for an input without an
        extension), so it never is the input itself: the JAX package's
        ``.replace(".mp4", ...)`` returns an ``.avi`` input's own path,
        and the detector would write over the file it reads."""
        stem, ext = os.path.splitext(video_path)
        ext = ext or ".mp4"
        if self._managed_path(video_path):
            return f"{stem}_output{ext}"
        import tempfile
        import uuid

        return os.path.join(
            tempfile.gettempdir(), f"analysis_{uuid.uuid4().hex}_output{ext}"
        )

    def _delete_input_later(self, path: str) -> None:
        if not self._managed_path(path):
            logger.info(
                "keeping caller-supplied input outside the media dir: %s",
                path,
            )
            return

        def task():
            try:
                if os.path.exists(path):
                    os.unlink(path)
                    logger.info("deleted input video: %s", path)
            except Exception as e:
                logger.error("failed to delete input video %s: %s", path, e)

        threading.Thread(target=task, daemon=True).start()

    def analyze_video(self, req: Request) -> Response:
        try:
            data = req.json() or {}
        except ValueError:
            return Response.json({"error": "Invalid JSON body"}, 400)
        video_path = data.get("videoPath")
        invalid = self._validate_media_path(video_path, "video")
        if invalid:
            return invalid
        output_path = self._output_path_for(video_path)
        try:
            fake_score, classifier_score = self._run_analysis(video_path, output_path)
        except Exception as e:
            return Response.json({"error": f"Failed to analyze video: {e}"}, 500)
        if not os.path.exists(output_path) or os.path.getsize(output_path) == 0:
            return Response.json(
                {"error": "Video analysis failed: No output video generated"}, 500
            )
        result_id = self.store.put(
            {"output_path": output_path, "fake_score": fake_score}
        )
        self._delete_input_later(video_path)
        payload = {"fakeScore": fake_score, "resultId": result_id}
        if classifier_score is not None:
            payload["classifierScore"] = classifier_score
        return Response.json(payload)

    def _news_analysis(self, audio_path: str, *, strict_keys: bool):
        """Shared fact-check flow.  ``strict_keys`` reproduces the contract
        split between /analyze-audio (503 on missing keys,
        server/server.py:698-707) and /analyze-combined (warning only,
        :880-885)."""
        news_score: Any = 0
        news_summary = "Could not analyze audio content"
        news_evidence: List[Dict[str, Any]] = []
        news_result: Dict[str, Any] = {}
        try:
            transcription = self.agents.transcribe_audio(audio_path)
            if not transcription:
                return None, news_score, "Could not transcribe audio content", news_evidence, news_result
            if strict_keys:
                if not self.gemini_api_key:
                    return (
                        Response.json({"error": "Gemini API key not configured"}, 503),
                        None, None, None, None,
                    )
                if not self.tavily_api_key:
                    return (
                        Response.json({"error": "Tavily API key not configured"}, 503),
                        None, None, None, None,
                    )
            else:
                if not self.gemini_api_key:
                    return None, news_score, (
                        "News analysis unavailable: Gemini API key not configured"
                    ), news_evidence, news_result
                if not self.tavily_api_key:
                    return None, news_score, (
                        "News analysis unavailable: Tavily API key not configured"
                    ), news_evidence, news_result
            try:
                query = self.agents.generate_search_query(
                    transcription, self.gemini_api_key
                )
            except Exception as e:
                logger.warning("search-query generation failed: %s", e)
                query = ""
            if not query:
                query = " ".join(transcription.split()[:30])[:350]
                logger.warning("using fallback search query: %s", query)
            results = self.agents.perform_search(query, self.tavily_api_key)
            if not results:
                news_result = {
                    "verdict": "Uncertain",
                    "confidence": 25,
                    "reasoning": "Could not find relevant information to verify content",
                    "sources": [],
                }
            else:
                try:
                    news_result = self.agents.judge_content(
                        transcription, results, self.gemini_api_key
                    )
                except Exception as e:
                    logger.error("credibility analysis failed: %s", e)
                    news_result = {
                        "verdict": "Uncertain",
                        "confidence": 0,
                        "reasoning": f"Analysis error: {str(e)[:100]}",
                        "sources": [],
                    }
            if "verdict" in news_result:
                verdict = news_result.get("verdict", "Uncertain")
                news_score = news_result.get(
                    "confidence", VERDICT_SCORES.get(verdict, 0)
                )
                news_summary = news_result.get("reasoning", "No reasoning provided")
                news_evidence = news_result.get("sources", [])
            else:
                news_score = news_result.get("score", 0)
                news_summary = news_result.get("summary", "No summary provided")
                news_evidence = news_result.get("evidence", [])
        except Exception as e:
            logger.error("audio processing failed: %s", e)
            news_summary = f"Audio analysis error: {e}"
        return None, news_score, news_summary, news_evidence, news_result

    def analyze_audio(self, req: Request) -> Response:
        try:
            data = req.json() or {}
        except ValueError:
            return Response.json({"error": "Invalid JSON body"}, 400)
        audio_path = data.get("audioPath")
        invalid = self._validate_media_path(audio_path, "audio")
        if invalid:
            return invalid
        early, news_score, news_summary, news_evidence, news_result = (
            self._news_analysis(audio_path, strict_keys=True)
        )
        if early is not None:
            return early
        result_id = self.store.put(
            {
                "audio_path": audio_path,
                "news_score": news_score,
                "news_summary": news_summary,
                "news_evidence": news_evidence,
                "verdict": news_result.get("verdict", "Uncertain"),
            }
        )
        response = {
            "newsScore": news_score,
            "newsSummary": news_summary,
            "resultId": result_id,
        }
        if news_result and "verdict" in news_result:
            response["verdict"] = news_result.get("verdict", "Uncertain")
            response["confidence"] = news_result.get("confidence", 0)
        if news_evidence:
            response["evidence"] = [
                {"title": s.get("title", ""), "url": s.get("url", "")}
                for s in news_evidence[:3]
            ]
        return Response.json(response)

    def analyze_combined(self, req: Request) -> Response:
        try:
            data = req.json() or {}
        except ValueError:
            return Response.json({"error": "Invalid JSON body"}, 400)
        video_path = data.get("videoPath")
        audio_path = data.get("audioPath")
        invalid = self._validate_media_path(video_path, "video")
        if invalid:
            return invalid
        if audio_path:
            invalid = self._validate_media_path(audio_path, "audio")
            if invalid:
                return invalid
        output_path = self._output_path_for(video_path)
        try:
            fake_score, _ = self._run_analysis(video_path, output_path)
        except Exception as e:
            return Response.json({"error": f"Video analysis failed: {e}"}, 500)
        if not os.path.exists(output_path) or os.path.getsize(output_path) == 0:
            return Response.json(
                {"error": "Video analysis failed: No output video generated"}, 500
            )
        news_score: Any = 0
        news_summary = "Could not analyze audio content"
        news_evidence: List[Dict[str, Any]] = []
        news_result: Dict[str, Any] = {}
        if audio_path:
            _, news_score, news_summary, news_evidence, news_result = (
                self._news_analysis(audio_path, strict_keys=False)
            )
        else:
            news_summary = "No audio content provided for analysis"
        result_id = self.store.put(
            {
                "output_path": output_path,
                "audio_path": audio_path
                if audio_path and os.path.exists(audio_path)
                else None,
                "fake_score": fake_score,
                "news_score": news_score,
                "news_summary": news_summary,
                "news_evidence": news_evidence,
                "verdict": news_result.get("verdict", "Uncertain"),
            }
        )
        self._delete_input_later(video_path)
        response = {
            "fakeScore": fake_score,
            "newsScore": news_score,
            "newsSummary": news_summary,
            "resultId": result_id,
        }
        if news_result and "verdict" in news_result:
            response["verdict"] = news_result.get("verdict", "Uncertain")
            response["confidence"] = news_result.get("confidence", 0)
        if news_evidence:
            response["evidence"] = [
                {"title": s.get("title", ""), "url": s.get("url", "")}
                for s in news_evidence[:3]
            ]
        return Response.json(response)

    # ---- async jobs -------------------------------------------------------

    def _submit_job(
        self, req: Request, kind: str, handler, *,
        batch_key=None, job_payload=None,
    ) -> Response:
        """Validate synchronously (4xx now), run the sync handler on the
        job worker, surface its JSON as the job result."""
        import json as _json

        try:
            data = req.json() or {}
        except ValueError:
            return Response.json({"error": "Invalid JSON body"}, 400)
        invalid = self._validate_media_path(data.get("videoPath"), "video")
        if invalid:
            return invalid

        def run_job():
            resp = handler(req)
            payload = _json.loads(resp.content)
            if resp.status != 200:
                raise RuntimeError(payload.get("error", f"HTTP {resp.status}"))
            return payload

        job = self.jobs.submit(
            kind, run_job, batch_key=batch_key, payload=job_payload
        )
        return Response.json({"jobId": job.job_id, "status": job.status}, 202)

    def submit_analyze_video(self, req: Request) -> Response:
        # Same-resolution jobs queued together share device batches via the
        # registered group runner; probe the bucket up front.
        batch_key = None
        payload = None
        try:
            vp = (req.json() or {}).get("videoPath")
            # The grouped runner's scheduler has no classifier: such jobs
            # run solo.
            if isinstance(vp, str) and os.path.isfile(vp) and not self._classifying():
                batch_key = self._probe_bucket(vp)
                payload = {"videoPath": vp}
        except ValueError:
            pass  # _submit_job reports the 400
        return self._submit_job(
            req, "analyze-video", self.analyze_video,
            batch_key=batch_key, job_payload=payload,
        )

    def submit_analyze_combined(self, req: Request) -> Response:
        return self._submit_job(req, "analyze-combined", self.analyze_combined)

    def get_job(self, req: Request) -> Response:
        job = self.jobs.get(req.path_params["job_id"])
        if job is None:
            return Response.error("Job not found or has expired", 404)
        return Response.json(job.to_json())

    # ------------------------------------------------------------------

    def serve(self):
        self.store.start_cleanup()
        server = make_server(self.router, self.config.host, self.config.port)
        logger.info("truely_tpu_torch server on %s:%d", self.config.host, self.config.port)
        try:
            server.serve_forever()
        finally:
            self.store.stop_cleanup()


def create_app(**kwargs) -> TruelyServer:
    """The server of ``kwargs`` (``TruelyServer``'s): how the CLI's
    ``serve`` builds it, as in the JAX package."""
    return TruelyServer(**kwargs)


def main(argv=None) -> int:
    """``python -m truely_tpu_torch serve`` with these arguments."""
    import sys

    from truely_tpu_torch import cli

    return cli.main(["serve", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
