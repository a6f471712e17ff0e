"""Async analysis jobs (copied from ``truely_tpu/serve/jobs.py``).

The reference's ``/analyze-*`` handlers block the HTTP request for the whole
analysis (minutes on its CPU path — SURVEY.md §2.3 even notes it stalls the
event loop).  The synchronous endpoints are kept for contract parity; this
adds an additive async surface:

    POST /jobs/analyze-video    {videoPath}            -> {jobId}
    POST /jobs/analyze-combined {videoPath, audioPath} -> {jobId}
    GET  /jobs/{job_id}         -> {status, ...result when done}

Jobs run on a single worker thread (the device is serialized anyway) and
results land in the same TTL store the synchronous path uses, so /view,
/video, /audio work identically on completed jobs.

Group batching: jobs submitted with a ``batch_key`` (e.g. the video's
resolution bucket) are dequeued TOGETHER with every other queued job of the
same kind+key and handed to the kind's registered group runner — the server
routes same-bucket analyze-video groups through the StreamScheduler so N
concurrent submissions share device batches instead of serializing N full
analyses on the detector lock (the reference runs strictly one at a time,
server/server.py:611).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclass
class Job:
    job_id: str
    kind: str
    status: str = "queued"        # queued | running | done | failed
    created_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    batch_key: Optional[Tuple] = None
    payload: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "jobId": self.job_id,
            "kind": self.kind,
            "status": self.status,
            "createdAt": self.created_at,
        }
        if self.started_at is not None:
            payload["startedAt"] = self.started_at
        if self.finished_at is not None:
            payload["finishedAt"] = self.finished_at
        if self.status == "done" and self.result is not None:
            payload.update(self.result)
        if self.status == "failed":
            payload["error"] = self.error
        return payload


class JobRunner:
    """Single-worker job queue (device access is serialized regardless),
    with optional same-bucket group dequeue (see module docstring)."""

    def __init__(self, ttl_seconds: float = 3600.0):
        self._jobs: Dict[str, Job] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: "collections.deque[str]" = collections.deque()
        self._fns: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._group_runners: Dict[str, Callable[[List[Job]], Dict[str, Dict[str, Any]]]] = {}
        self._ttl = ttl_seconds
        self._worker: Optional[threading.Thread] = None

    def register_group_runner(
        self, kind: str,
        fn: Callable[[List[Job]], Dict[str, Dict[str, Any]]],
    ) -> None:
        """``fn(jobs) -> {job_id: result}`` for a group of same-batch_key
        jobs of ``kind``; a missing job_id in the result marks that job
        failed.  An exception fails the whole group."""
        self._group_runners[kind] = fn

    def _ensure_worker(self) -> None:
        # Under the lock: two concurrent submits could otherwise both see a
        # missing worker and start two, breaking the single-worker queue
        # contract (device serialization would still hold downstream).
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._loop, daemon=True
                )
                self._worker.start()

    def submit(
        self,
        kind: str,
        fn: Callable[[], Dict[str, Any]],
        *,
        batch_key: Optional[Tuple] = None,
        payload: Optional[Dict[str, Any]] = None,
    ) -> Job:
        job = Job(
            job_id=str(uuid.uuid4()), kind=kind,
            batch_key=batch_key, payload=payload,
        )
        with self._cond:
            self._jobs[job.job_id] = job
            self._fns[job.job_id] = fn
            self._pending.append(job.job_id)
            self._cond.notify()
        self._ensure_worker()
        return job

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            self._sweep_locked()
            return self._jobs.get(job_id)

    def _sweep_locked(self) -> None:
        now = time.time()
        dead = [
            jid for jid, j in self._jobs.items()
            if j.finished_at and now - j.finished_at > self._ttl
        ]
        for jid in dead:
            self._jobs.pop(jid, None)
            self._fns.pop(jid, None)

    def _take_group_locked(self) -> List[Job]:
        """Pop the next job; when it is groupable, also pull every other
        queued job with the same kind+batch_key (FIFO order preserved for
        the rest of the queue)."""
        job_id = self._pending.popleft()
        job = self._jobs.get(job_id)
        if job is None:
            return []
        group = [job]
        if job.batch_key is not None and job.kind in self._group_runners:
            keep = collections.deque()
            while self._pending:
                jid = self._pending.popleft()
                other = self._jobs.get(jid)
                if (
                    other is not None
                    and other.kind == job.kind
                    and other.batch_key == job.batch_key
                ):
                    group.append(other)
                else:
                    keep.append(jid)
            self._pending = keep
        return group

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending:
                    self._cond.wait()
                group = self._take_group_locked()
                fns = {j.job_id: self._fns.pop(j.job_id, None) for j in group}
            if not group:
                continue
            now = time.time()
            for j in group:
                j.status = "running"
                j.started_at = now
            try:
                if len(group) > 1:
                    runner = self._group_runners[group[0].kind]
                    results = runner(group)
                    for j in group:
                        if j.job_id in results:
                            j.result = results[j.job_id]
                            j.status = "done"
                        else:
                            j.error = "analysis produced no result"
                            j.status = "failed"
                else:
                    j = group[0]
                    fn = fns[j.job_id]
                    if fn is None:
                        j.error = "job function missing"
                        j.status = "failed"
                    else:
                        j.result = fn()
                        j.status = "done"
            except Exception as e:
                logger.exception(
                    "job group %s failed", [j.job_id for j in group]
                )
                for j in group:
                    if j.status == "running":
                        j.error = str(e)
                        j.status = "failed"
            finally:
                done = time.time()
                for j in group:
                    j.finished_at = done

    def wait(self, job_id: str, timeout: float = 60.0) -> Optional[Job]:
        """Test helper: poll until the job leaves queued/running."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            job = self.get(job_id)
            if job is None or job.status in ("done", "failed"):
                return job
            time.sleep(0.02)
        return self.get(job_id)
