"""Thread-safe analysis-result store with TTL cleanup (copied from
``truely_tpu/serve/results.py``).

The reference keeps results in a bare dict mutated by request handlers while
a daemon thread iterates and deletes from it with no lock (server/server.py:
81-108 — an actual data race, SURVEY.md §5), and loses everything on restart.
Same behavior here (1-hour TTL, 5-minute sweep, on-expiry file deletion) but
correctly synchronized, with an injectable clock for tests, and optionally
persisted to a JSON snapshot so unexpired results survive restarts.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

_FILE_KEYS = ("output_path", "audio_path")


class ResultStore:
    def __init__(
        self,
        ttl_seconds: float = 3600.0,
        sweep_period_seconds: float = 300.0,
        clock: Callable[[], float] = time.time,
        persist_path: Optional[str] = None,
    ):
        self._ttl = ttl_seconds
        self._period = sweep_period_seconds
        self._clock = clock
        self._lock = threading.Lock()
        self._data: Dict[str, Dict[str, Any]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._persist_path = persist_path
        if persist_path and os.path.exists(persist_path):
            try:
                with open(persist_path) as f:
                    snapshot = json.load(f)
                now = self._clock()
                self._data = {
                    rid: rec
                    for rid, rec in snapshot.items()
                    if now - rec.get("timestamp", 0) <= self._ttl
                }
                logger.info(
                    "restored %d unexpired results from %s",
                    len(self._data), persist_path,
                )
            except Exception as e:
                logger.error("failed to restore result store: %s", e)

    def _persist_locked(self) -> None:
        if not self._persist_path:
            return
        try:
            tmp = f"{self._persist_path}.tmp"
            with open(tmp, "w") as f:
                json.dump(self._data, f)
            os.replace(tmp, self._persist_path)
        except Exception as e:
            logger.error("failed to persist result store: %s", e)

    # ------------------------------------------------------------------

    def put(self, record: Dict[str, Any], result_id: Optional[str] = None) -> str:
        result_id = result_id or str(uuid.uuid4())
        record = dict(record)
        record.setdefault("timestamp", self._clock())
        with self._lock:
            self._data[result_id] = record
            self._persist_locked()
        return result_id

    def get(self, result_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._data.get(result_id)
            return dict(rec) if rec is not None else None

    def __contains__(self, result_id: str) -> bool:
        with self._lock:
            return result_id in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    # ------------------------------------------------------------------

    def sweep(self) -> int:
        """Remove expired records and their files; returns removal count."""
        now = self._clock()
        with self._lock:
            expired = [
                (rid, rec)
                for rid, rec in self._data.items()
                if now - rec.get("timestamp", 0) > self._ttl
            ]
            for rid, _ in expired:
                del self._data[rid]
            if expired:
                self._persist_locked()
        for rid, rec in expired:
            for key in _FILE_KEYS:
                path = rec.get(key)
                if path and os.path.exists(path):
                    try:
                        os.unlink(path)
                    except OSError as e:
                        logger.error("failed to delete %s for %s: %s", path, rid, e)
            logger.info("cleaned up result %s", rid)
        return len(expired)

    def start_cleanup(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self._period):
                try:
                    self.sweep()
                except Exception as e:  # never kill the sweeper
                    logger.error("result sweep failed: %s", e)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop_cleanup(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
