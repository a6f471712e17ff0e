"""Minimal threaded HTTP framework (stdlib-only), copied from
``truely_tpu/serve/http.py``.

The reference serves through FastAPI/uvicorn — neither is in this image, and
an asyncio loop would anyway be the wrong shape here: the reference calls the
blocking analysis inside async handlers, stalling its event loop for the
whole video (server/server.py:611, SURVEY.md §2.3).  A thread-per-request
server with an explicit device lock keeps the API responsive while one
analysis owns the card.

File responses stream from disk in fixed-size chunks and honor ``Range``
headers with 206/416 semantics (reference behavior: FastAPI ``FileResponse``
at server/server.py:138-150 streams and supports Range), so the report
page's <video> player can seek and large videos never cost full-file RAM.
POST bodies are capped (413 beyond ``MAX_BODY_BYTES``) and concurrent
request threads are bounded (accepts back-pressure at ``MAX_THREADS``).
"""

from __future__ import annotations

import json
import logging
import mimetypes
import os
import re
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

logger = logging.getLogger(__name__)

CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Credentials": "true",
    "Access-Control-Allow-Methods": "*",
    "Access-Control-Allow-Headers": "*",
}

# JSON control-plane bodies are tiny; anything bigger is abuse.
MAX_BODY_BYTES = 16 * 1024 * 1024
# Upper bound on concurrent request handler threads.
MAX_THREADS = 64
# Streaming chunk size for file responses.
FILE_CHUNK_BYTES = 256 * 1024


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str]
    body: bytes = b""
    path_params: Dict[str, str] = field(default_factory=dict)
    headers: Dict[str, str] = field(default_factory=dict)  # lower-cased keys

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))


@dataclass
class Response:
    status: int = 200
    content: bytes = b""
    content_type: str = "application/json"
    headers: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def json(cls, payload: Any, status: int = 200) -> "Response":
        return cls(
            status=status,
            content=json.dumps(payload).encode("utf-8"),
            content_type="application/json",
        )

    @classmethod
    def html(cls, text: str, status: int = 200) -> "Response":
        return cls(status=status, content=text.encode("utf-8"),
                   content_type="text/html; charset=utf-8")

    @classmethod
    def error(cls, detail_or_payload, status: int) -> "Response":
        if isinstance(detail_or_payload, str):
            payload = {"detail": detail_or_payload}
        else:
            payload = detail_or_payload
        return cls.json(payload, status=status)

    # Streaming file response state (set by Response.file): when file_path
    # is set, `content` stays empty and the handler streams bytes
    # [file_offset, file_offset + file_length) from disk in chunks.
    file_path: Optional[str] = None
    file_offset: int = 0
    file_length: int = 0

    def body_bytes(self) -> bytes:
        """Materialize the full response body (streamed or inline)."""
        if self.file_path is None:
            return self.content
        with open(self.file_path, "rb") as f:
            f.seek(self.file_offset)
            return f.read(self.file_length)

    @classmethod
    def file(
        cls,
        path: str,
        media_type: Optional[str] = None,
        range_header: Optional[str] = None,
    ) -> "Response":
        """Streaming file response with HTTP Range support (206/416)."""
        if media_type is None:
            media_type = mimetypes.guess_type(path)[0] or "application/octet-stream"
        size = os.path.getsize(path)
        headers = {"Accept-Ranges": "bytes"}
        status, offset, length = 200, 0, size
        if range_header:
            parsed = parse_byte_range(range_header, size)
            if parsed is None:
                return cls(
                    status=416, content=b"", content_type=media_type,
                    headers={**headers, "Content-Range": f"bytes */{size}"},
                )
            offset, end = parsed
            length = end - offset + 1
            status = 206
            headers["Content-Range"] = f"bytes {offset}-{end}/{size}"
        return cls(
            status=status, content=b"", content_type=media_type,
            headers=headers, file_path=path, file_offset=offset,
            file_length=length,
        )


def parse_byte_range(header: str, size: int) -> Optional[Tuple[int, int]]:
    """Parse a single-range ``bytes=`` header into inclusive (start, end),
    or None when unsatisfiable.  Multi-range requests take the first range
    (the <video> element only ever sends one)."""
    m = re.match(r"bytes=(\d*)-(\d*)", header.strip())
    if not m or size == 0:
        return None
    start_s, end_s = m.group(1), m.group(2)
    if start_s == "" and end_s == "":
        return None
    if start_s == "":  # suffix range: last N bytes
        n = int(end_s)
        if n == 0:
            return None
        return max(size - n, 0), size - 1
    start = int(start_s)
    if start >= size:
        return None
    end = min(int(end_s), size - 1) if end_s else size - 1
    if end < start:
        return None
    return start, end


Handler = Callable[[Request], Response]


class Router:
    """Tiny pattern router: "/view/{result_id}" style path params."""

    def __init__(self):
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
        self._routes.append((method.upper(), re.compile(f"^{regex}$"), handler))

    def route(self, method: str, path: str) -> Optional[Tuple[Handler, Dict[str, str]]]:
        for m, regex, handler in self._routes:
            if m != method.upper():
                continue
            match = regex.match(path)
            if match:
                return handler, match.groupdict()
        return None

    def dispatch(self, request: Request) -> Response:
        found = self.route(request.method, request.path)
        if found is None:
            return Response.error("Not Found", 404)
        handler, params = found
        request.path_params = params
        try:
            return handler(request)
        except Exception as e:  # uniform 500s, like the reference's handlers
            logger.exception("handler error on %s %s", request.method, request.path)
            return Response.error(f"Internal server error: {e}", 500)


class _HTTPHandler(BaseHTTPRequestHandler):
    router: Router = None  # set by make_server
    protocol_version = "HTTP/1.1"

    def _respond(self, resp: Response) -> None:
        body_len = resp.file_length if resp.file_path else len(resp.content)
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(body_len))
        for k, v in {**CORS_HEADERS, **resp.headers}.items():
            self.send_header(k, v)
        self.end_headers()
        if resp.file_path:
            try:
                with open(resp.file_path, "rb") as f:
                    f.seek(resp.file_offset)
                    remaining = resp.file_length
                    while remaining > 0:
                        chunk = f.read(min(FILE_CHUNK_BYTES, remaining))
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                        remaining -= len(chunk)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client hung up mid-stream (seek, tab close)
            except OSError as e:
                # File vanished between Response.file() and streaming (the
                # TTL sweep deletes expired videos).  Headers are already
                # out, so the only honest move is to drop the connection —
                # but the handler thread must survive for the next request.
                logger.warning("file stream failed for %s: %s",
                               resp.file_path, e)
                self.close_connection = True
        else:
            try:
                self.wfile.write(resp.content)
            except (BrokenPipeError, ConnectionResetError):
                pass

    def _handle(self, method: str) -> None:
        parsed = urlparse(self.path)
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        try:
            # max(0, ...): a negative Content-Length would make
            # rfile.read(-N) read to EOF — blocking the handler thread
            # (and its semaphore slot) until the client disconnects.
            length = max(0, int(self.headers.get("Content-Length") or 0))
        except ValueError:
            length = 0
        if length > MAX_BODY_BYTES:
            self._respond(Response.error("Request body too large", 413))
            self.close_connection = True
            return
        body = self.rfile.read(length) if length else b""
        headers = {k.lower(): v for k, v in self.headers.items()}
        request = Request(method=method, path=parsed.path, query=query,
                          body=body, headers=headers)
        self._respond(self.router.dispatch(request))

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_OPTIONS(self):
        self._respond(Response(status=204, content=b"", content_type="text/plain"))

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.info("%s - %s", self.address_string(), fmt % args)


class BoundedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a cap on concurrent handler threads: the
    accept loop blocks once MAX_THREADS requests are in flight (back-pressure
    instead of unbounded thread growth)."""

    max_threads = MAX_THREADS

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._slots = threading.BoundedSemaphore(self.max_threads)

    def process_request(self, request, client_address):
        self._slots.acquire()
        try:
            super().process_request(request, client_address)
        except Exception:
            self._slots.release()
            raise

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._slots.release()


def make_server(router: Router, host: str, port: int) -> ThreadingHTTPServer:
    handler_cls = type("BoundHTTPHandler", (_HTTPHandler,), {"router": router})
    return BoundedThreadingHTTPServer((host, port), handler_cls)


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread
