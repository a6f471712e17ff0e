"""Media acquisition from social platforms via yt-dlp (off the hot path),
copied from ``truely_tpu/media/acquire.py``.

Behavioral equivalent of the acquisition layer inlined in reference
server/server.py:169-235 and its download endpoints (:237-572): URL →
(platform, id) regexes for YouTube/Twitter-X/Facebook/Reddit, format probing
for platforms whose format filters yt-dlp can't express, "best height <=
target" selection with 360p default, and video/audio/combined downloads with
the reference's timeouts and graceful audio-failure degradation.

Everything here is host-side subprocess work; it is gated on the yt-dlp
binary being present and unit-tested through injectable runners.  A
downloaded video is accepted only if the port's own reader
(``media.decode.VideoReader``: ``rawavi`` for an uncompressed I420 AVI,
cv2 otherwise) can open it.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import subprocess
import tempfile
import time
import uuid
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger(__name__)

ALLOWED_AUDIO_FORMATS = ("mp3", "m4a", "wav", "aac", "flac", "opus")

_URL_PATTERNS = {
    "youtube": [
        r"(?:youtube\.com\/watch\?v=|youtu\.be\/|youtube\.com\/shorts\/)([^&\?\/]+)",
    ],
    "twitter": [r"(?:twitter\.com|x\.com)\/\w+\/status\/(\d+)"],
    "facebook": [
        r"facebook\.com\/(?:watch\/\?v=|watch\?v=|.+?\/videos\/)(\d+)",
        r"fb\.watch\/([^\/]+)",
        r"facebook\.com\/[^\/]+\/videos\/(\d+)",
    ],
    "reddit": [
        r"reddit\.com\/r\/[^\/]+\/comments\/([^\/]+)",
        r"redd\.it\/(\w+)",
    ],
}

# Platforms where yt-dlp format filters are unreliable; probe + pick manually
# (reference server/server.py:265-271).
_PROBE_PLATFORMS = ("facebook", "reddit")


class AcquisitionError(RuntimeError):
    def __init__(self, message: str, status: int = 500):
        super().__init__(message)
        self.status = status


def get_platform_and_video_id(url: str) -> Tuple[Optional[str], Optional[str]]:
    for platform, patterns in _URL_PATTERNS.items():
        for pattern in patterns:
            m = re.search(pattern, url)
            if m:
                return platform, m.group(1)
    return None, None


def parse_quality(quality: Optional[str], default: int = 360) -> int:
    if quality and quality.lower().endswith("p"):
        try:
            height = int(quality[:-1])
            if height > 0:
                return height
        except ValueError:
            logger.warning("invalid quality %r, using default %dp", quality, default)
    return default


Runner = Callable[..., "subprocess.CompletedProcess"]


def _default_runner(cmd, timeout):
    return subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=timeout)


def have_ytdlp() -> bool:
    return shutil.which("yt-dlp") is not None


def get_available_formats(url: str, *, runner: Runner = _default_runner,
                          timeout: float = 30.0) -> List[dict]:
    if not url:
        return []
    try:
        result = runner(["yt-dlp", "--dump-json", "--no-playlist", "--", url],
                        timeout)
        if not result.stdout:
            return []
        return json.loads(result.stdout).get("formats", [])
    except Exception as e:  # probe failures degrade to "no formats"
        logger.error("format probe failed for %s: %s", url, e)
        return []


def select_best_format(formats: List[dict], target_height: int = 360) -> Optional[str]:
    """Largest height <= target; smallest available if all exceed it."""
    candidates = [
        f for f in formats if f.get("height") and f.get("vcodec") != "none"
    ]
    if not candidates:
        return None
    candidates.sort(key=lambda f: f.get("height", 0))
    best = None
    for fmt in candidates:
        if fmt.get("height", 0) <= target_height:
            best = fmt
        else:
            break
    if best is None:
        best = candidates[0]
    return best.get("format_id")


def _format_option(platform: str, url: str, target_height: int,
                   runner: Runner) -> List[str]:
    if platform in _PROBE_PLATFORMS:
        format_id = select_best_format(get_available_formats(url, runner=runner),
                                       target_height)
        return ["-f", format_id] if format_id else ["-f", "best"]
    return ["-f", f"best[height<={target_height}]"]


def _check_output_file(path: str, kind: str) -> None:
    if not os.path.exists(path):
        raise AcquisitionError(f"Failed to download {kind}: File not created")
    if os.path.getsize(path) == 0:
        try:
            os.unlink(path)
        except OSError:
            pass
        raise AcquisitionError(f"Failed to download {kind}: Empty file created")


def download_video(
    video_url: str,
    quality: str = "360p",
    *,
    runner: Runner = _default_runner,
    timeout: float = 180.0,
    validate: Optional[Callable[[str], bool]] = None,
) -> str:
    """Download a video as mp4; returns the local path.

    ``validate`` probes decodability (the reference uses cv2.VideoCapture,
    server/server.py:310-321); defaults to opening the file with the
    port's ``VideoReader``.
    """
    platform, extracted_id = get_platform_and_video_id(video_url)
    if not platform or not extracted_id:
        raise AcquisitionError("Unsupported URL format", status=400)
    target_height = parse_quality(quality)
    path = os.path.join(
        tempfile.gettempdir(),
        f"truely_video_{extracted_id}_{int(time.time())}.mp4",
    )
    cmd = (
        ["yt-dlp", "--verbose", "--force-overwrites", "--no-cache-dir", "--no-continue"]
        + _format_option(platform, video_url, target_height, runner)
        + ["--merge-output-format", "mp4", "-o", path, "--", video_url]
    )
    try:
        runner(cmd, timeout)
    except subprocess.TimeoutExpired:
        raise AcquisitionError("Video download timed out", status=504)
    except subprocess.CalledProcessError as e:
        raise AcquisitionError(f"Failed to download video: {e.stderr or e}")
    _check_output_file(path, "video")

    if validate is None:
        validate = _decodable
    if not validate(path):
        try:
            os.unlink(path)
        except OSError:
            pass
        raise AcquisitionError(
            "Downloaded video is corrupted or in an unsupported format"
        )
    return path


def download_audio(
    video_url: str,
    audio_format: str = "mp3",
    *,
    runner: Runner = _default_runner,
    timeout: float = 120.0,
) -> str:
    platform, extracted_id = get_platform_and_video_id(video_url)
    if not platform or not extracted_id:
        raise AcquisitionError("Unsupported URL format", status=400)
    if audio_format not in ALLOWED_AUDIO_FORMATS:
        logger.warning("unsupported audio format %r, using mp3", audio_format)
        audio_format = "mp3"
    path = os.path.join(
        tempfile.gettempdir(),
        f"truely_audio_{extracted_id}_{int(time.time())}.{audio_format}",
    )
    cmd = [
        "yt-dlp", "--verbose", "--force-overwrites", "--no-cache-dir",
        "--no-continue", "-x", "--audio-format", audio_format,
        "--audio-quality", "0", "-o", path, "--", video_url,
    ]
    try:
        runner(cmd, timeout)
    except subprocess.TimeoutExpired:
        raise AcquisitionError("Audio download timed out", status=504)
    except subprocess.CalledProcessError as e:
        raise AcquisitionError(f"Failed to download audio: {e.stderr or e}")
    _check_output_file(path, "audio")
    return path


@dataclass
class CombinedDownload:
    video_path: str
    audio_path: Optional[str]


def download_combined(
    video_url: str,
    audio_format: str = "mp3",
    quality: str = "360p",
    *,
    runner: Runner = _default_runner,
    video_timeout: float = 180.0,
    audio_timeout: float = 120.0,
    validate: Optional[Callable[[str], bool]] = None,
) -> CombinedDownload:
    """Video + audio; audio failure degrades to video-only (reference
    server/server.py:523-541)."""
    platform, extracted_id = get_platform_and_video_id(video_url)
    if not platform or not extracted_id:
        raise AcquisitionError("Unsupported URL format", status=400)
    if audio_format not in ALLOWED_AUDIO_FORMATS:
        audio_format = "mp3"
    stamp = int(time.time())
    video_path = os.path.join(
        tempfile.gettempdir(),
        f"truely_video_{extracted_id}_{uuid.uuid4().hex[:8]}_{stamp}.mp4",
    )
    target_height = parse_quality(quality)
    cmd = (
        ["yt-dlp", "--verbose", "--force-overwrites", "--no-cache-dir", "--no-continue"]
        + _format_option(platform, video_url, target_height, runner)
        + ["--merge-output-format", "mp4", "-o", video_path, "--", video_url]
    )
    try:
        runner(cmd, video_timeout)
    except subprocess.TimeoutExpired:
        raise AcquisitionError("Video download timed out", status=504)
    except subprocess.CalledProcessError as e:
        raise AcquisitionError(f"Failed to download video: {e.stderr or e}")
    if not os.path.exists(video_path):
        raise AcquisitionError("Downloaded video file does not exist")
    if os.path.getsize(video_path) == 0:
        try:
            os.unlink(video_path)
        except OSError:
            pass
        raise AcquisitionError("Downloaded video file is empty")

    audio_path: Optional[str] = os.path.join(
        tempfile.gettempdir(),
        f"truely_audio_{extracted_id}_{uuid.uuid4().hex[:8]}_{stamp}.{audio_format}",
    )
    audio_cmd = [
        "yt-dlp", "--verbose", "--force-overwrites", "--no-cache-dir",
        "--no-continue", "-x", "--audio-format", audio_format,
        "--audio-quality", "0", "-o", audio_path, "--", video_url,
    ]
    try:
        runner(audio_cmd, audio_timeout)
    except (subprocess.TimeoutExpired, subprocess.CalledProcessError) as e:
        logger.warning("audio download failed (%s); proceeding video-only", e)
        audio_path = None
    if audio_path is not None:
        if not os.path.exists(audio_path):
            audio_path = None
        elif os.path.getsize(audio_path) == 0:
            try:
                os.unlink(audio_path)
            except OSError:
                pass
            audio_path = None
    return CombinedDownload(video_path=video_path, audio_path=audio_path)


def _decodable(path: str) -> bool:
    """Whether the port's reader can open ``path``."""
    from truely_tpu_torch.media.decode import VideoReader

    try:
        VideoReader(path).close()
    except IOError:
        return False
    return True
