"""Host-side video encode of the annotated output (counterpart of
``truely_tpu/media/encode.py``).

An ``.avi`` path is written by ``rawavi`` on every machine: uncompressed
I420, whose frames the reader gives back byte for byte.  Any other path is
encoded as H.264 by the native writer (``media/videoenc.py``, libx264 of
the system libavcodec) where it is built, else by cv2's fourcc chain (avc1,
H264, then mp4v), which needs cv2.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from truely_tpu_torch.media import native, rawavi, videoenc

try:
    import cv2
except ImportError:  # .avi output, or the native writer, only
    cv2 = None

_CODEC_PREFERENCE: Sequence[str] = ("avc1", "H264", "mp4v")


def _rational_fps(fps: float):
    """Integer or NTSC-style (x/1001) frame rate, as the JAX writer takes
    it from cv2's float."""
    if abs(fps - round(fps)) < 1e-6:
        return int(round(fps)), 1
    return int(round(fps * 1001)), 1001


class VideoWriter:
    def __init__(self, path: str, fps: float, width: int, height: int, *,
                 preset: Optional[str] = None, crf: Optional[int] = None,
                 threads: Optional[int] = None, slices: Optional[int] = None):
        """``preset``/``crf``/``threads``/``slices`` tune the native x264
        writer (the others ignore them).  Defaults: ultrafast, crf 23, x264's
        own frame threads, no slices."""
        self.path = path
        self._avi: Optional[rawavi.RawAviWriter] = None
        self._native: Optional[videoenc.Handle] = None
        self._writer = None
        self.codec: Optional[str] = None
        if os.path.splitext(path)[1].lower() == ".avi":
            self._avi = rawavi.RawAviWriter(path, fps, width, height)
            self.codec = "I420"
            return
        native_error = None
        if videoenc.available() and width % 2 == 0 and height % 2 == 0 and float(fps) > 0:
            try:
                self._native = videoenc.open(
                    path, width, height, *_rational_fps(float(fps)), preset or "ultrafast",
                    23 if crf is None else int(crf), 0 if threads is None else int(threads),
                    0 if slices is None else int(slices))
                self.codec = "h264"
                return
            except (IOError, ValueError) as e:  # e.g. a libavcodec without libx264
                native_error = e
        if cv2 is None:
            why = f" (the native writer failed: {native_error})" if native_error else ""
            raise IOError(f"writing {path} needs cv2, which is not installed{why}; an .avi path "
                          "is written as uncompressed I420 without it")
        for codec in _CODEC_PREFERENCE:
            w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps, (width, height))
            if w.isOpened():
                self._writer = w
                self.codec = codec
                break
            w.release()
        if self._writer is None:
            raise IOError(f"no working video encoder for {path}")

    def write(self, frame: np.ndarray) -> None:
        """Encode one (H, W, 3) uint8 BGR frame."""
        if self._avi is not None:
            self._avi.write(frame)
        elif self._native is not None:
            videoenc.write(self._native, frame)
        else:
            self._writer.write(frame)

    def write_i420(self, packed: np.ndarray) -> None:
        """Encode one packed (H*3//2, W) uint8 I420 picture: stored as is in
        an AVI and copied into the native writer's frame (no colour
        conversion either way); converted to BGR for cv2, which takes no
        planar input."""
        if self._avi is not None:
            self._avi.write_i420(packed)
        elif self._native is not None:
            videoenc.write_i420(self._native, packed)
        else:
            self._writer.write(native.i420_to_bgr_host(packed))

    def close(self) -> None:
        if self._avi is not None:
            avi, self._avi = self._avi, None
            avi.close()
        if self._native is not None:
            handle, self._native = self._native, None
            videoenc.close(handle)
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        # The reference's empty-output check (server/server.py:618).
        if not exc[0] and (not os.path.exists(self.path) or os.path.getsize(self.path) == 0):
            raise IOError(f"encoder produced empty output: {self.path}")
