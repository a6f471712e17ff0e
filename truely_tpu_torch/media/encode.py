"""Host-side video encode of the annotated output (counterpart of
``truely_tpu/media/encode.py``).

An ``.avi`` path is written by ``rawavi`` on every machine: uncompressed
I420, whose frames the reader gives back byte for byte.  Any other path
goes to cv2's fourcc chain (avc1, H264, then mp4v), and needs cv2.  The
JAX package's native x264 writer is not ported.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from truely_tpu_torch.media import native, rawavi

try:
    import cv2
except ImportError:  # .avi output only
    cv2 = None

_CODEC_PREFERENCE: Sequence[str] = ("avc1", "H264", "mp4v")


class VideoWriter:
    def __init__(self, path: str, fps: float, width: int, height: int):
        self.path = path
        self._avi: Optional[rawavi.RawAviWriter] = None
        self._writer = None
        self.codec: Optional[str] = None
        if os.path.splitext(path)[1].lower() == ".avi":
            self._avi = rawavi.RawAviWriter(path, fps, width, height)
            self.codec = "I420"
            return
        if cv2 is None:
            raise IOError(f"writing {path} needs cv2, which is not installed; an .avi path "
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
        else:
            self._writer.write(frame)

    def write_i420(self, packed: np.ndarray) -> None:
        """Encode one packed (H*3//2, W) uint8 I420 picture: stored as is in
        an AVI (no colour conversion either way); converted to BGR for
        cv2, which takes no planar input."""
        if self._avi is not None:
            self._avi.write_i420(packed)
        else:
            self._writer.write(native.i420_to_bgr_host(packed))

    def close(self) -> None:
        if self._avi is not None:
            avi, self._avi = self._avi, None
            avi.close()
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
