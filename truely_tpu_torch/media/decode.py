"""Host-side video decode into fixed-size sampled-frame batches (counterpart
of ``truely_tpu/media/decode.py``).

Decode runs on a background thread that stays ahead of the device, and
yields *segments*: the frames of a stretch of the video (for the annotated
re-encode) and a padded batch of its sampled frames, ready for one device
step.

The file's header chooses the decoder.  An uncompressed I420 AVI goes
through ``rawavi`` on every machine: with ``yuv=True`` the sampled frames
are packed I420, read straight into the staging batch and converted on the
device (kernel K1), and unsampled frames are never read unless the caller
wants host frames; with ``yuv=False`` every frame is converted to BGR on
the host (``native.i420_to_bgr_host``, byte-identical to cv2's decode).
Any other file goes through cv2, to BGR, and needs cv2: without it only
the I420 AVI can be read.  Once ``rawavi`` has taken a file, a parse error
raises; nothing is retried through cv2.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from truely_tpu_torch.media import native, rawavi

try:
    import cv2
except ImportError:  # rawavi files only
    cv2 = None


@dataclass(frozen=True)
class VideoMeta:
    width: int
    height: int
    fps: int           # int(frames per second): the reference truncates
    fps_exact: float
    frame_count: int   # the container's count; the frames read decide


@dataclass
class Segment:
    """A contiguous stretch of the video covering one device batch."""

    frames: List[np.ndarray]        # the stretch's frames in order: BGR/RGB
                                    # HWC uint8, or packed I420 (H*3//2, W)
                                    # when ``frames_i420``; empty in YUV mode
                                    # without host frames
    frame_indices: List[int]        # global indices of the stretch's frames
    sampled: np.ndarray             # (B, H, W, 3) uint8 padded, or packed
                                    # I420 (B, H*3//2, W) in YUV mode
    sampled_indices: List[int]      # global indices of the valid sampled rows
    n_valid: int                    # valid rows of ``sampled``
    n_frames: int = 0               # frames covered
    frames_i420: bool = False       # ``frames`` holds packed I420 pictures


class VideoReader:
    """Iterates decode segments with background prefetch.

    ``yuv=True`` asks for packed-I420 segments, which only the ``rawavi``
    decoder gives (``yuv_active``); ``host_frames=True`` then also carries
    the packed picture of every frame of a segment (``frames_i420``), so
    that a writer can re-encode the frames it does not draw on without a
    colour conversion.  Otherwise, and for every file cv2 decodes, segments
    carry BGR frames (RGB with ``rgb=True``)."""

    def __init__(self, path: str, *, rgb: bool = False, prefetch: int = 2,
                 yuv: bool = False, host_frames: bool = False):
        self._rgb = rgb
        self._prefetch = prefetch
        self._active_stop: Optional[threading.Event] = None
        self._active_thread: Optional[threading.Thread] = None
        self._avi: Optional[rawavi.RawAviReader] = None
        self._cap = None
        try:
            self._avi = rawavi.RawAviReader(path)
        except rawavi.NotEligible as e:
            if cv2 is None:
                raise IOError(f"{e}; decoding it needs cv2, which is not installed (without "
                              "it only uncompressed I420 AVI files are read)") from None
        if self._avi is not None:
            info = self._avi.info
            self.meta = VideoMeta(width=info.width, height=info.height,
                                  fps=int(info.rate / info.scale),
                                  fps_exact=info.rate / info.scale,
                                  frame_count=self._avi.frame_count)
        else:
            self._cap = cv2.VideoCapture(path)
            if not self._cap.isOpened():
                raise IOError(f"could not open video: {path}")
            self.meta = VideoMeta(
                width=int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                height=int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                fps=int(self._cap.get(cv2.CAP_PROP_FPS)),
                fps_exact=float(self._cap.get(cv2.CAP_PROP_FPS)),
                frame_count=int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            )
        if self.meta.width <= 0 or self.meta.height <= 0 or self.meta.fps <= 0:
            self._release()
            raise IOError(f"invalid video properties: width={self.meta.width} "
                          f"height={self.meta.height} fps={self.meta.fps}")
        self.yuv_active = yuv and self._avi is not None
        self._host_frames = host_frames and self.yuv_active

    def _release(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None
        if self._avi is not None:
            self._avi.close()
            self._avi = None

    def close(self) -> None:
        # Stop an in-flight prefetch producer BEFORE releasing the decoder:
        # neither cv2.VideoCapture nor a closed file descriptor is safe
        # against a producer that is still reading.
        stop, t = self._active_stop, self._active_thread
        if stop is not None:
            stop.set()
        if t is not None and t.is_alive():
            t.join(timeout=10.0)
            if t.is_alive():
                # Still blocked in a read: leak the decoder rather than
                # release it under a live reader (the daemon thread and
                # process exit bound it).
                logging.getLogger(__name__).warning(
                    "decode producer did not exit within 10s; leaking the decoder rather "
                    "than releasing it under a live reader")
                return
        self._release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------

    def frames(self) -> Iterator[Tuple[int, np.ndarray]]:
        """Iterate (frame_index, BGR or RGB frame) pairs to EOF."""
        if self._avi is not None:
            for k in range(self._avi.frame_count):
                yield k, native.i420_to_bgr_host(self._avi.read(k), rgb=self._rgb)
            return
        idx = 0
        while True:
            ret, frame = self._cap.read()
            if not ret:
                return
            if self._rgb:
                frame = frame[..., ::-1]
            yield idx, frame
            idx += 1

    def yuv_frames(self, sample_interval: int = 1) -> Iterator[Tuple[int, Optional[np.ndarray]]]:
        """Iterate (frame_index, packed I420) pairs to EOF (YUV mode only;
        packed is (H*3//2, W) uint8).  Frames whose index is not a multiple
        of ``sample_interval`` are not read and come as (index, None), so
        the caller keeps an honest frame count at no cost."""
        if not self.yuv_active:
            raise RuntimeError("yuv_frames() requires yuv_active")
        for k in range(self._avi.frame_count):
            yield k, (self._avi.read(k) if k % sample_interval == 0 else None)

    def segments(self, sample_interval: int, batch: int) -> Iterator[Segment]:
        """Yield segments of exactly ``batch`` sampled frames each (the last
        padded to ``batch``), decoded on a background thread so that host
        decode overlaps device compute.  Frames after the last sampled one
        join the last segment (the JAX reader gives them a segment of their
        own, with no sampled frame, on which the detector runs a device
        step for nothing)."""
        q: "queue.Queue[Optional[Segment]]" = queue.Queue(maxsize=self._prefetch)
        err: List[BaseException] = []
        stop = threading.Event()
        # A full segment, put once a later sampled frame shows it is not the
        # last one.
        held: List[Segment] = []

        def put(item) -> bool:
            """Bounded put that gives up once the consumer is gone, so a
            consumer that abandons the generator on an error path never
            leaves the producer blocked holding its frames."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def release() -> bool:
            return put(held.pop()) if held else True

        def finish(tail: Optional[Segment]) -> None:
            """At EOF: a tail without sampled frames joins the held segment."""
            if held:
                last = held.pop()
                if tail is not None:
                    last.frames += tail.frames
                    last.frame_indices += tail.frame_indices
                    last.n_frames += tail.n_frames
                put(last)
            elif tail is not None:
                put(tail)

        def yuv_producer():
            avi, host = self._avi, self._host_frames
            rows, w = self.meta.height * 3 // 2, self.meta.width
            try:
                stack = np.zeros((batch, rows, w), np.uint8)
                cur_frames: List[np.ndarray] = []
                cur_idx: List[int] = []
                sampled_idx: List[int] = []

                def take() -> Segment:
                    nonlocal stack
                    seg = Segment(frames=list(cur_frames), frame_indices=list(cur_idx),
                                  sampled=stack, sampled_indices=list(sampled_idx),
                                  n_valid=len(sampled_idx), n_frames=len(cur_idx),
                                  frames_i420=host)
                    # the Segment owns the buffer; stage a fresh one
                    stack = np.zeros((batch, rows, w), np.uint8)
                    cur_frames.clear()
                    cur_idx.clear()
                    sampled_idx.clear()
                    return seg

                for idx in range(avi.frame_count):
                    if stop.is_set():
                        return
                    if idx % sample_interval == 0:
                        if not release():
                            return
                        buf = stack[len(sampled_idx)]   # read straight into the batch
                        avi.read_into(idx, buf)
                        sampled_idx.append(idx)
                        if host:
                            cur_frames.append(buf)      # a view; the Segment keeps it
                    elif host:
                        cur_frames.append(avi.read(idx))
                    cur_idx.append(idx)
                    if len(sampled_idx) == batch:
                        held.append(take())
                finish(take() if cur_idx else None)
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                put(None)

        def producer():
            try:
                h, w = self.meta.height, self.meta.width
                cur_frames: List[np.ndarray] = []
                cur_idx: List[int] = []
                sampled: List[np.ndarray] = []
                sampled_idx: List[int] = []

                def take() -> Segment:
                    stack = np.zeros((batch, h, w, 3), np.uint8)
                    native.pack_frames(stack, sampled, list(range(len(sampled))))
                    seg = Segment(frames=list(cur_frames), frame_indices=list(cur_idx),
                                  sampled=stack, sampled_indices=list(sampled_idx),
                                  n_valid=len(sampled), n_frames=len(cur_frames))
                    cur_frames.clear()
                    cur_idx.clear()
                    sampled.clear()
                    sampled_idx.clear()
                    return seg

                for idx, frame in self.frames():
                    if stop.is_set():
                        return
                    if idx % sample_interval == 0 and not release():
                        return
                    cur_frames.append(frame)
                    cur_idx.append(idx)
                    if idx % sample_interval == 0:
                        sampled.append(frame)
                        sampled_idx.append(idx)
                        if len(sampled) == batch:
                            held.append(take())
                finish(take() if cur_idx else None)
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                put(None)

        t = threading.Thread(target=yuv_producer if self.yuv_active else producer, daemon=True)
        self._active_stop, self._active_thread = stop, t
        t.start()
        try:
            while True:
                try:
                    seg = q.get(timeout=0.5)
                except queue.Empty:
                    if not t.is_alive():
                        # The producer may have put its last segment and
                        # the sentinel between the timeout and this check:
                        # drain before concluding EOF.
                        while True:
                            try:
                                seg = q.get_nowait()
                            except queue.Empty:
                                break
                            if seg is None:
                                break
                            yield seg
                        break
                    continue
                if seg is None:
                    break
                yield seg
            t.join()
            if err:
                raise err[0]
        finally:
            # Finished, or closed early by the consumer: retire the
            # producer before the decoder can be released under it.
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.05)
            self._active_stop = self._active_thread = None
