"""Host-side video decode into fixed-size sampled-frame batches (counterpart
of ``truely_tpu/media/decode.py``).

Decode runs on a background thread that stays ahead of the device, and
yields *segments*: the frames of a stretch of the video (for the annotated
re-encode) and a padded batch of its sampled frames, ready for one device
step.

Three decoders, chosen in this order (``VideoReader.decoder`` names the
one that runs):

- ``rawavi``: an uncompressed I420 AVI, on every machine;
- ``videodec``: with ``yuv=True``, any file libav reads whose stream is
  eligible for the exact conversion (8-bit yuv420p, W even, H % 4 == 0,
  untagged or BT.601 colour space, limited or untagged range), where the
  libav headers let ``media/videodec.py`` be built;
- cv2, to BGR, for everything else (needed for it).

With packed I420 (the first two, ``yuv=True``) the sampled frames are read
straight into the staging batch and converted on the device (kernel K1),
and unsampled frames are decoded without export (``videodec.skip``) or
not read at all (``rawavi``) unless the caller wants host frames.  BGR
frames of those two come from ``native.i420_to_bgr_host``, byte-identical
to cv2's decode.  The metadata comes from cv2 where it is installed, as in
the JAX package, else from the decoder.  Once ``rawavi`` has taken a file,
a parse error raises; nothing is retried through another decoder.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from truely_tpu_torch.media import native, rawavi, videodec

try:
    import cv2
except ImportError:  # rawavi, and videodec where it is built, only
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


# swscale tag values for which the exact conversion (K1, ``native``) is the
# one cv2 applies: untagged or BT.601-family colour space, limited ("tv") or
# untagged range.  Anything else (bt709 tags, full range) takes the cv2
# path, as in the JAX package.
_YUV_OK_SPACES = frozenset({"unknown", "bt470bg", "smpte170m"})
_YUV_OK_RANGES = frozenset({"unknown", "tv"})


def _probe_yuv(path: str, meta: Optional[VideoMeta]):
    """An open ``videodec`` handle of ``path`` and its metadata if the
    library is built and the stream is eligible for the exact conversion
    (``meta``, cv2's, must agree on the size), else None.  Raises only if
    the library fails to build where the libav headers are."""
    if not videodec.available():
        return None
    try:
        hnd, w, h, fps_num, fps_den, nb = videodec.open(path)
    except IOError:
        return None
    space, rng = videodec.colorinfo(hnd)
    if (videodec.pixfmt(hnd) == "yuv420p" and w % 2 == 0
            # H % 4, not just % 2: the packed (H*3//2, W) layout holds the
            # chroma planes in whole rows only when H/4 is integral.
            and h % 4 == 0 and space in _YUV_OK_SPACES and rng in _YUV_OK_RANGES
            and (meta is None or (w, h) == (meta.width, meta.height))
            and fps_num > 0 and fps_den > 0):
        return hnd, VideoMeta(width=w, height=h, fps=int(fps_num / fps_den),
                              fps_exact=fps_num / fps_den, frame_count=nb)
    videodec.close(hnd)
    return None


class VideoReader:
    """Iterates decode segments with background prefetch.

    ``yuv=True`` asks for packed-I420 segments, which the ``rawavi`` and
    ``videodec`` decoders give (``yuv_active``); ``host_frames=True`` then
    also carries the packed picture of every frame of a segment
    (``frames_i420``), so that a writer can re-encode the frames it does
    not draw on without a colour conversion.  Otherwise, and for every file
    cv2 decodes, segments carry BGR frames (RGB with ``rgb=True``)."""

    def __init__(self, path: str, *, rgb: bool = False, prefetch: int = 2,
                 yuv: bool = False, host_frames: bool = False):
        self._rgb = rgb
        self._prefetch = prefetch
        self._active_stop: Optional[threading.Event] = None
        self._active_thread: Optional[threading.Thread] = None
        self._avi: Optional[rawavi.RawAviReader] = None
        self._vd: Optional[videodec.Handle] = None
        self._cap = None
        try:
            self._avi = rawavi.RawAviReader(path)
        except rawavi.NotEligible as e:
            not_avi = e
        if self._avi is not None:
            info = self._avi.info
            self.decoder = "rawavi"
            self.meta = VideoMeta(width=info.width, height=info.height,
                                  fps=int(info.rate / info.scale),
                                  fps_exact=info.rate / info.scale,
                                  frame_count=self._avi.frame_count)
        else:
            meta = None
            if cv2 is not None:
                self._cap = cv2.VideoCapture(path)
                if not self._cap.isOpened():
                    self._cap.release()
                    raise IOError(f"could not open video: {path}")
                meta = VideoMeta(
                    width=int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                    height=int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                    fps=int(self._cap.get(cv2.CAP_PROP_FPS)),
                    fps_exact=float(self._cap.get(cv2.CAP_PROP_FPS)),
                    frame_count=int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                )
            probed = _probe_yuv(path, meta) if yuv else None
            if probed is not None:
                self._vd, vd_meta = probed
                self.decoder = "videodec"
                if self._cap is not None:   # cv2 gave the metadata; videodec decodes
                    self._cap.release()
                    self._cap = None
                self.meta = meta or vd_meta
            elif self._cap is None:
                raise IOError(f"{not_avi}; decoding it needs cv2, which is not installed "
                              "(without it only uncompressed I420 AVI files, and with yuv=True "
                              "the streams the native decoder takes, are read)")
            else:
                self.decoder = "cv2"
                self.meta = meta
        if self.meta.width <= 0 or self.meta.height <= 0 or self.meta.fps <= 0:
            self._release()
            raise IOError(f"invalid video properties: width={self.meta.width} "
                          f"height={self.meta.height} fps={self.meta.fps}")
        self.yuv_active = yuv and self.decoder != "cv2"
        self._host_frames = host_frames and self.yuv_active

    def _release(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None
        if self._avi is not None:
            self._avi.close()
            self._avi = None
        if self._vd is not None:
            vd, self._vd = self._vd, None
            videodec.close(vd)

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

    def _pictures(self):
        """(read(idx, buf) -> bool, skip(idx) -> bool) over the packed I420
        pictures in order, for ``rawavi`` (random access: an unsampled
        frame costs nothing) and ``videodec`` (decoded in sequence); each
        gives False at the end."""
        if self._avi is not None:
            avi = self._avi

            def read(idx: int, buf: np.ndarray) -> bool:
                if idx >= avi.frame_count:
                    return False
                avi.read_into(idx, buf)
                return True

            return read, lambda idx: idx < avi.frame_count
        vd = self._vd
        return (lambda idx, buf: videodec.read(vd, buf)), (lambda idx: videodec.skip(vd))

    def frames(self) -> Iterator[Tuple[int, np.ndarray]]:
        """Iterate (frame_index, BGR or RGB frame) pairs to EOF."""
        if self._cap is None:
            read, _ = self._pictures()
            rows, w = self.meta.height * 3 // 2, self.meta.width
            for idx in itertools.count():
                buf = np.empty((rows, w), np.uint8)
                if not read(idx, buf):
                    return
                yield idx, native.i420_to_bgr_host(buf, rgb=self._rgb)
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
        of ``sample_interval`` are skipped without export and come as
        (index, None), so the caller keeps an honest frame count."""
        if not self.yuv_active:
            raise RuntimeError("yuv_frames() requires yuv_active")
        read, skip = self._pictures()
        rows, w = self.meta.height * 3 // 2, self.meta.width
        for idx in itertools.count():
            if idx % sample_interval == 0:
                buf = np.empty((rows, w), np.uint8)
                if not read(idx, buf):
                    return
                yield idx, buf
            elif not skip(idx):
                return
            else:
                yield idx, None

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
            read, skip = self._pictures()
            host = self._host_frames
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

                for idx in itertools.count():
                    if stop.is_set():
                        return
                    if idx % sample_interval == 0:
                        buf = stack[len(sampled_idx)]   # read straight into the batch
                        if not read(idx, buf):
                            break
                        if not release():
                            return
                        sampled_idx.append(idx)
                        if host:
                            cur_frames.append(buf)      # a view; the Segment keeps it
                    elif host:
                        buf = np.empty((rows, w), np.uint8)
                        if not read(idx, buf):
                            break
                        cur_frames.append(buf)
                    elif not skip(idx):
                        break
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
