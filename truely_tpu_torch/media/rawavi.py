"""Uncompressed I420 AVI: a reader and a writer in plain Python.

It needs neither cv2 nor libav, so this is the one container the port
reads and writes wherever it runs, beside the native libav decoder
(``media/videodec.py``) where that is built.  It reads one codec: a
RIFF/AVI file with an uncompressed video stream whose fourcc is ``I420``
or ``IYUV``, 12 bits a pixel.  Each video chunk holds one packed I420
picture, which is exactly the (H*3//2, W) uint8 layout the device steps
take, so the reader copies bytes from the file into the staging batch and
converts nothing.

Reader: the header is parsed once and the ``movi`` list is walked (nested
``LIST rec `` included; ``JUNK``, other streams' chunks and index chunks
skipped; pad bytes of odd sizes honoured; no ``idx1`` needed) into the file
offset of every frame, so frame k is one positioned read and an unsampled
frame costs nothing.  A file that is no such AVI raises ``NotEligible``
(the caller may decode it another way); an eligible file whose chunks are
broken raises ``Malformed``, naming the reason.

Writer: the same format, one ``00dc`` chunk a frame and an ``idx1`` index.
``write_i420`` stores a packed picture as is; ``write`` converts a BGR
frame to I420 first (BT.601 limited range, cv2's fixed-point luma, chroma
averaged over each 2x2 block).  RIFF sizes are 32-bit, so the writer
refuses a frame that would take the file to 4 GiB.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, List, Tuple

import numpy as np

FOURCCS = (b"I420", b"IYUV")
_RIFF_MAX = 0xFFFFFFFF  # a RIFF size field is a uint32

# cv2's BT.601 limited-range RGB -> YUV coefficients, scaled by 2^20
# (``cv2.cvtColor(..., COLOR_BGR2YUV_I420)``).
_SHIFT = 20
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CRV, _CGV, _CBV = 460324, -385875, -74448


class NotEligible(IOError):
    """Not an uncompressed I420 AVI that this module reads."""


class Malformed(IOError):
    """An I420 AVI whose chunks are broken (truncated, wrong sizes)."""


@dataclass(frozen=True)
class AviInfo:
    width: int
    height: int
    rate: int
    scale: int
    offsets: np.ndarray  # (n,) int64 file offset of each frame's bytes

    @property
    def frame_bytes(self) -> int:
        return self.width * self.height * 3 // 2


def _header(f: BinaryIO, at: int, limit: int) -> Tuple[bytes, int]:
    """(tag, size) of the chunk header at ``at``; raises ``Malformed`` if
    the header runs past ``limit``."""
    if at + 8 > limit:
        raise Malformed(f"truncated chunk header at byte {at}")
    f.seek(at)
    raw = f.read(8)
    if len(raw) < 8:
        raise Malformed(f"truncated chunk header at byte {at}")
    return raw[:4], struct.unpack("<I", raw[4:])[0]


def _chunks(f: BinaryIO, start: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """(tag, payload offset, payload size) of each chunk in [start, end),
    a LIST's payload offset pointing past its list type."""
    at = start
    while at + 8 <= end:
        tag, size = _header(f, at, end)
        if at + 8 + size > end:
            raise Malformed(f"truncated chunk {tag!r} at byte {at}: {size} bytes declared, "
                            f"{end - at - 8} left")
        yield tag, at + 8, size
        at += 8 + size + (size & 1)  # odd sizes carry a pad byte


def _list_type(f: BinaryIO, at: int) -> bytes:
    """The list type: the first four bytes of a LIST's payload."""
    f.seek(at)
    return f.read(4)


def _stream_format(f: BinaryIO, strl_at: int, strl_size: int):
    """(strh fields, strf bytes) of one ``LIST strl``."""
    strh = strf = None
    for tag, at, size in _chunks(f, strl_at + 4, strl_at + strl_size):
        f.seek(at)
        if tag == b"strh" and size >= 56:
            strh = struct.unpack("<4s4sIHHIIIIIIIIhhhh", f.read(56))
        elif tag == b"strf":
            strf = f.read(size)
    return strh, strf


def probe(path: str) -> AviInfo:
    """Parse ``path`` as an uncompressed I420 AVI.  Raises ``IOError`` if
    it cannot be opened, ``NotEligible`` if it is not one (not RIFF/AVI, no video stream, another fourcc, not 12
    bits a pixel, odd width, height not divisible by 4) and ``Malformed``
    if it is one whose chunks are broken."""
    try:
        f = open(path, "rb")
    except OSError as e:
        raise IOError(f"could not open video: {path} ({e.strerror})") from e
    with f:
        file_size = os.fstat(f.fileno()).st_size
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:] != b"AVI ":
            raise NotEligible(f"{path}: not a RIFF/AVI file")
        riff_end = 8 + struct.unpack("<I", head[4:8])[0]
        width, height, rate, scale, index = _video_format(f, path, min(riff_end, file_size))
        # Eligible: from here on, a broken file raises.
        try:
            if riff_end > file_size:
                raise Malformed(f"truncated: RIFF declares {riff_end} bytes, the file has "
                                f"{file_size}")
            f.seek(riff_end + (riff_end & 1))
            if f.read(4) == b"RIFF":
                raise Malformed("an OpenDML extension (RIFF AVIX) follows the first RIFF; "
                                "only single-RIFF files are read")
            movi = next(((at, size) for tag, at, size in _chunks(f, 12, riff_end)
                         if tag == b"LIST" and _list_type(f, at) == b"movi"), None)
            if movi is None:
                raise Malformed("no movi list")
            offsets = _frame_offsets(f, movi, b"%02d" % index, width * height * 3 // 2)
        except Malformed as e:
            raise Malformed(f"{path}: {e}") from None
        return AviInfo(width=width, height=height, rate=rate, scale=scale,
                       offsets=np.asarray(offsets, np.int64))


def _video_format(f: BinaryIO, path: str, end: int) -> Tuple[int, int, int, int, int]:
    """(width, height, rate, scale, stream index) of the first video
    stream, from the header list, which leads an AVI; raises
    ``NotEligible`` unless it is uncompressed I420."""
    try:
        tag, size = _header(f, 12, end)
        if tag != b"LIST" or 20 + size > end or _list_type(f, 20) != b"hdrl":
            raise NotEligible(f"{path}: no AVI header list")
        index = 0
        for tag, at, size in _chunks(f, 24, 20 + size):
            if tag != b"LIST" or _list_type(f, at) != b"strl":
                continue
            strh, strf = _stream_format(f, at, size)
            if strh is not None and strh[0] == b"vids":
                break
            index += 1
        else:
            raise NotEligible(f"{path}: no video stream")
    except Malformed as e:
        raise NotEligible(f"{path}: unreadable AVI header ({e})") from None
    if strf is None or len(strf) < 20:
        raise NotEligible(f"{path}: no BITMAPINFOHEADER for the video stream")
    _, width, height, _, bits, fourcc = struct.unpack("<IiiHH4s", strf[:20])
    height = abs(height)
    scale, rate = strh[6], strh[7]
    if fourcc not in FOURCCS:
        raise NotEligible(f"{path}: fourcc {fourcc!r} is not I420/IYUV")
    if bits != 12:
        raise NotEligible(f"{path}: {bits} bits a pixel, not 12")
    if width <= 0 or width % 2:
        raise NotEligible(f"{path}: width {width} is not even")
    if height <= 0 or height % 4:
        raise NotEligible(f"{path}: height {height} is not divisible by 4")
    if rate <= 0 or scale <= 0:
        raise NotEligible(f"{path}: frame rate {rate}/{scale}")
    return width, height, rate, scale, index


def _frame_offsets(f: BinaryIO, movi: Tuple[int, int], sid: bytes, frame_bytes: int) -> List[int]:
    """The payload offset of every ``<sid>dc``/``<sid>db`` chunk of the
    movi list, in order, through nested lists."""
    offsets: List[int] = []

    def walk(start: int, end: int) -> None:
        for tag, at, size in _chunks(f, start, end):
            if tag == b"LIST":
                walk(at + 4, at + size)      # LIST rec (and any other list)
            elif tag[:2] == sid and tag[2:] in (b"dc", b"db"):
                if size != frame_bytes:
                    raise Malformed(f"frame chunk {tag!r} at byte {at - 8} holds {size} bytes, "
                                    f"not the {frame_bytes} of one picture")
                offsets.append(at)

    walk(movi[0] + 4, movi[0] + movi[1])
    return offsets


class RawAviReader:
    """Random access to the frames of an uncompressed I420 AVI."""

    def __init__(self, path: str):
        self.info = probe(path)
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)

    @property
    def frame_count(self) -> int:
        return len(self.info.offsets)

    def read_into(self, k: int, buf: np.ndarray) -> None:
        """Frame k's packed I420 bytes into ``buf`` (a C-contiguous uint8
        array of ``frame_bytes``): one positioned read, safe from any
        thread."""
        n = os.preadv(self._fd, [memoryview(buf).cast("B")], int(self.info.offsets[k]))
        if n != self.info.frame_bytes:
            raise Malformed(f"{self.path}: frame {k}: read {n} of {self.info.frame_bytes} bytes")

    def read(self, k: int) -> np.ndarray:
        """Frame k as a new packed (H*3//2, W) uint8 array."""
        buf = np.empty((self.info.height * 3 // 2, self.info.width), np.uint8)
        self.read_into(k, buf)
        return buf

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


def bgr_to_i420(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> packed (H*3//2, W) uint8 I420: BT.601
    limited range with cv2's fixed-point coefficients; luma equal to
    ``cv2.cvtColor(..., COLOR_BGR2YUV_I420)``, chroma from the 2x2 block's
    summed R, G, B (cv2 takes the block's top-left pixel)."""
    h, w = frame.shape[:2]
    c = frame.astype(np.int32)
    b, g, r = c[..., 0], c[..., 1], c[..., 2]
    out = np.empty((h * 3 // 2, w), np.uint8)
    half = 1 << (_SHIFT - 1)
    out[:h] = (_CRY * r + _CGY * g + _CBY * b + (16 << _SHIFT) + half) >> _SHIFT
    # Block sums of four pixels: the chroma shift is two more bits.  The
    # results stay in 16..240, so nothing is clipped, and in int32 range.
    rs, gs, bs = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
                  for x in (r, g, b))
    s = _SHIFT + 2
    u = (_CRU * rs + _CGU * gs + _CBU * bs + (128 << s) + (1 << (s - 1))) >> s
    v = (_CRV * rs + _CGV * gs + _CBV * bs + (128 << s) + (1 << (s - 1))) >> s
    q = h // 4
    out[h:h + q] = u.reshape(q, w)
    out[h + q:] = v.reshape(q, w)
    return out


class RawAviWriter:
    """Writes an uncompressed I420 AVI, one frame at a time."""

    def __init__(self, path: str, fps: float, width: int, height: int):
        if width <= 0 or width % 2 or height <= 0 or height % 4:
            raise IOError(f"{path}: an I420 AVI needs an even width and a height divisible "
                          f"by 4, got {width}x{height}")
        if fps <= 0:
            raise IOError(f"{path}: fps must be positive, got {fps}")
        rate, scale = ((int(round(fps)), 1) if abs(fps - round(fps)) < 1e-6
                       else (int(round(fps * 1001)), 1001))
        self.path, self.width, self.height = path, width, height
        self.frame_bytes = width * height * 3 // 2
        self._n = 0
        fb = self.frame_bytes

        def chunk(tag, payload):
            return tag + struct.pack("<I", len(payload)) + payload

        def lst(kind, payload):
            return chunk(b"LIST", kind + payload)

        avih = struct.pack("<14I", int(round(1e6 * scale / rate)), min(fb * rate // scale, _RIFF_MAX), 0,
                           0x10, 0, 0, 1, fb, width, height, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"I420", 0, 0, 0, 0, scale, rate,
                           0, 0, fb, 0xFFFFFFFF, 0, 0, 0, width, height)
        strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 12, b"I420", fb, 0, 0, 0, 0)
        hdrl = lst(b"hdrl", chunk(b"avih", avih)
                   + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
        # The frame counts and sizes are patched in at close.
        self._total_frames_at = 12 + 8 + 4 + 8 + 16   # avih dwTotalFrames
        self._length_at = hdrl.index(b"strh") + 12 + 8 + 32  # strh dwLength
        self._movi_at = 12 + len(hdrl)
        self._f = open(path, "wb")
        self._f.write(b"RIFF\0\0\0\0AVI " + hdrl + b"LIST\0\0\0\0movi")
        self._pos = self._movi_at + 12

    def write_i420(self, packed: np.ndarray) -> None:
        """Store one packed (H*3//2, W) uint8 I420 picture as is."""
        packed = np.ascontiguousarray(packed, np.uint8)
        if packed.size != self.frame_bytes:
            raise ValueError(f"expected a {self.width}x{self.height} I420 picture "
                             f"({self.frame_bytes} bytes), got {packed.shape}")
        # Header, frames, idx1 (8 + 16 a frame) must stay within a uint32.
        final = self._pos + 8 + self.frame_bytes + 8 + 16 * (self._n + 1)
        if final - 8 > _RIFF_MAX:
            raise IOError(f"{self.path}: frame {self._n} would take the AVI to 4 GiB; "
                          "RIFF sizes are 32-bit")
        self._f.write(b"00dc" + struct.pack("<I", self.frame_bytes))
        self._f.write(memoryview(packed).cast("B"))
        self._pos += 8 + self.frame_bytes
        self._n += 1

    def write(self, frame: np.ndarray) -> None:
        """Store one (H, W, 3) uint8 BGR frame, converted to I420."""
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"expected a ({self.height}, {self.width}, 3) frame, "
                             f"got {frame.shape}")
        self.write_i420(bgr_to_i420(frame))

    def close(self) -> None:
        f = self._f
        if f is None:
            return
        self._f = None
        with f:
            fb = self.frame_bytes
            idx = b"".join(struct.pack("<4sIII", b"00dc", 0x10, 4 + i * (8 + fb), fb)
                           for i in range(self._n))
            f.write(b"idx1" + struct.pack("<I", len(idx)) + idx)
            end = f.tell()
            for at, value in ((4, end - 8), (self._movi_at + 4, self._pos - self._movi_at - 8),
                              (self._total_frames_at, self._n), (self._length_at, self._n)):
                f.seek(at)
                f.write(struct.pack("<I", value))
