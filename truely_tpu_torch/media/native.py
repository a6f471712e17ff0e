"""Host-side frame helpers (counterpart of ``truely_tpu/media/native.py``):
``pack_frames``, ``i420_to_bgr_host``, ``draw_rect`` and ``bgr_to_rgb``
call ``csrc/framepack.cpp`` (built with the system compiler at first use,
``media/host_build.py``; the GIL is released for each call).  The numpy
functions ``*_plain`` compute the same results: they are the reference the
tests hold the library to.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from truely_tpu_torch.media import host_build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_fns = {}


def _fn(symbol: str):
    """``symbol`` of the framepack library, bound once per process."""
    fn = _fns.get(symbol)
    if fn is None:
        lib = host_build.load("framepack")
        argtypes, restype = {
            "tt_pack_frames": ([_P, _L, _P, _P, _L, _L], _I),
            "tt_i420_to_bgr": ([_P, _P, _I, _I, _I], _I),
            "tt_draw_rect": ([_P, _L, _L, _L, _L, _L, _L, _I, _I, _I, _L], None),
            "tt_bgr_to_rgb": ([_P, _L], None),
        }[symbol]
        fn = _fns[symbol] = host_build.bind(lib, symbol, argtypes, restype)
    return fn


def _writable_u8(a: np.ndarray, what: str) -> None:
    if a.dtype != np.uint8 or not a.flags["C_CONTIGUOUS"] or not a.flags["WRITEABLE"]:
        raise ValueError(f"{what} must be a writable C-contiguous uint8 array")


# ---------------------------------------------------------------------------
# The library's functions
# ---------------------------------------------------------------------------


def pack_frames(dst: np.ndarray, frames: Sequence[np.ndarray],
                offsets: Sequence[int]) -> None:
    """Copy each HxWx3 uint8 frame into row ``offsets[i]`` of (B, H, W, 3)
    ``dst`` (the device-batch staging buffer).  Raises ValueError for an
    offset outside ``dst``, frames of different sizes or a count mismatch."""
    _writable_u8(dst, "dst")
    srcs = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    offs = [int(o) for o in offsets]
    if len(srcs) != len(offs):
        raise ValueError("frames and offsets length mismatch")
    if not srcs:
        return
    frame_bytes = srcs[0].nbytes
    if any(s.nbytes != frame_bytes for s in srcs):
        raise ValueError("frames must all be the same size")
    ptrs = (ctypes.c_void_p * len(srcs))(*[s.ctypes.data for s in srcs])
    off_arr = (ctypes.c_int64 * len(offs))(*offs)
    if _fn("tt_pack_frames")(dst.ctypes.data, dst.nbytes, ptrs, off_arr, len(srcs),
                             frame_bytes) != 0:
        raise ValueError("offset out of range for dst")


def i420_to_bgr_host(packed: np.ndarray, *, rgb: bool = False) -> np.ndarray:
    """Exact yuv420p -> BGR/RGB conversion of one packed I420 picture
    ((H*3//2, W) uint8 -> (H, W, 3) uint8) on the host: the function of
    kernel K1 (``ops/yuv.py``), byte-identical to cv2's BGR decode of the
    same stream.  It gives host pixels to the frames the annotated output
    draws on, and BGR frames to a reader asked for them."""
    rows, w = packed.shape
    h = rows * 2 // 3
    if packed.dtype != np.uint8 or rows * 2 % 3 or h % 2 or w % 2:
        raise ValueError(f"expected a packed (H*3//2, W) uint8 I420 picture with H, W even, "
                         f"got {packed.shape} {packed.dtype}")
    src = np.ascontiguousarray(packed)
    out = np.empty((h, w, 3), np.uint8)
    if _fn("tt_i420_to_bgr")(src.ctypes.data, out.ctypes.data, w, h, int(rgb)) != 0:
        raise ValueError(f"bad I420 picture size {w}x{h}")
    return out


def draw_rect(frame: np.ndarray, x1: int, y1: int, x2: int, y2: int,
              color_bgr, thickness: int = 2) -> None:
    """Rectangle outline on an HxWx3 uint8 frame, clamped to the image.  A
    frame that is not C-contiguous (an RGB view of a BGR frame) is drawn on
    by the numpy version, as the JAX package does."""
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 frame, got {frame.shape} {frame.dtype}")
    if not frame.flags["C_CONTIGUOUS"]:
        draw_rect_plain(frame, x1, y1, x2, y2, color_bgr, thickness)
        return
    _writable_u8(frame, "frame")
    b, g, r = (int(c) for c in color_bgr)
    _fn("tt_draw_rect")(frame.ctypes.data, frame.shape[0], frame.shape[1], int(x1), int(y1),
                        int(x2), int(y2), b, g, r, int(thickness))


def bgr_to_rgb(frame: np.ndarray) -> None:
    """In-place BGR<->RGB channel swap (the numpy version for a frame that
    is not C-contiguous)."""
    if frame.dtype != np.uint8 or frame.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) uint8 pixels, got {frame.shape} {frame.dtype}")
    if not frame.flags["C_CONTIGUOUS"]:
        bgr_to_rgb_plain(frame)
        return
    _writable_u8(frame, "frame")
    _fn("tt_bgr_to_rgb")(frame.ctypes.data, frame.size // 3)


# ---------------------------------------------------------------------------
# Plain numpy versions: the tests' reference
# ---------------------------------------------------------------------------


def pack_frames_plain(dst: np.ndarray, frames: Sequence[np.ndarray],
                      offsets: Sequence[int]) -> None:
    for frame, off in zip(frames, offsets):
        dst[off] = frame


def i420_to_bgr_host_plain(packed: np.ndarray, *, rgb: bool = False) -> np.ndarray:
    rows, w = packed.shape
    h = rows * 2 // 3
    # The chroma terms at chroma resolution, broadcast over each 2x2 block.
    q = ((76305 * packed[:h].astype(np.int32) - 1219995) >> 16).reshape(h // 2, 2, w // 2, 2)
    u = packed[h: h + h // 4].reshape(h // 2, 1, w // 2, 1).astype(np.int32)
    v = packed[h + h // 4:].reshape(h // 2, 1, w // 2, 1).astype(np.int32)
    tb = (132193 * u - 16920704) >> 16
    tg = ((-25673 * u + 3286144) >> 16) + ((-53281 * v + 6819968) >> 16)
    tr = (104593 * v - 13387904) >> 16
    out = np.empty((h // 2, 2, w // 2, 2, 3), np.uint8)
    for c, term in enumerate((tr, tg, tb) if rgb else (tb, tg, tr)):
        out[..., c] = np.clip(q + term, 0, 255)
    return out.reshape(h, w, 3)


def draw_rect_plain(frame: np.ndarray, x1: int, y1: int, x2: int, y2: int,
                    color_bgr, thickness: int = 2) -> None:
    h, w = frame.shape[0], frame.shape[1]
    color = np.asarray([int(c) for c in color_bgr], np.uint8)
    for t in range(thickness):
        o = t - thickness // 2
        ys, ye = y1 - o, y2 + o
        xs, xe = x1 - o, x2 + o
        cy_s, cy_e = max(0, ys), min(h - 1, ye)
        cx_s, cx_e = max(0, xs), min(w - 1, xe)
        if 0 <= ys < h and cx_s <= cx_e:
            frame[ys, cx_s:cx_e + 1] = color
        if 0 <= ye < h and cx_s <= cx_e:
            frame[ye, cx_s:cx_e + 1] = color
        if 0 <= xs < w and cy_s <= cy_e:
            frame[cy_s:cy_e + 1, xs] = color
        if 0 <= xe < w and cy_s <= cy_e:
            frame[cy_s:cy_e + 1, xe] = color


def bgr_to_rgb_plain(frame: np.ndarray) -> None:
    frame[..., [0, 2]] = frame[..., [2, 0]]
