"""Host-side frame helpers: the numpy versions of the JAX package's
framepack functions (``truely_tpu/media/native.py``).  The native extension
is not ported; these are the functions it accelerates, with the same
results."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pack_frames(dst: np.ndarray, frames: Sequence[np.ndarray],
                offsets: Sequence[int]) -> None:
    """Copy each HxWx3 uint8 frame into row ``offsets[i]`` of (B, H, W, 3)
    ``dst`` (the device-batch staging buffer)."""
    for frame, off in zip(frames, offsets):
        dst[off] = frame


def draw_rect(frame: np.ndarray, x1: int, y1: int, x2: int, y2: int,
              color_bgr, thickness: int = 2) -> None:
    """Rectangle outline on an HxWx3 uint8 frame, clamped to the image."""
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


def i420_to_bgr_host(packed: np.ndarray, *, rgb: bool = False) -> np.ndarray:
    """Exact yuv420p -> BGR/RGB conversion of one packed I420 picture
    ((H*3//2, W) uint8 -> (H, W, 3) uint8) on the host: the function of
    kernel K1 (``ops/yuv.py``), byte-identical to cv2's BGR decode of the
    same stream.  It gives host pixels to the frames the annotated output
    draws on, and BGR frames to a reader asked for them."""
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


def bgr_to_rgb(frame: np.ndarray) -> None:
    """In-place BGR<->RGB channel swap."""
    frame[..., [0, 2]] = frame[..., [2, 0]]
