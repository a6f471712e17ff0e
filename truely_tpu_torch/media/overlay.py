"""Annotation overlay: red/green boxes and status text (counterpart of
``truely_tpu/media/overlay.py``).

A red box with "AI Detected - Frame N" (top left, scale 1) once the
run-length threshold trips, else a green box with "Real Frame" above the
face.  With cv2, rectangles and text come from cv2 (the reference's look);
without it, rectangles come from
``native.draw_rect`` and there is no text.
"""

from __future__ import annotations

import numpy as np

from truely_tpu_torch.media import native

try:
    import cv2
except ImportError:  # no cv2: numpy rectangles, no text
    cv2 = None

RED = (0, 0, 255)
GREEN = (0, 255, 0)
CYAN = (255, 255, 0)


def _order(color, rgb: bool):
    """The colors above are BGR; reversed for RGB frames (corrected mode)
    so that a red box stays red after the RGB->BGR flip at encode time."""
    return color[::-1] if rgb else color


def draw_landmarks(frame: np.ndarray, landmarks_xy: np.ndarray, *, color=CYAN,
                   radius: int = 1, rgb: bool = False) -> np.ndarray:
    """Draw 68-point landmarks (image coordinates) as anti-aliased dots
    (cv2 only: without it there is no such look to draw)."""
    if cv2 is None:
        raise ImportError("draw_landmarks needs cv2 (opencv-python), which is not installed")
    color = _order(color, rgb)
    h, w = frame.shape[0], frame.shape[1]
    for x, y in landmarks_xy:
        xi, yi = int(x), int(y)
        if 0 <= xi < w and 0 <= yi < h:
            cv2.circle(frame, (xi, yi), radius, color, -1, cv2.LINE_AA)
    return frame


def _rect(frame, x1, y1, x2, y2, color):
    if cv2 is not None:
        cv2.rectangle(frame, (x1, y1), (x2, y2), color, 2)
    else:
        native.draw_rect(frame, x1, y1, x2, y2, color, thickness=2)


def annotate_frame(frame: np.ndarray, box_xyxy, *, flagged: bool, frame_index: int,
                   rgb: bool = False) -> np.ndarray:
    """Draw in place and return the frame.  ``rgb`` declares the frame's
    channel order; colors are swapped so the hue is the same either way."""
    red, green = _order(RED, rgb), _order(GREEN, rgb)
    x1, y1, x2, y2 = [int(v) for v in box_xyxy]
    if flagged:
        _rect(frame, x1, y1, x2, y2, red)
        if cv2 is not None:
            cv2.putText(frame, f"AI Detected - Frame {frame_index}", (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 1, red, 2, cv2.LINE_AA)
    else:
        _rect(frame, x1, y1, x2, y2, green)
        if cv2 is not None:
            cv2.putText(frame, "Real Frame", (x1, y1 - 10),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, green, 2, cv2.LINE_AA)
    return frame
