"""Frozen copy of ``truely_tpu_torch/ops/boxes.py``.

Box algebra of the detection cascade (counterpart of ``truely_tpu/ops/boxes.py``).

The +1 "MATLAB pixel" width convention in regression and IoU, square
re-rectification, and truncate-then-clamp crop bounds, batched over
``(..., 4)`` tensors of ``[x1, y1, x2, y2]``.
"""

from __future__ import annotations

import torch


def bbreg(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """Apply regression offsets: corners move by reg * (side + 1)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return torch.stack(
        [
            boxes[..., 0] + reg[..., 0] * w,
            boxes[..., 1] + reg[..., 1] * h,
            boxes[..., 2] + reg[..., 2] * w,
            boxes[..., 3] + reg[..., 3] * h,
        ],
        dim=-1,
    )


def rerec(boxes: torch.Tensor) -> torch.Tensor:
    """Re-rectify boxes to squares centred on the original box."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    side = torch.maximum(w, h)
    x1 = boxes[..., 0] + w * 0.5 - side * 0.5
    y1 = boxes[..., 1] + h * 0.5 - side * 0.5
    return torch.stack([x1, y1, x1 + side, y1 + side], dim=-1)


def pad_crop_bounds(boxes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Truncate boxes to int and clamp to the image: 0-based half-open
    int32 crop bounds (x0, y0, x1, y1), the 1-based clamp ``x<1 -> 1;
    ex>w -> w`` followed by the slice ``[y-1:ey, x-1:ex]``."""
    b = boxes.to(torch.int32)  # truncates toward zero, like astype(int32)
    x0 = b[..., 0].clamp_min(1) - 1
    y0 = b[..., 1].clamp_min(1) - 1
    x1 = b[..., 2].clamp_max(width)
    y1 = b[..., 3].clamp_max(height)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def clip_boxes(boxes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Clamp float boxes into [0, W] x [0, H] (reference model.py:50-53)."""
    return torch.stack([boxes[..., 0].clamp(0, width), boxes[..., 1].clamp(0, height),
                        boxes[..., 2].clamp(0, width), boxes[..., 3].clamp(0, height)], dim=-1)


def box_area(boxes: torch.Tensor, plus_one: bool = True) -> torch.Tensor:
    off = 1.0 if plus_one else 0.0
    return (boxes[..., 2] - boxes[..., 0] + off) * (boxes[..., 3] - boxes[..., 1] + off)


def iou_matrix(boxes: torch.Tensor, *, method: str = "union",
               plus_one: bool = True) -> torch.Tensor:
    """Pairwise IoU of (..., K, 4) boxes -> (..., K, K), with the +1
    convention unless ``plus_one=False`` (the track matcher);
    ``method='min'`` divides by the smaller area."""
    off = 1.0 if plus_one else 0.0
    a = boxes[..., :, None, :]
    b = boxes[..., None, :, :]
    ix = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]) + off).clamp_min(0.0)
    iy = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]) + off).clamp_min(0.0)
    inter = ix * iy
    area = box_area(boxes, plus_one)
    if method == "min":
        denom = torch.minimum(area[..., :, None], area[..., None, :])
    else:
        denom = area[..., :, None] + area[..., None, :] - inter
    return inter / denom.clamp_min(1e-12)
