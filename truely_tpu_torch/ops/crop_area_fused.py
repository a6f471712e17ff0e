"""Exact area stage crops from planar frames, kernel K5 (counterpart of
``truely_tpu/ops/crop_area_fused.py``).

The same function as ``ops/resize.crop_resize_area`` at ``quant=1``: each
crop's adaptive-pool bins, an exact integer sum per bin, one float32
division by ``max(area, 1)``.  The frames come in planar ``(B, C, H, W)``
uint8 form, made once per frame step by ``prep_frames_for_fused_crops`` and
shared by both stage crops (and by the refinement step).  The TPU's layout
(int8 shift, 128-padding, W-major) served its bf16 matrix unit; on the card
a planar plane gives each channel contiguous byte rows.

Kernel ``csrc/crop_area_fused.cu`` replaces the Pallas kernel
``truely_tpu/ops/crop_area_fused.py:crop_resize_area_fused``.  The wrapper
launches it on a CUDA tensor and takes the plain version only on a CPU
tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from truely_tpu_torch.ops import cuda_build
from truely_tpu_torch.ops.resize import bin_edges


def prep_frames_for_fused_crops(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) uint8 frames -> (B, C, H, W) uint8, contiguous."""
    if frames.dtype != torch.uint8 or frames.dim() != 4:
        raise ValueError(f"expected (B, H, W, C) uint8 frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    return frames.permute(0, 3, 1, 2).contiguous()


def _check(frames_p: torch.Tensor, bounds: torch.Tensor, src_hw: Tuple[int, int]) -> None:
    b, c, h, w = frames_p.shape
    if frames_p.dtype != torch.uint8 or bounds.dim() != 3 or bounds.shape[0] != b \
            or bounds.shape[2] != 4:
        raise ValueError(f"expected (B, C, H, W) uint8 and (B, K, 4) bounds, got "
                         f"{tuple(frames_p.shape)} {frames_p.dtype}, {tuple(bounds.shape)}")
    if tuple(src_hw) != (h, w):
        raise ValueError(f"src_hw {tuple(src_hw)} is not the planar frames' {(h, w)}")


def crop_resize_area_fused_plain(frames_p: torch.Tensor, bounds: torch.Tensor, out_size: int,
                                 *, src_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version: an exact int32 integral image per plane, four corner
    gathers per bin, one float32 division per bin (the arithmetic of
    ``crop_resize_area_plain`` at q=1)."""
    _check(frames_p, bounds, src_hw)
    b, c, h, w = frames_p.shape
    x0, y0, x1, y1 = bounds.to(torch.int64).unbind(-1)
    integral = torch.nn.functional.pad(
        torch.cumsum(torch.cumsum(frames_p.to(torch.int32), 2, dtype=torch.int32), 3,
                     dtype=torch.int32),
        (1, 0, 1, 0))                                      # (B, C, H+1, W+1)
    sy, ey = bin_edges(y0, y1 - y0, out_size)             # (B, K, O)
    sx, ex = bin_edges(x0, x1 - x0, out_size)
    area = (ey - sy)[..., :, None] * (ex - sx)[..., None, :]
    bi = torch.arange(b, device=frames_p.device)[:, None, None, None, None]
    ci = torch.arange(c, device=frames_p.device)[None, None, None, None, :]

    def corner(ys, xs):  # (B, K, O, O, C); clamped like an XLA gather
        return integral[bi, ci, ys.clamp(0, h)[..., :, None, None],
                        xs.clamp(0, w)[..., None, :, None]]

    total = corner(ey, ex) - corner(sy, ex) - corner(ey, sx) + corner(sy, sx)
    mean = total.to(torch.float32) / area.to(torch.float32).clamp_min(1.0)[..., None]
    return torch.where((area > 0)[..., None], mean, 0.0)


def crop_resize_area_fused(frames_p: torch.Tensor, bounds: torch.Tensor, out_size: int,
                           *, src_hw: Tuple[int, int]) -> torch.Tensor:
    """Exact area crop-resize of K boxes per frame from planar frames.

    frames_p: (B, C, H, W) uint8 from :func:`prep_frames_for_fused_crops`;
    bounds: (B, K, 4) int32 half-open (x0, y0, x1, y1) clipped to the frame
    (ops.boxes.pad_crop_bounds); src_hw: (H, W).  Returns (B, K, O, O, C)
    float32 in [0, 255], bit-equal to ``crop_resize_area`` at q=1; empty
    boxes give zeros.  Kernel K5 on CUDA tensors, the plain version on CPU
    tensors.
    """
    _check(frames_p, bounds, src_hw)
    if frames_p.device.type == "cpu":
        return crop_resize_area_fused_plain(frames_p, bounds, out_size, src_hw=src_hw)
    cuda_build.require_cuda("crop_resize_area_fused", frames_p, bounds)
    b, c, h, w = frames_p.shape
    k = bounds.shape[1]
    if out_size * out_size * c * 4 > 48 * 1024:
        raise ValueError(f"out_size {out_size}: the {out_size}x{out_size}x{c} int32 bin tile "
                         f"does not fit in shared memory")
    frames_p = frames_p.contiguous()
    bounds = bounds.to(torch.int32).contiguous()
    out = torch.empty((b, k, out_size, out_size, c), dtype=torch.float32, device=frames_p.device)
    P, I = cuda_build.P, cuda_build.I
    cuda_build.launch("crop_area_fused", "tt_crop_area_fused", [P, P, P, I, I, I, I, I, I],
                      frames_p.data_ptr(), bounds.data_ptr(), out.data_ptr(), b, c, h, w, k,
                      out_size, device=frames_p.device)
    crop_resize_area_fused.launches += 1
    return out


crop_resize_area_fused.launches = 0
