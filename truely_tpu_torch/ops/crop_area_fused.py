"""Exact area stage crops read straight from the frames, kernel K5
(counterpart of ``truely_tpu/ops/crop_area_fused.py``).

The same function as ``ops/resize.crop_resize_area`` at ``quant=1``: each
crop's adaptive-pool bins, an exact integer sum per bin over the bin's part
inside the frame, one float32 division by ``max(area, 1)``.  The frames
come as the cascade holds them, ``(B, H, W, 3)`` uint8: a crop's row is one
run of contiguous bytes for all three channels, so no planar copy is made
(the JAX package's ``prep_frames_for_fused_crops`` layout served its bf16
matrix unit and has no counterpart here).

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

MAX_OUT = 256  # the kernel's x-bin table


def y_bins_per_cta(total: int) -> int:
    """A CTA's share of one crop's y-bins, from the launch's ``total``
    y-bins (B * K * O): one while the launch has few (the refine step's
    K=4 crops fill the card that way), up to four in a large launch, whose
    CTAs then cost less to set up than they read (measured on the H100:
    ``chip_smoke.py --sweep``)."""
    return min(4, max(1, total // 3072))


def _check(frames: torch.Tensor, bounds: torch.Tensor, src_hw: Tuple[int, int]) -> None:
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[3] != 3 \
            or bounds.dim() != 3 or bounds.shape[0] != frames.shape[0] or bounds.shape[2] != 4:
        raise ValueError(f"expected (B, H, W, 3) uint8 frames and (B, K, 4) bounds, got "
                         f"{tuple(frames.shape)} {frames.dtype}, {tuple(bounds.shape)}")
    if tuple(src_hw) != tuple(frames.shape[1:3]):
        raise ValueError(f"src_hw {tuple(src_hw)} is not the frames' {tuple(frames.shape[1:3])}")


def crop_resize_area_fused_plain(frames: torch.Tensor, bounds: torch.Tensor, out_size: int,
                                 *, src_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version: an exact int32 integral image per frame, four corner
    gathers per bin, one float32 division per bin (the arithmetic of
    ``crop_resize_area_plain`` at q=1)."""
    _check(frames, bounds, src_hw)
    b, h, w, c = frames.shape
    x0, y0, x1, y1 = bounds.to(torch.int64).unbind(-1)
    integral = torch.nn.functional.pad(
        torch.cumsum(torch.cumsum(frames.to(torch.int32), 1, dtype=torch.int32), 2,
                     dtype=torch.int32),
        (0, 0, 1, 0, 1, 0))                                # (B, H+1, W+1, C)
    sy, ey = bin_edges(y0, y1 - y0, out_size)             # (B, K, O)
    sx, ex = bin_edges(x0, x1 - x0, out_size)
    area = (ey - sy)[..., :, None] * (ex - sx)[..., None, :]
    bi = torch.arange(b, device=frames.device)[:, None, None, None, None]
    ci = torch.arange(c, device=frames.device)[None, None, None, None, :]

    def corner(ys, xs):  # (B, K, O, O, C); clamped like an XLA gather
        return integral[bi, ys.clamp(0, h)[..., :, None, None],
                        xs.clamp(0, w)[..., None, :, None], ci]

    total = corner(ey, ex) - corner(sy, ex) - corner(ey, sx) + corner(sy, sx)
    mean = total.to(torch.float32) / area.to(torch.float32).clamp_min(1.0)[..., None]
    return torch.where((area > 0)[..., None], mean, 0.0)


def crop_resize_area_fused(frames: torch.Tensor, bounds: torch.Tensor, out_size: int,
                           *, src_hw: Tuple[int, int]) -> torch.Tensor:
    """Exact area crop-resize of K boxes per frame.

    frames: (B, H, W, 3) uint8; bounds: (B, K, 4) int32 half-open
    (x0, y0, x1, y1) (ops.boxes.pad_crop_bounds; a part outside the frame
    adds nothing); src_hw: (H, W).  Returns (B, K, O, O, 3) float32 in
    [0, 255], bit-equal to ``crop_resize_area`` at q=1; empty boxes give
    zeros.  Kernel K5 on CUDA tensors, the plain version on CPU tensors.
    """
    _check(frames, bounds, src_hw)
    if frames.device.type == "cpu":
        return crop_resize_area_fused_plain(frames, bounds, out_size, src_hw=src_hw)
    cuda_build.require_cuda("crop_resize_area_fused", frames, bounds)
    if not 0 < out_size <= MAX_OUT:
        raise ValueError(f"out_size {out_size}: the kernel takes 1..{MAX_OUT}")
    b, h, w, _ = frames.shape
    k = bounds.shape[1]
    frames = frames.contiguous()
    bounds = bounds.to(torch.int32).contiguous()
    out = torch.empty((b, k, out_size, out_size, 3), dtype=torch.float32, device=frames.device)
    P, I = cuda_build.P, cuda_build.I
    cuda_build.launch("crop_area_fused", "tt_crop_area_fused", [P, P, P, I, I, I, I, I, I],
                      frames.data_ptr(), bounds.data_ptr(), out.data_ptr(), b, h, w, k,
                      out_size, y_bins_per_cta(b * k * out_size), device=frames.device)
    crop_resize_area_fused.launches += 1
    return out


crop_resize_area_fused.launches = 0
