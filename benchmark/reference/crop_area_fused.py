"""Frozen copy of ``truely_tpu_torch/ops/crop_area_fused.py``, with
every kernel wrapper calling its plain version (no CUDA kernel of the
port runs here).

Exact area stage crops read straight from the frames, kernel K5
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


from .resize import bin_edges

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
    """Exact area crop-resize of K boxes per frame by the plain version, on
    any device."""
    _check(frames, bounds, src_hw)
    return crop_resize_area_fused_plain(frames, bounds, out_size, src_hw=src_hw)
