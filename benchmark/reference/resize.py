"""Frozen copy of ``truely_tpu_torch/ops/resize.py``, with
every kernel wrapper calling its plain version (no CUDA kernel of the
port runs here).

Resamplers of the cascade (counterpart of ``truely_tpu/ops/resize.py``).

- ``resize_area``: PyTorch ``interpolate(mode='area')`` (adaptive average
  pooling) of whole frames, the pyramid levels, as two separable averaging
  matmuls.  These are plain matrix products (the JAX package leaves them to
  XLA too), in float32, or in bf16 on the cascaded production pyramid.
- ``resize_area_u8``: the same bins over uint8 frames with exact integer
  bin sums and one division, to bfloat16: the bf16 pyramid when it is not
  cascaded (``--exact-pyramid``).
- ``resize_bilinear``: cv2 INTER_LINEAR of whole frames (static sizes).
- ``crop_resize_area``: the same bins over K dynamic boxes per frame, the
  R-Net/O-Net stage crops: kernel K3 and its plain version, in two steps:
  ``crop_area_integral`` (the prep, once per frame step: the integral image
  of the frame) and ``crop_resize_area_from_integral`` (four corner
  gathers and one division per bin, once per stage crop).  ``quant=1`` is
  exact; ``quant>1`` snaps boxes to a quant-px grid and bins the quant x
  quant block sums, still exact integer arithmetic.
- ``crop_resize_bilinear``: cv2 INTER_LINEAR over one dynamic box per
  frame, the 80x80 face crop: kernel K4 and its plain version.

Kernels (``csrc/crop_area.cu``, ``csrc/crop_bilinear.cu``) replace the
Pallas kernels ``truely_tpu/ops/crop_fused2.py:crop_resize_area_fused2``
and ``truely_tpu/ops/crop_pallas.py:crop_resize_bilinear_pallas``.  All
are bound by bytes on the H100.  Each wrapper launches its kernel on a CUDA
tensor and takes the plain version only on a CPU tensor.

The plain versions divide by device tensors, never by Python numbers: on
CUDA, PyTorch turns ``x / scalar`` into ``x * (1 / scalar)``, which rounds
differently from the IEEE division that the reference and the kernels do.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch




# ---------------------------------------------------------------------------
# Static-size area resize (pyramid levels)
# ---------------------------------------------------------------------------


def _area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 averaging matrix, adaptive-pool bins."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        s = (i * in_size) // out_size
        e = -((-(i + 1) * in_size) // out_size)
        mat[i, s:e] = 1.0 / (e - s)
    return mat


def resize_area(x: torch.Tensor, out_hw: Tuple[int, int],
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Area resize of (B, H, W, C) to (B, OH, OW, C) in ``dtype`` (the
    matrices are rounded to ``dtype`` too, as in the JAX bf16 path)."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x.to(dtype)
    rh = torch.from_numpy(_area_matrix(h, oh)).to(x.device, dtype)
    rw = torch.from_numpy(_area_matrix(w, ow)).to(x.device, dtype)
    y = torch.matmul(rh, x.to(dtype).reshape(b, h, w * c))           # contract H
    y = y.reshape(b, oh, w, c).transpose(2, 3)                        # (B, OH, C, W)
    return torch.matmul(y, rw.t()).transpose(2, 3)                    # contract W


def _sum_matrix(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(out_size, in_size) float32 0/1 bin-membership matrix, adaptive-pool
    bins, and the float32 bin widths."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    widths = np.zeros((out_size,), dtype=np.float32)
    for i in range(out_size):
        s = (i * in_size) // out_size
        e = -((-(i + 1) * in_size) // out_size)
        mat[i, s:e] = 1.0
        widths[i] = e - s
    return mat, widths


def resize_area_u8(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Area resize of (B, H, W, C) uint8 frames to (B, OH, OW, C) bfloat16,
    as ``truely_tpu/ops/resize.py:resize_area_u8`` computes it: every bin
    sum an exact integer, ONE float32 division by the bin's area, then the
    cast to bfloat16.  The pyramid of the bf16 path when it is not cascaded.

    The sums are float32 matrix products whose every operand is an integer
    of at most 8 bits, so they stay exact even where TF32 rounds a GEMM's
    inputs to 11 significant bits: the H-pass multiplies pixels (<= 255) by
    0/1; its row sums (<= 255 * bin_h) are split as hi * 128 + lo (both
    <= 255 for bins of <= 127 rows, the JAX function's own limit) before the
    W-pass; every sum stays below 255 * 127 * 127 < 2^24, so float32
    accumulation is exact in any order."""
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"expected (B, H, W, C) uint8, got {tuple(x.shape)} {x.dtype}")
    b, h, w, c = x.shape
    oh, ow = out_hw
    sh, wh = _sum_matrix(h, oh)
    sw, ww = _sum_matrix(w, ow)
    if wh.max() > 127 or ww.max() > 127:
        raise ValueError(f"bins of {wh.max():.0f}x{ww.max():.0f} px exceed 127: "
                         f"{h}x{w} -> {oh}x{ow}")
    dev = x.device
    y = torch.matmul(torch.from_numpy(sh).to(dev), x.to(torch.float32).reshape(b, h, w * c))
    y = y.reshape(b, oh, w, c).transpose(2, 3)                        # (B, OH, C, W)
    hi = torch.floor(y * 0.0078125)                                   # y // 128, exact
    lo = y - hi * 128.0
    swt = torch.from_numpy(sw.T.copy()).to(dev)
    z = torch.matmul(hi, swt) * 128.0 + torch.matmul(lo, swt)         # (B, OH, C, OW)
    area = torch.from_numpy(wh[:, None] * ww[None, :]).to(dev)        # (OH, OW), a device tensor
    return (z.transpose(2, 3) / area[:, :, None]).to(torch.bfloat16)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_LINEAR-style resize of (B, H, W, C) to float32 (B, OH, OW,
    C) with static sizes, as two separable interpolation matrix products
    (``truely_tpu/ops/resize.py:resize_bilinear``)."""

    def lerp_matrix(in_size: int, out_size: int) -> torch.Tensor:
        mat = np.zeros((out_size, in_size), dtype=np.float32)
        scale = in_size / out_size
        for i in range(out_size):
            src = min(max((i + 0.5) * scale - 0.5, 0.0), in_size - 1.0)
            lo = int(np.floor(src))
            hi = min(lo + 1, in_size - 1)
            mat[i, lo] += 1.0 - (src - lo)
            mat[i, hi] += src - lo
        return torch.from_numpy(mat).to(x.device)

    b, h, w, c = x.shape
    oh, ow = out_hw
    y = torch.matmul(lerp_matrix(h, oh), x.to(torch.float32).reshape(b, h, w * c))
    y = y.reshape(b, oh, w, c).transpose(2, 3)                        # (B, OH, C, W)
    return torch.matmul(y, lerp_matrix(w, ow).t()).transpose(2, 3)


# ---------------------------------------------------------------------------
# Dynamic-box area crops (kernel K3)
# ---------------------------------------------------------------------------


def bin_edges(start: torch.Tensor, length: torch.Tensor, out_size: int):
    """Adaptive-pool bin edges of (..., ) segments -> (..., O) each;
    empty segments (length <= 0) give s == e."""
    i = torch.arange(out_size, device=start.device, dtype=start.dtype)
    length = length.clamp_min(0)[..., None]
    start = start[..., None]
    s = start + (i * length) // out_size
    e = start + -((-(i + 1) * length) // out_size)
    return s, torch.maximum(e, s)


def snapped_bounds(bounds: torch.Tensor, quant: int):
    """(x0, y0, x1, y1) int64 of (..., 4) pixel bounds on the grid of
    quant x quant blocks: floor for the near edge, ceil for the far edge,
    and a box that is empty stays empty.  quant == 1 leaves them as they are."""
    x0, y0, x1, y1 = bounds.to(torch.int64).unbind(-1)
    if quant == 1:
        return x0, y0, x1, y1
    qx0, qy0 = x0 // quant, y0 // quant
    x1 = torch.where(x1 > x0, -((-x1) // quant), qx0)
    y1 = torch.where(y1 > y0, -((-y1) // quant), qy0)
    return qx0, qy0, x1, y1


def crop_area_integral_plain(frames: torch.Tensor, quant: int = 1) -> torch.Tensor:
    """Plain version of the prep: the exact int32 integral image of the
    frame's quant x quant block sums (of its pixels at quant=1), padded with
    a zero first row and column: (B, H/q+1, W/q+1, C)."""
    b, h, w, c = frames.shape
    src = frames.to(torch.int32)
    if quant > 1:
        src = src.reshape(b, h // quant, quant, w // quant, quant, c).sum(dim=(2, 4), dtype=torch.int32)
    return torch.nn.functional.pad(
        torch.cumsum(torch.cumsum(src, 1, dtype=torch.int32), 2, dtype=torch.int32),
        (0, 0, 1, 0, 1, 0))


def crop_resize_area_from_integral_plain(integral: torch.Tensor, bounds: torch.Tensor,
                                         out_size: int, *, quant: int = 1) -> torch.Tensor:
    """Plain version of the crop: four corner gathers per bin from the
    integral, one float32 division per bin."""
    b = integral.shape[0]
    x0, y0, x1, y1 = snapped_bounds(bounds, quant)
    sy, ey = bin_edges(y0, y1 - y0, out_size)   # (B, K, O)
    sx, ex = bin_edges(x0, x1 - x0, out_size)
    area = (ey - sy)[..., :, None] * (ex - sx)[..., None, :]
    bi = torch.arange(b, device=integral.device)[:, None, None, None]
    hq, wq = integral.shape[1] - 1, integral.shape[2] - 1

    def corner(ys, xs):
        # Empty bins of boxes outside the frame may index past it; their
        # value is masked below, so the index is clamped like an XLA gather.
        return integral[bi, ys.clamp(0, hq)[..., :, None], xs.clamp(0, wq)[..., None, :]]

    total = corner(ey, ex) - corner(sy, ex) - corner(ey, sx) + corner(sy, sx)
    denom = area.to(torch.float32).clamp_min(1.0) * float(quant * quant)
    mean = total.to(torch.float32) / denom[..., None]
    return torch.where((area > 0)[..., None], mean, 0.0)


def crop_resize_area_plain(frames: torch.Tensor, bounds: torch.Tensor,
                           out_size: int, *, quant: int = 1) -> torch.Tensor:
    """Plain version: an exact int32 integral image of the frame (of its
    quant x quant block sums when quant > 1), four corner gathers per bin,
    one float32 division per bin."""
    return crop_resize_area_from_integral_plain(
        crop_area_integral_plain(frames, quant), bounds, out_size, quant=quant)


def crop_area_integral(frames: torch.Tensor, quant: int = 1) -> torch.Tensor:
    """The integral image of the stage crops (the plain version, on any
    device): (B, H, W, 3) uint8 -> (B, H/q+1, W/q+1, 3) int32."""
    return crop_area_integral_plain(frames, quant)


def crop_resize_area_from_integral(integral: torch.Tensor, bounds: torch.Tensor,
                                   out_size: int, *, quant: int = 1) -> torch.Tensor:
    """Area crop-resize of K boxes per frame from :func:`crop_area_integral`
    (the plain version, on any device)."""
    return crop_resize_area_from_integral_plain(integral, bounds, out_size, quant=quant)


def crop_resize_area(frames: torch.Tensor, bounds: torch.Tensor,
                     out_size: int, *, quant: int = 1) -> torch.Tensor:
    """Area crop-resize of K boxes per frame: :func:`crop_area_integral`
    then :func:`crop_resize_area_from_integral` (the cascade makes the
    integral once per frame step and cuts both stage crops from it).

    frames: (B, H, W, C=3) uint8; bounds: (B, K, 4) int32 half-open pixel
    bounds (x0, y0, x1, y1) clipped to the frame (ops.boxes.pad_crop_bounds).
    ``quant > 1`` needs H and W divisible by it (callers fall back to 1).
    Returns (B, K, O, O, C) float32 in [0, 255]; empty boxes give zeros.
    Kernel K3 on CUDA tensors, the plain version on CPU tensors.
    """
    return crop_resize_area_from_integral(crop_area_integral(frames, quant), bounds, out_size,
                                          quant=quant)


# ---------------------------------------------------------------------------
# Dynamic-box bilinear crop (kernel K4)
# ---------------------------------------------------------------------------


def crop_resize_bilinear_plain(frames: torch.Tensor, bounds: torch.Tensor,
                               out_size: int) -> torch.Tensor:
    """Plain version of cv2 INTER_LINEAR crop-resize, every float32
    operation in the order of ``truely_tpu/ops/resize.py:_crop_bilinear_one``."""
    b, h, w, c = frames.shape
    x0, y0, x1, y1 = bounds.to(torch.int32).unbind(-1)   # (B, K)
    i = torch.arange(out_size, device=frames.device, dtype=torch.float32)
    o = torch.tensor(float(out_size), device=frames.device)

    def axis(lo, hi, size):
        n = (hi - lo).to(torch.float32)[..., None]
        s = (i + 0.5) * n / o - 0.5
        s = torch.minimum(s.clamp_min(0.0), (n - 1.0).clamp_min(0.0))
        a = lo.to(torch.float32)[..., None] + s
        a_lo = torch.floor(a).to(torch.int64)
        f = a - a_lo.to(torch.float32)
        return (a_lo.clamp(0, size - 1), (a_lo + 1).clamp(0, size - 1), f)

    ylo, yhi, fy = axis(y0, y1, h)   # (B, K, O)
    xlo, xhi, fx = axis(x0, x1, w)
    bi = torch.arange(b, device=frames.device)[:, None, None, None]

    def px(ys, xs):
        return frames[bi, ys[..., :, None], xs[..., None, :]].to(torch.float32)

    fx = fx[..., None, :, None]
    fy = fy[..., :, None, None]
    tl, tr, bl, br = px(ylo, xlo), px(ylo, xhi), px(yhi, xlo), px(yhi, xhi)
    top = tl + (tr - tl) * fx
    bot = bl + (br - bl) * fx
    out = top + (bot - top) * fy
    nonempty = ((y1 > y0) & (x1 > x0))[..., None, None, None]
    return torch.where(nonempty, out, 0.0)


def crop_resize_bilinear(frames: torch.Tensor, bounds: torch.Tensor,
                         out_size: int) -> torch.Tensor:
    """Bilinear crop-resize by the plain version, on any device."""
    return crop_resize_bilinear_plain(frames, bounds, out_size)
