"""The classifier's face crop, kernel K7: the DFDC winner's crop
preparation (``kernel_utils.py`` of github.com/selimsef/dfdc_deepfake_challenge)
for all of a batch's face boxes in one launch.

For each (frame, track) slot whose mask is set, from the detector's float
box:

- the box as integers by truncation (Python's ``int``), grown by
  ``w // margin`` and ``h // margin`` on each side (``margin`` 3: a third)
  and clipped to the frame as numpy slicing clips;
- ``isotropically_resize_image``: the long side to ``size`` (380), the short
  side to ``int(short * size / long)`` in double precision; cv2's
  ``INTER_AREA`` when shrinking, ``INTER_CUBIC`` (a = -0.75) when growing,
  none when the long side is already ``size``;
- the resized crop rounded to uint8, put at ``((size - h) // 2, (size - w)
  // 2)`` of a zero ``size`` x ``size`` canvas (``put_to_center``);
- RGB, ``(x / 255 - mean) / std`` with ImageNet's mean and std, as bf16.

Masked slots give zeros.  The resampling is exact integer arithmetic, so
the kernel and its plain version agree bit for bit:

- area: each output pixel is the exact mean of the source area it covers
  (cv2's overlap weights; coordinates scaled by the output length make
  every overlap an integer), rounded half up;
- cubic: cv2's fixed-point scheme: per axis the float coefficients of
  ``interpolateCubic`` at ``(j + 0.5) * scale - 0.5`` rounded to shorts of
  scale 2048, taps clamped to the edge, horizontal then vertical integer
  sums, ``(v + 2^21) >> 22`` clipped to [0, 255].

cv2 itself rounds its area sums in float (half to even) and its vertical
cubic sum in float with FMA, so it differs from this by at most 1 on the
0-255 scale (``tests/test_torch_classifier.py`` holds it to that).  Where
the short side would truncate to 0 it is taken as 1 (cv2 refuses a zero
size).  The normalisation is a table of the 256 values per channel
(``normalize_table``).

Kernel K7 (``csrc/crop_classifier.cu``) replaces no TPU kernel: the JAX
package has no classifier.  The wrapper launches it on CUDA tensors and
takes the plain version on CPU tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from truely_tpu_torch.ops import cuda_build

MEAN = (0.485, 0.456, 0.406)   # ImageNet, RGB
STD = (0.229, 0.224, 0.225)
COEF_BITS = 11                 # cv2's INTER_RESIZE_COEF_BITS
CUBIC_A = -0.75


class Geometry(NamedTuple):
    """Where one slot's crop comes from and where it lands."""

    y0: int        # the grown, clipped source rectangle [y0, y1) x [x0, x1)
    y1: int
    x0: int
    x1: int
    nh: int        # the resized crop's size
    nw: int
    oy: int        # its offset on the canvas
    ox: int


def geometry(box, h: int, w: int, size: int, margin: int) -> Optional[Geometry]:
    """The crop of one float box (x0, y0, x1, y1) in an (h, w) frame, or
    None where the grown rectangle is empty."""
    xmin, ymin, xmax, ymax = (int(v) for v in box)
    p_w, p_h = (xmax - xmin) // margin, (ymax - ymin) // margin

    def clip(lo, hi, n):  # numpy's slice [lo:hi] of a length-n axis, lo >= 0
        hi = hi + n if hi < 0 else hi
        return min(lo, n), min(max(hi, 0), n)

    y0, y1 = clip(max(ymin - p_h, 0), ymax + p_h, h)
    x0, x1 = clip(max(xmin - p_w, 0), xmax + p_w, w)
    ch, cw = y1 - y0, x1 - x0
    if ch <= 0 or cw <= 0:
        return None
    if max(ch, cw) == size:
        nh, nw = ch, cw
    elif cw > ch:
        nh, nw = int(ch * (size / cw)), size
    else:
        nh, nw = size, int(cw * (size / ch))
    nh, nw = max(nh, 1), max(nw, 1)
    return Geometry(y0, y1, x0, x1, nh, nw, (size - nh) // 2, (size - nw) // 2)


def area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) integer overlaps: output j covers [j*src, (j+1)*src) and
    input i covers [i*dst, (i+1)*dst); each row sums to ``src``."""
    i = np.arange(src, dtype=np.int64)[None, :]
    j = np.arange(dst, dtype=np.int64)[:, None]
    return np.maximum(0, np.minimum((i + 1) * dst, (j + 1) * src) - np.maximum(i * dst, j * src))


def cubic_coeffs(x: np.float32) -> np.ndarray:
    """cv2's ``interpolateCubic`` in float32, operation by operation."""
    f = np.float32
    a = f(CUBIC_A)
    x1 = x + f(1)
    c0 = ((a * x1 - f(5) * a) * x1 + f(8) * a) * x1 - f(4) * a
    c1 = ((a + f(2)) * x - (a + f(3))) * x * x + f(1)
    y = f(1) - x
    c2 = ((a + f(2)) * y - (a + f(3))) * y * y + f(1)
    c3 = f(1) - c0 - c1 - c2
    return np.array([c0, c1, c2, c3], np.float32)


def cubic_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) integer weights of cv2's fixed-point cubic resize of one
    axis: four taps per output, clamped to the edge (a clamped tap adds
    its weight to the edge pixel), in units of 2**COEF_BITS."""
    scale = 1.0 / (dst / src)
    out = np.zeros((dst, src), np.int64)
    for j in range(dst):
        fx = np.float32((j + 0.5) * scale - 0.5)
        sx = int(math.floor(fx))
        fx = np.float32(fx - np.float32(sx))
        coef = np.rint(cubic_coeffs(fx) * np.float32(1 << COEF_BITS)).astype(np.int64)
        for k in range(4):
            out[j, min(max(sx - 1 + k, 0), src - 1)] += coef[k]
    return out


def resize_u8(crop: torch.Tensor, nh: int, nw: int, size: int) -> torch.Tensor:
    """(ch, cw, 3) uint8 -> (nh, nw, 3) uint8, as ``isotropically_resize_image``
    with ``size`` as its target: a copy, area or fixed-point cubic.  The
    sums are of integers below 2**53, so float64 products are exact on any
    device."""
    ch, cw = crop.shape[:2]
    if max(ch, cw) == size:
        return crop.clone()
    dev = crop.device
    src = crop.to(torch.float64)
    if max(ch, cw) > size:   # shrinking: the long side's scale is below 1
        wy, wx = area_weights(ch, nh), area_weights(cw, nw)
        num = torch.einsum("ys,sxc->yxc", torch.from_numpy(wy).to(dev, torch.float64),
                           torch.einsum("xs,ysc->yxc", torch.from_numpy(wx).to(dev, torch.float64),
                                        src))
        den = float(ch * cw)
        out = torch.floor((2 * num + den) / (2 * den))
    else:
        wy, wx = cubic_weights(ch, nh), cubic_weights(cw, nw)
        num = torch.einsum("ys,sxc->yxc", torch.from_numpy(wy).to(dev, torch.float64),
                           torch.einsum("xs,ysc->yxc", torch.from_numpy(wx).to(dev, torch.float64),
                                        src))
        out = torch.floor((num + float(1 << (2 * COEF_BITS - 1))) / float(1 << (2 * COEF_BITS)))
    return out.clamp(0, 255).to(torch.uint8)


def normalize_table(device) -> torch.Tensor:
    """(256, 3) bf16: the normalised value of each byte for each output
    channel (RGB), ``(v / 255 - mean) / std`` in numpy's float32."""
    v = np.arange(256, dtype=np.float32)[:, None] / np.float32(255)
    table = (v - np.asarray(MEAN, np.float32)) / np.asarray(STD, np.float32)
    return torch.from_numpy(table).to(device, torch.bfloat16)


def crop_classifier_u8(frames: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor,
                       size: int, margin: int):
    """The plain crops before the normalisation: (B·T, size, size, 3)
    uint8 canvases in the frames' channel order, and the (B·T,) slots that
    hold a crop (mask set and rectangle not empty)."""
    b, h, w, _ = frames.shape
    t = boxes.shape[1]
    out = torch.zeros((b * t, size, size, 3), dtype=torch.uint8, device=frames.device)
    filled = torch.zeros(b * t, dtype=torch.bool)
    boxes_h, mask_h = boxes.float().cpu().numpy(), mask.cpu().numpy()
    for n in range(b * t):
        i, k = divmod(n, t)
        g = geometry(boxes_h[i, k], h, w, size, margin) if mask_h[i, k] else None
        if g is None:
            continue
        crop = resize_u8(frames[i, g.y0:g.y1, g.x0:g.x1], g.nh, g.nw, size)
        out[n, g.oy:g.oy + g.nh, g.ox:g.ox + g.nw] = crop
        filled[n] = True
    return out, filled


def crop_classifier_plain(frames: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor,
                          size: int, margin: int, rgb_in: bool) -> torch.Tensor:
    """Plain version of K7: (B·T, size, size, 3) bf16."""
    canvas, filled = crop_classifier_u8(frames, boxes, mask, size, margin)
    if not rgb_in:
        canvas = canvas.flip(-1)
    table = normalize_table(frames.device)
    out = table[canvas.long(), torch.arange(3, device=frames.device)]
    return torch.where(filled.to(frames.device)[:, None, None, None], out, 0.0).to(torch.bfloat16)


_tables: dict = {}


def crop_classifier(frames: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor,
                    size: int, margin: int, rgb_in: bool) -> torch.Tensor:
    """frames (B, H, W, 3) uint8 (BGR, or RGB with ``rgb_in``), boxes (B, T,
    4) float32 (x0, y0, x1, y1), mask (B, T) bool -> (B·T, size, size, 3)
    bf16 normalised RGB crops, zeros for masked slots.  Kernel K7 on CUDA
    tensors, the plain version on CPU tensors."""
    b, h, w, c = frames.shape
    t = boxes.shape[1]
    if frames.dtype != torch.uint8 or c != 3 or boxes.shape != (b, t, 4) or mask.shape != (b, t):
        raise ValueError(f"expected (B, H, W, 3) uint8, (B, T, 4) boxes and a (B, T) mask, got "
                         f"{tuple(frames.shape)} {frames.dtype}, {tuple(boxes.shape)}, "
                         f"{tuple(mask.shape)}")
    if frames.is_cpu:
        return crop_classifier_plain(frames, boxes, mask, size, margin, rgb_in)
    cuda_build.require_cuda("crop_classifier", frames, boxes, mask)
    table = _tables.get(frames.device)
    if table is None:
        table = _tables[frames.device] = normalize_table(frames.device)
    frames = frames.contiguous()
    boxes = boxes.to(torch.float32).contiguous()
    mask = mask.to(torch.uint8).contiguous()
    out = torch.empty((b * t, size, size, 3), dtype=torch.bfloat16, device=frames.device)
    P, I = cuda_build.P, cuda_build.I
    cuda_build.launch("crop_classifier", "tt_crop_classifier", [P, P, P, P, P, I, I, I, I, I, I, I],
                      frames.data_ptr(), boxes.data_ptr(), mask.data_ptr(), table.data_ptr(),
                      out.data_ptr(), b, h, w, t, size, margin, int(rgb_in),
                      device=frames.device)
    crop_classifier.launches += 1
    return out


crop_classifier.launches = 0
