"""Frozen copy of ``truely_tpu_torch/ops/yuv.py``, with
every kernel wrapper calling its plain version (no CUDA kernel of the
port runs here).

I420 -> BGR/RGB: kernel K1 and its plain version (counterpart of
``truely_tpu/ops/yuv.py``).

The function is cv2/swscale's exact BT.601 limited-range yuv420p -> bgr24
conversion, learned on all 16.7M (y, u, v) triples in the JAX package:

    q = (76305*y - 1219995) >> 16                 (shared luma ramp)
    B = clip(q + ((132193*u - 16920704) >> 16))
    G = clip(q + ((-25673*u + 3286144) >> 16) + ((-53281*v + 6819968) >> 16))
    R = clip(q + ((104593*v - 13387904) >> 16))

with 2x2 chroma replication (arithmetic shifts, i.e. floor division).

Kernel: ``csrc/yuv.cu`` replaces the Pallas kernel
``truely_tpu/ops/yuv.py:i420_to_bgr_pallas``; it is bound by bytes on the
H100 (1.5 read + 3 written per pixel).
"""

from __future__ import annotations

import torch



_LUMA = (76305, -1219995)
_B_U = (132193, -16920704)
_G_U = (-25673, 3286144)
_G_V = (-53281, 6819968)
_R_V = (104593, -13387904)


def _check_shape(packed: torch.Tensor) -> tuple:
    if packed.dim() != 3 or packed.dtype != torch.uint8:
        raise ValueError(f"expected (B, 3H/2, W) uint8, got {tuple(packed.shape)} {packed.dtype}")
    b, h32, w = packed.shape
    if h32 % 3 or (h32 * 2 // 3) % 4 or w % 2 or w == 0:
        raise ValueError(f"I420 needs H % 4 == 0 and even W, got packed {tuple(packed.shape)}")
    return b, h32 * 2 // 3, w


def i420_to_bgr_plain(packed: torch.Tensor, *, rgb: bool = False) -> torch.Tensor:
    """Plain PyTorch version: (B, 3H/2, W) uint8 -> (B, H, W, 3) uint8."""
    b, h, w = _check_shape(packed)
    ch, cw = h // 2, w // 2
    y = packed[:, :h, :].to(torch.int32)
    u = packed[:, h:h + h // 4, :].reshape(b, ch, cw).to(torch.int32)
    v = packed[:, h + h // 4:, :].reshape(b, ch, cw).to(torch.int32)

    def affine(x, mb):
        return (x * mb[0] + mb[1]) >> 16

    q = affine(y, _LUMA)
    tb = affine(u, _B_U)
    tg = affine(u, _G_U) + affine(v, _G_V)
    tr = affine(v, _R_V)

    def chan(term):
        up = term.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return (q + up).clamp(0, 255).to(torch.uint8)

    bb, gg, rr = chan(tb), chan(tg), chan(tr)
    return torch.stack((rr, gg, bb) if rgb else (bb, gg, rr), dim=-1)


def i420_to_bgr(packed: torch.Tensor, *, rgb: bool = False) -> torch.Tensor:
    """I420 -> BGR (or RGB) by the plain version, on any device."""
    _check_shape(packed)
    return i420_to_bgr_plain(packed, rgb=rgb)
