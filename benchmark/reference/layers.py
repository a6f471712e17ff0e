"""Frozen copy of ``truely_tpu_torch/models/layers.py``, plus the control
of the benchmark's correctness check: inside ``fp8_matmuls()`` every
convolution and dense layer rounds its input and weights to float8 e4m3
(per-tensor scale, amax to 448) before the product, the precision below
bfloat16 that a later change might be tempted to run the nets in.

Layer pieces shared by the nets (counterpart of ``truely_tpu/models/layers.py``).

The nets keep NCHW inside (PyTorch's layout) and take and return NHWC at
their public functions, as the JAX functions do.  Convolutions and dense
layers run in the compute dtype and hand float32 on, as the JAX layers do
with ``preferred_element_type=float32``: batchnorm, PReLU and the residual
sums stay in float32.  Kept details of the upstream checkpoints: batchnorm
eps 1e-3, per-channel PReLU, ceil-mode max-pool in the MTCNN nets, and the
(W, H, C) flatten order of the MTCNN dense layers.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3
FP8_MAX = 448.0  # the largest float8 e4m3 value
_fp8 = contextvars.ContextVar("fp8_matmuls", default=False)


@contextlib.contextmanager
def fp8_matmuls():
    """Round every conv and dense operand to float8 e4m3 inside the block."""
    token = _fp8.set(True)
    try:
        yield
    finally:
        _fp8.reset(token)


def operand(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``t`` in ``dt``; inside ``fp8_matmuls()`` first rounded to float8
    e4m3 under a per-tensor scale that maps its largest magnitude to 448."""
    if not _fp8.get():
        return t.to(dt)
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(dt)


class FrozenBN(nn.Module):
    """Inference batchnorm in float32: x * scale + (beta - mean * scale)."""

    def __init__(self, c: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.register_buffer("gamma", torch.ones(c))
        self.register_buffer("beta", torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.gamma * torch.rsqrt(self.var + self.eps)
        shift = self.beta - self.mean * scale
        shape = (1, -1) + (1,) * (x.dim() - 2)  # channel axis 1
        return x.float() * scale.view(shape) + shift.view(shape)


def conv(m: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``m`` applied with input and weights cast to ``dtype``; float32 out,
    the bias added in float32 as the JAX layer adds it."""
    dt = dtype or torch.float32
    out = F.conv2d(operand(x, dt), operand(m.weight, dt), None, m.stride, m.padding).float()
    return out if m.bias is None else out + m.bias.view(1, -1, 1, 1)


def dense(m: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    dt = dtype or torch.float32
    out = F.linear(operand(x, dt), operand(m.weight, dt)).float()
    return out if m.bias is None else out + m.bias


def prelu(m: nn.PReLU, x: torch.Tensor) -> torch.Tensor:
    return F.prelu(x, m.weight.to(x.dtype))


def max_pool_ceil(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, ceil_mode=True)


def flatten_mtcnn(x: torch.Tensor) -> torch.Tensor:
    """Flatten NCHW maps in the (W, H, C) order the MTCNN dense layers
    expect (the upstream ``permute(0, 3, 2, 1)``)."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels-last in memory, which cuDNN takes as is)."""
    return x.permute(0, 3, 1, 2)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)
