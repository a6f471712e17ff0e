"""Frozen copy of ``truely_tpu_torch/models/mtcnn_nets.py`` (the P-Net
regression head takes its operands through ``layers.operand``, as every
conv and dense layer does).

P-Net / R-Net / O-Net, the MTCNN stage nets (counterpart of
``truely_tpu/models/mtcnn_nets.py``).

Submodule names are the keys of the JAX param trees (and of the upstream
facenet_pytorch checkpoints), so weights load by a mechanical walk
(models/weights.py).  Inputs are NHWC, already normalized.  The P-Net trunk
is the direct form (``apply_pnet_trunk``); the JAX width-folded trunk
(``ops/fold.py``) is a TPU lane layout of the same function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from . import layers as L


class PNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = nn.PReLU(10)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = nn.PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def trunk(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3).  Returns (prob (B, H', W'), feat (B, H', W', 32))
        with H' = (H - 10) // 2 after the valid convs and the ceil pool."""
        h = L.prelu(self.prelu1, L.conv(self.conv1, L.to_nchw(x), dtype))
        h = L.max_pool_ceil(h, 2, 2)
        h = L.prelu(self.prelu2, L.conv(self.conv2, h, dtype))
        h = L.prelu(self.prelu3, L.conv(self.conv3, h, dtype))
        cls = L.conv(self.conv4_1, h, dtype)
        prob = torch.softmax(cls, dim=1)[:, 1]
        return prob, h.permute(0, 2, 3, 1)

    def reg_from_features(self, feat: torch.Tensor,
                          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The conv4_2 1x1 regression head on (..., 32) feature rows."""
        dt = dtype or torch.float32
        w = self.conv4_2.weight.reshape(4, 32).t()
        return torch.matmul(L.operand(feat, dt), L.operand(w, dt)).float() + self.conv4_2.bias

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
        """Returns (prob (B, H', W'), reg (B, H', W', 4))."""
        prob, feat = self.trunk(x, dtype)
        reg = L.conv(self.conv4_2, L.to_nchw(feat), dtype)
        return prob, reg.permute(0, 2, 3, 1)


class RNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = nn.PReLU(28)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = nn.PReLU(48)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = nn.PReLU(64)
        self.dense4 = nn.Linear(576, 128)
        self.prelu4 = nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
        """x: (N, 24, 24, 3).  Returns (prob (N,), reg (N, 4))."""
        h = L.prelu(self.prelu1, L.conv(self.conv1, L.to_nchw(x), dtype))
        h = L.max_pool_ceil(h, 3, 2)
        h = L.prelu(self.prelu2, L.conv(self.conv2, h, dtype))
        h = L.max_pool_ceil(h, 3, 2)
        h = L.prelu(self.prelu3, L.conv(self.conv3, h, dtype))
        h = L.flatten_mtcnn(h)
        h = L.prelu(self.prelu4, L.dense(self.dense4, h, dtype))
        cls = L.dense(self.dense5_1, h, dtype)
        reg = L.dense(self.dense5_2, h, dtype)
        return torch.softmax(cls, dim=-1)[:, 1], reg


class ONet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = nn.PReLU(32)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = nn.PReLU(64)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = nn.PReLU(64)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = nn.PReLU(128)
        self.dense5 = nn.Linear(1152, 256)
        self.prelu5 = nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
        """x: (N, 48, 48, 3).  Returns (prob (N,), reg (N, 4), landmarks
        (N, 10) as [x1..x5, y1..y5] in box-relative units)."""
        h = L.prelu(self.prelu1, L.conv(self.conv1, L.to_nchw(x), dtype))
        h = L.max_pool_ceil(h, 3, 2)
        h = L.prelu(self.prelu2, L.conv(self.conv2, h, dtype))
        h = L.max_pool_ceil(h, 3, 2)
        h = L.prelu(self.prelu3, L.conv(self.conv3, h, dtype))
        h = L.max_pool_ceil(h, 2, 2)
        h = L.prelu(self.prelu4, L.conv(self.conv4, h, dtype))
        h = L.flatten_mtcnn(h)
        h = L.prelu(self.prelu5, L.dense(self.dense5, h, dtype))
        cls = L.dense(self.dense6_1, h, dtype)
        reg = L.dense(self.dense6_2, h, dtype)
        lmk = L.dense(self.dense6_3, h, dtype)
        return torch.softmax(cls, dim=-1)[:, 1], reg, lmk
