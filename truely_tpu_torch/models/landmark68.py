"""The batched 68-point landmark head (counterpart of
``truely_tpu/models/landmark68.py``): four stride-2 conv blocks, global
average pooling and two dense layers regressing (x, y) in [0, 1] crop
coordinates."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from truely_tpu_torch.models import layers as L

CHANNELS = (32, 64, 128, 256)


class LandmarkBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_a = nn.Conv2d(cin, cout, 3, stride=2, padding=1, bias=False)
        self.bn_a = L.FrozenBN(cout)
        self.conv_b = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn_b = L.FrozenBN(cout)

    def forward(self, x, dtype=None):
        h = torch.relu(self.bn_a(L.conv(self.conv_a, x, dtype)))
        return torch.relu(self.bn_b(L.conv(self.conv_b, h, dtype)))


class Landmark68(nn.Module):
    def __init__(self):
        super().__init__()
        cins = (3,) + CHANNELS[:-1]
        self.blocks = nn.ModuleList([LandmarkBlock(a, b) for a, b in zip(cins, CHANNELS)])
        self.dense_hidden = nn.Linear(CHANNELS[-1], 256)
        self.dense_out = nn.Linear(256, 136)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x: (N, S, S, 3) crops in [0, 1].  Returns (N, 68, 2) in [0, 1]."""
        h = L.to_nchw(x)
        for blk in self.blocks:
            h = blk(h, dtype)
        h = torch.relu(L.dense(self.dense_hidden, h.mean(dim=(2, 3)), dtype))
        return L.dense(self.dense_out, h, dtype).reshape(-1, 68, 2)
