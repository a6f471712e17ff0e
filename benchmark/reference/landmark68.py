"""Frozen copy of ``truely_tpu_torch/models/landmark68.py``.

The batched 68-point landmark head (counterpart of
``truely_tpu/models/landmark68.py``): four stride-2 conv blocks, global
average pooling and two dense layers regressing (x, y) in [0, 1] crop
coordinates."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from . import layers as L

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


def synthetic_landmark_batch(rng: np.random.Generator, batch: int, size: int = 80):
    """The synthetic landmark task of ``truely_tpu/models/landmark68.py``:
    random affine placements of a canonical 68-point template (a circle)
    drawn as bright dots on dark noise, from the numpy generator ``rng``.
    The stand-in training and quality data while no real landmark set is
    available.  Returns (crops (B, S, S, 3) float32 in [0, 1], landmarks
    (B, 68, 2) in [0, 1] crop coordinates)."""
    t = np.linspace(0, 2 * np.pi, 68)
    template = np.stack([0.5 + 0.35 * np.cos(t), 0.5 + 0.35 * np.sin(t)], axis=1)
    crops = rng.integers(0, 80, (batch, size, size, 3)).astype(np.uint8)
    lmks = np.zeros((batch, 68, 2), np.float32)
    for i in range(batch):
        scale = rng.uniform(0.6, 1.0)
        off = rng.uniform(0.0, 1.0 - scale, 2)
        pts = template * scale + off
        lmks[i] = pts
        px = np.clip((pts * size).astype(int), 0, size - 1)
        crops[i, px[:, 1], px[:, 0]] = 255
    return crops.astype(np.float32) / 255.0, lmks
