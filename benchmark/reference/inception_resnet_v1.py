"""Frozen copy of ``truely_tpu_torch/models/inception_resnet_v1.py``.

Inception-ResNet-v1, the FaceNet embedder (counterpart of
``truely_tpu/models/inception_resnet_v1.py``).

The upstream facenet_pytorch architecture with its module names (so the
JAX param trees and the public checkpoints load by name), run on NHWC
crops: 512-d L2-normalized embeddings after global average pooling.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers as L


class BasicConv2d(nn.Module):
    """Bias-less conv, inference batchnorm, ReLU."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = L.FrozenBN(cout)

    def forward(self, x, dtype=None):
        return torch.relu(self.bn(L.conv(self.conv, x, dtype)))


def _chain(convs, x, dtype):
    for c in convs:
        x = c(x, dtype)
    return x


class Block35(nn.Module):
    def __init__(self, scale=0.17):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(256, 32, 1)
        self.branch1 = nn.ModuleList([BasicConv2d(256, 32, 1), BasicConv2d(32, 32, 3, padding=1)])
        self.branch2 = nn.ModuleList([
            BasicConv2d(256, 32, 1), BasicConv2d(32, 32, 3, padding=1),
            BasicConv2d(32, 32, 3, padding=1),
        ])
        self.conv2d = nn.Conv2d(96, 256, 1)

    def forward(self, x, dtype=None):
        mixed = torch.cat([self.branch0(x, dtype), _chain(self.branch1, x, dtype),
                           _chain(self.branch2, x, dtype)], dim=1)
        return torch.relu(x + L.conv(self.conv2d, mixed, dtype) * self.scale)


class Block17(nn.Module):
    def __init__(self, scale=0.10):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1)
        self.branch1 = nn.ModuleList([
            BasicConv2d(896, 128, 1), BasicConv2d(128, 128, (1, 7), padding=(0, 3)),
            BasicConv2d(128, 128, (7, 1), padding=(3, 0)),
        ])
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x, dtype=None):
        mixed = torch.cat([self.branch0(x, dtype), _chain(self.branch1, x, dtype)], dim=1)
        return torch.relu(x + L.conv(self.conv2d, mixed, dtype) * self.scale)


class Block8(nn.Module):
    def __init__(self, scale=0.20, no_relu=False):
        super().__init__()
        self.scale = scale
        self.no_relu = no_relu
        self.branch0 = BasicConv2d(1792, 192, 1)
        self.branch1 = nn.ModuleList([
            BasicConv2d(1792, 192, 1), BasicConv2d(192, 192, (1, 3), padding=(0, 1)),
            BasicConv2d(192, 192, (3, 1), padding=(1, 0)),
        ])
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x, dtype=None):
        mixed = torch.cat([self.branch0(x, dtype), _chain(self.branch1, x, dtype)], dim=1)
        out = x + L.conv(self.conv2d, mixed, dtype) * self.scale
        return out if self.no_relu else torch.relu(out)


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, stride=2)
        self.branch1 = nn.ModuleList([
            BasicConv2d(256, 192, 1), BasicConv2d(192, 192, 3, padding=1),
            BasicConv2d(192, 256, 3, stride=2),
        ])

    def forward(self, x, dtype=None):
        return torch.cat([self.branch0(x, dtype), _chain(self.branch1, x, dtype),
                          F.max_pool2d(x, 3, 2)], dim=1)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.ModuleList([BasicConv2d(896, 256, 1), BasicConv2d(256, 384, 3, stride=2)])
        self.branch1 = nn.ModuleList([BasicConv2d(896, 256, 1), BasicConv2d(256, 256, 3, stride=2)])
        self.branch2 = nn.ModuleList([
            BasicConv2d(896, 256, 1), BasicConv2d(256, 256, 3, padding=1),
            BasicConv2d(256, 256, 3, stride=2),
        ])

    def forward(self, x, dtype=None):
        return torch.cat([_chain(self.branch0, x, dtype), _chain(self.branch1, x, dtype),
                          _chain(self.branch2, x, dtype), F.max_pool2d(x, 3, 2)], dim=1)


class InceptionResnetV1(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.conv2d_4b = BasicConv2d(192, 256, 3, stride=2)
        self.repeat_1 = nn.ModuleList([Block35() for _ in range(5)])
        self.mixed_6a = Mixed6a()
        self.repeat_2 = nn.ModuleList([Block17() for _ in range(10)])
        self.mixed_7a = Mixed7a()
        self.repeat_3 = nn.ModuleList([Block8() for _ in range(5)])
        self.block8 = Block8(scale=1.0, no_relu=True)
        self.last_linear = nn.Linear(1792, 512, bias=False)
        self.last_bn = L.FrozenBN(512)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                normalize: bool = True) -> torch.Tensor:
        """x: (N, H, W, 3) float crops (the reference feeds [0, 1] crops with
        no standardization).  Returns (N, 512) embeddings."""
        h = self.conv2d_1a(L.to_nchw(x), dtype)
        h = self.conv2d_2a(h, dtype)
        h = self.conv2d_2b(h, dtype)
        h = F.max_pool2d(h, 3, 2)
        for name in ("conv2d_3b", "conv2d_4a", "conv2d_4b"):
            h = getattr(self, name)(h, dtype)
        for blk in self.repeat_1:
            h = blk(h, dtype)
        h = self.mixed_6a(h, dtype)
        for blk in self.repeat_2:
            h = blk(h, dtype)
        h = self.mixed_7a(h, dtype)
        for blk in self.repeat_3:
            h = blk(h, dtype)
        h = self.block8(h, dtype)
        h = h.mean(dim=(2, 3))
        ll = self.last_linear
        # A column-split projection (parallel.sharding.tp_shard_facenet)
        # computes its own slices.
        h = L.dense(ll, h, dtype) if isinstance(ll, nn.Linear) else ll(h, dtype)
        h = self.last_bn(h)
        return L.l2_normalize(h) if normalize else h
