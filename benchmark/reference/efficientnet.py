"""The plain reference of the DFDC winner's classifier net: timm's
``tf_efficientnet_b7_ns`` (arXiv:1905.11946) as the encoder of the
solution's ``DeepFakeClassifier`` (github.com/selimsef/dfdc_deepfake_challenge,
``training/zoo/classifiers.py``): features, global average pooling,
``Linear(2560, 1)``.

Plain ``torch`` in float32 with the batchnorms unfolded (eps 1e-3),
TensorFlow's "same" padding (``F.pad``, asymmetric where the stride is
2), SiLU, squeeze-excitation on the block's mid channels reducing to a
quarter of its input channels, and a residual where the stride is 1 and
the widths agree.  Every convolution and dense operand goes through
``layers.operand``, so that ``fp8_matmuls()`` makes this the control.
Widths: a 64-channel stride-2 stem; stages of 4, 7, 7, 10, 10, 13, 4
blocks, 32, 48, 80, 160, 224, 384, 640 channels, kernels 3, 3, 5, 3, 5, 5,
3, strides 1, 2, 2, 2, 1, 2, 1, expansion 6 (1 in the first stage); a 1x1
head to 2560.  The module names are timm's, so a param tree loads by name
(``params``-style: conv ``{"w": HWIO, "b"}``, dense ``{"w": (in, out),
"b"}``, batchnorm ``{"gamma", "beta", "mean", "var"}``).  Dropout and
drop-path are inference no-ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import FrozenBN, operand

# (repeats, kernel, stride of the first block, expansion, output channels)
STAGES = ((4, 3, 1, 1, 32), (7, 3, 2, 6, 48), (7, 5, 2, 6, 80), (10, 3, 2, 6, 160),
          (10, 5, 1, 6, 224), (13, 5, 2, 6, 384), (4, 3, 1, 6, 640))
STEM, HEAD = 64, 2560


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``m`` with TensorFlow's "same" padding, its operands through
    ``operand``."""
    k, s = m.kernel_size[0], m.stride[0]
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad's order: W, then H
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads)
    return F.conv2d(operand(x, torch.float32), operand(m.weight, torch.float32), m.bias, s, 0,
                    1, m.groups)


class SE(nn.Module):
    def __init__(self, chs, rd):
        super().__init__()
        self.conv_reduce = nn.Conv2d(chs, rd, 1)
        self.conv_expand = nn.Conv2d(rd, chs, 1)

    def forward(self, h):
        s = F.silu(conv(self.conv_reduce, h.mean((2, 3), keepdim=True)))
        return h * torch.sigmoid(conv(self.conv_expand, s))


class Block(nn.Module):
    """An MBConv block: timm's ``DepthwiseSeparableConv`` (expansion 1:
    ``conv_dw``, ``bn1``, ``se``, ``conv_pw``, ``bn2``) or
    ``InvertedResidual`` (``conv_pw``, ``bn1``, ``conv_dw``, ``bn2``,
    ``se``, ``conv_pwl``, ``bn3``)."""

    def __init__(self, cin, cout, k, stride, e):
        super().__init__()
        self.e = e
        self.skip = stride == 1 and cin == cout
        mid = cin * e
        if e == 1:
            self.conv_dw = nn.Conv2d(cin, cin, k, stride, groups=cin, bias=False)
            self.bn1 = FrozenBN(cin)
            self.se = SE(cin, max(1, cin // 4))
            self.conv_pw = nn.Conv2d(cin, cout, 1, bias=False)
            self.bn2 = FrozenBN(cout)
        else:
            self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
            self.bn1 = FrozenBN(mid)
            self.conv_dw = nn.Conv2d(mid, mid, k, stride, groups=mid, bias=False)
            self.bn2 = FrozenBN(mid)
            self.se = SE(mid, max(1, cin // 4))
            self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
            self.bn3 = FrozenBN(cout)

    def last_bn(self) -> FrozenBN:
        return self.bn2 if self.e == 1 else self.bn3

    def forward(self, x, bn):
        if self.e == 1:
            h = F.silu(bn(self.bn1, conv(self.conv_dw, x)))
            h = bn(self.bn2, conv(self.conv_pw, self.se(h)))
        else:
            h = F.silu(bn(self.bn1, conv(self.conv_pw, x)))
            h = F.silu(bn(self.bn2, conv(self.conv_dw, h)))
            h = bn(self.bn3, conv(self.conv_pwl, self.se(h)))
        return h + x if self.skip else h


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_stem = nn.Conv2d(3, STEM, 3, 2, bias=False)
        self.bn1 = FrozenBN(STEM)
        stages, cin = [], STEM
        for repeats, k, s, e, cout in STAGES:
            blocks = []
            for i in range(repeats):
                blocks.append(Block(cin, cout, k, s if i == 0 else 1, e))
                cin = cout
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)
        self.conv_head = nn.Conv2d(cin, HEAD, 1, bias=False)
        self.bn2 = FrozenBN(HEAD)


class DeepFakeClassifier(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = Encoder()
        self.fc = nn.Linear(HEAD, 1)

    def forward(self, crops: torch.Tensor, calibrate: bool = False) -> torch.Tensor:
        """(N, H, W, 3) normalised RGB crops -> (N,) float32 logits.
        ``calibrate``: each batchnorm first takes, as its statistics, its
        input's batch mean per channel and the mean over channels of the
        batch variance (the seeded weights' calibration)."""
        def bn(m, y):
            if calibrate:
                m.mean.copy_(y.mean((0, 2, 3)))
                m.var.fill_(float(y.var((0, 2, 3), unbiased=False).mean()))
            return m(y)

        enc = self.encoder
        x = F.silu(bn(enc.bn1, conv(enc.conv_stem, crops.float().permute(0, 3, 1, 2))))
        for stage in enc.blocks:
            for blk in stage:
                x = blk(x, bn)
        x = F.silu(bn(enc.bn2, conv(enc.conv_head, x)))
        pooled = x.mean((2, 3))
        return (F.linear(operand(pooled, torch.float32), operand(self.fc.weight, torch.float32))
                + self.fc.bias)[:, 0]

    def residual_bns(self):
        return [blk.last_bn() for stage in self.encoder.blocks for blk in stage if blk.skip]
