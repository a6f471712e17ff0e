"""EfficientNet-B7 as the DFDC winner's classifier runs it: the encoder
``tf_efficientnet_b7_ns`` (timm; arXiv:1905.11946) inside the solution's
``DeepFakeClassifier`` (github.com/selimsef/dfdc_deepfake_challenge,
``training/zoo/classifiers.py``): the encoder's features, global average
pooling and ``Linear(2560, 1)``, one logit a face crop.

The published widths: width 2.0 and depth 3.1 over the B0 base, so a
64-channel stem of stride 2, seven stages of 4, 7, 7, 10, 10, 13 and 4
MBConv blocks (55) with 32, 48, 80, 160, 224, 384 and 640 output channels,
kernels 3, 3, 5, 3, 5, 5, 3, strides 1, 2, 2, 2, 1, 2, 1 (on the first
block of a stage, in its depthwise convolution) and expansion 6 (1 and no
expand convolution in the first stage), squeeze-excitation reducing to a
quarter of a block's input channels, SiLU, and a 1x1 head to 2560.  A
block adds its input where its stride is 1 and its widths agree.  The
``tf_`` weights keep TensorFlow's "same" padding, asymmetric where the
stride is 2 (``same_pad``), and batchnorm eps 1e-3.

``DeepFakeClassifier`` is the loading form: timm's module names (a param
tree of the layouts of ``models/weights.py`` loads into it by name), its
batchnorms unfolded.  ``FoldedClassifier`` is what runs: every batchnorm
folded into the convolution before it, the weights in the compute dtype
and channels-last.  Departures from the published model: bf16 where the
solution runs ``.half()``; the folded batchnorms; dropout and drop-path,
inference no-ops, left out.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from truely_tpu_torch.models.layers import FrozenBN

NAME = "tf_efficientnet_b7_ns"
STEM, HEAD, FEATURES = 64, 2560, 2560
# (repeats, kernel, stride of the first block, expansion, output channels)
STAGES = ((4, 3, 1, 1, 32), (7, 3, 2, 6, 48), (7, 5, 2, 6, 80), (10, 3, 2, 6, 160),
          (10, 5, 1, 6, 224), (13, 5, 2, 6, 384), (4, 3, 1, 6, 640))


def same_pad(size: int, kernel: int, stride: int):
    """TensorFlow's "same" padding of one axis: (before, after)."""
    pad = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return pad // 2, pad - pad // 2


def block_specs():
    """(in channels, out channels, kernel, stride, expansion) of each of
    the 55 blocks, stage by stage."""
    specs, cin = [], STEM
    for repeats, k, s, e, cout in STAGES:
        stage = []
        for i in range(repeats):
            stage.append((cin, cout, k, s if i == 0 else 1, e))
            cin = cout
        specs.append(stage)
    return specs


def _conv(cin, cout, k, stride=1, groups=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride=stride, groups=groups, bias=bias)


class SqueezeExcite(nn.Module):
    def __init__(self, chs: int, rd: int):
        super().__init__()
        self.conv_reduce = _conv(chs, rd, 1, bias=True)
        self.conv_expand = _conv(rd, chs, 1, bias=True)


class DepthwiseSeparableConv(nn.Module):
    """The first stage's block: depthwise, SE, pointwise (expansion 1)."""

    def __init__(self, cin, cout, k, stride, _e):
        super().__init__()
        self.conv_dw = _conv(cin, cin, k, stride, groups=cin)
        self.bn1 = FrozenBN(cin)
        self.se = SqueezeExcite(cin, max(1, cin // 4))
        self.conv_pw = _conv(cin, cout, 1)
        self.bn2 = FrozenBN(cout)


class InvertedResidual(nn.Module):
    """Expand, depthwise, SE, project."""

    def __init__(self, cin, cout, k, stride, e):
        super().__init__()
        mid = cin * e
        self.conv_pw = _conv(cin, mid, 1)
        self.bn1 = FrozenBN(mid)
        self.conv_dw = _conv(mid, mid, k, stride, groups=mid)
        self.bn2 = FrozenBN(mid)
        self.se = SqueezeExcite(mid, max(1, cin // 4))
        self.conv_pwl = _conv(mid, cout, 1)
        self.bn3 = FrozenBN(cout)


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_stem = _conv(3, STEM, 3, 2)
        self.bn1 = FrozenBN(STEM)
        self.blocks = nn.ModuleList(
            nn.ModuleList((DepthwiseSeparableConv if spec[4] == 1 else InvertedResidual)(*spec)
                          for spec in stage)
            for stage in block_specs())
        self.conv_head = _conv(STAGES[-1][-1], HEAD, 1)
        self.bn2 = FrozenBN(HEAD)


def conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` in float32 with TensorFlow's "same" padding."""
    k, s = conv.kernel_size[0], conv.stride[0]
    (t, b), (le, r) = (same_pad(n, k, s) for n in x.shape[2:])
    return F.conv2d(F.pad(x, (le, r, t, b)), conv.weight, conv.bias, s, 0, 1, conv.groups)


class DeepFakeClassifier(nn.Module):
    """The loading form: ``encoder`` and ``fc`` as the solution names them.
    Its ``forward`` is the unfolded net in float32, for the seeded init's
    batchnorm statistics and the tests."""

    def __init__(self):
        super().__init__()
        self.encoder = Encoder()
        self.fc = nn.Linear(FEATURES, 1)

    def forward(self, crops: torch.Tensor, calibrate: bool = False) -> torch.Tensor:
        """(N, H, W, 3) crops -> (N,) logits.  ``calibrate``: each
        batchnorm first takes its input's batch mean per channel, and the
        mean over its channels of their batch variance, as its statistics."""
        def bn(m: FrozenBN, y):
            if calibrate:
                m.mean.copy_(y.mean((0, 2, 3)))
                m.var.fill_(float(y.var((0, 2, 3), unbiased=False).mean()))
            return m(y)

        enc = self.encoder
        x = F.silu(bn(enc.bn1, conv_same(enc.conv_stem, crops.float().permute(0, 3, 1, 2))))
        for stage in enc.blocks:
            for blk in stage:
                ir = isinstance(blk, InvertedResidual)
                h = F.silu(bn(blk.bn1, conv_same(blk.conv_pw, x))) if ir else x
                h = F.silu(bn(blk.bn2 if ir else blk.bn1, conv_same(blk.conv_dw, h)))
                s = F.silu(conv_same(blk.se.conv_reduce, h.mean((2, 3), keepdim=True)))
                h = h * torch.sigmoid(conv_same(blk.se.conv_expand, s))
                h = bn(blk.bn3, conv_same(blk.conv_pwl, h)) if ir else bn(
                    blk.bn2, conv_same(blk.conv_pw, h))
                x = h + x if h.shape == x.shape and blk.conv_dw.stride[0] == 1 else h
        x = F.silu(bn(enc.bn2, conv_same(enc.conv_head, x)))
        return self.fc(x.mean((2, 3)))[:, 0]


# ---------------------------------------------------------------------------
# The folded net


class Conv(NamedTuple):
    weight: torch.Tensor  # (O, I/groups, k, k) compute dtype, channels-last
    bias: torch.Tensor    # (O,) compute dtype
    stride: int
    groups: int


class Block(NamedTuple):
    expand: Optional[Conv]
    dw: Conv
    se_reduce: Conv
    se_expand: Conv
    project: Conv
    skip: bool


def _fold(conv: nn.Conv2d, bn: Optional[FrozenBN], dtype, device) -> Conv:
    """``conv`` with ``bn`` folded in, in numpy's float32 as
    ``models/weights.fold_batchnorm`` folds: w * gamma / sqrt(var + eps) per
    output channel, bias beta - mean * gamma / sqrt(var + eps)."""
    w = conv.weight.detach().cpu().numpy()
    b = (conv.bias.detach().cpu().numpy() if conv.bias is not None
         else np.zeros(w.shape[0], np.float32))
    if bn is not None:
        gamma, beta, mean, var = (t.detach().cpu().numpy() for t in (bn.gamma, bn.beta, bn.mean,
                                                                      bn.var))
        scale = gamma / np.sqrt(var + np.float32(bn.eps))
        w = w * scale[:, None, None, None]
        b = beta - mean * scale + b * scale
    weight = torch.from_numpy(np.ascontiguousarray(w)).to(device, dtype)
    return Conv(weight.contiguous(memory_format=torch.channels_last),
                torch.from_numpy(np.ascontiguousarray(b)).to(device, dtype),
                conv.stride[0], conv.groups)


def _apply(c: Conv, x: torch.Tensor) -> torch.Tensor:
    k = c.weight.shape[-1]
    if k > 1:
        (t, bo), (le, r) = (same_pad(n, k, c.stride) for n in x.shape[2:])
        if t == bo and le == r:
            return F.conv2d(x, c.weight, c.bias, c.stride, (t, le), 1, c.groups)
        x = F.pad(x, (le, r, t, bo))
    return F.conv2d(x, c.weight, c.bias, c.stride, 0, 1, c.groups)


class FoldedClassifier:
    """The classifier as it runs: (N, H, W, 3) normalised crops in the
    compute dtype (channels-last: NHWC in memory) to (N,) float32 logits:
    the convolutions and activations in the compute dtype, the residual
    sums, the pooled features and the logit in float32."""

    def __init__(self, module: DeepFakeClassifier, dtype=torch.bfloat16, device="cpu"):
        enc = module.encoder
        self.dtype = dtype
        self.stem = _fold(enc.conv_stem, enc.bn1, dtype, device)
        self.blocks: List[Block] = []
        for stage, specs in zip(enc.blocks, block_specs()):
            for blk, (cin, cout, _k, stride, e) in zip(stage, specs):
                expand = _fold(blk.conv_pw, blk.bn1, dtype, device) if e > 1 else None
                dw = _fold(blk.conv_dw, blk.bn2 if e > 1 else blk.bn1, dtype, device)
                project = (_fold(blk.conv_pwl, blk.bn3, dtype, device) if e > 1
                           else _fold(blk.conv_pw, blk.bn2, dtype, device))
                self.blocks.append(Block(
                    expand, dw, _fold(blk.se.conv_reduce, None, dtype, device),
                    _fold(blk.se.conv_expand, None, dtype, device), project,
                    stride == 1 and cin == cout))
        self.head = _fold(enc.conv_head, enc.bn2, dtype, device)
        self.fc_weight = module.fc.weight.detach().to(device, dtype)
        self.fc_bias = module.fc.bias.detach().to(device, torch.float32)

    def block(self, blk: Block, x: torch.Tensor) -> torch.Tensor:
        """One MBConv block on NCHW float32 activations (the residual sums
        stay in float32, as in ``models/layers.py``; the block's
        convolutions and activations run in the compute dtype)."""
        h = x.to(self.dtype)
        if blk.expand is not None:
            h = F.silu(_apply(blk.expand, h), inplace=True)
        h = F.silu(_apply(blk.dw, h), inplace=True)
        s = F.silu(_apply(blk.se_reduce, h.mean((2, 3), keepdim=True)), inplace=True)
        h = h * torch.sigmoid(_apply(blk.se_expand, s))
        h = _apply(blk.project, h).float()
        return h + x if blk.skip else h

    def __call__(self, crops: torch.Tensor) -> torch.Tensor:
        x = F.silu(_apply(self.stem, crops.to(self.dtype).permute(0, 3, 1, 2)),
                   inplace=True).float()
        for blk in self.blocks:
            x = self.block(blk, x)
        x = F.silu(_apply(self.head, x.to(self.dtype)), inplace=True)
        pooled = x.mean((2, 3), dtype=torch.float32)
        return F.linear(pooled.to(self.dtype), self.fc_weight).float()[:, 0] + self.fc_bias


# The seeded init (``init_classifier``).  A B7 of random weights is chaotic:
# with unit batchnorm scales its residual sums grow without bound on some
# crops and bf16 rounding moves its logit by as much as the logit itself
# (at scales 0.2 and 0.05 on the residual branches still by a quarter of the
# logits' spread on some crops).  So every batchnorm scale is BN_GAMMA
# (SiLU nearly linear), the last batchnorm of each residual branch
# RESIDUAL_GAMMA, each batchnorm's
# statistics are those of its input over seeded calibration crops
# (``calibration_crops``, blocks of CALIBRATION_BLOCK px of seeded values in
# [-2, 2], about the range of normalised pixels), and the logit's weights
# are scaled by LOGIT_SCALE, so that logits spread by about 1 over crops.
BN_GAMMA, RESIDUAL_GAMMA, LOGIT_SCALE = 0.1, 0.02, 48.0
CALIBRATION_CROPS, CALIBRATION_SIZE, CALIBRATION_BLOCK = 8, 64, 8


def calibration_crops(seed: int, n: int = CALIBRATION_CROPS, size: int = CALIBRATION_SIZE,
                      block: int = CALIBRATION_BLOCK) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    cells = torch.rand((n, -(-size // block), -(-size // block), 3), generator=gen) * 4 - 2
    return cells.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :size, :size]


def residual_bns(module: DeepFakeClassifier) -> List[FrozenBN]:
    """The last batchnorm of every block that adds its input."""
    return [blk.bn3 if e > 1 else blk.bn2
            for stage, specs in zip(module.encoder.blocks, block_specs())
            for blk, (cin, cout, _k, stride, e) in zip(stage, specs)
            if stride == 1 and cin == cout]


def init_classifier(seed: int, size: int = CALIBRATION_SIZE) -> DeepFakeClassifier:
    """Seeded init: conv and dense weights N(0, 2/fan_in) (the distribution
    of ``models/weights.init_params``), zero biases, batchnorm scales
    BN_GAMMA and RESIDUAL_GAMMA, shifts 0, statistics measured on
    ``calibration_crops(seed)`` at ``size`` px, the logit's weights times
    LOGIT_SCALE."""
    module = DeepFakeClassifier()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, 1.0, generator=gen).mul_(math.sqrt(2.0 / m.weight[0].numel()))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FrozenBN):
                m.gamma.fill_(BN_GAMMA)
        for bn in residual_bns(module):
            bn.gamma.fill_(RESIDUAL_GAMMA)
        module.fc.weight.mul_(LOGIT_SCALE)
        module(calibration_crops(seed, size=size), calibrate=True)
    return module.eval()


def classifier_from_tree(tree) -> DeepFakeClassifier:
    """The loading form with the weights of a param tree (the layouts of
    ``models/weights.py``: conv ``{"w": HWIO, "b"}``, dense ``{"w": (in,
    out), "b"}``, batchnorm ``{"gamma", "beta", "mean", "var"}``)."""
    from truely_tpu_torch.models.weights import _load

    module = DeepFakeClassifier()
    n = _load(module, tree, NAME)
    if n != len(module.state_dict()):
        raise ValueError(f"{NAME}: tree sets {n} tensors, module has {len(module.state_dict())}")
    return module.eval()
