"""The model of the ``dfdc_b7_*`` configurations: the DFDC winner's
classifier (github.com/selimsef/dfdc_deepfake_challenge) on the FaceNet
model's multi-face detector.  Every valid face crop of the tracks' boxes,
grown by a third and centred on a 380x380 canvas, goes through an ensemble
of EfficientNet-B7 nets (``tf_efficientnet_b7_ns``, ``Linear(2560, 1)``),
and a clip's score is the mean over the nets of each net's
``confident_strategy`` over its crops.

What the harness asks of a model module (``models/facenet.py`` lists it),
with this model's answer:

- ``seeded_trees``: the FaceNet model's five nets, and the ensemble's
  members drawn from the seed on the device (``member_tree``);
- ``detector``: the port's ``Detector`` with ``DetectorConfig.classifier``
  set from the configuration's ``classifier`` object;
- ``entry``: ``analyze_i420_tracks``, whose result carries the
  classifier's ``Classified`` fourth;
- ``reference``: ``reference/dfdc.py``'s analysis, the FaceNet model's
  reference with the classifier on the crops of the boxes it folds;
- ``answer``: (the tracks' ``TrackResult``, the classifier's answer);
- ``check``: the FaceNet model's tracks numbers, ``logit_gap`` (the
  largest |logit difference| over the members and the crops of frames
  whose boxes agree: every slot's mask equal, and its box equal as the
  integers the crop truncates it to) and ``video_prob_gap`` (|score
  difference| over the clips whose boxes all agree);
- ``row_flops``, ``step_forms``: the FaceNet model's (the classifier's
  operations are counted apart, ``counts/dfdc.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from benchmark import spec
from benchmark.reference import dfdc as ref_dfdc

facenet = spec.model({"model": "facenet"})


def classifier_config(config: Mapping):
    """The port's ``ClassifierConfig`` of a configuration file (an
    ImportError on a port that has none)."""
    from truely_tpu_torch.config import ClassifierConfig

    return ClassifierConfig(**config["classifier"])


def calibration_crops(gen, n: int, size: int, device) -> torch.Tensor:
    """``n`` seeded crops like the canvases K7 makes of the mixes' frames:
    a centred rectangle of flat blocks of size/20 to size/6 px (the
    content's 20 px blocks after the resize) of uniform values in [-1.9,
    2.3] (the normalised range of its bytes), its short side a quarter to
    all of ``size``, on the normalised zero (the canvas's padding), wide on
    even crops and tall on odd ones."""
    zero = -torch.tensor(ref_dfdc.MEAN, device=device) / torch.tensor(ref_dfdc.STD, device=device)
    out = zero.expand(n, size, size, 3).clone()
    lo, hi = max(2, size // 20), max(3, size // 6)
    for i in range(n):
        b = int(torch.randint(lo, hi + 1, (1,), generator=gen, device=device))
        short = int(torch.randint(max(1, size // 4), size + 1, (1,), generator=gen, device=device))
        cells = torch.rand((-(-short // b), -(-size // b), 3), generator=gen, device=device)
        img = (cells * 4.2 - 1.9).repeat_interleave(b, 0).repeat_interleave(b, 1)[:short, :size]
        top = (size - short) // 2
        if i % 2 == 0:
            out[i, top:top + short] = img
        else:
            out[i, :, top:top + short] = img.transpose(0, 1)
    return out


def member_tree(seed: int, index: int, device, config: Mapping):
    """Member ``index``'s param tree, drawn on ``device`` from ``seed``:
    conv and dense weights N(0, 2/fan_in) in one draw, zero biases,
    batchnorm scales ``bn_gamma`` (``residual_gamma`` on the last of each
    residual branch), the logit's weights times ``logit_scale``, and each
    batchnorm's statistics those of its input over ``calibration_crops``
    seeded crops at the input size (``calibration_crops``; ``assumed``)."""
    from benchmark.reference.efficientnet import DeepFakeClassifier
    from benchmark.reference.params import tree_of

    a = config["assumed"]
    gen = torch.Generator(device=device).manual_seed(
        (seed * 8 + index + 1) % (1 << 63))
    net = DeepFakeClassifier().to(device)
    layers = [m for m in net.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    sizes = [m.weight.numel() for m in layers]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    offset = 0
    with torch.no_grad():
        for m, n in zip(layers, sizes):
            m.weight.copy_(draw[offset:offset + n].view_as(m.weight)
                           * math.sqrt(2.0 / m.weight[0].numel()))
            offset += n
            if m.bias is not None:
                m.bias.zero_()
        for m in net.modules():
            if hasattr(m, "gamma"):
                m.gamma.fill_(a["bn_gamma"])
        for bn in net.residual_bns():
            bn.gamma.fill_(a["residual_gamma"])
        net.fc.weight.mul_(a["logit_scale"])
        crops = calibration_crops(gen, a["calibration_crops"], config["classifier"]["input_size"],
                                  device)
        saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            net(crops, calibrate=True)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return tree_of(net)


def seeded_trees(seed: int, device, config: Mapping):
    classifier_config(config)  # a port without the classifier stops here
    return {"nets": facenet.seeded_trees(seed, device, config),
            "members": [member_tree(seed, i, device, config)
                        for i in range(config["classifier"]["ensemble"])]}


def detector(config: Mapping, trees, device, mesh):
    from truely_tpu_torch.config import DetectorConfig
    from truely_tpu_torch.pipeline.detector import Detector

    cfg = DetectorConfig(**facenet.detector_kwargs(config["detector"]),
                         classifier=classifier_config(config))
    return Detector(cfg, params=dict(trees["nets"], classifier=trees["members"]), device=device,
                    mesh=mesh)


def entry(program, config: Mapping):
    return program.analyze_i420_tracks


def reference(config: Mapping, trees, device, fps: int, rows: int):
    from benchmark.reference import analysis as ref
    from benchmark.reference.config import DetectorConfig as RefConfig

    ref_cfg = RefConfig(**facenet.detector_kwargs(config["detector"], reference=True))
    built = ref.build_nets(trees["nets"], device)
    members = [ref_dfdc.net_from_tree(t).to(device) for t in trees["members"]]
    return lambda frames: ref_dfdc.analyze_tracks(built, members, frames, fps, ref_cfg,
                                                  config["classifier"], yuv=True, device=device)


def answer(result):
    """(``TrackResult``, ``reference.dfdc.Classified``) of the program's
    (score, per-track scores, state, ``Classified``)."""
    got = result[3]
    return facenet.answer(tuple(result[:3])), ref_dfdc.Classified(
        float(got.score), np.asarray(got.logits, np.float32), np.asarray(got.mask, bool),
        np.asarray(got.boxes, np.float32))


def check(config: Mapping, got, want) -> Dict[str, float]:
    out = facenet.check(config, [g for g, _ in got], [w for w, _ in want])
    logit_gap = prob_gap = 0.0
    for (_, g), (_, w) in zip(got, want):
        if g.mask.shape != w.mask.shape or g.logits.shape != w.logits.shape:
            raise ValueError("the program and the reference classified different slots")
        boxes_agree = (np.trunc(g.boxes) == np.trunc(w.boxes)).all(-1)
        agree = ((g.mask == w.mask) & (boxes_agree | ~g.mask)).all(-1)   # (N,) frames
        sel = agree[:, None] & g.mask
        if sel.any():
            logit_gap = max(logit_gap, float(np.abs(g.logits[:, sel].astype(np.float64)
                                                    - w.logits[:, sel]).max()))
        if agree.all():
            prob_gap = max(prob_gap, abs(g.score - w.score))
    out["logit_gap"] = logit_gap
    out["video_prob_gap"] = prob_gap
    return out


row_flops = facenet.row_flops
step_forms = facenet.step_forms
