"""The DFDC winner's classifier on the multi-face path
(github.com/selimsef/dfdc_deepfake_challenge): each segment's valid face
crops (kernel K7, ``ops/crop_classifier.py``) through an ensemble of
EfficientNet-B7 nets (``models/efficientnet.py``), and a video's score,
the mean over the nets of each net's ``confident_strategy`` over the
probabilities of all of its crops (``predict_on_video``).

The stage runs on the boxes and the ``valid & ok`` mask that go to the
track fold, on a segment's first ``n_valid`` rows (the host knows the
count: no sync), and keeps the logits on the device; the host waits for
them once, with the final scores (``Collector.finish``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from truely_tpu_torch.config import ClassifierConfig
from truely_tpu_torch.models.efficientnet import (
    NAME, FoldedClassifier, classifier_from_tree, init_classifier,
)
from truely_tpu_torch.utils.profiling import span

# Members without given weights take the seeded init, member i seed SEED + i.
SEED = 107
# predict_on_video's score of a video without a face crop.
NO_FACE_SCORE = 0.5


class Classified(NamedTuple):
    """A video's classifier result, N sampled frames of T track slots."""

    score: float                # the ensemble's score
    member_scores: np.ndarray   # (M,) each net's confident_strategy
    logits: np.ndarray          # (M, N, T) float32
    probs: np.ndarray           # (M, N, T) float32 sigmoid(logits)
    mask: np.ndarray            # (N, T) bool: the slots that held a crop
    boxes: np.ndarray           # (N, T, 4) float32: the boxes they came from


def confident_strategy(pred, t: float = 0.8, real: float = 0.2, min_fakes: int = 11) -> float:
    """The solution's ``confident_strategy`` (``kernel_utils.py``), with its
    thresholds as arguments: more than ``min_fakes`` crops, and more than
    ``len // 2.5`` (a float floor), above ``t``: their mean; else, more than
    90% of the crops below ``real``: their mean; else the mean of all."""
    pred = np.array(pred)
    sz = len(pred)
    fakes = np.count_nonzero(pred > t)
    if fakes > sz // 2.5 and fakes > min_fakes:
        return np.mean(pred[pred > t])
    elif np.count_nonzero(pred < real) > 0.9 * sz:
        return np.mean(pred[pred < real])
    else:
        return np.mean(pred)


def video_score(probs: np.ndarray, mask: np.ndarray, cfg: ClassifierConfig):
    """(score, member scores) of (M, N, T) probabilities over the (N, T)
    crops of a video: ``predict_on_video``'s mean over the nets of each
    net's strategy; NO_FACE_SCORE without a crop."""
    if not mask.any():
        return NO_FACE_SCORE, np.full(probs.shape[0], NO_FACE_SCORE, np.float32)
    members = np.array([confident_strategy(p[mask], cfg.fake_threshold, cfg.real_threshold,
                                           cfg.min_fakes) for p in probs])
    return float(np.mean(members)), members


def load_members(cfg: ClassifierConfig, trees: Optional[Sequence],
                 device) -> List[FoldedClassifier]:
    """The ensemble, folded in the compute dtype on ``device``: from
    ``trees`` (one param tree per member) where given, else the seeded
    init (``init_classifier``)."""
    if cfg.net != NAME:
        raise ValueError(f"classifier net {cfg.net!r}: only {NAME!r} is built")
    if trees is not None and len(trees) != cfg.ensemble:
        raise ValueError(f"{len(trees)} classifier trees for an ensemble of {cfg.ensemble}")
    dtype = getattr(torch, cfg.compute_dtype)
    modules = ([classifier_from_tree(t) for t in trees] if trees is not None
               else [init_classifier(SEED + i) for i in range(cfg.ensemble)])
    return [FoldedClassifier(m, dtype, device) for m in modules]


class Collector:
    """One video's classifier outputs: ``add`` runs the stage on a segment
    (through ``detector.classify``), ``finish`` fetches and scores."""

    def __init__(self, detector):
        self.detector = detector
        self.logits: List[torch.Tensor] = []
        self.boxes: List[torch.Tensor] = []
        self.mask: List[torch.Tensor] = []

    def add(self, dev: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor, n_valid: int,
            yuv: bool) -> None:
        if n_valid == 0:
            return
        self.logits.append(self.detector.classify(dev, boxes, valid, n_valid, yuv))
        self.boxes.append(boxes[:n_valid])
        self.mask.append(valid[:n_valid])

    def finish(self) -> Classified:
        det = self.detector
        cfg = det.config.classifier
        m, t = len(det.classifier), det.config.max_tracks
        with span("classifier.score"):
            if self.logits:
                logits = torch.cat(self.logits, 1).float()
                probs, logits, mask, boxes = (x.cpu().numpy() for x in (
                    torch.sigmoid(logits), logits, torch.cat(self.mask),
                    torch.cat(self.boxes).float()))
            else:
                logits = probs = np.zeros((m, 0, t), np.float32)
                mask, boxes = np.zeros((0, t), bool), np.zeros((0, t, 4), np.float32)
            score, members = video_score(probs, mask, cfg)
        det.classified_crops += int(mask.sum())
        return Classified(score, members, logits, probs, mask, boxes)
