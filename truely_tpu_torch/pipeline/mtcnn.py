"""Batched fixed-capacity MTCNN cascade (counterpart of
``truely_tpu/pipeline/mtcnn.py``).

The whole cascade runs over a batch of frames with fixed capacities and
validity masks: the area pyramid and the P-Net trunk per level, ONE exact
global top-k over every pyramid cell (boxes rebuilt from the flat cell
index), per-scale NMS grouped by level then cross-scale NMS, 24x24 area
crops and R-Net, 48x48 area crops and O-Net with 'min' NMS.  All four NMS
calls go through kernel K2.  The stage crops go through kernel K3 (one
integral image per frame step, both crops cut from it), or through kernel
K5 on the exact crop chain with ``use_fused_crops=1``.
``refine_faces`` is the track-propagated entry: stages 2-3 only, seeded
from a known box per frame (``refine_faces_multi``: T boxes per frame, the
multi-face tracks' seeds).

Numeric conventions of the upstream cascade are kept: (x - 127.5) / 128
normalization, the (2x+1)/scale cell-to-box mapping, stage-1 regression
without the +1 width, bbreg/rerec with +1, trunc-clamp crop bounds,
landmark mapping before the final regression.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from truely_tpu_torch.config import MTCNNConfig
from truely_tpu_torch.ops.boxes import bbreg, pad_crop_bounds, rerec
from truely_tpu_torch.ops.crop_area_fused import crop_resize_area_fused
from truely_tpu_torch.ops.nms import NEG_INF, nms_masked_batch
from truely_tpu_torch.ops.resize import (
    crop_area_integral, crop_resize_area_from_integral, resize_area, resize_area_u8,
)
from truely_tpu_torch.ops.topk import exact_topk_lastdim
from truely_tpu_torch.pipeline.pyramid import pyramid_schedule
from truely_tpu_torch.utils.profiling import span


class MTCNNNets(NamedTuple):
    pnet: nn.Module
    rnet: nn.Module
    onet: nn.Module


class Detections(NamedTuple):
    boxes: torch.Tensor      # (B, K, 4) f32 [x1, y1, x2, y2] image coords
    scores: torch.Tensor     # (B, K) f32 O-Net probabilities
    landmarks: torch.Tensor  # (B, K, 5, 2) f32 five-point landmarks
    valid: torch.Tensor      # (B, K) bool


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return (x.float() - 127.5) * 0.0078125


def _topk_gather(scores, valid, k_out, boxes):
    """Per-frame top-k by masked score (ties to the lower index), with the
    boxes gathered along.  Returns (scores, valid, boxes)."""
    masked = torch.where(valid, scores, NEG_INF)
    vals, idx = exact_topk_lastdim(masked, k_out)
    new_valid = vals > NEG_INF / 2
    taken = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
    return torch.where(new_valid, vals, 0.0), new_valid, taken


def _stage1(nets: MTCNNNets, frames: torch.Tensor, cfg: MTCNNConfig, dtype):
    """P-Net over the pyramid.  Returns (boxes, scores, valid) at capacity
    ``cfg.pnet_topk_total``, regression applied and squared."""
    b, h, w = frames.shape[:3]
    device = frames.device
    levels = pyramid_schedule(h, w, cfg.min_face_size, cfg.scale_factor)
    # bf16 production path: each level resamples the previous one.  float32
    # (the golden and parity runs) keeps the exact one-shot resample.  bf16
    # without the cascade resamples the frames with exact integer bin sums,
    # as the JAX package's int8 path does (``use_i8_resize``).
    cascade = cfg.pyramid_cascade and dtype == torch.bfloat16
    exact_u8 = not cascade and dtype == torch.bfloat16 and frames.dtype == torch.uint8
    probs, feats, offsets, wps, scales = [], [], [], [], []
    offset = 0
    src = frames
    for lvl in levels:
        with span("mtcnn.pyramid"):
            if cascade:
                scaled = resize_area(src, (lvl.height, lvl.width), dtype=dtype).contiguous()
                src = scaled
            elif exact_u8:
                scaled = resize_area_u8(frames, (lvl.height, lvl.width)).contiguous()
            else:
                scaled = resize_area(frames, (lvl.height, lvl.width)).to(dtype).contiguous()
        prob, feat = nets.pnet.trunk(_normalize(scaled), dtype)
        hp, wp = prob.shape[1], prob.shape[2]
        probs.append(prob.reshape(b, hp * wp))
        feats.append(feat.reshape(b, hp * wp, feat.shape[-1]))
        offsets.append(offset)
        wps.append(wp)
        scales.append(lvl.scale)
        offset += hp * wp

    probs_all = torch.cat(probs, dim=1)                 # (B, N)
    k_total = min(cfg.pnet_topk_total, probs_all.shape[1])
    scores, idx = exact_topk_lastdim(probs_all, k_total)
    valid = scores >= cfg.thresholds[0]

    # (level, y, x) of each selected cell from its flat index.
    offs = torch.tensor(offsets, dtype=torch.int64, device=device)
    lvl_id = torch.searchsorted(offs, idx.contiguous(), right=True) - 1
    wp_sel = torch.tensor(wps, dtype=torch.int64, device=device)[lvl_id]
    scale_sel = torch.tensor(scales, dtype=torch.float32, device=device)[lvl_id]
    cell = idx - offs[lvl_id]
    ys = (cell // wp_sel).to(torch.float32)
    xs = (cell % wp_sel).to(torch.float32)
    # Cell -> image box: stride 2, cell 12 (upstream mapping).
    boxes = torch.stack([
        torch.floor((2.0 * xs + 1.0) / scale_sel),
        torch.floor((2.0 * ys + 1.0) / scale_sel),
        torch.floor((2.0 * xs + 12.0) / scale_sel),
        torch.floor((2.0 * ys + 12.0) / scale_sel),
    ], dim=-1)
    # Gather the selected cells' trunk features level by level.
    feat_sel = torch.zeros((b, k_total, feats[0].shape[-1]), dtype=feats[0].dtype, device=device)
    for li, f in enumerate(feats):
        local = (idx - offsets[li]).clamp(0, f.shape[1] - 1)
        g = torch.gather(f, 1, local[..., None].expand(-1, -1, f.shape[-1]))
        feat_sel = torch.where((lvl_id == li)[..., None], g, feat_sel)
    regs = nets.pnet.reg_from_features(feat_sel, dtype)

    # Per-scale NMS (same-level pairs only), then cross-scale NMS.
    keep = nms_masked_batch(boxes, scores, valid, iou_threshold=cfg.nms_thresholds[0],
                            max_rounds=cfg.nms_max_rounds, groups=lvl_id)
    valid = valid & keep
    keep = nms_masked_batch(boxes, scores, valid, iou_threshold=cfg.nms_thresholds[1],
                            max_rounds=cfg.nms_max_rounds)
    valid = valid & keep
    # Stage-1 regression (upstream w = x2 - x1, no +1 here), then square.
    regw = (boxes[..., 2] - boxes[..., 0])[..., None]
    regh = (boxes[..., 3] - boxes[..., 1])[..., None]
    shift = regs * torch.cat([regw, regh, regw, regh], dim=-1)
    return rerec(boxes + shift), scores, valid


def crop_quant(cfg: MTCNNConfig, frames: torch.Tensor, dtype) -> int:
    """Stage-crop snap grid: ``stage_crop_quant`` on the bf16 production
    path when it divides the frame, else 1 (exact crops)."""
    q = cfg.stage_crop_quant
    h, w = frames.shape[1], frames.shape[2]
    if q > 1 and dtype == torch.bfloat16 and frames.dtype == torch.uint8 and not (h % q or w % q):
        return q
    return 1


class CropSource(NamedTuple):
    """What the stage crops read, prepared once per frame step.  Without an
    integral kernel K5 cuts the crops from ``frames`` themselves (the
    ``planar`` copy of the frames that K5 once read is gone)."""

    frames: torch.Tensor              # (B, H, W, 3) uint8
    quant: int                        # stage-crop snap grid (1 = exact)
    integral: Optional[torch.Tensor]  # (B, H/q+1, W/q+1, 3) int32 for kernel K3, or None


def prep_crop_frames(frames: torch.Tensor, cfg: MTCNNConfig, dtype) -> CropSource:
    """The crop quant and what the crop kernel reads, made once per frame
    step and shared by both stage crops (counterpart of
    ``_prep_crop_frames``): with ``use_fused_crops == 1`` on exact crops
    nothing (kernel K5 reads the frames), else the integral image of kernel
    K3."""
    quant = crop_quant(cfg, frames, dtype)
    if cfg.use_fused_crops == 1 and quant == 1:
        return CropSource(frames, quant, None)
    return CropSource(frames, quant, crop_area_integral(frames, quant))


def _stage_crops(src: CropSource, boxes, out_size):
    """K5 from the frames; else K3 from the integral (on the snapped grid
    when q > 1)."""
    h, w = src.frames.shape[1], src.frames.shape[2]
    bounds = pad_crop_bounds(boxes, w, h)
    if src.integral is None:
        return crop_resize_area_fused(src.frames, bounds, out_size, src_hw=(h, w))
    return crop_resize_area_from_integral(src.integral, bounds, out_size, quant=src.quant)


def _stages23(nets: MTCNNNets, src: CropSource, boxes, scores, valid, cfg: MTCNNConfig,
              *, k2: int, k3: int, dtype) -> Detections:
    """R-Net refine and O-Net score/landmarks on a candidate set: the shared
    tail of full detection and of track-propagated refinement."""
    b = src.frames.shape[0]

    scores, valid, boxes = _topk_gather(scores, valid, k2, boxes)
    crops = _stage_crops(src, boxes, 24)
    prob, reg = nets.rnet(_normalize(crops.reshape(b * k2, 24, 24, 3)), dtype)
    prob = prob.reshape(b, k2)
    valid = valid & (prob > cfg.thresholds[1])
    scores = prob
    keep = nms_masked_batch(boxes, scores, valid, iou_threshold=cfg.nms_thresholds[2],
                            max_rounds=cfg.nms_max_rounds)
    valid = valid & keep
    boxes = rerec(bbreg(boxes, reg.reshape(b, k2, 4)))

    scores, valid, boxes = _topk_gather(scores, valid, k3, boxes)
    crops = _stage_crops(src, boxes, 48)
    prob, reg, lmk = nets.onet(_normalize(crops.reshape(b * k3, 48, 48, 3)), dtype)
    prob = prob.reshape(b, k3)
    lmk = lmk.reshape(b, k3, 10)
    valid = valid & (prob > cfg.thresholds[2])
    scores = torch.where(valid, prob, 0.0)
    # Landmarks map through the PRE-regression box with +1 sides, -1 offset.
    wi = boxes[..., 2] - boxes[..., 0] + 1.0
    hi = boxes[..., 3] - boxes[..., 1] + 1.0
    pts_x = wi[..., None] * lmk[..., 0:5] + boxes[..., 0:1] - 1.0
    pts_y = hi[..., None] * lmk[..., 5:10] + boxes[..., 1:2] - 1.0
    landmarks = torch.stack([pts_x, pts_y], dim=-1)
    boxes = bbreg(boxes, reg.reshape(b, k3, 4))
    keep = nms_masked_batch(boxes, scores, valid, iou_threshold=cfg.nms_thresholds[3],
                            method="min", max_rounds=cfg.nms_max_rounds)
    return Detections(boxes=boxes, scores=scores, landmarks=landmarks, valid=valid & keep)


def detect_faces(nets: MTCNNNets, frames: torch.Tensor, cfg: MTCNNConfig = MTCNNConfig(),
                 *, dtype=torch.bfloat16) -> Detections:
    """The full cascade on a (B, H, W, 3) uint8 frame batch (the reference
    feeds BGR): the span ``mtcnn.cascade``, each pyramid level's resample
    the span ``mtcnn.pyramid`` inside it."""
    with span("mtcnn.cascade"):
        boxes, scores, valid = _stage1(nets, frames, cfg, dtype)
        k2 = min(cfg.rnet_capacity, boxes.shape[1])
        return _stages23(nets, prep_crop_frames(frames, cfg, dtype), boxes, scores, valid, cfg,
                         k2=k2, k3=min(cfg.onet_capacity, k2), dtype=dtype)


# Refinement candidates: concentric squares around the seed box at these
# scales.  Four fill the capacity; the largest tolerates about half a side
# of face motion between keyframes, and O-Net's regression re-localizes
# within a candidate.
PROPAGATE_SCALES = (1.0, 1.3, 1.65, 2.0)


def refine_faces(nets: MTCNNNets, frames: torch.Tensor, seed_boxes: torch.Tensor,
                 seed_valid: torch.Tensor, cfg: MTCNNConfig = MTCNNConfig(),
                 *, dtype=torch.bfloat16) -> Detections:
    """Track-propagated detection: stages 2-3 only, seeded from one known
    box per frame (seed_boxes (B, 4) f32, seed_valid (B,) bool).  The
    candidates are concentric squares at ``PROPAGATE_SCALES`` with
    descending placeholder scores (tightest first, so the top-k gather
    keeps their order); R-Net and O-Net re-score, refine and can reject
    them.  A frame whose seed is not valid yields no detection."""
    return refine_faces_multi(nets, frames, seed_boxes[:, None], seed_valid[:, None], cfg,
                              dtype=dtype)


def refine_faces_multi(nets: MTCNNNets, frames: torch.Tensor, seed_boxes: torch.Tensor,
                       seed_valid: torch.Tensor, cfg: MTCNNConfig = MTCNNConfig(),
                       *, dtype=torch.bfloat16) -> Detections:
    """Track-propagated detection with T seeds per frame (seed_boxes
    (B, T, 4) f32, seed_valid (B, T) bool; ``refine_faces`` is T = 1):
    each seed spawns the ``PROPAGATE_SCALES`` candidates, seed-major, a
    (B, T·C) candidate set with descending placeholder scores, and stages
    2-3 refine, re-score and cross-suppress them, so candidates of two
    seeds on one face merge under the per-frame NMS.  Invalid seed slots
    contribute nothing.  The span ``mtcnn.cascade``."""
    b, t = seed_boxes.shape[:2]
    c = len(PROPAGATE_SCALES)
    with span("mtcnn.cascade"):
        sq = rerec(seed_boxes)
        cx = (sq[..., 0] + sq[..., 2]) * 0.5
        cy = (sq[..., 1] + sq[..., 3]) * 0.5
        side = sq[..., 2] - sq[..., 0]
        cands = []
        for s in PROPAGATE_SCALES:
            half = side * (0.5 * s)
            cands.append(torch.stack([cx - half, cy - half, cx + half, cy + half], dim=-1))
        boxes = torch.stack(cands, dim=2).reshape(b, t * c, 4)            # seed-major
        valid = seed_valid[:, :, None].expand(b, t, c).reshape(b, t * c)
        ranks = 1.0 - 0.01 * torch.arange(t * c, dtype=torch.float32, device=frames.device)
        scores = torch.where(valid, ranks[None, :], 0.0)
        return _stages23(nets, prep_crop_frames(frames, cfg, dtype), boxes, scores, valid, cfg,
                         k2=t * c, k3=t * c, dtype=dtype)


def select_primary_face(det: Detections, *, largest: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One face per frame: the largest area (facenet_pytorch
    select_largest=True) or the highest score.  Returns (box (B, 4),
    score (B,), has_face (B,))."""
    if largest:
        key = (det.boxes[..., 2] - det.boxes[..., 0]) * (det.boxes[..., 3] - det.boxes[..., 1])
    else:
        key = det.scores
    key = torch.where(det.valid, key, -torch.inf)
    idx = torch.argmax(key, dim=1)  # first maximum, as jnp.argmax
    box = torch.gather(det.boxes, 1, idx[:, None, None].expand(-1, 1, 4))[:, 0]
    score = torch.gather(det.scores, 1, idx[:, None])[:, 0]
    return box, score, det.valid.any(dim=1)
