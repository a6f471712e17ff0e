"""The device steps of the detector: frozen copy of the step functions of
``truely_tpu_torch/pipeline/detector.py`` (``DetectorNets`` and
``FrameOutputs``, ``clamp_box`` to ``multiface_step_propagate_yuv``, ``Steps`` and
``steps_for``, without the
stream scheduler's refine steps), on the
plain versions of this package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from .config import DetectorConfig
from .mtcnn import (
    Detections, MTCNNNets, detect_faces, refine_faces, refine_faces_multi, select_primary_face,
)
from .resize import crop_resize_bilinear
from .topk import exact_topk_lastdim
from .yuv import i420_to_bgr


class DetectorNets(NamedTuple):
    mtcnn: MTCNNNets
    facenet: nn.Module
    landmark: nn.Module


class FrameOutputs(NamedTuple):
    """Per-frame device outputs of one batch."""

    box: torch.Tensor          # (B, 4) f32 raw detector box
    crop_bounds: torch.Tensor  # (B, 4) int32 clipped crop actually used
    has_face: torch.Tensor     # (B,) bool
    embedding: torch.Tensor    # (B, 512) f32
    landmarks68: torch.Tensor  # (B, 68, 2) f32 in crop-normalized coords




def clamp_box(box: torch.Tensor, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference crop semantics of (..., 4) boxes: trunc to int, clamp to
    the frame.  Returns the (..., 4) int32 bounds and whether each is
    non-degenerate (the clamp gate)."""
    bi = box.to(torch.int32)
    x0 = bi[..., 0].clamp_min(0)
    y0 = bi[..., 1].clamp_min(0)
    x1 = bi[..., 2].clamp_max(w)
    y1 = bi[..., 3].clamp_max(h)
    return torch.stack([x0, y0, x1, y1], dim=-1), (x1 > x0) & (y1 > y0)


def face_crops(frames: torch.Tensor, bounds: torch.Tensor, cfg: DetectorConfig) -> torch.Tensor:
    """(B, K, 4) clamped bounds -> (B·K, S, S, 3) FaceNet inputs: the
    bilinear crop (kernel K4) and the input scaling."""
    crops = crop_resize_bilinear(frames, bounds, cfg.crop_size)
    crops = crops.reshape((-1,) + tuple(crops.shape[2:]))
    if cfg.reference_compat:
        return crops * (1.0 / 255.0)   # torchvision to_tensor, no standardization
    return (crops - 127.5) * (1.0 / 128.0)


def embed_tail(nets: DetectorNets, frames: torch.Tensor, box: torch.Tensor,
               has_face: torch.Tensor, cfg: DetectorConfig, dtype) -> FrameOutputs:
    """The clamped box (``clamp_box``), the 80x80 bilinear crop (kernel K4),
    normalization, FaceNet embedding and the landmark head."""
    bounds, ok = clamp_box(box, frames.shape[1], frames.shape[2])
    has_face = has_face & ok
    crops = face_crops(frames, bounds[:, None, :], cfg)
    emb = nets.facenet(crops, dtype)
    lmk = nets.landmark(crops, dtype)
    return FrameOutputs(box=box, crop_bounds=bounds, has_face=has_face,
                        embedding=emb, landmarks68=lmk)


def to_frames(packed: torch.Tensor, cfg: DetectorConfig) -> torch.Tensor:
    """Packed I420 (B, 3H/2, W) uint8 -> the (B, H, W, 3) frames the steps
    take, by kernel K1 (bit-identical to cv2's BGR decode)."""
    return i420_to_bgr(packed, rgb=not cfg.reference_compat)


def frame_step(nets: DetectorNets, frames: torch.Tensor, cfg: DetectorConfig,
               dtype) -> FrameOutputs:
    """One batch of (B, H, W, 3) uint8 frames through the whole device step."""
    det = detect_faces(nets.mtcnn, frames, cfg.mtcnn, dtype=dtype)
    box, _score, has_face = select_primary_face(det, largest=cfg.mtcnn.select_largest)
    return embed_tail(nets, frames, box, has_face, cfg, dtype)


def frame_step_yuv(nets: DetectorNets, packed: torch.Tensor, cfg: DetectorConfig,
                   dtype) -> FrameOutputs:
    """The frame step on packed I420 (B, 3H/2, W) uint8, converted on the
    device by kernel K1 (``to_frames``).  Every ``*_yuv`` step is its
    step on ``to_frames(packed)``."""
    return frame_step(nets, to_frames(packed, cfg), cfg, dtype)


def frame_step_detect(nets: DetectorNets, frames: torch.Tensor, cfg: DetectorConfig,
                      dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cascade-only seed step of the keyframe batch: (box, has_face) equal to
    the full step's, embed tail's clamp gate included, without the
    embedding (each keyframe row's embedding comes from its segment's
    propagate step)."""
    det = detect_faces(nets.mtcnn, frames, cfg.mtcnn, dtype=dtype)
    box, _score, has_face = select_primary_face(det, largest=cfg.mtcnn.select_largest)
    _, ok = clamp_box(box, frames.shape[1], frames.shape[2])
    return box, has_face & ok


def frame_step_detect_yuv(nets: DetectorNets, packed: torch.Tensor, cfg: DetectorConfig,
                          dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    return frame_step_detect(nets, to_frames(packed, cfg), cfg, dtype)


def seed_rows(seeds: torch.Tensor, k: int, row0: int, b: int) -> torch.Tensor:
    """The per-row seeds of rows ``[row0, row0 + b)`` of a batch whose
    every group of ``k`` rows shares one seed: a data shard of the batch
    takes its rows by its global offset ``row0``."""
    return seeds.repeat_interleave(k, dim=0)[row0:row0 + b]


def keyframe_rows(k: int, row0: int, b: int, device) -> torch.Tensor:
    """Whether each row of ``[row0, row0 + b)`` is a keyframe (every k-th
    row of the whole batch)."""
    return (torch.arange(row0, row0 + b, device=device) % k) == 0


def frame_step_propagate(nets: DetectorNets, frames: torch.Tensor, seed_boxes: torch.Tensor,
                         seed_valid: torch.Tensor, cfg: DetectorConfig, dtype,
                         k: Optional[int] = None, row0: int = 0) -> FrameOutputs:
    """Track-propagated frame step: ``frames`` is a chronological batch whose
    every K-th row is a keyframe, ``seed_boxes``/``seed_valid`` the (B/K,)
    keyframe detections.  Keyframe rows pass their seed through (bit-equal
    to full detection); the rows between refine it (``refine_faces``).
    ``k`` overrides the config's interval (the "auto" ladder's rung).  On
    a data shard, ``frames`` holds rows ``[row0, row0 + B_shard)`` of the
    batch and the seeds are the whole batch's."""
    k = k if k is not None else cfg.detect_interval
    b = frames.shape[0]
    sb = seed_rows(seed_boxes, k, row0, b)    # (B, 4)
    sv = seed_rows(seed_valid, k, row0, b)    # (B,)
    det = refine_faces(nets.mtcnn, frames, sb, sv, cfg.mtcnn, dtype=dtype)
    box, _score, ok = select_primary_face(det, largest=cfg.mtcnn.select_largest)
    is_kf = keyframe_rows(k, row0, b, frames.device)
    box = torch.where(is_kf[:, None], sb, box)
    has_face = torch.where(is_kf, sv, ok)
    return embed_tail(nets, frames, box, has_face, cfg, dtype)


def frame_step_propagate_yuv(nets: DetectorNets, packed: torch.Tensor,
                             seed_boxes: torch.Tensor, seed_valid: torch.Tensor,
                             cfg: DetectorConfig, dtype, k: Optional[int] = None,
                             row0: int = 0) -> FrameOutputs:
    return frame_step_propagate(nets, to_frames(packed, cfg), seed_boxes, seed_valid, cfg,
                                dtype, k=k, row0=row0)






def multiface_select(det: Detections, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``t`` detections per frame by box area (no +1), invalid
    slots last at -inf, ties to the lower index (as ``jax.lax.top_k``)."""
    area = (det.boxes[..., 2] - det.boxes[..., 0]) * (det.boxes[..., 3] - det.boxes[..., 1])
    key = torch.where(det.valid, area, -torch.inf)
    _, idx = exact_topk_lastdim(key, t)
    boxes = torch.gather(det.boxes, 1, idx[..., None].expand(-1, -1, 4))
    return boxes, torch.gather(det.valid, 1, idx)


def multiface_tail(nets: DetectorNets, frames: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor, cfg: DetectorConfig, dtype):
    """The clamp gate, the face crops of the (B, T) boxes (kernel K4 at
    K = T) and FaceNet on the B·T crops, shared by every multi-face step so
    that keyframe rows of the propagate step equal the full step's.  No
    landmark head."""
    b, t = boxes.shape[:2]
    bounds, ok = clamp_box(boxes, frames.shape[1], frames.shape[2])
    emb = nets.facenet(face_crops(frames, bounds, cfg), dtype).reshape(b, t, -1)
    return boxes.to(torch.float32), valid & ok, emb


def multiface_step(nets: DetectorNets, frames: torch.Tensor, cfg: DetectorConfig, dtype):
    """The full cascade, then the top ``max_tracks`` faces of each frame
    embedded."""
    det = detect_faces(nets.mtcnn, frames, cfg.mtcnn, dtype=dtype)
    boxes, valid = multiface_select(det, cfg.max_tracks)
    return multiface_tail(nets, frames, boxes, valid, cfg, dtype)


def multiface_step_yuv(nets: DetectorNets, packed: torch.Tensor, cfg: DetectorConfig, dtype):
    return multiface_step(nets, to_frames(packed, cfg), cfg, dtype)


def multiface_detect(nets: DetectorNets, frames: torch.Tensor, cfg: DetectorConfig,
                     dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cascade-only multi-face seed step of the keyframe batch: (boxes,
    valid) equal to the full step's, the clamp gate included."""
    det = detect_faces(nets.mtcnn, frames, cfg.mtcnn, dtype=dtype)
    boxes, valid = multiface_select(det, cfg.max_tracks)
    _, ok = clamp_box(boxes, frames.shape[1], frames.shape[2])
    return boxes, valid & ok


def multiface_detect_yuv(nets: DetectorNets, packed: torch.Tensor, cfg: DetectorConfig,
                         dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    return multiface_detect(nets, to_frames(packed, cfg), cfg, dtype)


def multiface_step_propagate(nets: DetectorNets, frames: torch.Tensor,
                             seed_boxes: torch.Tensor, seed_valid: torch.Tensor,
                             cfg: DetectorConfig, dtype, k: Optional[int] = None,
                             row0: int = 0):
    """Track-propagated multi-face step: ``seed_boxes`` (B/K, T, 4) and
    ``seed_valid`` (B/K, T) are the keyframes' detections.  Keyframe rows
    pass their seeds through; the rows between refine all T seeds
    (``refine_faces_multi``).  ``row0`` as in ``frame_step_propagate``."""
    k = k if k is not None else cfg.detect_interval
    b = frames.shape[0]
    sb = seed_rows(seed_boxes, k, row0, b)    # (B, T, 4)
    sv = seed_rows(seed_valid, k, row0, b)    # (B, T)
    det = refine_faces_multi(nets.mtcnn, frames, sb, sv, cfg.mtcnn, dtype=dtype)
    boxes, valid = multiface_select(det, cfg.max_tracks)
    is_kf = keyframe_rows(k, row0, b, frames.device)
    boxes = torch.where(is_kf[:, None, None], sb, boxes)
    valid = torch.where(is_kf[:, None], sv, valid)
    return multiface_tail(nets, frames, boxes, valid, cfg, dtype)


def multiface_step_propagate_yuv(nets: DetectorNets, packed: torch.Tensor,
                                 seed_boxes: torch.Tensor, seed_valid: torch.Tensor,
                                 cfg: DetectorConfig, dtype, k: Optional[int] = None,
                                 row0: int = 0):
    return multiface_step_propagate(nets, to_frames(packed, cfg), seed_boxes, seed_valid, cfg,
                                    dtype, k=k, row0=row0)


class Steps(NamedTuple):
    """The frame steps of one kind of analysis, and what a step's outputs
    found: (B,) faces (single face) or (B, T) (row, track) slots."""

    full: Callable
    detect: Callable
    propagate: Callable
    found: Callable[[object], torch.Tensor]


def steps_for(yuv: bool, multi_face: bool) -> Steps:
    """The steps for I420 or BGR batches, single- or multi-face (looked up
    when called, so a test can stand in for one)."""
    if multi_face:
        return Steps(*((multiface_step_yuv, multiface_detect_yuv, multiface_step_propagate_yuv)
                       if yuv else (multiface_step, multiface_detect, multiface_step_propagate)),
                     found=lambda out: out[1])
    return Steps(*((frame_step_yuv, frame_step_detect_yuv, frame_step_propagate_yuv) if yuv
                   else (frame_step, frame_step_detect, frame_step_propagate)),
                 found=lambda out: out.has_face)
