"""The video detector (counterpart of ``truely_tpu/pipeline/detector.py``):
cascade -> face crop -> embedding -> temporal scan -> score, over batches of
sampled frames.

Two entry points: ``analyze_frames`` takes decoded BGR frames, and
``analyze_i420`` takes packed I420 frames held in memory and converts them
on the device with kernel K1 (the ingest loop of the JAX
``analyze_video``, with the file decoder replaced by memory).  Both sample
every ``sample_interval(fps)``-th frame, pad each batch to
``frame_batch``, and return the same ``VideoAnalysis`` records.

With ``detect_interval`` K > 1 (or "auto") detection is track-propagated:
the full cascade runs only on every K-th sampled frame, whose rows of K
uploaded batches are gathered on the device into one full-width seed batch,
and the frames between refine the keyframe's box (``refine_faces``).

``analyze_frames_tracks`` and ``analyze_i420_tracks`` are the multi-face
counterparts: up to ``max_tracks`` faces per frame are embedded
(``multiface_step``) and folded into per-track states
(``pipeline/tracks.py``), with the same keyframe cycles and "auto" ladder
(``refine_faces_multi`` between keyframes).  With
``DetectorConfig.classifier`` set, every segment's valid face crops also go
through the DFDC classifier (``pipeline/classifier.py``) and the multi-face
entry points return its ``Classified`` result as a fourth item.  The
``*_refine`` steps are the stream scheduler's: every row refines its
stream's carried seeds.

The file entry points, ``analyze_video``, ``analyze_video_multiface`` and
``run``, read a video through ``media.decode.VideoReader`` (packed I420
from an uncompressed I420 AVI or through the native libav decoder, BGR
through cv2 otherwise) and can write
the annotated video; annotating and encoding run on a worker thread beside
the device loop.  ``warmup`` runs one step of each of those paths at a
resolution, so that a server's first request does not pay the first-use
costs.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from truely_tpu_torch.config import DetectorConfig
from truely_tpu_torch.media.decode import VideoReader
from truely_tpu_torch.media.encode import VideoWriter
from truely_tpu_torch.media.native import i420_to_bgr_host
from truely_tpu_torch.media.overlay import annotate_frame, draw_landmarks
from truely_tpu_torch.models.weights import load_all
from truely_tpu_torch.ops.crop_classifier import crop_classifier
from truely_tpu_torch.ops.resize import crop_resize_bilinear
from truely_tpu_torch.ops.temporal import (
    TemporalResult, TemporalState, init_temporal_state, temporal_consistency,
    weighted_score,
)
from truely_tpu_torch.ops.topk import exact_topk_lastdim
from truely_tpu_torch.ops.yuv import i420_to_bgr
from truely_tpu_torch.pipeline.mtcnn import (
    Detections, MTCNNNets, detect_faces, refine_faces, refine_faces_multi,
    select_primary_face,
)
from truely_tpu_torch.pipeline.tracks import (
    TrackState, init_track_state, stream_state, track_scores, track_timeline,
)
from truely_tpu_torch.utils.profiling import StageTimer, span


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


@dataclass
class FrameRecord:
    frame_index: int
    has_face: bool
    box: Tuple[float, float, float, float]
    annotated: bool
    flagged: bool
    similarity: float
    counter: int


@dataclass
class VideoAnalysis:
    """Result of one video analysis (superset of the reference's int score)."""

    fake_score: int
    frame_count: int
    fps: int
    total_processed: int      # sampled frames analyzed
    flagged_count: int        # reference deep_fake_frame_count
    final_counter: int
    records: List[FrameRecord] = field(default_factory=list)
    timings: Dict[str, float] = field(default_factory=dict)
    output_path: Optional[str] = None
    yuv_ingest: bool = False  # packed I420 converted on the device

    @property
    def suspicious_frames(self) -> List[int]:
        return [r.frame_index for r in self.records if r.flagged]


# The spans behind each host timing of ``VideoAnalysis.timings``, and the
# spans in which the caller issues the frame steps or waits on them.
TIMING_SPANS = {"decode": ("detector.decode",), "upload": ("detector.stage", "detector.upload"),
                "temporal": ("detector.temporal",), "encode": ("detector.encode",)}
DEVICE_SPANS = ("detector.analyze", "mtcnn.cascade", "mtcnn.pyramid", "detector.embed",
                "detector.sync", "detector.fetch")


def analysis_timings(timer: StageTimer, keys: Tuple[str, ...]) -> Dict[str, float]:
    """``VideoAnalysis.timings`` from the spans of an analysis's thread:
    each of ``keys`` the total of its spans (``TIMING_SPANS``), ``total``
    the span ``detector.analyze``, and ``device`` the self time of
    ``DEVICE_SPANS``: the analysis outside the host spans, issuing the
    frame steps and waiting on their results."""
    totals, own = timer.report(), timer.self_report()
    got = {k: sum(totals.get(name, 0.0) for name in TIMING_SPANS[k]) for k in keys}
    got.update(device=sum(own.get(name, 0.0) for name in DEVICE_SPANS),
               total=totals.get("detector.analyze", 0.0))
    order = ("decode", "upload", "device", "temporal", "encode", "total")
    return {k: got[k] for k in order if k in got}


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
    with span("detector.embed"):
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


def frame_step_refine(nets: DetectorNets, frames: torch.Tensor, seed_boxes: torch.Tensor,
                      seed_valid: torch.Tensor, cfg: DetectorConfig, dtype,
                      rows_per_seed: int, row0: int = 0) -> FrameOutputs:
    """Seeded refinement of every row (the stream scheduler's step between
    keyframe steps): ``frames`` is (S·rows_per_seed, ...) grouped per
    stream, ``seed_boxes``/``seed_valid`` (S,) each stream's carried seed
    (on a data shard: rows from ``row0`` on, as in
    ``frame_step_propagate``).  No row passes its seed through, so a stale
    seed is re-checked (and can be rejected) on every sampled frame."""
    b = frames.shape[0]
    sb = seed_rows(seed_boxes, rows_per_seed, row0, b)
    sv = seed_rows(seed_valid, rows_per_seed, row0, b)
    det = refine_faces(nets.mtcnn, frames, sb, sv, cfg.mtcnn, dtype=dtype)
    box, _score, ok = select_primary_face(det, largest=cfg.mtcnn.select_largest)
    return embed_tail(nets, frames, box, ok, cfg, dtype)


def frame_step_refine_yuv(nets: DetectorNets, packed: torch.Tensor, seed_boxes: torch.Tensor,
                          seed_valid: torch.Tensor, cfg: DetectorConfig, dtype,
                          rows_per_seed: int, row0: int = 0) -> FrameOutputs:
    return frame_step_refine(nets, to_frames(packed, cfg), seed_boxes, seed_valid, cfg, dtype,
                             rows_per_seed, row0=row0)


# ---------------------------------------------------------------------------
# Multi-face steps: each returns (boxes (B, T, 4) f32, valid (B, T) bool,
# embeddings (B, T, D)), T = max_tracks; the cascade-only seed step returns
# (boxes, valid).


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
    with span("detector.embed"):
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


def multiface_step_refine(nets: DetectorNets, frames: torch.Tensor, seed_boxes: torch.Tensor,
                          seed_valid: torch.Tensor, cfg: DetectorConfig, dtype,
                          rows_per_seed: int, row0: int = 0):
    """Seeded multi-face refinement of every row (the stream scheduler's
    multi-face step between keyframe steps): ``seed_boxes`` (S, T, 4) and
    ``seed_valid`` (S, T) are each stream's carried track seeds; ``row0``
    as in ``frame_step_refine``."""
    b = frames.shape[0]
    sb = seed_rows(seed_boxes, rows_per_seed, row0, b)
    sv = seed_rows(seed_valid, rows_per_seed, row0, b)
    det = refine_faces_multi(nets.mtcnn, frames, sb, sv, cfg.mtcnn, dtype=dtype)
    boxes, valid = multiface_select(det, cfg.max_tracks)
    return multiface_tail(nets, frames, boxes, valid, cfg, dtype)


def multiface_step_refine_yuv(nets: DetectorNets, packed: torch.Tensor,
                              seed_boxes: torch.Tensor, seed_valid: torch.Tensor,
                              cfg: DetectorConfig, dtype, rows_per_seed: int, row0: int = 0):
    return multiface_step_refine(nets, to_frames(packed, cfg), seed_boxes, seed_valid, cfg,
                                 dtype, rows_per_seed, row0=row0)


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


class Segment(NamedTuple):
    """One uploaded batch: the sampled frame indices of its valid rows and
    the (B, ...) uint8 device batch (rows past them are zeros).  From a
    file, also the stretch of the video the batch covers: its frames on the
    host (BGR, or packed I420 with ``frames_i420``; none in YUV mode unless
    an output is written), their global indices and their count."""

    indices: List[int]
    dev: torch.Tensor
    frames: Tuple[np.ndarray, ...] = ()
    frame_indices: Tuple[int, ...] = ()
    n_frames: int = 0
    frames_i420: bool = False

    @property
    def n_valid(self) -> int:
        return len(self.indices)


class _AnnotateWorker:
    """Annotate and encode on a worker thread, beside the device loop.

    The caller's thread makes every torch call and hands the worker numpy
    arrays it has fetched (``submit``); the worker runs ``fn`` on each in
    the span ``detector.encode``.  A failure inside ``fn`` (disk
    full, codec error) is kept, the queue drains, and the caller raises
    the first one after ``shutdown()``: promptly, never a hang."""

    def __init__(self, fn):
        self._fn = fn
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self.err: List[BaseException] = []
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self.err:
                continue  # drain what is left after a failure
            try:
                with span("detector.encode"):
                    self._fn(*item)
            except BaseException as e:  # raised again by the caller
                self.err.append(e)

    def submit(self, *item):
        self._q.put(item)

    def shutdown(self):
        """Flush and join.  Does not raise (safe in ``finally``); check
        ``err`` afterwards."""
        self._q.put(None)
        self._t.join()


@contextlib.contextmanager
def full_float32():
    """float32 convolutions and matmuls without TF32 (cuDNN allows TF32
    for float32 convolutions by default)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def precision(dtype):
    """``full_float32()`` for float32 compute, else nothing."""
    return full_float32() if dtype == torch.float32 else contextlib.nullcontext()


class Detector:
    """The score path (one face per frame) and the multi-face path
    (``analyze_*_tracks``) on one device.

    ``params``: optional mapping net name -> JAX-layout param tree
    (``pnet``, ``rnet``, ``onet``, ``facenet``, ``landmark68``); missing
    nets load from ``weights_dir``/``$TRUELY_TPU_WEIGHTS`` or take the
    seeded init.  ``device`` defaults to CUDA and raises when there is no
    CUDA device; pass ``device="cpu"`` to run the plain versions on the CPU.

    ``mesh``: a ``parallel.mesh.Mesh``; every batch step then runs
    data-parallel over its ``data_axis`` (the frame axis split into one
    shard per position, each shard on its device's replica of the nets,
    the outputs gathered on the mesh's first device, which is the
    Detector's device), so every entry point scales by constructing the
    Detector with a mesh and nothing else changes.
    """

    def __init__(self, config: Optional[DetectorConfig] = None,
                 params: Optional[Mapping[str, object]] = None,
                 device=None, weights_dir: Optional[str] = None,
                 mesh=None, data_axis: str = "data"):
        self.config = config or DetectorConfig()
        cfg = self.config
        self.mesh = mesh
        self._data_axis = data_axis
        if mesh is not None:
            from truely_tpu_torch.parallel.mesh import canonical_device

            if device is not None and canonical_device(device) != mesh.first_device:
                raise ValueError(f"device {device} is not the mesh's first device "
                                 f"{mesh.first_device}")
            device = mesh.first_device
            n_dp = mesh.shape[data_axis]
            if cfg.frame_batch % n_dp:
                raise ValueError(f"frame_batch ({cfg.frame_batch}) must be divisible by the "
                                 f"'{data_axis}' mesh axis ({n_dp})")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
        if cfg.draw_mode not in ("all", "flagged-only"):
            raise ValueError(f"draw_mode must be 'all' or 'flagged-only', got {cfg.draw_mode!r}")
        # detect_interval: a fixed K (self._detect_k) or "auto" (None).
        self._auto_interval = cfg.detect_interval == "auto"
        if self._auto_interval:
            kmax = cfg.auto_interval_max
            if kmax < 2 or (kmax & (kmax - 1)):
                raise ValueError(f"auto_interval_max must be a power of two >= 2, got {kmax}")
            if cfg.frame_batch % kmax:
                raise ValueError(f"frame_batch ({cfg.frame_batch}) must be divisible by "
                                 f"auto_interval_max ({kmax})")
            self._detect_k = None
        else:
            di = cfg.detect_interval
            if not isinstance(di, int) or di < 1:
                raise ValueError(f'detect_interval must be an int >= 1 or "auto", got {di!r}')
            if di > 1 and cfg.frame_batch % di:
                raise ValueError(f"frame_batch ({cfg.frame_batch}) must be divisible by "
                                 f"detect_interval ({di}): keyframes batch across {di} "
                                 f"segments at frame_batch/{di} per segment")
            self._detect_k = di
        # "auto" telemetry: segments run through full detection and through
        # refinement, and the ladder's current rung.
        self.auto_keyframe_segments = 0
        self.auto_refine_segments = 0
        self.auto_interval_current = 1
        # Segments that ``propagate_fallback`` re-ran through the full step.
        self.fallback_segments = 0
        # The classifier's valid crops (once per video, whatever the
        # ensemble) and rows run (masked ones included).
        self.classified_crops = 0
        self.classifier_rows = 0
        self.dtype = getattr(torch, self.config.compute_dtype)
        nets, given = load_all(params, weights_dir)
        # False: FaceNet is the seeded init, and its scores mean nothing.
        self.facenet_pretrained = "facenet" in given
        nets = {name: m.to(self.device) for name, m in nets.items()}
        self.nets = DetectorNets(
            mtcnn=MTCNNNets(nets["pnet"], nets["rnet"], nets["onet"]),
            facenet=nets["facenet"], landmark=nets["landmark68"],
        )
        self.embedding_dim = nets["facenet"].last_linear.out_features
        # The classifier's ensemble (``pipeline/classifier.py``), or None.
        self.classifier = None
        if cfg.classifier is not None:
            if not cfg.multi_face:
                raise ValueError("the classifier runs on the multi-face path: set multi_face")
            from truely_tpu_torch.pipeline.classifier import load_members

            self.classifier = load_members(cfg.classifier, (params or {}).get("classifier"),
                                           self.device)
        # (mesh, axis) -> the nets' replicas; (mesh, axis, ...) -> sharded steps
        self._sharded_cache: dict = {}
        if mesh is not None:
            self._spec, self._replicas = self._mesh_replicas(mesh, data_axis)

    def _run(self, fn, *args, **kwargs):
        """``fn(nets, *args, config, dtype, **kwargs)``, one of the frame
        steps; with a mesh, on every data shard of ``args[0]``."""
        with torch.inference_mode(), precision(self.dtype):
            if self.mesh is None:
                return fn(self.nets, *args, self.config, self.dtype, **kwargs)
            from truely_tpu_torch.parallel.sharding import run_sharded

            return run_sharded(self._spec, fn, self._replicas, *args, cfg=self.config,
                               dtype=self.dtype, **kwargs)

    def _mesh_replicas(self, mesh, data_axis: str):
        """(data split, replicas of the nets) for ``mesh``, made once per
        (mesh, axis) and shared by every sharded step on it."""
        key = (mesh, data_axis)
        if key not in self._sharded_cache:
            from truely_tpu_torch.parallel.sharding import dp_spec, replicate

            self._sharded_cache[key] = (dp_spec(mesh, data_axis), replicate(mesh, self.nets))
        return self._sharded_cache[key]

    def sharded_step(self, mesh, data_axis: str = "data", yuv: bool = False,
                     multiface: bool = False):
        """Cached ``(step_fn, params, spec)`` for data-parallel execution over
        an explicit mesh: ``step_fn(params, frames)`` runs the full step
        (``yuv``: on packed I420; ``multiface``: the per-track step) on each
        data shard, ``params`` are the nets' replicas (one set per (mesh,
        axis), shared by every step on it; the Detector's own for its own
        mesh: meshes compare by devices and axes), ``spec`` the frame
        axis's split."""
        key = (mesh, data_axis, yuv, multiface)
        if key not in self._sharded_cache:
            from truely_tpu_torch.parallel.sharding import shard_frame_step

            spec, replicas = self._mesh_replicas(mesh, data_axis)
            self._sharded_cache[key] = (
                shard_frame_step(mesh, self.config, data_axis=data_axis, yuv=yuv,
                                 multiface=multiface), replicas, spec)
        return self._sharded_cache[key]

    def sharded_refine_step(self, mesh, data_axis: str = "data", yuv: bool = False,
                            rows_per_seed: int = 1, multiface: bool = False):
        """Cached ``(refine_fn, params)`` for the stream scheduler's
        propagate mode over an explicit mesh: ``refine_fn(params, frames,
        seed_boxes, seed_valid)``, as ``sharded_step`` (the replicas are
        the same), one per ``rows_per_seed``."""
        key = (mesh, data_axis, yuv, "refine", rows_per_seed, multiface)
        if key not in self._sharded_cache:
            from truely_tpu_torch.parallel.sharding import shard_frame_step

            _, replicas = self._mesh_replicas(mesh, data_axis)
            self._sharded_cache[key] = (
                shard_frame_step(mesh, self.config, data_axis=data_axis, yuv=yuv,
                                 refine_rows=rows_per_seed, multiface=multiface), replicas)
        return self._sharded_cache[key]

    def step(self, frames: torch.Tensor) -> FrameOutputs:
        """One batch of (B, H, W, 3) uint8 frames on the device."""
        return self._run(frame_step, frames)

    def step_yuv(self, packed: torch.Tensor) -> FrameOutputs:
        """One batch of packed I420 (B, 3H/2, W) uint8 frames on the device."""
        return self._run(frame_step_yuv, packed)

    def temporal(self, out: FrameOutputs, n_valid: int, state: TemporalState) -> TemporalResult:
        with torch.inference_mode():
            return temporal_consistency(
                out.embedding, out.has_face, n_valid, state=state,
                similarity_threshold=self.config.similarity_threshold,
                run_length_threshold=self.config.run_length_threshold,
            )

    def track_fold(self, state: TrackState, boxes: torch.Tensor, valid: torch.Tensor,
                   emb: torch.Tensor, n_valid) -> Tuple[TrackState, object]:
        """``track_timeline`` of (S, F, T, ...) multi-face outputs: one
        launch of kernel K6 on the card, the plain fold on the CPU."""
        with span("tracks.fold"), torch.inference_mode():
            return track_timeline(
                state, boxes, valid, emb, n_valid,
                similarity_threshold=self.config.similarity_threshold,
                run_length_threshold=self.config.run_length_threshold,
            )

    def classify(self, dev: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                 n_valid: int, yuv: bool) -> torch.Tensor:
        """The classifier on a segment's first ``n_valid`` rows: the frames
        (kernel K1 for packed I420), the crops of their (B, T) boxes where
        ``valid`` (kernel K7), each member's forward.  Returns the (M,
        n_valid, T) float32 logits, on the device."""
        cfg, cc = self.config, self.config.classifier
        t = boxes.shape[1]
        with torch.inference_mode():
            with span("classifier.crop"):
                frames = to_frames(dev[:n_valid], cfg) if yuv else dev[:n_valid]
                crops = crop_classifier(frames, boxes[:n_valid], valid[:n_valid], cc.input_size,
                                        cc.margin, rgb_in=not cfg.reference_compat)
            with span("classifier.net"), precision(getattr(torch, cc.compute_dtype)):
                logits = torch.stack([net(crops) for net in self.classifier])
        self.classifier_rows += n_valid * t
        return logits.reshape(len(self.classifier), n_valid, t)

    def _collector(self):
        """A ``pipeline.classifier.Collector`` for one video, or None
        without the classifier."""
        if self.classifier is None:
            return None
        from truely_tpu_torch.pipeline.classifier import Collector

        return Collector(self)

    def track_scores(self, state: TrackState, frame_count: int, fps: int) -> np.ndarray:
        return track_scores(state, frame_count, fps,
                            run_length_threshold=self.config.run_length_threshold,
                            long_video_seconds=self.config.long_video_seconds)

    def score(self, flagged_count: int, final_counter: int, total_processed: int,
              frame_count: int, fps: int) -> int:
        return weighted_score(
            flagged_count, final_counter, total_processed, frame_count, fps,
            run_length_threshold=self.config.run_length_threshold,
            long_video_seconds=self.config.long_video_seconds,
        )

    def analyze_frames(self, frames_bgr: np.ndarray, fps: int) -> VideoAnalysis:
        """Analyze an in-memory (N, H, W, 3) uint8 BGR frame array."""
        return self._analyze(frames_bgr, fps, yuv=False)

    def analyze_i420(self, packed: np.ndarray, fps: int) -> VideoAnalysis:
        """Analyze in-memory packed I420 frames (N, 3H/2, W) uint8 (the
        layout cv2 and the native decoder use: Y rows, then the U plane,
        then the V plane), converted on the device."""
        return self._analyze(packed, fps, yuv=True)

    def analyze_frames_tracks(self, frames_bgr: np.ndarray, fps: int):
        """Multi-face analysis of an in-memory (N, H, W, 3) uint8 BGR frame
        array: per-track consistency scoring.  Returns (aggregate score,
        the max over tracks; per-track scores (T,) int32; the final
        ``TrackState`` of (T, ...) tensors), and with the classifier its
        ``Classified`` result fourth."""
        return self._analyze_tracks(frames_bgr, fps, yuv=False)

    def analyze_i420_tracks(self, packed: np.ndarray, fps: int):
        """``analyze_frames_tracks`` on in-memory packed I420 frames
        (N, 3H/2, W) uint8, converted on the device (the ingest loop of the
        JAX ``analyze_video_multiface`` with the decoder replaced by
        memory)."""
        return self._analyze_tracks(packed, fps, yuv=True)

    def _keyframes(self, cycle: List[Segment], k: int) -> torch.Tensor:
        """Every k-th row of each segment of the cycle, gathered on the
        device into one full-width seed batch (zero rows where the last
        cycle is short)."""
        rows = torch.cat([seg.dev[::k] for seg in cycle])
        pad = self.config.frame_batch - rows.shape[0]
        if pad:
            rows = torch.cat([rows, rows.new_zeros((pad,) + tuple(rows.shape[1:]))])
        return rows

    def _propagate_cycle(self, cycle: List[Segment], k: int, steps: Steps, count: bool):
        """One keyframe cycle of k segments: the cascade-only seed step on
        their gathered keyframes, then each segment's propagate step.
        Yields (segment, outputs, seeded, lost, fell_back); with ``count``
        (a host sync per segment) ``seeded``/``lost`` count the segment's
        seeded frames (multi-face: seeded (row, track) slots) and those
        whose refinement found no face, and with ``propagate_fallback`` a
        segment that lost more than half of them is re-run through the full
        step."""
        bk = self.config.frame_batch // k
        seed_box, seed_found = self._run(steps.detect, self._keyframes(cycle, k))
        if count:
            with span("detector.sync"):
                sv_host = seed_found.cpu().numpy()
        for j, seg in enumerate(cycle):
            rows = slice(j * bk, (j + 1) * bk)
            out = self._run(steps.propagate, seg.dev, seed_box[rows], seed_found[rows], k=k)
            seeded = lost = 0
            fell_back = False
            if count:
                with span("detector.sync"):
                    found = steps.found(out)[: seg.n_valid].cpu().numpy()
                sv = np.repeat(sv_host[rows], k, axis=0)[: seg.n_valid]
                seeded, lost = int(sv.sum()), int((sv & ~found).sum())
                if self.config.propagate_fallback and seeded and lost * 2 > seeded:
                    out = self._run(steps.full, seg.dev)
                    fell_back = True
                    self.fallback_segments += 1
            yield seg, out, seeded, lost, fell_back

    def _propagate_outputs(self, segments, steps: Steps):
        """(segment, outputs) with full detection on keyframes only, at the
        fixed interval K: K segments per cycle."""
        k = self._detect_k
        while True:
            cycle = list(itertools.islice(segments, k))
            if not cycle:
                return
            for seg, out, *_ in self._propagate_cycle(cycle, k, steps,
                                                      self.config.propagate_fallback):
                yield seg, out

    def _propagate_outputs_auto(self, segments, steps: Steps):
        """(segment, outputs) with adaptive keyframing: rung 1 is full
        detection per segment and escalates once at least half the valid
        rows hold a face; a rung k > 1 is the fixed-k cycle, after which the
        ladder collapses to 1 if the cycle lost more than half its seeded
        frames (multi-face: slots), or doubles (up to
        ``auto_interval_max``) if it lost at most ``auto_escalate_lost`` of
        them."""
        cfg = self.config
        kmax = cfg.auto_interval_max
        k = 1
        while True:
            if k == 1:
                seg = next(segments, None)
                if seg is None:
                    return
                out = self._run(steps.full, seg.dev)
                self.auto_keyframe_segments += 1
                n = seg.n_valid
                if n:
                    with span("detector.sync"):
                        held = steps.found(out)[:n].reshape(n, -1).any(1).cpu().numpy().mean()
                    if held >= 0.5:
                        k = min(2, kmax)
                self.auto_interval_current = k
                yield seg, out
                continue
            cycle = list(itertools.islice(segments, k))
            if not cycle:
                return
            cycle_seeded = cycle_lost = 0
            for seg, out, seeded, lost, fell_back in self._propagate_cycle(
                    cycle, k, steps, True):
                self.auto_refine_segments += 1
                self.auto_keyframe_segments += fell_back
                cycle_seeded += seeded
                cycle_lost += lost
                yield seg, out
            if cycle_seeded == 0 or cycle_lost * 2 > cycle_seeded:
                k = 1                                   # collapse: re-acquire
            elif cycle_lost <= cfg.auto_escalate_lost * cycle_seeded:
                k = min(k * 2, kmax)                    # stable: escalate
            self.auto_interval_current = k

    def _segment_outputs(self, segments, yuv: bool, multi_face: bool = False):
        """(segment, outputs): full detection per segment, the keyframe
        cycles of a fixed K > 1, or the "auto" ladder."""
        segments = iter(segments)
        steps = steps_for(yuv, multi_face)
        if self._auto_interval:
            return self._propagate_outputs_auto(segments, steps)
        if self._detect_k > 1:
            return self._propagate_outputs(segments, steps)
        return ((seg, self._run(steps.full, seg.dev)) for seg in segments)

    def _segments(self, frames: np.ndarray, sampled: List[int]):
        """The sampled frames in uploaded ``frame_batch`` batches, the last
        one zero-padded."""
        b = self.config.frame_batch
        for s in range(0, len(sampled), b):
            chunk = sampled[s:s + b]
            with span("detector.stage"):
                stack = np.zeros((b,) + frames.shape[1:], np.uint8)
                stack[: len(chunk)] = frames[chunk]
            with span("detector.upload"):
                dev = torch.from_numpy(stack).to(self.device, non_blocking=True)
            yield Segment(chunk, dev)

    def _analyze(self, frames: np.ndarray, fps: int, *, yuv: bool) -> VideoAnalysis:
        cfg = self.config
        timer = StageTimer()
        n = frames.shape[0]
        sampled = list(range(0, n, cfg.sample_interval(fps)))
        records: List[FrameRecord] = []
        flagged_total = 0

        def fetch(chunk, out, res):
            nonlocal flagged_total
            with span("detector.fetch"):
                bounds, has_face, annotated, flagged, sims, counters = (
                    t.cpu().numpy() for t in (out.crop_bounds, res.has_face, res.annotated,
                                              res.flagged, res.similarity, res.counter))
            flagged_total += int(np.sum(flagged[: len(chunk)]))
            for k, gi in enumerate(chunk):
                records.append(FrameRecord(
                    frame_index=gi, has_face=bool(has_face[k]),
                    box=tuple(float(v) for v in bounds[k]), annotated=bool(annotated[k]),
                    flagged=bool(flagged[k]), similarity=float(sims[k]),
                    counter=int(counters[k]),
                ))

        with timer.stage("detector.analyze"):
            state = init_temporal_state(self.embedding_dim, self.device)
            # One-deep pipeline: batch N+1 is uploaded and enqueued before
            # the host waits on batch N's results (with propagation, a
            # keyframe cycle's batches are all uploaded before its seed
            # step).
            in_flight = None
            for seg, out in self._segment_outputs(self._segments(frames, sampled), yuv):
                res = self.temporal(out, seg.n_valid, state)
                state = res.state
                if in_flight is not None:
                    fetch(*in_flight)
                in_flight = (seg.indices, out, res)
            if in_flight is not None:
                fetch(*in_flight)
            with span("detector.fetch"):
                final_counter = int(state.counter)
        return VideoAnalysis(
            fake_score=self.score(flagged_total, final_counter, len(sampled), n, fps),
            frame_count=n, fps=fps, total_processed=len(sampled),
            flagged_count=flagged_total, final_counter=final_counter,
            records=records, timings=analysis_timings(timer, ("upload",)), yuv_ingest=yuv,
        )

    def _analyze_tracks(self, frames: np.ndarray, fps: int, *, yuv: bool):
        """Every batch's multi-face outputs folded into one stream's track
        state on the device; the host waits only for the final scores."""
        cfg = self.config
        n = frames.shape[0]
        sampled = list(range(0, n, cfg.sample_interval(fps)))
        cls = self._collector()
        with span("detector.analyze"):
            state = init_track_state(cfg.max_tracks, self.embedding_dim, device=self.device)
            for seg, (boxes, valid, emb) in self._segment_outputs(
                    self._segments(frames, sampled), yuv, multi_face=True):
                state, _ = self.track_fold(state, boxes[None], valid[None], emb[None],
                                           seg.n_valid)
                if cls is not None:
                    cls.add(seg.dev, boxes, valid, seg.n_valid, yuv)
            with span("detector.fetch"):
                per_track = self.track_scores(state, n, fps)[0]
            result = (int(per_track.max(initial=0)), per_track, stream_state(state, 0))
            return result if cls is None else result + (cls.finish(),)

    # ------------------------------------------------------------------
    # Files

    def _file_segments(self, reader: VideoReader):
        """The reader's segments, uploaded: the wait on the decode thread
        is the span ``detector.decode``, the copy ``detector.upload``."""
        it = reader.segments(self.config.sample_interval(reader.meta.fps),
                             self.config.frame_batch)
        try:
            while True:
                with span("detector.decode"):
                    seg = next(it, None)
                if seg is None:
                    return
                with span("detector.upload"):
                    dev = torch.from_numpy(seg.sampled).to(self.device, non_blocking=True)
                yield Segment(seg.sampled_indices, dev, tuple(seg.frames),
                              tuple(seg.frame_indices), seg.n_frames, seg.frames_i420)
        finally:
            it.close()

    def analyze_video(self, input_path: str, output_path: Optional[str] = None) -> VideoAnalysis:
        """Analysis of a video file, and with ``output_path`` the annotated
        video (the reference's ``run()``, server/model.py:11-95).  Timings,
        host seconds of the caller's thread (``analysis_timings``):
        ``decode`` (opening and closing the reader, waiting on its decode
        thread), ``upload``, ``device`` (issuing the frame steps and waiting
        on their results), ``temporal`` (issuing the fold), ``encode`` (the
        records; with an output, opening and closing the writer and waiting
        on the worker thread that annotates and writes), ``total``."""
        cfg = self.config
        rgb = not cfg.reference_compat
        timer = StageTimer()
        # With an output, every frame's packed picture comes along, so that
        # the frames not drawn on re-encode without a colour conversion.
        with timer.stage("detector.analyze"), contextlib.ExitStack() as closing:
            with timer.stage("detector.decode"):
                reader = VideoReader(input_path, rgb=rgb, yuv=cfg.yuv_ingest,
                                     host_frames=output_path is not None)

            def close_reader():   # the decode thread's join is decode time too
                with timer.stage("detector.decode"):
                    reader.close()

            closing.callback(close_reader)
            meta = reader.meta
            with timer.stage("detector.encode"):
                writer = (VideoWriter(output_path, meta.fps, meta.width, meta.height)
                          if output_path else None)
            state = init_temporal_state(self.embedding_dim, self.device)
            records: List[FrameRecord] = []
            totals = {"frames": 0, "processed": 0, "flagged": 0}

            def fetch_results(out, res):
                # Everything the records and the annotator need, in one wait.
                with span("detector.fetch"):
                    got = tuple(t.cpu().numpy() for t in (
                        out.crop_bounds, res.has_face, res.annotated, res.flagged,
                        res.similarity, res.counter))
                    lmks = out.landmarks68.cpu().numpy() if cfg.draw_landmarks else None
                return got + (lmks,)

            def encode_segment(seg: Segment, fetched):
                bounds, has_face, annotated, flagged, sims, counters, lmks = fetched
                totals["flagged"] += int(np.sum(flagged[: seg.n_valid]))
                totals["processed"] += seg.n_valid
                totals["frames"] += seg.n_frames
                ann = {gi: k for k, gi in enumerate(seg.indices)}
                for j, gi in enumerate(seg.frame_indices):
                    frame = seg.frames[j] if seg.frames else None
                    k = ann.get(gi)
                    px = None  # interleaved pixels, only for a frame drawn on
                    if k is not None:
                        records.append(FrameRecord(
                            frame_index=gi, has_face=bool(has_face[k]),
                            box=tuple(float(v) for v in bounds[k]),
                            annotated=bool(annotated[k]), flagged=bool(flagged[k]),
                            similarity=float(sims[k]), counter=int(counters[k])))
                        draw = annotated[k] and (cfg.draw_mode != "flagged-only" or flagged[k])
                        if writer and draw:
                            px = i420_to_bgr_host(frame, rgb=rgb) if seg.frames_i420 else frame
                            annotate_frame(px, bounds[k], flagged=bool(flagged[k]),
                                           frame_index=gi, rgb=rgb)
                            if lmks is not None:
                                x0, y0, x1, y1 = bounds[k]
                                pts = (lmks[k] * np.asarray([max(x1 - x0, 1), max(y1 - y0, 1)])
                                       + np.asarray([x0, y0]))
                                draw_landmarks(px, pts, rgb=rgb)
                    if writer:
                        if px is None and seg.frames_i420:
                            writer.write_i420(frame)   # as decoded, no conversion
                        else:
                            px = frame if px is None else px
                            # The writers take BGR; corrected mode decodes RGB.
                            writer.write(px if cfg.reference_compat
                                         else np.ascontiguousarray(px[..., ::-1]))

            # With an output, annotate and encode run on a worker thread, and
            # the caller's wait for room in its queue is encode time;
            # score-only runs do the little host work in line.
            wt = _AnnotateWorker(encode_segment) if writer is not None else None
            hand_on = wt.submit if wt is not None else encode_segment

            def emit(seg: Segment, fetched):
                with timer.stage("detector.encode"):
                    hand_on(seg, fetched)

            try:
                # One-deep pipeline: batch N+1 is uploaded and enqueued
                # before the host waits on batch N's results.
                in_flight = None
                for seg, out in self._segment_outputs(self._file_segments(reader),
                                                      reader.yuv_active):
                    # A failed writer stops decoding and uploading at once.
                    if wt is not None and wt.err:
                        break
                    with span("detector.temporal"):
                        res = self.temporal(out, seg.n_valid, state)
                    state = res.state
                    if in_flight is not None:
                        emit(in_flight[0], fetch_results(*in_flight[1:]))
                    in_flight = (seg, out, res)
                if in_flight is not None:
                    emit(in_flight[0], fetch_results(*in_flight[1:]))
            finally:
                with timer.stage("detector.encode"):
                    if wt is not None:
                        wt.shutdown()
                    if writer:
                        writer.close()
            if wt is not None and wt.err:
                raise wt.err[0]
            yuv_ingest = reader.yuv_active
            with span("detector.fetch"):
                final_counter = int(state.counter)

        timings = analysis_timings(timer, ("decode", "upload", "temporal", "encode"))
        return VideoAnalysis(
            fake_score=self.score(totals["flagged"], final_counter, totals["processed"],
                                  totals["frames"], meta.fps),
            frame_count=totals["frames"], fps=meta.fps, total_processed=totals["processed"],
            flagged_count=totals["flagged"], final_counter=final_counter, records=records,
            timings=timings, output_path=output_path, yuv_ingest=yuv_ingest,
        )

    def analyze_video_multiface(self, input_path: str, output_path: Optional[str] = None):
        """Multi-face analysis of a video file: every tracked face gets its
        own consistency score and, with ``output_path``, its red or green
        box.  Returns (aggregate score, the max over tracks; per-track
        scores (T,) int32; the final ``TrackState`` of (T, ...) tensors),
        and with the classifier its ``Classified`` result fourth."""
        cfg = self.config
        rgb = not cfg.reference_compat
        t = cfg.max_tracks
        with span("detector.analyze"), VideoReader(
                input_path, rgb=rgb, yuv=cfg.yuv_ingest,
                host_frames=output_path is not None) as reader:
            meta = reader.meta
            writer = (VideoWriter(output_path, meta.fps, meta.width, meta.height)
                      if output_path else None)
            state = init_track_state(t, self.embedding_dim, device=self.device)
            frame_count = 0
            cls = self._collector()

            def encode_segment(seg: Segment, fetched):
                t_boxes, t_upd, t_flag = fetched

                def drawn(k, i):
                    return bool(t_upd[k, i]) and (cfg.draw_mode != "flagged-only"
                                                  or bool(t_flag[k, i]))

                ann = {gi: k for k, gi in enumerate(seg.indices)}
                for gi, frame in zip(seg.frame_indices, seg.frames):
                    k = ann.get(gi)
                    tracks = [i for i in range(t) if drawn(k, i)] if k is not None else []
                    if not tracks and seg.frames_i420:
                        writer.write_i420(frame)   # as decoded, no conversion
                        continue
                    px = i420_to_bgr_host(frame, rgb=rgb) if seg.frames_i420 else frame
                    for i in tracks:
                        annotate_frame(px, t_boxes[k, i], flagged=bool(t_flag[k, i]),
                                       frame_index=gi, rgb=rgb)
                    writer.write(px if cfg.reference_compat
                                 else np.ascontiguousarray(px[..., ::-1]))

            def fetch(outs):
                with span("detector.fetch"):
                    return tuple(x[0].cpu().numpy() for x in (
                        outs.track_box, outs.track_updated, outs.track_flagged))

            # The structure of analyze_video: a one-deep pipeline feeding an
            # encode worker.
            wt = _AnnotateWorker(encode_segment) if writer is not None else None
            try:
                in_flight = None
                for seg, (boxes, valid, emb) in self._segment_outputs(
                        self._file_segments(reader), reader.yuv_active, multi_face=True):
                    if wt is not None and wt.err:
                        break
                    state, outs = self.track_fold(state, boxes[None], valid[None], emb[None],
                                                  seg.n_valid)
                    if cls is not None:
                        cls.add(seg.dev, boxes, valid, seg.n_valid, reader.yuv_active)
                    frame_count += seg.n_frames
                    if wt is None:
                        continue
                    if in_flight is not None:
                        wt.submit(in_flight[0], fetch(in_flight[1]))
                    in_flight = (seg, outs)
                if wt is not None and in_flight is not None:
                    wt.submit(in_flight[0], fetch(in_flight[1]))
            finally:
                if wt is not None:
                    wt.shutdown()
                if writer:
                    writer.close()
            if wt is not None and wt.err:
                raise wt.err[0]
            with span("detector.fetch"):
                per_track = self.track_scores(state, frame_count, meta.fps)[0]
            result = (int(per_track.max(initial=0)), per_track, stream_state(state, 0))
            return result if cls is None else result + (cls.finish(),)

    def run(self, video_path_one: str, video_path_two: str) -> int:
        """The reference's ``run()`` (server/model.py): the 0-100 fake
        score of ``video_path_one``, with the annotated video written to
        ``video_path_two``; 0 for a missing, empty or unreadable file.
        With ``config.multi_face`` the score is the max over face tracks."""
        return self.run_classified(video_path_one, video_path_two)[0]

    def run_classified(self, video_path_one: str,
                       video_path_two: str) -> Tuple[int, Optional[float]]:
        """``run``'s score and, with the classifier, the video's
        classifier score (None without it, or where ``run`` gives 0 for an
        unreadable file)."""
        if not os.path.exists(video_path_one) or os.path.getsize(video_path_one) == 0:
            return 0, None
        try:
            if self.config.multi_face:
                result = self.analyze_video_multiface(video_path_one, video_path_two)
                return result[0], result[3].score if len(result) > 3 else None
            return self.analyze_video(video_path_one, video_path_two).fake_score, None
        except IOError:
            return 0, None

    def warmup(self, height: int, width: int) -> None:
        """Warm the (height, width) bucket for ``run()`` and the server's
        group runner: on CUDA, build the kernels (``cuda_build.build``);
        then, on zero frames, one step of each path this config takes (the
        BGR step, and the packed-I420 step when ``yuv_ingest`` and the
        shape can be I420; at K > 1 or "auto" also the cascade-only seed
        step and the propagate step, at the fixed K or the ladder's first
        rung), and one temporal fold (multi-face: one track fold, and the
        classifier on the full batch where it is set), so that
        cuDNN's algorithm choice, the first launch of every kernel and the
        caching allocator's first growth happen here.  Synchronises, and
        changes no state of the detector."""
        cfg = self.config
        b = cfg.frame_batch
        if self.device.type == "cuda":
            from truely_tpu_torch.ops import cuda_build

            cuda_build.build()
        batches = {False: torch.zeros((b, height, width, 3), dtype=torch.uint8,
                                      device=self.device)}
        if cfg.yuv_ingest and height % 4 == 0 and width % 2 == 0:
            batches[True] = torch.zeros((b, height * 3 // 2, width), dtype=torch.uint8,
                                        device=self.device)
        k = self._detect_k if self._detect_k is not None else min(2, cfg.auto_interval_max)
        seeds = (b // k, cfg.max_tracks) if cfg.multi_face else (b // k,)
        seed_box = torch.zeros(seeds + (4,), dtype=torch.float32, device=self.device)
        seed_valid = torch.zeros(seeds, dtype=torch.bool, device=self.device)
        for yuv, batch in batches.items():
            steps = steps_for(yuv, cfg.multi_face)
            out = self._run(steps.full, batch)
            if k > 1:
                self._run(steps.detect, batch)
                self._run(steps.propagate, batch, seed_box, seed_valid, k=k)
        if cfg.multi_face:
            boxes, valid, emb = out
            state = init_track_state(cfg.max_tracks, self.embedding_dim, device=self.device)
            self.track_fold(state, boxes[None], valid[None], emb[None], b)
            if self.classifier is not None:
                self.classify(batch, boxes, valid, b, yuv)
        else:
            self.temporal(out, b, init_temporal_state(self.embedding_dim, self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
