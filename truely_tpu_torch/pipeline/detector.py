"""The score path of the video detector (counterpart of
``truely_tpu/pipeline/detector.py``): cascade -> face crop -> embedding ->
temporal scan -> score, over batches of sampled frames.

Two entry points: ``analyze_frames`` takes decoded BGR frames, and
``analyze_i420`` takes packed I420 frames held in memory and converts them
on the device with kernel K1 (the ingest loop of the JAX
``analyze_video``, with the file decoder replaced by memory).  Both sample
every ``sample_interval(fps)``-th frame, pad each batch to
``frame_batch``, and return the same ``VideoAnalysis`` records.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from truely_tpu_torch.config import DetectorConfig
from truely_tpu_torch.models.weights import load_all
from truely_tpu_torch.ops.resize import crop_resize_bilinear
from truely_tpu_torch.ops.temporal import (
    TemporalResult, TemporalState, init_temporal_state, temporal_consistency,
    weighted_score,
)
from truely_tpu_torch.ops.yuv import i420_to_bgr
from truely_tpu_torch.pipeline.mtcnn import MTCNNNets, detect_faces, select_primary_face


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
    yuv_ingest: bool = False  # packed I420 converted on the device

    @property
    def suspicious_frames(self) -> List[int]:
        return [r.frame_index for r in self.records if r.flagged]


def embed_tail(nets: DetectorNets, frames: torch.Tensor, box: torch.Tensor,
               has_face: torch.Tensor, cfg: DetectorConfig, dtype) -> FrameOutputs:
    """Reference crop semantics after a box is known (trunc to int, clamp to
    the frame, non-degenerate), the 80x80 bilinear crop (kernel K4),
    normalization, FaceNet embedding and the landmark head."""
    h, w = frames.shape[1], frames.shape[2]
    bi = box.to(torch.int32)
    x0 = bi[:, 0].clamp_min(0)
    y0 = bi[:, 1].clamp_min(0)
    x1 = bi[:, 2].clamp_max(w)
    y1 = bi[:, 3].clamp_max(h)
    has_face = has_face & (x1 > x0) & (y1 > y0)
    bounds = torch.stack([x0, y0, x1, y1], dim=-1)
    crops = crop_resize_bilinear(frames, bounds[:, None, :], cfg.crop_size)[:, 0]
    if cfg.reference_compat:
        crops = crops * (1.0 / 255.0)   # torchvision to_tensor, no standardization
    else:
        crops = (crops - 127.5) * (1.0 / 128.0)
    emb = nets.facenet(crops, dtype)
    lmk = nets.landmark(crops, dtype)
    return FrameOutputs(box=box, crop_bounds=bounds, has_face=has_face,
                        embedding=emb, landmarks68=lmk)


def frame_step(nets: DetectorNets, frames: torch.Tensor, cfg: DetectorConfig,
               dtype) -> FrameOutputs:
    """One batch of (B, H, W, 3) uint8 frames through the whole device step."""
    det = detect_faces(nets.mtcnn, frames, cfg.mtcnn, dtype=dtype)
    box, _score, has_face = select_primary_face(det, largest=cfg.mtcnn.select_largest)
    return embed_tail(nets, frames, box, has_face, cfg, dtype)


def frame_step_yuv(nets: DetectorNets, packed: torch.Tensor, cfg: DetectorConfig,
                   dtype) -> FrameOutputs:
    """The frame step on packed I420 (B, 3H/2, W) uint8, converted on the
    device by kernel K1 (bit-identical to cv2's BGR decode)."""
    frames = i420_to_bgr(packed, rgb=not cfg.reference_compat)
    return frame_step(nets, frames, cfg, dtype)


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


class Detector:
    """The score path on one device.

    ``params``: optional mapping net name -> JAX-layout param tree
    (``pnet``, ``rnet``, ``onet``, ``facenet``, ``landmark68``); missing
    nets load from ``weights_dir``/``$TRUELY_TPU_WEIGHTS`` or take the
    seeded init.  ``device`` defaults to CUDA and raises when there is no
    CUDA device; pass ``device="cpu"`` to run the plain versions on the CPU.
    """

    def __init__(self, config: Optional[DetectorConfig] = None,
                 params: Optional[Mapping[str, object]] = None,
                 device=None, weights_dir: Optional[str] = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.config = config or DetectorConfig()
        self.dtype = getattr(torch, self.config.compute_dtype)
        nets = {name: m.to(self.device) for name, m in load_all(params, weights_dir).items()}
        self.nets = DetectorNets(
            mtcnn=MTCNNNets(nets["pnet"], nets["rnet"], nets["onet"]),
            facenet=nets["facenet"], landmark=nets["landmark68"],
        )
        self.embedding_dim = nets["facenet"].last_linear.out_features

    def _precision(self):
        return full_float32() if self.dtype == torch.float32 else contextlib.nullcontext()

    def step(self, frames: torch.Tensor) -> FrameOutputs:
        """One batch of (B, H, W, 3) uint8 frames on the device."""
        with torch.inference_mode(), self._precision():
            return frame_step(self.nets, frames, self.config, self.dtype)

    def step_yuv(self, packed: torch.Tensor) -> FrameOutputs:
        """One batch of packed I420 (B, 3H/2, W) uint8 frames on the device."""
        with torch.inference_mode(), self._precision():
            return frame_step_yuv(self.nets, packed, self.config, self.dtype)

    def temporal(self, out: FrameOutputs, n_valid: int, state: TemporalState) -> TemporalResult:
        with torch.inference_mode():
            return temporal_consistency(
                out.embedding, out.has_face, n_valid, state=state,
                similarity_threshold=self.config.similarity_threshold,
                run_length_threshold=self.config.run_length_threshold,
            )

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

    def _analyze(self, frames: np.ndarray, fps: int, *, yuv: bool) -> VideoAnalysis:
        cfg = self.config
        step = self.step_yuv if yuv else self.step
        t_start = time.perf_counter()
        timings = {"upload": 0.0, "device": 0.0}
        n = frames.shape[0]
        sampled = list(range(0, n, cfg.sample_interval(fps)))
        b = cfg.frame_batch
        state = init_temporal_state(self.embedding_dim, self.device)
        records: List[FrameRecord] = []
        flagged_total = 0

        def fetch(chunk, out, res):
            nonlocal flagged_total
            t0 = time.perf_counter()
            bounds, has_face, annotated, flagged, sims, counters = (
                t.cpu().numpy() for t in (out.crop_bounds, res.has_face, res.annotated,
                                          res.flagged, res.similarity, res.counter))
            timings["device"] += time.perf_counter() - t0
            flagged_total += int(np.sum(flagged[: len(chunk)]))
            for k, gi in enumerate(chunk):
                records.append(FrameRecord(
                    frame_index=gi, has_face=bool(has_face[k]),
                    box=tuple(float(v) for v in bounds[k]), annotated=bool(annotated[k]),
                    flagged=bool(flagged[k]), similarity=float(sims[k]),
                    counter=int(counters[k]),
                ))

        # One-deep pipeline: batch N+1 is uploaded and enqueued before the
        # host waits on batch N's results.
        in_flight = None
        for s in range(0, len(sampled), b):
            chunk = sampled[s:s + b]
            t0 = time.perf_counter()
            stack = np.zeros((b,) + frames.shape[1:], np.uint8)
            stack[: len(chunk)] = frames[chunk]
            dev = torch.from_numpy(stack).to(self.device, non_blocking=True)
            timings["upload"] += time.perf_counter() - t0
            out = step(dev)
            res = self.temporal(out, len(chunk), state)
            state = res.state
            if in_flight is not None:
                fetch(*in_flight)
            in_flight = (chunk, out, res)
        if in_flight is not None:
            fetch(*in_flight)

        final_counter = int(state.counter)
        timings["total"] = time.perf_counter() - t_start
        return VideoAnalysis(
            fake_score=self.score(flagged_total, final_counter, len(sampled), n, fps),
            frame_count=n, fps=fps, total_processed=len(sampled),
            flagged_count=flagged_total, final_counter=final_counter,
            records=records, timings=timings, yuv_ingest=yuv,
        )
