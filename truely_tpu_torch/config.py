"""Configuration of the detector and the API server, copied from
``truely_tpu/config.py``.

Only the fields this package reads are kept, with the same names and
defaults.  The TPU layout switches (folded P-Net, Pallas NMS/face crop/YUV)
are left out: on the card the hand-written kernels always run.  The
semantic switches that change results stay: ``pyramid_cascade``,
``stage_crop_quant``, ``compute_dtype``, the thresholds, the capacities, the
NMS round cap and track propagation (``detect_interval`` and its options).
``use_fused_crops`` stays as the choice between the two stage-crop kernels:
1 selects kernel K5 (``ops/crop_area_fused.py``) whenever the stage crops
are exact (q == 1); 0 and 2 keep kernel K3, which already serves what the
JAX package's ``crop_fused2.py`` (version 2) serves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MTCNNConfig:
    """Cascade parameters (facenet_pytorch MTCNN defaults)."""

    min_face_size: int = 20
    # Stage score thresholds for P-Net / R-Net / O-Net.
    thresholds: Tuple[float, float, float] = (0.6, 0.7, 0.7)
    # Pyramid decimation factor between scales.
    scale_factor: float = 0.709
    # NMS IoU thresholds: per-scale P-Net, cross-scale P-Net, R-Net, O-Net.
    nms_thresholds: Tuple[float, float, float, float] = (0.5, 0.7, 0.7, 0.7)
    # Round cap of the parallel-greedy NMS fixpoint (0 = run to
    # convergence); deeper chains get the deterministic tail rule.
    nms_max_rounds: int = 64
    # bf16 only: resample each pyramid level from the previous level
    # instead of the full frame.  float32 keeps the exact one-shot resample.
    pyramid_cascade: bool = True
    # bf16 only: snap R-Net/O-Net crop boxes to a quant-px grid (exact
    # integer semantics on the block-summed frame).  1 = exact crops.
    stage_crop_quant: int = 4
    # Fixed capacities: one global top-K over every pyramid cell, then
    # after R-Net and after O-Net.
    pnet_topk_total: int = 256
    rnet_capacity: int = 64
    onet_capacity: int = 32
    # Select the largest-area face (facenet_pytorch select_largest=True).
    select_largest: bool = True
    # Exact (q == 1) stage crops through kernel K5 (1) or kernel K3 (0, 2).
    # Both are bit-equal; q > 1 always takes K3.
    use_fused_crops: int = 0


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """The DFDC winner's classifier on the multi-face path
    (github.com/selimsef/dfdc_deepfake_challenge): every valid face crop
    grown by ``box // margin`` on each side, resized so its long side is
    ``input_size`` and centred on a square canvas (kernel K7), then each of
    ``ensemble`` nets; a video's score is the mean over the nets of each
    net's ``confident_strategy`` over its crops' probabilities."""

    net: str = "tf_efficientnet_b7_ns"
    input_size: int = 380
    # The box grows by w // margin and h // margin on each side: a third.
    margin: int = 3
    ensemble: int = 7
    # confident_strategy(pred, t=0.8): more than min_fakes crops (and more
    # than len // 2.5) above fake_threshold: their mean; else more than 90%
    # below real_threshold: their mean; else the mean of all.
    fake_threshold: float = 0.8
    real_threshold: float = 0.2
    min_fakes: int = 11
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """End-to-end visual detector parameters."""

    mtcnn: MTCNNConfig = MTCNNConfig()
    # Cosine similarity below which a frame pair is "drifting".
    similarity_threshold: float = 0.99
    # Consecutive drifting sampled frames before flagging.
    run_length_threshold: int = 15
    # Face-crop side fed to FaceNet (the reference feeds 80, not 160).
    crop_size: int = 80
    # Sampling interval is max(1, int(fps / sample_hz)).
    sample_hz: int = 7
    # Device batch of sampled frames.
    frame_batch: int = 32
    # BGR input to MTCNN and /255 crop scaling without standardization.
    reference_compat: bool = True
    # Compute dtype of the conv stacks (params stay float32).
    compute_dtype: str = "bfloat16"
    # Long-video weighting kicks in above this many seconds.
    long_video_seconds: int = 30
    # Per-face tracks (pipeline/tracks.py) instead of the largest face
    # only: up to max_tracks faces per frame, each with its own counter and
    # score; the video's score is the max over tracks.
    multi_face: bool = False
    max_tracks: int = 4
    # Track-propagated detection: the full cascade runs on every K-th
    # sampled frame only (a keyframe); the frames between refine the
    # keyframe's box through R-Net/O-Net (pipeline/mtcnn.refine_faces).
    # 1 = off (full detection on every sampled frame).  "auto" ladders K
    # 1 -> 2 -> 4 -> ... -> auto_interval_max while refinement keeps its
    # seeds and drops back to 1 when a cycle loses most of them.
    # frame_batch must be divisible by K (by auto_interval_max for "auto").
    detect_interval: "int | str" = 1
    # "auto": the top rung, a power of two.
    auto_interval_max: int = 8
    # "auto": escalate after a cycle that lost at most this fraction of its
    # seeded frames.
    auto_escalate_lost: float = 0.1
    # With K > 1: re-run full detection on a segment whose refinement lost
    # more than half of its seeded frames (one host sync per segment).
    propagate_fallback: bool = True
    # Draw the 68-point landmark head's output on annotated frames.
    draw_landmarks: bool = False
    # Which frames of the annotated output get boxes: "all" (every sampled
    # frame with a face, the reference's contract) or "flagged-only" (red
    # boxes on flagged frames only; the others re-encode from their decoded
    # I420 planes).  Decisions are the same in both modes.
    draw_mode: str = "all"
    # Read files as packed I420 and convert on the device (kernel K1) when
    # the reader can (media/decode.py: an uncompressed I420 AVI, or an
    # eligible stream through the native libav decoder); other files decode
    # to BGR on the host.  Results are the same either way.
    yuv_ingest: bool = True
    # The DFDC classifier on every multi-face step's valid face crops
    # (``pipeline/classifier.py``); None: not run.
    classifier: Optional[ClassifierConfig] = None

    def sample_interval(self, fps: int) -> int:
        return max(1, int(fps / self.sample_hz))


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """API server parameters (reference server/server.py)."""

    host: str = "0.0.0.0"
    port: int = 5001
    result_ttl_seconds: float = 3600.0
    cleanup_period_seconds: float = 300.0
    default_quality: str = "360p"
    video_download_timeout: float = 180.0
    audio_download_timeout: float = 120.0
    # Optional JSON snapshot so unexpired results survive server restarts.
    result_store_path: str = ""
    # Resolution buckets ("HxW") to warm at startup on a background thread
    # (``Detector.warmup``: the kernels' build, cuDNN's algorithm choice and
    # the allocator's first growth), so the first /analyze-* request does
    # not pay them.  /health reports progress.
    warmup_resolutions: tuple = ()


@dataclasses.dataclass(frozen=True)
class AgentsConfig:
    """Fact-check agent parameters (reference server/web/): the defaults of
    ``agents/transcribe.py``, ``agents/judge.py`` and ``agents/search.py``."""

    groq_model: str = "whisper-large-v3-turbo"
    gemini_model: str = "gemini-2.5-flash"
    gemini_temperature: float = 0.2
    tavily_max_results: int = 5
    search_query_max_chars: int = 350
    fallback_query_words: int = 30
