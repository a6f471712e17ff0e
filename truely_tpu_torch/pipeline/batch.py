"""Offline batch analysis: many videos through shared device batches
(counterpart of ``truely_tpu/pipeline/batch.py``, without its mesh).

Each video is a stream of the multi-stream scheduler: every device step
packs frames of all videos into one batch, and per-video states keep each
video's decisions exactly those of its solo analysis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from truely_tpu_torch.media.decode import VideoReader
from truely_tpu_torch.media.encode import VideoWriter
from truely_tpu_torch.media.native import i420_to_bgr_host
from truely_tpu_torch.media.overlay import annotate_frame
from truely_tpu_torch.pipeline.stream_files import stream_videos


@dataclass
class BatchVideoResult:
    path: str
    fake_score: int
    frame_count: int
    fps: int
    total_processed: int
    flagged_count: int
    suspicious_frames: List[int]
    output_path: Optional[str] = None
    # Multi-face mode only: per-track scores (fake_score = max over tracks).
    track_scores: Optional[List[int]] = None


def _result(s, output_path: Optional[str] = None) -> BatchVideoResult:
    return BatchVideoResult(path=s.path, fake_score=s.fake_score, frame_count=s.frame_count,
                            fps=s.fps, total_processed=s.processed,
                            flagged_count=s.flagged_count,
                            suspicious_frames=s.suspicious_frames, output_path=output_path,
                            track_scores=s.track_scores)


def analyze_videos(detector, paths: Sequence[str], *, frames_per_video: Optional[int] = None,
                   mesh=None) -> List[BatchVideoResult]:
    """Analyze a batch of same-resolution videos concurrently on one card,
    or over a mesh: ``mesh`` goes to the scheduler, which splits every
    shared batch over the mesh's data axis.

    fps may differ per video (per-video sampling intervals).  Runs the
    live-stream path (``stream_files.stream_videos``) at full decode
    speed, so each result is exactly the video's solo ``analyze_video``."""
    summaries = stream_videos(detector, paths, frames_per_stream=frames_per_video, mesh=mesh)
    return [_result(s) for s in summaries]


def _event_drawn(e, flagged_only: bool) -> bool:
    """Whether an event gets any box (the solo writers' conditions)."""
    return e.annotated and (not flagged_only or e.flagged)


def _draw_event(px, e, idx: int, rgb: bool, flagged_only: bool) -> None:
    """Draw one event: per-track boxes for a multi-face event (the tracks
    ``analyze_video_multiface`` draws), else the one box."""
    boxes = getattr(e, "track_boxes", None)
    if boxes is None:
        annotate_frame(px, e.box, flagged=e.flagged, frame_index=idx, rgb=rgb)
        return
    for t, box in enumerate(boxes):
        if e.track_updated[t] and (not flagged_only or e.track_flagged[t]):
            annotate_frame(px, box, flagged=bool(e.track_flagged[t]), frame_index=idx, rgb=rgb)


def render_annotated(config, path: str, output_path: str, events) -> None:
    """Re-render one video with the boxes its stream events imply, on the
    host: decode, draw on the frames with a drawn event, encode.  Frames
    without one pass through as I420 where the reader gives it, as in
    ``Detector.analyze_video``'s writer path."""
    rgb = not config.reference_compat
    flagged_only = config.draw_mode == "flagged-only"
    with VideoReader(path, rgb=rgb, yuv=config.yuv_ingest, host_frames=True) as reader:
        meta = reader.meta
        with VideoWriter(output_path, meta.fps, meta.width, meta.height) as writer:
            if reader.yuv_active:
                for idx, packed in reader.yuv_frames():
                    e = events.get(idx)
                    if e is None or not _event_drawn(e, flagged_only):
                        writer.write_i420(packed)
                        continue
                    px = i420_to_bgr_host(packed, rgb=rgb)
                    _draw_event(px, e, idx, rgb, flagged_only)
                    writer.write(px if config.reference_compat
                                 else np.ascontiguousarray(px[..., ::-1]))
            else:
                for idx, frame in reader.frames():
                    e = events.get(idx)
                    if e is not None and _event_drawn(e, flagged_only):
                        _draw_event(frame, e, idx, rgb, flagged_only)
                    writer.write(frame if config.reference_compat
                                 else np.ascontiguousarray(frame[..., ::-1]))


def analyze_videos_annotated(detector, paths: Sequence[str], output_paths: Sequence[str], *,
                             mesh=None) -> List[BatchVideoResult]:
    """Shared-batch scoring of N same-resolution videos, plus an annotated
    output for each.  One pass through the scheduler does all device work
    for every video (decisions equal each video's solo analysis), and the
    annotation is a host-only re-render from the recorded events.  With a
    multi-face detector, results carry per-track scores and the re-render
    draws every updated track's box.  ``mesh`` as in ``analyze_videos``."""
    if len(paths) != len(output_paths):
        raise ValueError(f"{len(paths)} inputs but {len(output_paths)} output paths")
    events: Dict[int, Dict[int, object]] = {i: {} for i in range(len(paths))}

    def on_event(e):
        events[e.stream_id][e.frame_index] = e

    summaries = stream_videos(detector, paths, mesh=mesh, on_event=on_event)
    out = []
    for i, (s, opath) in enumerate(zip(summaries, output_paths)):
        render_annotated(detector.config, paths[i], opath, events[i])
        out.append(_result(s, opath))
    return out
