"""Live multi-stream analysis of video files (counterpart of
``truely_tpu/pipeline/stream_files.py``, without its multi-device mesh).

N concurrent files go through the shared-batch ``StreamScheduler``: every
device step packs sampled frames from all streams, and each stream gets
live events and an end-of-stream summary with sampled frames/s and lag
statistics.  Each stream's events and score equal the solo
``Detector.analyze_video`` of its file.

Exposed as ``python -m truely_tpu_torch stream A.avi B.avi ...`` (cli.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from truely_tpu_torch.media.decode import VideoReader
from truely_tpu_torch.ops.temporal import weighted_score
from truely_tpu_torch.pipeline.streaming import StreamEvent, StreamScheduler


@dataclass
class StreamSummary:
    path: str
    fake_score: int
    frame_count: int
    fps: int
    processed: int            # sampled frames analyzed
    flagged_count: int
    suspicious_frames: List[int]
    wall_s: float             # stream open -> last event
    sampled_fps: float        # processed / wall_s
    mean_lag_s: float         # push -> event latency
    max_lag_s: float
    yuv_ingest: bool = False
    p50_lag_s: float = 0.0
    p95_lag_s: float = 0.0
    # Multi-face mode only: per-track 0-100 scores (fake_score = max).
    track_scores: Optional[List[int]] = None


@dataclass
class _PerStream:
    it: object
    done: bool = False
    frame_count: int = 0
    push_times: Dict[int, float] = field(default_factory=dict)
    lags: List[float] = field(default_factory=list)
    flagged: List[int] = field(default_factory=list)


def stream_videos(
    detector,
    paths: Sequence[str],
    *,
    frames_per_stream: Optional[int] = None,
    mesh=None,
    realtime: bool = False,
    partial_step_budget: float = 0.0,
    yuv: Optional[bool] = None,
    on_event: Optional[Callable[[StreamEvent], None]] = None,
    scheduler_stats: Optional[dict] = None,
    multi_face: Optional[bool] = None,
) -> List[StreamSummary]:
    """Analyze N same-resolution videos as concurrent live streams.

    ``realtime=True`` paces each stream at its own fps (a live feed; lag
    then reflects steady-state latency); by default files are read as fast
    as decode allows (lag reflects batching and device time).  ``yuv=None``
    follows the detector's ``yuv_ingest``; packed I420 is used only when
    every stream can give it.  ``on_event`` fires for every sampled frame as
    its step completes.  A dict passed as ``scheduler_stats`` receives the
    batch-efficiency counters (steps, frames scored, padded rows uploaded).
    ``mesh`` goes to the scheduler, which splits every shared batch over the
    mesh's data axis (default: the detector's mesh).

    ``partial_step_budget`` (realtime only): a partial batch runs only once
    its oldest queued frame is that many seconds old; until then the loop
    accumulates toward a full batch.  0 steps on any paced idle gap.

    ``multi_face=None`` follows the detector config: in multi-face mode
    every stream runs per-track scoring (events are
    ``MultiFaceStreamEvent``, summaries carry ``track_scores``, the score is
    the max over tracks: the solo ``analyze_video_multiface`` result)."""
    if yuv is None:
        yuv = detector.config.yuv_ingest
    readers: List[VideoReader] = []
    try:
        for p in paths:
            readers.append(VideoReader(p, rgb=not detector.config.reference_compat, yuv=yuv))
        return _run(detector, paths, readers, frames_per_stream=frames_per_stream,
                    mesh=mesh, realtime=realtime, partial_step_budget=partial_step_budget,
                    on_event=on_event, scheduler_stats=scheduler_stats, multi_face=multi_face)
    finally:
        for r in readers:
            r.close()


def _run(detector, paths, readers, *, frames_per_stream, mesh, realtime, on_event,
         scheduler_stats=None, partial_step_budget=0.0, multi_face=None):
    metas = [r.meta for r in readers]
    h, w = metas[0].height, metas[0].width
    for m in metas[1:]:
        if (m.height, m.width) != (h, w):
            raise ValueError("stream_videos requires equal resolutions: "
                             f"{(h, w)} vs {(m.height, m.width)}")
    # one kind of ingest for all: packed I420 only when every stream has it
    use_yuv = all(r.yuv_active for r in readers)
    sched = StreamScheduler(detector, n_streams=len(paths), frames_per_stream=frames_per_stream,
                            fps=metas[0].fps, mesh=mesh, yuv=use_yuv, multi_face=multi_face)
    cfg = detector.config
    streams: List[_PerStream] = []
    for r, m in zip(readers, metas):
        interval = cfg.sample_interval(m.fps)
        streams.append(_PerStream(it=r.yuv_frames(interval) if use_yuv
                                  else _bgr_frames(r, interval)))
    capacity = len(paths) * sched.frames_per_stream

    t_start = time.perf_counter()
    next_due = [t_start] * len(paths)  # realtime pacing

    def handle(events: List[StreamEvent]) -> None:
        now = time.perf_counter()
        for e in events:
            st = streams[e.stream_id]
            pushed = st.push_times.pop(e.frame_index, None)
            if pushed is not None:
                st.lags.append(now - pushed)
            if e.flagged:
                st.flagged.append(e.frame_index)
            if on_event is not None:
                on_event(e)

    while not all(s.done for s in streams):
        now = time.perf_counter()
        for i, st in enumerate(streams):
            if st.done:
                continue
            if realtime and now < next_due[i]:
                continue
            try:
                idx, frame = next(st.it)
            except StopIteration:
                st.done = True
                continue
            st.frame_count += 1
            next_due[i] += 1.0 / max(metas[i].fps_exact, 1.0)
            if frame is not None:
                st.push_times[idx] = time.perf_counter()
                sched.push_sampled(i, frame, idx, st.frame_count)
            else:
                sched.stats[i].frames_seen = st.frame_count
        if sched.pending() >= capacity:
            handle(sched.step())
        elif realtime and all(s.done or now < next_due[i] for i, s in enumerate(streams)):
            # A paced idle gap: run a partial step rather than sit on queued
            # frames, unless the budget defers it while the oldest queued
            # frame is younger than the budget.
            if sched.pending():
                oldest = min(min(st.push_times.values()) for st in streams if st.push_times)
                if time.perf_counter() - oldest >= partial_step_budget:
                    handle(sched.step())
                else:
                    time.sleep(0.001)
            else:
                time.sleep(0.001)
    handle(sched.drain())
    wall = time.perf_counter() - t_start
    if scheduler_stats is not None:
        util = sched.frames_stepped / max(1, sched.frames_stepped + sched.frames_padded)
        scheduler_stats.update(steps=sched.steps_run, frames_scored=sched.frames_stepped,
                               frames_padded=sched.frames_padded, batch_utilization=util)

    summaries = []
    for i, (path, st, m) in enumerate(zip(paths, streams, metas)):
        stats = sched.stats[i]
        track_scores = None
        if sched.multi_face:
            per_track = sched.track_scores_for(i, frames_seen=st.frame_count, fps=m.fps)
            track_scores = [int(v) for v in per_track]
            score = int(per_track.max(initial=0)) if stats.processed else 0
        else:
            score = weighted_score(
                stats.flagged_count, sched.stream_counter(i), stats.processed, st.frame_count,
                m.fps, run_length_threshold=cfg.run_length_threshold,
                long_video_seconds=cfg.long_video_seconds) if stats.processed else 0
        summaries.append(StreamSummary(
            path=path, fake_score=score, frame_count=st.frame_count, fps=m.fps,
            processed=stats.processed, flagged_count=stats.flagged_count,
            suspicious_frames=sorted(st.flagged), wall_s=wall,
            sampled_fps=stats.processed / wall if wall > 0 else 0.0,
            mean_lag_s=(sum(st.lags) / len(st.lags)) if st.lags else 0.0,
            max_lag_s=max(st.lags) if st.lags else 0.0,
            p50_lag_s=_percentile(st.lags, 0.50), p95_lag_s=_percentile(st.lags, 0.95),
            yuv_ingest=use_yuv, track_scores=track_scores,
        ))
    return summaries


def _percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile of a small latency sample."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def _bgr_frames(reader: VideoReader, interval: int):
    """(idx, frame or None), the shape ``yuv_frames`` yields."""
    for idx, frame in reader.frames():
        yield idx, (frame if idx % interval == 0 else None)
