"""Multi-stream scheduler (counterpart of ``truely_tpu/pipeline/streaming.py``).

N concurrent video streams share device batches: each ``step()`` packs up
to ``frames_per_stream`` queued sampled frames of every stream into one
(N·F, H, W, 3) batch (or packed I420 with ``yuv=True``), runs one frame
step on it, then folds each stream's slice through its own state, all
streams in one batched fold (``ops/temporal.py`` over a leading stream
axis, or ``pipeline/tracks.py`` in multi-face mode), so each stream gets
exactly the decisions it would get analyzed alone.

With ``detect_interval`` K > 1 every K-th step runs the full cascade and
the steps between refine every row from its stream's carried seed
(``detector.frame_step_refine``, or ``multiface_step_refine`` with the
stream's T track seeds); a step where no stream holds a seed is promoted
to a keyframe step.  "auto" ladders K (single face only: a multi-face
scheduler given "auto" runs full detection on every step).

With ``mesh=`` (default: the detector's) each step's batch is split over
the mesh's data axis (``Detector.sharded_step``); events and scores are
the single-device ones.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Deque, Dict, List, Tuple

import numpy as np
import torch

from truely_tpu_torch.config import DetectorConfig
from truely_tpu_torch.ops.temporal import (
    init_temporal_state, temporal_consistency, weighted_score,
)
from truely_tpu_torch.pipeline.detector import (
    frame_step, frame_step_refine, frame_step_refine_yuv, frame_step_yuv, multiface_step,
    multiface_step_refine, multiface_step_refine_yuv, multiface_step_yuv,
)
from truely_tpu_torch.pipeline.tracks import init_track_state, stream_state


@dataclass
class StreamEvent:
    stream_id: int
    frame_index: int
    has_face: bool
    flagged: bool
    annotated: bool
    box: Tuple[float, float, float, float]
    similarity: float
    counter: int


@dataclass
class MultiFaceStreamEvent:
    """Per-sampled-frame event in multi-face mode: one entry per track slot.
    ``track_updated[t]`` means track t matched a detection and had a
    previous embedding, the condition under which a solo multi-face run
    draws its box."""

    stream_id: int
    frame_index: int
    track_boxes: Tuple[Tuple[float, float, float, float], ...]  # (T, 4)
    track_updated: Tuple[bool, ...]
    track_flagged: Tuple[bool, ...]
    track_sim: Tuple[float, ...]
    track_active: Tuple[bool, ...]

    @property
    def has_face(self) -> bool:
        return any(self.track_updated)

    @property
    def flagged(self) -> bool:
        return any(self.track_flagged)

    @property
    def annotated(self) -> bool:
        return any(self.track_updated)


@dataclass
class StreamStats:
    processed: int = 0       # sampled frames analyzed
    flagged_count: int = 0
    frames_seen: int = 0     # total frames pushed (incl. unsampled)
    pending: int = 0


class StreamScheduler:
    def __init__(self, detector, n_streams: int, *, frames_per_stream=None, fps: int = 60,
                 mesh=None, data_axis: str = "data", yuv: bool = False,
                 detect_interval=None, multi_face=None):
        """``detector``: a ``pipeline.detector.Detector``.  ``yuv=True``:
        pushed frames are packed I420 pictures ((H*3//2, W) uint8),
        converted on the device (kernel K1); events and scores equal BGR
        feeding.  ``mesh``/``data_axis``, ``detect_interval`` (default: the
        detector config's) and ``multi_face`` (default: the config's) as in
        the module docstring."""
        self.detector = detector
        self.config: DetectorConfig = detector.config
        self.n_streams = n_streams
        self.yuv = yuv
        self.fps = fps
        self.multi_face = multi_face if multi_face is not None else self.config.multi_face
        self.sample_interval = self.config.sample_interval(fps)
        f = frames_per_stream or max(1, self.config.frame_batch // n_streams)
        self.frames_per_stream = f
        # A mesh Detector always shards its steps, so the scheduler takes its
        # mesh by default and checks the shared batch against it.
        if mesh is None and detector.mesh is not None:
            mesh, data_axis = detector.mesh, detector._data_axis
        self._mesh = mesh
        if mesh is not None:
            n_dp = mesh.shape[data_axis]
            if (n_streams * f) % n_dp:
                raise ValueError(f"streams*frames_per_stream ({n_streams}*{f}) must be "
                                 f"divisible by the '{data_axis}' mesh axis ({n_dp})")
            # cached on the detector: one set of replicas per mesh
            self._sharded_step, self._sharded_params, _ = detector.sharded_step(
                mesh, data_axis, yuv=yuv, multiface=self.multi_face)
        self._queues: List[Deque[Tuple[int, np.ndarray]]] = [
            collections.deque() for _ in range(n_streams)]
        self._states = self._fresh_states(n_streams)
        self.stats: Dict[int, StreamStats] = {i: StreamStats() for i in range(n_streams)}
        # Batch efficiency: a partial step still uploads the whole
        # zero-padded batch.
        self.steps_run = 0
        self.frames_stepped = 0      # valid rows scored
        self.frames_padded = 0       # zero rows uploaded beside them

        k = detect_interval if detect_interval is not None else self.config.detect_interval
        # "auto" ladders the keyframe cadence 1 -> 2 -> ... ->
        # auto_interval_max while refine steps keep their seeds.  The ladder
        # is single-face: a multi-face scheduler given "auto" runs full
        # detection on every step.
        self.auto_interval = k == "auto"
        if self.auto_interval and self.multi_face:
            self.auto_interval = False
            k = 1
        if self.auto_interval:
            kmax = self.config.auto_interval_max
            if kmax < 2:
                raise ValueError(f"auto_interval_max must be >= 2, got {kmax}")
            self._cur_k = 1
            k = kmax
        elif not isinstance(k, int) or k < 1:
            raise ValueError(f'detect_interval must be an int >= 1 or "auto", got {k!r}')
        self.detect_interval = k
        self.keyframe_steps = 0      # full-cascade steps run
        if k > 1:
            seed_shape = (n_streams, self.config.max_tracks) if self.multi_face else (n_streams,)
            self._seed_box = np.zeros(seed_shape + (4,), np.float32)
            self._seed_valid = np.zeros(seed_shape, bool)
            self._since_keyframe = 0
        if self.multi_face:
            self._full = multiface_step_yuv if yuv else multiface_step
            self._refine = multiface_step_refine_yuv if yuv else multiface_step_refine
        else:
            self._full = frame_step_yuv if yuv else frame_step
            self._refine = frame_step_refine_yuv if yuv else frame_step_refine
        if mesh is not None and k > 1:
            self._refine_step, _ = detector.sharded_refine_step(
                mesh, data_axis, yuv=yuv, rows_per_seed=f, multiface=self.multi_face)

    def _fresh_states(self, n: int):
        dim, device = self.detector.embedding_dim, self.detector.device
        if self.multi_face:
            return init_track_state(self.config.max_tracks, dim, streams=n, device=device)
        return init_temporal_state(dim, device, lead=(n,))

    # ------------------------------------------------------------------

    def push(self, stream_id: int, frame: np.ndarray) -> None:
        """Feed the next frame of a stream; every ``sample_interval``-th
        frame is queued for the next step."""
        st = self.stats[stream_id]
        if st.frames_seen % self.sample_interval == 0:
            self._queues[stream_id].append((st.frames_seen, frame))
            st.pending += 1
        st.frames_seen += 1

    def push_sampled(self, stream_id: int, frame: np.ndarray, frame_index: int,
                     frames_seen: int) -> None:
        """Feed an already-sampled frame (for callers with their own
        sampling law); ``frames_seen`` is the score's frame count."""
        st = self.stats[stream_id]
        self._queues[stream_id].append((frame_index, frame))
        st.pending += 1
        st.frames_seen = frames_seen

    def stream_counter(self, stream_id: int) -> int:
        """A stream's run-length counter (multi-face: the max over its
        tracks)."""
        c = self._states.counter[stream_id].cpu().numpy()
        return int(c.max()) if self.multi_face else int(c)

    def track_scores_for(self, stream_id: int, *, frames_seen=None, fps=None) -> np.ndarray:
        """Per-track 0-100 scores of one stream (multi-face mode), what a
        solo multi-face analysis of the stream returns."""
        if not self.multi_face:
            raise ValueError("track_scores_for requires multi_face mode")
        st = self.stats[stream_id]
        return self.detector.track_scores(
            stream_state(self._states, stream_id),
            frames_seen if frames_seen is not None else st.frames_seen,
            fps if fps is not None else self.fps)

    def reset_stream(self, stream_id: int) -> None:
        """Recycle a stream slot for a new stream: drop its queue, seed,
        state and stats, so nothing of the old stream leaks into the new
        one.  The states are rebuilt, not written in place (the folds
        return inference tensors)."""
        self._queues[stream_id].clear()
        if self.detect_interval > 1:
            self._seed_valid[stream_id] = False
            self._seed_box[stream_id] = 0.0
        i = stream_id
        self._states = type(self._states)(*(
            torch.cat([x[:i], fresh, x[i + 1:]])
            for x, fresh in zip(self._states, self._fresh_states(1))))
        self.stats[stream_id] = StreamStats()

    def pending(self) -> int:
        return sum(len(q) for q in self._queues)

    # ------------------------------------------------------------------

    def step(self) -> list:
        """Run one shared device batch over whatever is queued."""
        s, f = self.n_streams, self.frames_per_stream
        sample = next((q[0][1] for q in self._queues if q), None)
        if sample is None:
            return []
        batch = np.zeros((s, f) + sample.shape, np.uint8)
        n_valid = np.zeros((s,), np.int32)
        indices: List[List[int]] = [[] for _ in range(s)]
        for i, q in enumerate(self._queues):
            while q and len(indices[i]) < f:
                idx, frame = q.popleft()
                batch[i, len(indices[i])] = frame
                indices[i].append(idx)
                self.stats[i].pending -= 1
            n_valid[i] = len(indices[i])

        n_total = int(n_valid.sum())
        self.steps_run += 1
        self.frames_stepped += n_total
        self.frames_padded += s * f - n_total

        run_full = True
        if self.detect_interval > 1:
            # full cascade every K-th step (the ladder's rung in "auto"),
            # earlier when no stream holds a seed
            cadence = self._cur_k if self.auto_interval else self.detect_interval
            run_full = self._since_keyframe >= cadence or not self._seed_valid.any()
            seeded_before = self._seed_valid.copy()
            if run_full:
                self.keyframe_steps += 1
                self._since_keyframe = 1
            else:
                self._since_keyframe += 1
        det = self.detector
        frames = torch.from_numpy(batch.reshape((s * f,) + sample.shape)).to(det.device)
        if not run_full:
            seeds = (torch.from_numpy(self._seed_box).to(det.device),
                     torch.from_numpy(self._seed_valid).to(det.device))
        if self._mesh is not None:
            params = self._sharded_params
            out = (self._sharded_step(params, frames) if run_full
                   else self._refine_step(params, frames, *seeds))
            # gathered on the mesh's first device; the states are on the detector's
            moved = (t.to(det.device) for t in out)
            out = out._make(moved) if hasattr(out, "_make") else tuple(moved)
        elif run_full:
            out = det._run(self._full, frames)
        else:
            out = det._run(self._refine, frames, *seeds, rows_per_seed=f)
        n_dev = torch.from_numpy(n_valid).to(det.device)
        if self.multi_face:
            return self._multiface_events(out, n_valid, n_dev, indices)

        with torch.inference_mode():
            res = temporal_consistency(
                out.embedding.reshape(s, f, -1), out.has_face.reshape(s, f), n_dev,
                state=self._states, similarity_threshold=self.config.similarity_threshold,
                run_length_threshold=self.config.run_length_threshold)
        self._states = res.state
        bounds, obox, ohf, hf, ann, flg, sim, cnt = (t.cpu().numpy() for t in (
            out.crop_bounds, out.box, out.has_face, res.has_face, res.annotated, res.flagged,
            res.similarity, res.counter))
        bounds, obox, ohf = bounds.reshape(s, f, 4), obox.reshape(s, f, 4), ohf.reshape(s, f)
        if self.detect_interval > 1:
            # each stream's seed rolls to its latest row with a face; a
            # stream with none drops it and re-acquires at a keyframe step
            for i in range(s):
                nv = int(n_valid[i])
                if nv == 0:
                    continue
                rows = np.nonzero(ohf[i, :nv])[0]
                self._seed_valid[i] = rows.size > 0
                if rows.size:
                    self._seed_box[i] = obox[i, rows[-1]]
            if self.auto_interval:
                self._auto_ladder_update(run_full, seeded_before, ohf, n_valid)
        events: List[StreamEvent] = []
        for i in range(s):
            for j, frame_idx in enumerate(indices[i]):
                events.append(StreamEvent(
                    stream_id=i, frame_index=frame_idx, has_face=bool(hf[i, j]),
                    flagged=bool(flg[i, j]), annotated=bool(ann[i, j]),
                    box=tuple(float(v) for v in bounds[i, j]), similarity=float(sim[i, j]),
                    counter=int(cnt[i, j])))
            st = self.stats[i]
            st.processed += int(n_valid[i])
            st.flagged_count += int(flg[i, : n_valid[i]].sum())
        return events

    def _auto_ladder_update(self, run_full: bool, seeded_before: np.ndarray, ohf: np.ndarray,
                            n_valid: np.ndarray) -> None:
        """The "auto" rung after a step: after a keyframe step, leave rung
        1 once at least half the valid rows hold a face; after a refine
        step, over the rows whose stream carried a seed into it, collapse
        to 1 if more than half lost their face, double (up to
        ``auto_interval_max``) if at most ``auto_escalate_lost`` did."""
        kmax = self.config.auto_interval_max
        if run_full:
            total = int(n_valid.sum())
            found = sum(int(ohf[i, : n_valid[i]].sum()) for i in range(self.n_streams))
            if self._cur_k == 1 and total and found * 2 >= total:
                self._cur_k = min(2, kmax)
            return
        seeded_rows = lost = 0
        for i in np.nonzero(seeded_before)[0]:
            nv = int(n_valid[i])
            seeded_rows += nv
            lost += nv - int(ohf[i, :nv].sum())
        if seeded_rows == 0 or lost * 2 > seeded_rows:
            self._cur_k = 1
        elif lost <= self.config.auto_escalate_lost * seeded_rows:
            self._cur_k = min(self._cur_k * 2, kmax)

    def _multiface_events(self, out, n_valid: np.ndarray, n_dev: torch.Tensor,
                          indices: List[List[int]]) -> List[MultiFaceStreamEvent]:
        """The multi-face half of ``step()``: every stream's slice folded
        into its track state, seeds rolled, per-track events."""
        s, f = self.n_streams, self.frames_per_stream
        t = self.config.max_tracks
        boxes, valid, emb = out
        boxes, valid = boxes.reshape(s, f, t, 4), valid.reshape(s, f, t)
        self._states, outs = self.detector.track_fold(
            self._states, boxes, valid, emb.reshape(s, f, t, -1), n_dev)
        tb, tu, tf, tsim, ta, dv, db = (x.cpu().numpy() for x in (
            outs.track_box, outs.track_updated, outs.track_flagged, outs.track_sim,
            outs.track_active, valid, boxes))
        if self.detect_interval > 1:
            # each stream's T seeds roll to its latest row with any
            # detection; a stream with none drops them
            for i in range(s):
                nv = int(n_valid[i])
                if nv == 0:
                    continue
                rows = np.nonzero(dv[i, :nv].any(axis=-1))[0]
                if rows.size:
                    self._seed_box[i] = db[i, rows[-1]]
                    self._seed_valid[i] = dv[i, rows[-1]]
                else:
                    self._seed_valid[i] = False
        events: List[MultiFaceStreamEvent] = []
        for i in range(s):
            for j, frame_idx in enumerate(indices[i]):
                events.append(MultiFaceStreamEvent(
                    stream_id=i, frame_index=frame_idx,
                    track_boxes=tuple(tuple(float(v) for v in tb[i, j, k]) for k in range(t)),
                    track_updated=tuple(bool(v) for v in tu[i, j]),
                    track_flagged=tuple(bool(v) for v in tf[i, j]),
                    track_sim=tuple(float(v) for v in tsim[i, j]),
                    track_active=tuple(bool(v) for v in ta[i, j])))
            st = self.stats[i]
            nv = int(n_valid[i])
            st.processed += nv
            # frames where any track flagged (per-track counts live in the
            # track state)
            st.flagged_count += int(tf[i, :nv].any(axis=-1).sum())
        return events

    def drain(self) -> list:
        events = []
        while self.pending():
            events.extend(self.step())
        return events

    # ------------------------------------------------------------------

    def score(self, stream_id: int) -> int:
        """Rolling fake score of one stream over the frames seen so far
        (multi-face: the max over its per-track scores)."""
        st = self.stats[stream_id]
        if st.processed == 0:
            return 0
        if self.multi_face:
            return int(self.track_scores_for(stream_id).max(initial=0))
        return weighted_score(
            st.flagged_count, self.stream_counter(stream_id), st.processed, st.frames_seen,
            self.fps, run_length_threshold=self.config.run_length_threshold,
            long_video_seconds=self.config.long_video_seconds)
