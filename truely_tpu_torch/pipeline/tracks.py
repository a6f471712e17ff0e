"""Multi-face tracks with per-track consistency scoring (counterpart of
``truely_tpu/pipeline/tracks.py``).

Up to ``max_tracks`` faces per frame are embedded, greedily associated to
persistent tracks by box IoU, and each track runs its own resettable
run-length counter and score; a video's score is the max over its tracks.

Every function works on a leading stream axis: the state is (S, T, ...)
and a frame's detections are (S, K, ...), so the stream scheduler folds
all its streams in one batched pass where the JAX package maps a solo fold
over them.  A solo analysis is S = 1.  The greedy match is a fixed
``min(T, K)`` steps of a flat argmax over each stream's (T, K) IoU matrix.

``track_timeline`` folds the frames of a batch one after another with no
host sync.  On CUDA tensors it is one launch of kernel K6
(``csrc/tracks.cu``: a CTA per stream, the frames in sequence), whatever
the shape; ``track_timeline_plain``, a loop of ``track_step`` over the
frames, is its plain version, taken on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from truely_tpu_torch.ops import cuda_build
from truely_tpu_torch.ops.boxes import iou_matrix
from truely_tpu_torch.ops.temporal import weighted_score


class TrackState(NamedTuple):
    active: torch.Tensor         # (S, T) bool
    box: torch.Tensor            # (S, T, 4) f32 last matched box
    embedding: torch.Tensor      # (S, T, D) f32 last face embedding
    has_prev: torch.Tensor       # (S, T) bool, embedding valid
    counter: torch.Tensor        # (S, T) int32 run-length counter
    flagged_count: torch.Tensor  # (S, T) int32
    processed: torch.Tensor      # (S, T) int32 frames with a counter update
    misses: torch.Tensor         # (S, T) int32 consecutive unmatched frames
    final_counter: torch.Tensor  # (S, T) int32 counter as of the last update


class TrackFrameOut(NamedTuple):
    """One frame's per-track outputs; ``track_timeline`` stacks them to
    (S, F, T, ...)."""

    track_flagged: torch.Tensor  # (S, T) bool
    track_sim: torch.Tensor      # (S, T) f32
    track_box: torch.Tensor      # (S, T, 4) f32
    track_active: torch.Tensor   # (S, T) bool
    track_updated: torch.Tensor  # (S, T) bool, matched with a previous embedding


def init_track_state(max_tracks: int, dim: int, streams: int = 1, device=None) -> TrackState:
    s, t = streams, max_tracks

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((s, t) + shape, dtype=dtype, device=device)

    return TrackState(
        active=zeros(dtype=torch.bool), box=zeros(4, dtype=torch.float32),
        embedding=zeros(dim, dtype=torch.float32), has_prev=zeros(dtype=torch.bool),
        counter=zeros(), flagged_count=zeros(), processed=zeros(), misses=zeros(),
        final_counter=zeros(),
    )


def stream_state(state: TrackState, i: int) -> TrackState:
    """Stream ``i``'s state, without the stream axis ((T, ...) fields)."""
    return TrackState(*(x[i] for x in state))


def _greedy_match(track_boxes, track_active, det_boxes, det_valid,
                  match_iou: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy global-argmax assignment between T tracks and K detections of
    each stream.  Returns (det_for_track (S, T), track_for_det (S, K)),
    int64 with -1 where unmatched."""
    s, t = track_boxes.shape[:2]
    k = det_boxes.shape[1]
    both = torch.cat([track_boxes, det_boxes], dim=1)
    iou = iou_matrix(both, plus_one=False)[:, :t, t:]          # (S, T, K)
    score = torch.where(track_active[:, :, None] & det_valid[:, None, :], iou, -1.0)
    det_for_track = torch.full((s, t), -1, dtype=torch.int64, device=score.device)
    track_for_det = torch.full((s, k), -1, dtype=torch.int64, device=score.device)
    rows = torch.arange(t, device=score.device)
    cols = torch.arange(k, device=score.device)
    for _ in range(min(t, k)):
        flat = score.reshape(s, t * k)
        best = torch.argmax(flat, dim=1)                   # first maximum, as jnp.argmax
        ti, ki = best // k, best % k
        ok = torch.gather(flat, 1, best[:, None])[:, 0] >= match_iou
        hit_t = rows[None, :] == ti[:, None]                # (S, T)
        hit_k = cols[None, :] == ki[:, None]                # (S, K)
        det_for_track = torch.where(ok[:, None] & hit_t, ki[:, None], det_for_track)
        track_for_det = torch.where(ok[:, None] & hit_k, ti[:, None], track_for_det)
        score = torch.where(hit_t[:, :, None] | hit_k[:, None, :], -1.0, score)
    return det_for_track, track_for_det


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (S, K, ...) at idx (S, T) -> (S, T, ...)."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def track_step(
    state: TrackState,
    det_boxes: torch.Tensor,   # (S, K, 4)
    det_valid: torch.Tensor,   # (S, K)
    det_emb: torch.Tensor,     # (S, K, D)
    *,
    similarity_threshold: float = 0.99,
    run_length_threshold: int = 15,
    match_iou: float = 0.3,
    max_misses: int = 10,
) -> Tuple[TrackState, TrackFrameOut]:
    """Fold one frame's detections of every stream into the track state."""
    t = state.box.shape[1]
    k = det_boxes.shape[1]
    det_for_track, track_for_det = _greedy_match(
        state.box, state.active, det_boxes, det_valid, match_iou)
    matched = det_for_track >= 0
    safe_det = det_for_track.clamp_min(0)
    new_box = _take(det_boxes, safe_det)
    new_emb = _take(det_emb, safe_det)

    # Similarity and counter of matched tracks with a previous embedding.
    update = matched & state.has_prev
    dot = torch.sum(new_emb * state.embedding, dim=-1)
    norms = torch.linalg.vector_norm(new_emb, dim=-1) * torch.linalg.vector_norm(
        state.embedding, dim=-1)
    sim = torch.where(update, dot / norms.clamp_min(1e-12), 0.0)
    below = sim < similarity_threshold
    counter = torch.where(update, torch.where(below, state.counter + 1, 0), state.counter)
    flagged = update & (counter > run_length_threshold)

    # Matched tracks refresh; unmatched ones accrue misses and retire after
    # max_misses.
    misses = torch.where(matched, 0, state.misses + state.active.to(torch.int32))
    active = (state.active & (misses <= max_misses)) | matched

    # Spawn: unmatched detections claim inactive slots in detection order.
    unmatched_det = det_valid & (track_for_det < 0)
    free_slot = ~active
    det_rank = torch.cumsum(unmatched_det.to(torch.int32), 1) - 1
    slot_rank = torch.cumsum(free_slot.to(torch.int32), 1) - 1
    det_ranks_full = torch.where(unmatched_det, det_rank, k + 1)
    order = torch.argsort(det_ranks_full, dim=1, stable=True)
    n_unmatched = unmatched_det.sum(1, dtype=torch.int64)
    take = min(t, k)
    cand_rank = torch.arange(take, device=order.device)
    det_by_rank = torch.full_like(det_for_track, -1)
    det_by_rank[:, :take] = torch.where(cand_rank[None, :] < n_unmatched[:, None],
                                        order[:, :take], -1)
    spawn_det = torch.where(
        free_slot, torch.gather(det_by_rank, 1, slot_rank.clamp(0, t - 1).long()), -1)
    spawns = spawn_det >= 0
    spawn_safe = spawn_det.clamp_min(0)

    box = torch.where(matched[..., None], new_box,
                      torch.where(spawns[..., None], _take(det_boxes, spawn_safe), state.box))
    emb = torch.where(matched[..., None], new_emb,
                      torch.where(spawns[..., None], _take(det_emb, spawn_safe),
                                  state.embedding))
    # A spawned track starts a fresh history, its counts included, so a
    # slot vacated by a retired track leaks nothing into the new one.
    new_state = TrackState(
        active=active | spawns,
        box=box,
        embedding=emb,
        has_prev=matched | spawns | state.has_prev,
        counter=torch.where(spawns, 0, counter),
        flagged_count=torch.where(spawns, 0, state.flagged_count + flagged.to(torch.int32)),
        processed=torch.where(spawns, 0, state.processed + update.to(torch.int32)),
        misses=torch.where(spawns, 0, misses),
        final_counter=torch.where(spawns, 0, torch.where(update, counter, state.final_counter)),
    )
    out = TrackFrameOut(track_flagged=flagged, track_sim=sim, track_box=box,
                        track_active=new_state.active, track_updated=update)
    return new_state, out


def track_timeline_plain(
    state: TrackState,
    boxes: torch.Tensor,     # (S, F, K, 4)
    valid: torch.Tensor,     # (S, F, K)
    emb: torch.Tensor,       # (S, F, K, D)
    n_valid_frames,          # int, or (S,) tensor
    **kwargs,
) -> Tuple[TrackState, TrackFrameOut]:
    """Plain version of :func:`track_timeline`: a batch of F frames of
    every stream folded through the tracker, ``track_step`` frame after
    frame.  Frames at index >= n_valid_frames of their stream are
    inert: they keep the state as it was.  Returns the final state and the
    per-frame outputs stacked to (S, F, T, ...)."""
    s, f = boxes.shape[:2]
    n = torch.as_tensor(n_valid_frames, device=boxes.device).expand(s)
    emb = emb.float()
    outs = []
    for i in range(f):
        live = i < n                                          # (S,)
        new, out = track_step(state, boxes[:, i], valid[:, i] & live[:, None], emb[:, i],
                              **kwargs)
        state = TrackState(*(
            torch.where(live.reshape((s,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(new, state)))
        outs.append(out)
    return state, TrackFrameOut(*(torch.stack(x, dim=1) for x in zip(*outs)))


@functools.lru_cache(maxsize=None)
def _workspace_words(t: int, k: int) -> int:
    """int32 words of K6's scratch per stream at T tracks and K detections."""
    fn = cuda_build.load("tracks").tt_track_fold_workspace_words
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    return fn(t, k)


def track_timeline(
    state: TrackState,
    boxes: torch.Tensor,     # (S, F, K, 4)
    valid: torch.Tensor,     # (S, F, K)
    emb: torch.Tensor,       # (S, F, K, D)
    n_valid_frames,          # int, or (S,) tensor
    *,
    similarity_threshold: float = 0.99,
    run_length_threshold: int = 15,
    match_iou: float = 0.3,
    max_misses: int = 10,
) -> Tuple[TrackState, TrackFrameOut]:
    """Fold a batch of F frames of every stream through the tracker, frame
    after frame.  Frames at index >= n_valid_frames of their stream are
    inert: they keep the state as it was.  Returns the final state and the
    per-frame outputs stacked to (S, F, T, ...), all new tensors (the input
    state is not written).

    The plain version on CPU tensors; kernel K6 on CUDA tensors of any
    shape, one launch for the batch, counted in ``track_timeline.launches``."""
    rules = dict(similarity_threshold=similarity_threshold,
                 run_length_threshold=run_length_threshold, match_iou=match_iou,
                 max_misses=max_misses)
    if boxes.device.type == "cpu":
        return track_timeline_plain(state, boxes, valid, emb, n_valid_frames, **rules)
    s, f, k = boxes.shape[:3]
    t, d = state.box.shape[1], emb.shape[-1]
    if (boxes.shape != (s, f, k, 4) or valid.shape != (s, f, k) or emb.shape != (s, f, k, d)
            or state.box.shape != (s, t, 4) or state.embedding.shape != (s, t, d)):
        raise ValueError(f"track_timeline: shape mismatch: state box {tuple(state.box.shape)}, "
                         f"embedding {tuple(state.embedding.shape)}; boxes "
                         f"{tuple(boxes.shape)}, valid {tuple(valid.shape)}, emb "
                         f"{tuple(emb.shape)}")
    dev = boxes.device
    if isinstance(n_valid_frames, torch.Tensor):
        n_dev = n_valid_frames.to(dev, torch.int32).expand(s).contiguous()
        n_int = 0
    else:
        n_dev, n_int = None, int(n_valid_frames)
    dtypes = (torch.bool, torch.float32, torch.float32, torch.bool) + (torch.int32,) * 5
    state = TrackState(*(x.to(dtype).contiguous() for x, dtype in zip(state, dtypes)))
    ins = (boxes.to(torch.float32).contiguous(), valid.to(torch.bool).contiguous(),
           emb.float().contiguous())
    cuda_build.require_cuda("track_timeline", *state, *ins, n_dev)
    new = TrackState(*(torch.empty_like(x) for x in state))
    out = TrackFrameOut(
        track_flagged=torch.empty((s, f, t), dtype=torch.bool, device=dev),
        track_sim=torch.empty((s, f, t), dtype=torch.float32, device=dev),
        track_box=torch.empty((s, f, t, 4), dtype=torch.float32, device=dev),
        track_active=torch.empty((s, f, t), dtype=torch.bool, device=dev),
        track_updated=torch.empty((s, f, t), dtype=torch.bool, device=dev))
    workspace = torch.empty((s, _workspace_words(t, k)), dtype=torch.int32, device=dev)
    P, I, F32 = cuda_build.P, cuda_build.I, ctypes.c_float
    cuda_build.launch(
        "tracks", "tt_track_fold", [P] * 13 + [I] + [P] * 15 + [I] * 5 + [F32, I, F32, I],
        *(x.data_ptr() for x in (*state, *ins)), n_dev.data_ptr() if n_dev is not None else None,
        n_int, *(x.data_ptr() for x in (*new, *out, workspace)), s, f, t, k, d,
        similarity_threshold, run_length_threshold, match_iou, max_misses, device=dev)
    track_timeline.launches += 1
    return new, out


track_timeline.launches = 0


def track_scores(state: TrackState, frame_count: int, fps: int, *,
                 run_length_threshold: int = 15, long_video_seconds: int = 30) -> np.ndarray:
    """Per-track 0-100 scores (int32, the state's (S, T) or (T,) shape):
    the reference formula (``ops.temporal.weighted_score``, float32) per
    track; a track with no counter update scores 0."""
    flagged, final, processed = (x.cpu().numpy() for x in (
        state.flagged_count, state.final_counter, state.processed))
    scores = np.zeros(processed.shape, np.int32)
    for i in zip(*np.nonzero(processed > 0)):
        scores[i] = weighted_score(
            int(flagged[i]), int(final[i]), int(processed[i]), frame_count, fps,
            run_length_threshold=run_length_threshold, long_video_seconds=long_video_seconds)
    return scores
