"""Frozen copy of ``truely_tpu_torch/ops/temporal.py``.

Temporal consistency scan and the final score (counterpart of
``truely_tpu/ops/temporal.py``).

The reference loop compares each face embedding with the previous face
embedding, counts consecutive sampled frames below the similarity
threshold (resetting on a frame above it), flags frames whose run exceeds
the run-length threshold, and turns the counts into a 0-100 score.  Here
the resettable counter is computed without a loop: between two resets it
is a prefix sum of the "below" frames, so it is a cumulative sum minus its
value at the last reset.  Batches fold through ``TemporalState`` with the
same results as one pass over the whole timeline.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TemporalState(NamedTuple):
    """Carry from one batch of the timeline to the next."""

    prev_embedding: torch.Tensor  # (D,) f32, last face embedding seen
    has_prev: torch.Tensor        # () bool, whether any face has been seen
    counter: torch.Tensor         # () int32 run-length counter


def init_temporal_state(dim: int, device=None, lead: tuple = ()) -> TemporalState:
    """The empty state, one per index of the leading shape ``lead``."""
    return TemporalState(
        prev_embedding=torch.zeros(lead + (dim,), dtype=torch.float32, device=device),
        has_prev=torch.zeros(lead, dtype=torch.bool, device=device),
        counter=torch.zeros(lead, dtype=torch.int32, device=device),
    )


class TemporalResult(NamedTuple):
    similarity: torch.Tensor      # (..., T) f32, 0 where undefined
    counter: torch.Tensor         # (..., T) int32 after each frame's update
    flagged: torch.Tensor         # (..., T) bool, drawn red
    annotated: torch.Tensor       # (..., T) bool, any box drawn
    has_face: torch.Tensor        # (..., T) bool
    flagged_count: torch.Tensor   # (...) int32
    final_counter: torch.Tensor   # (...) int32
    state: TemporalState


def resettable_run_length(update: torch.Tensor, below: torch.Tensor,
                          initial: torch.Tensor) -> torch.Tensor:
    """c[t] = c[t-1] + 1 if update and below; 0 if update and not below;
    c[t-1] if not update, along the last axis.  ``initial`` (the leading
    axes' shape) is the counter carried in."""
    t = update.shape[-1]
    idx = torch.arange(t, dtype=torch.int32, device=update.device)
    reset = update & ~below
    counts = torch.cumsum((update & below).to(torch.int32), -1, dtype=torch.int32)
    last_reset = torch.cummax(torch.where(reset, idx, -1), -1).values
    # A reset frame counts 0 itself, so the run since it is counts - counts[r].
    base = torch.where(
        last_reset >= 0, torch.gather(counts, -1, last_reset.clamp_min(0).long()),
        -initial.to(torch.int32)[..., None]
    )
    return counts - base


def previous_face_index(has_face: torch.Tensor) -> torch.Tensor:
    """Index of the last face frame strictly before each frame, or -1,
    along the last axis."""
    t = has_face.shape[-1]
    idx = torch.arange(t, dtype=torch.int32, device=has_face.device)
    cummax = torch.cummax(torch.where(has_face, idx, -1), -1).values
    return torch.cat([cummax.new_full(cummax.shape[:-1] + (1,), -1), cummax[..., :-1]], -1)


def _take_rows(emb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """emb (..., N, D) rows at idx (..., M) -> (..., M, D)."""
    idx = idx.clamp_min(0).long()[..., None]
    return torch.gather(emb, -2, idx.expand(idx.shape[:-1] + (emb.shape[-1],)))


def temporal_consistency(
    embeddings: torch.Tensor,
    has_face: torch.Tensor,
    n_sampled,
    *,
    state: TemporalState | None = None,
    similarity_threshold: float = 0.99,
    run_length_threshold: int = 15,
) -> TemporalResult:
    """Temporal consistency over one batch of the timeline.

    embeddings: (..., T, D); has_face: (..., T) bool; frames at
    ``t >= n_sampled`` (an int, or a tensor of the leading shape) are
    padding and inert.  Leading axes are independent timelines (the
    stream scheduler's streams), each with its own ``state``.  Folding
    batch by batch through ``state`` gives the same result as one call
    over the whole timeline.
    """
    *lead, t_axis, dim = embeddings.shape
    device = embeddings.device
    if state is None:
        state = init_temporal_state(dim, device)
    idx = torch.arange(t_axis, device=device)
    if isinstance(n_sampled, torch.Tensor):
        n_sampled = n_sampled[..., None]
    has_face = has_face & (idx < n_sampled)

    emb = embeddings.float()
    # Slot 0 carries the previous batch's last face embedding.
    emb_ext = torch.cat([state.prev_embedding[..., None, :], emb], -2)
    has_face_ext = torch.cat([state.has_prev[..., None], has_face], -1)
    prev_idx = previous_face_index(has_face_ext)[..., 1:]
    has_prev = has_face & (prev_idx >= 0)

    prev_emb = _take_rows(emb_ext, prev_idx)
    dot = torch.sum(emb * prev_emb, dim=-1)
    norms = torch.linalg.vector_norm(emb, dim=-1) * torch.linalg.vector_norm(prev_emb, dim=-1)
    sim = torch.where(has_prev, dot / norms.clamp_min(1e-12), 0.0)

    below = sim < similarity_threshold
    counter = resettable_run_length(has_prev, below, state.counter)
    flagged = has_prev & (counter > run_length_threshold)

    last_face_ext = previous_face_index(
        torch.cat([has_face_ext, has_face_ext.new_ones(has_face_ext.shape[:-1] + (1,))], -1)
    )[..., -1:]
    new_state = TemporalState(
        prev_embedding=_take_rows(emb_ext, last_face_ext)[..., 0, :],
        has_prev=state.has_prev | has_face.any(-1),
        counter=counter[..., -1] if t_axis > 0 else state.counter,
    )
    return TemporalResult(
        similarity=sim,
        counter=counter,
        flagged=flagged,
        annotated=has_prev,
        has_face=has_face,
        flagged_count=flagged.sum(-1, dtype=torch.int32),
        final_counter=new_state.counter,
        state=new_state,
    )


def weighted_score(
    flagged_count: int,
    final_counter: int,
    total_processed: int,
    frame_count: int,
    fps: int,
    *,
    run_length_threshold: int = 15,
    long_video_seconds: int = 30,
    long_weight: float = 0.5,
    short_weight: float = 0.3,
) -> int:
    """Final 0-100 fake score in float32, as the reference computes it.

    ``final_counter`` is the run-length counter at the END of the video (the
    reference reuses its loop variable after the loop, a quirk kept on
    purpose).
    """
    if total_processed <= 0:
        return 0
    f32 = np.float32
    total = max(f32(total_processed), f32(1.0))
    pct = f32(flagged_count) / total * f32(100.0)
    conf = min(pct * (f32(final_counter) / f32(run_length_threshold)), f32(100.0))
    weight = f32(long_weight if frame_count > fps * long_video_seconds else short_weight)
    weighted = min(pct + conf * weight, f32(100.0))
    return int(np.clip(np.floor(weighted), 0.0, 100.0))
