"""How ``correct`` is decided: the numbers that hold what the timed path
produced against the plain reference, each against its limit from the
configuration file (``limits``; the model module picks the kind of check).

Single face (``records``), per sampled clip: every sampled frame's record
(has a face, crop bounds, drawn, flagged, run-length counter) and the
clip's score.
- ``record_mismatch``: the share of sampled frames whose record differs
  from the reference's (a bound more than 1 px off, or any flag or
  counter different);
- ``score_gap``: the largest |score - reference score| over the clips
  whose records all agree, where the score, a function of the records,
  must be equal: an exact comparison.

Multi-face (``tracks``), per sampled clip: the per-track scores and the
final track state.
- ``score_gap``: the largest |per-track score - reference| over the
  clips whose track states all agree, where the scores, a function of
  the states, must be equal: an exact comparison;
- ``track_mismatch``: the share of track slots whose discrete state
  (active, has a previous embedding, counter, flagged count, frames
  processed, misses, final counter) or last box (more than 1 px) differs;
- ``embedding_gap``: the largest |embedding - reference| over the slots
  that hold an embedding on both sides.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np

from benchmark.reference.analysis import Records, TrackResult

DISCRETE = ("active", "has_prev", "counter", "flagged_count", "processed", "misses",
            "final_counter")


def records_of(analysis) -> Records:
    """The port's ``VideoAnalysis`` as the reference's ``Records``."""
    r = analysis.records
    return Records(
        frame_index=np.array([x.frame_index for x in r]),
        has_face=np.array([x.has_face for x in r], bool),
        box=np.array([x.box for x in r], np.float64).reshape(-1, 4),
        annotated=np.array([x.annotated for x in r], bool),
        flagged=np.array([x.flagged for x in r], bool),
        similarity=np.array([x.similarity for x in r], np.float32),
        counter=np.array([x.counter for x in r], np.int32), score=int(analysis.fake_score))


def tracks_of(result) -> TrackResult:
    """The port's ``(score, per_track, state)`` as a ``TrackResult``."""
    score, per_track, state = result
    return TrackResult(score=int(score), per_track=np.asarray(per_track),
                       state={f: v.cpu().numpy() for f, v in state._asdict().items()})


def record_numbers(got: Sequence[Records], want: Sequence[Records]) -> Dict[str, float]:
    frames = mismatched = 0
    score_gap = 0.0
    for g, w in zip(got, want):
        if len(g.has_face) != len(w.has_face) or (g.frame_index != w.frame_index).any():
            raise ValueError("the program and the reference sampled different frames")
        same = ((g.has_face == w.has_face) & (np.abs(g.box - w.box).max(-1) <= 1.0)
                & (g.annotated == w.annotated) & (g.flagged == w.flagged)
                & (g.counter == w.counter))
        frames += len(same)
        mismatched += int((~same).sum())
        if same.all():
            score_gap = max(score_gap, float(abs(g.score - w.score)))
    return {"record_mismatch": mismatched / max(frames, 1), "score_gap": score_gap}


def track_numbers(got: Sequence[TrackResult], want: Sequence[TrackResult]) -> Dict[str, float]:
    slots = mismatched = 0
    emb_gap = score_gap = 0.0
    for g, w in zip(got, want):
        gs, ws = g.state, w.state
        same = np.abs(gs["box"] - ws["box"]).max(-1) <= 1.0
        for f in DISCRETE:
            same &= gs[f] == ws[f]
        slots += same.size
        mismatched += int((~same).sum())
        both = gs["has_prev"] & ws["has_prev"]
        if both.any():
            emb_gap = max(emb_gap, float(np.abs(gs["embedding"][both]
                                                - ws["embedding"][both]).max()))
        if same.all():
            score_gap = max(score_gap, float(np.abs(g.per_track.astype(np.int64)
                                                    - w.per_track.astype(np.int64)).max()))
    return {"score_gap": score_gap, "track_mismatch": mismatched / max(slots, 1),
            "embedding_gap": emb_gap}


def numbers(kind: str, got: Sequence, want: Sequence) -> Dict[str, float]:
    return record_numbers(got, want) if kind == "records" else track_numbers(got, want)


def judge(found: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number within its limit, and none missing."""
    return all(k in found and found[k] <= v for k, v in limits.items())


def lines(found: Mapping[str, float], limits: Mapping[str, float]) -> List[str]:
    """One "name number limit" line per compared number."""
    return [f"{k} {found.get(k, float('nan'))!r} limit {v!r}" for k, v in limits.items()]


def sample(units: Sequence, seed: int, max_frames: int) -> List[int]:
    """Indices of the finished clips the reference checks: the longest
    (the first of them), then others in a seeded order while the frames
    stay within ``max_frames``."""
    if not units:
        return []
    first = max(range(len(units)), key=lambda i: (units[i].frames, -i))
    chosen, total = [first], units[first].frames
    for i in np.random.default_rng(seed).permutation(len(units)):
        if int(i) != first and total + units[i].frames <= max_frames:
            chosen.append(int(i))
            total += units[i].frames
    return sorted(chosen)
