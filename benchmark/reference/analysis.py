"""The plain reference of a whole analysis: the batch loops of
``truely_tpu_torch/pipeline/detector.py`` (``Detector._analyze`` and
``Detector._analyze_tracks`` with the keyframe cycles of
``_propagate_cycle``), restated over the frozen steps of this package.

Everything here is plain PyTorch and numpy: no kernel of the port, no
object the port made.  The nets come from the param trees the benchmark
drew (``params.nets_from_trees``), the frames from the benchmark's own
generator or decoder.  ``rows`` runs each batch as blocks of that many
rows, as a data mesh runs its shards (each row's result is its own; only
the shapes the convolutions see change).
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from .config import DetectorConfig
from .mtcnn import MTCNNNets
from .params import nets_from_trees
from .steps import DetectorNets, steps_for
from .temporal import init_temporal_state, temporal_consistency, weighted_score
from .tracks import init_track_state, stream_state, track_scores, track_timeline


class Records(NamedTuple):
    """One analysed clip, one entry per sampled frame (the fields of the
    port's ``FrameRecord``), and its score."""

    frame_index: np.ndarray  # (n,) int
    has_face: np.ndarray     # (n,) bool
    box: np.ndarray          # (n, 4) float64, the clamped crop bounds
    annotated: np.ndarray    # (n,) bool
    flagged: np.ndarray      # (n,) bool
    similarity: np.ndarray   # (n,) float32
    counter: np.ndarray      # (n,) int32
    score: int


class TrackResult(NamedTuple):
    """One multi-face clip: the aggregate score, the per-track scores and
    the final track state of the clip's stream as numpy."""

    score: int
    per_track: np.ndarray
    state: Dict[str, np.ndarray]


def build_nets(trees: Mapping[str, object], device) -> DetectorNets:
    nets = nets_from_trees(trees, device)
    return DetectorNets(mtcnn=MTCNNNets(nets["pnet"], nets["rnet"], nets["onet"]),
                        facenet=nets["facenet"], landmark=nets["landmark68"])


def _precision(dtype):
    """float32 convolutions and matmuls without TF32 for float32 compute."""
    if dtype != torch.float32:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def full():
        saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    return full()


def _blocks(fn, batch: torch.Tensor, rows: int):
    """``fn`` on ``rows``-row blocks of ``batch``, its outputs (a named
    tuple of row-major tensors) concatenated row-wise."""
    if rows >= batch.shape[0]:
        return fn(batch)
    outs = [fn(batch[r:r + rows]) for r in range(0, batch.shape[0], rows)]
    return type(outs[0])(*(torch.cat(parts) for parts in zip(*outs)))


def _batches(frames: np.ndarray, sampled: List[int], b: int, device):
    for s in range(0, len(sampled), b):
        chunk = sampled[s:s + b]
        stack = np.zeros((b,) + frames.shape[1:], np.uint8)
        stack[: len(chunk)] = frames[chunk]
        yield chunk, torch.from_numpy(stack).to(device)


def analyze(nets: DetectorNets, frames: np.ndarray, fps: int, cfg: DetectorConfig, *,
            yuv: bool, device, rows: Optional[int] = None) -> Records:
    """Single-face analysis of in-memory frames: packed I420 (N, 3H/2, W)
    with ``yuv``, else (N, H, W, 3) BGR, every ``sample_interval``-th frame
    in zero-padded batches of ``frame_batch``, the temporal scan carried
    across batches, then the score."""
    dtype = getattr(torch, cfg.compute_dtype)
    b = cfg.frame_batch
    rows = rows or b
    full = steps_for(yuv, multi_face=False).full
    n = frames.shape[0]
    sampled = list(range(0, n, cfg.sample_interval(fps)))
    state = init_temporal_state(nets.facenet.last_linear.out_features, device)
    cols: Dict[str, list] = {k: [] for k in ("has_face", "box", "annotated", "flagged",
                                             "similarity", "counter")}
    with torch.inference_mode(), _precision(dtype):
        for chunk, dev in _batches(frames, sampled, b, device):
            out = _blocks(lambda x: full(nets, x, cfg, dtype), dev, rows)
            res = temporal_consistency(out.embedding, out.has_face, len(chunk), state=state,
                                       similarity_threshold=cfg.similarity_threshold,
                                       run_length_threshold=cfg.run_length_threshold)
            state = res.state
            m = len(chunk)
            for key, t in (("has_face", res.has_face), ("box", out.crop_bounds),
                           ("annotated", res.annotated), ("flagged", res.flagged),
                           ("similarity", res.similarity), ("counter", res.counter)):
                cols[key].append(t[:m].cpu().numpy())
        final_counter = int(state.counter)
    flagged = np.concatenate(cols["flagged"])
    score = weighted_score(int(flagged.sum()), final_counter, len(sampled), n, fps,
                           run_length_threshold=cfg.run_length_threshold,
                           long_video_seconds=cfg.long_video_seconds)
    return Records(frame_index=np.asarray(sampled), has_face=np.concatenate(cols["has_face"]),
                   box=np.concatenate(cols["box"]).astype(np.float64),
                   annotated=np.concatenate(cols["annotated"]), flagged=flagged,
                   similarity=np.concatenate(cols["similarity"]).astype(np.float32),
                   counter=np.concatenate(cols["counter"]).astype(np.int32), score=score)


def analyze_tracks(nets: DetectorNets, frames: np.ndarray, fps: int, cfg: DetectorConfig, *,
                   yuv: bool, device) -> TrackResult:
    """Multi-face analysis of in-memory frames at a fixed ``detect_interval``
    K: each cycle of K batches gathers every K-th row into one seed batch,
    runs the cascade-only seed step on it, then each batch's propagate step
    (with ``propagate_fallback``: the full step where refinement lost more
    than half the seeded slots); K = 1 runs the full step per batch.  Every
    batch's outputs fold into one stream's track state."""
    if not isinstance(cfg.detect_interval, int):
        raise NotImplementedError("the reference runs a fixed detect_interval")
    dtype = getattr(torch, cfg.compute_dtype)
    b, k = cfg.frame_batch, cfg.detect_interval
    steps = steps_for(yuv, multi_face=True)
    n = frames.shape[0]
    sampled = list(range(0, n, cfg.sample_interval(fps)))
    state = init_track_state(cfg.max_tracks, nets.facenet.last_linear.out_features,
                             device=device)

    def fold(out, n_valid):
        boxes, valid, emb = out
        return track_timeline(state, boxes[None], valid[None], emb[None], n_valid,
                              similarity_threshold=cfg.similarity_threshold,
                              run_length_threshold=cfg.run_length_threshold)[0]

    with torch.inference_mode(), _precision(dtype):
        batches = _batches(frames, sampled, b, device)
        while True:
            cycle = list(itertools.islice(batches, k))
            if not cycle:
                break
            if k == 1:
                chunk, dev = cycle[0]
                state = fold(steps.full(nets, dev, cfg, dtype), len(chunk))
                continue
            bk = b // k
            keyframes = torch.cat([dev[::k] for _, dev in cycle])
            pad = b - keyframes.shape[0]
            if pad:
                keyframes = torch.cat([keyframes, keyframes.new_zeros(
                    (pad,) + tuple(keyframes.shape[1:]))])
            seed_box, seed_found = steps.detect(nets, keyframes, cfg, dtype)
            sv_host = seed_found.cpu().numpy()
            for j, (chunk, dev) in enumerate(cycle):
                rows = slice(j * bk, (j + 1) * bk)
                out = steps.propagate(nets, dev, seed_box[rows], seed_found[rows], cfg, dtype,
                                      k=k)
                if cfg.propagate_fallback:
                    found = out[1][: len(chunk)].cpu().numpy()
                    sv = np.repeat(sv_host[rows], k, axis=0)[: len(chunk)]
                    seeded, lost = int(sv.sum()), int((sv & ~found).sum())
                    if seeded and lost * 2 > seeded:
                        out = steps.full(nets, dev, cfg, dtype)
                state = fold(out, len(chunk))
    per_track = track_scores(state, n, fps, run_length_threshold=cfg.run_length_threshold,
                             long_video_seconds=cfg.long_video_seconds)[0]
    final = {f: v.cpu().numpy() for f, v in stream_state(state, 0)._asdict().items()}
    return TrackResult(score=int(per_track.max(initial=0)), per_track=per_track, state=final)
