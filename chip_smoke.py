#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``truely_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR] [--kernels-only] [--sweep]

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit, as nvidia-smi reports them;
2. the build of every CUDA kernel (one nvcc per source, all started
   together);
3. kernels: K1-K5 at the shapes of one production step (1080p,
   frame_batch 32) on seeded random inputs, each held with ``torch.equal``
   to its plain PyTorch version run on the same CUDA tensors (K5 also to K3
   at q=1), and timed beside the plain version, a PyTorch library call
   where one computes the same function, and its bound: ``ms`` is the
   CUDA-event time of back-to-back calls (the issue rate), ``host_ms``
   the host's cost of issuing a call (``device_ms`` comes in phase 11).
   Each call form belongs to the paths that make it: score (bf16
   defaults), propagate (its keyframe step and its refine step),
   multiface (4 tracks: K4 at K=4, the refine step's K2 and K5 at K=16)
   and stream (the scheduler's full and refine steps: K3 at K=4 and K=16,
   q=4); the file and serve paths make the score step's forms; or to
   none (forms kept for comparison).  K3's prep (the integral image, once
   per frame step) is a form of its own with bound 0; its crop
   forms cut from a prepared integral.  Edge forms of K2 (chains deeper
   than max_rounds, tied scores, K of 1, 37 and 100, every slot invalid,
   IoUs at the threshold float and its neighbours) and of K5 (crops
   narrower than O, partly outside the frame, empty, at every x0 residue
   mod 16, as wide as the frame, rows that are no multiple of 16 bytes)
   belong to no path.  Then the host's cost per call of K4's wrapper and
   of its parts (the launch floor);
4. end to end, score path: ``Detector`` at the bf16 defaults with its own
   seeded weights runs ``analyze_i420`` on seeded synthetic 1080p I420
   frames, one warm-up batch and then four batches of 32 sampled frames.
   Every launch count is set to 0 just before that run and read just after
   it; K1-K4 (K3's prep and its crop) must have launched and K5 not;
5. end to end, propagate path: the same at ``detect_interval=4`` and then
   ``"auto"``, on the exact crop chain with ``use_fused_crops=1`` and
   thresholds of 0, on stable content (a few seeded base frames shifted by
   a few pixels), one warm-up cycle and then 16 batches; K1, K2, K4 and K5
   must have launched and neither K3's prep nor its crop, and the "auto"
   ladder must have climbed
   (the seeded R-Net/O-Net box regressions are scaled down for these runs,
   see PROP_REGRESSION_SCALE).  Each run prints how many segments the
   propagate fallback re-ran through the full step;
6. end to end, multiface path: ``analyze_i420_tracks`` with 4 tracks, at
   the bf16 defaults (one warm-up batch, four timed; K1-K4 and not K5),
   then at K=4 and "auto" under the propagate path's conditions (one
   warm-up cycle, eight timed batches; K1, K2, K4, K5 and not K3; the
   ladder must climb).  Each prints sampled frames/s, active tracks and
   per-track scores, and the stage times of one batch (cascade, tail,
   track fold); then the classifier path: ``analyze_i420_tracks`` at K=4
   under the propagate path's conditions with ``DetectorConfig.classifier``
   set (a one-member ensemble of seeded EfficientNet-B7 nets), one warm-up
   cycle and four timed batches: K7 (the classifier's crop) once per
   batch, every result's crop mask and logits sane;
7. end to end, stream path: ``StreamScheduler`` with 8 streams x 4 frames
   a step at 1080p, I420, each stream its own stable content, single-face
   at the defaults, at K=4 and at "auto", and multi-face at K=4 (the
   propagate path's thresholds and regression heads on the bf16 crop
   chain, q=4): K1-K4 and not K5 in each, refine steps in the last three,
   the "auto" rung must climb, and the events must be one per pushed
   sampled frame.  Each prints sampled frames/s over all streams, steps,
   keyframe steps and padded rows;
8. end to end, file path: a 1080p uncompressed I420 AVI of 128 stable
   frames at fps 14 (64 sampled frames), written by the port's ``rawavi``
   writer into a temporary directory.  ``Detector.analyze_video`` at the
   bf16 defaults (its records must equal ``analyze_i420``'s on the same
   frames); with an annotated output under the propagate path's thresholds
   and heads (the output holds every frame, the frames not drawn on
   byte-equal to the source, a drawn frame different from the source,
   converted as the writer converts, only near its box outline);
   ``analyze_video_multiface`` at K=4 with an output; ``python -m
   truely_tpu_torch analyze`` in its own process (its score equal to
   ``analyze_video``'s); ``stream_videos`` over 8 readers of the file and
   ``analyze_videos`` over 8 paths (each equal to the solo run with an
   output), and ``stream_videos`` at K=4 (the 8 streams equal).
   K1-K4 must launch in each run and K5 not.  Each prints sampled frames/s
   and the host timings (decode, upload, device, temporal, encode);
9. end to end, serve path: 8 prefixes of the file path's clip (128 down
   to 100 frames), at the bf16 defaults on nets that find faces at the
   default thresholds (``serve_weights``, a weights directory), after
   ``Detector.warmup`` at 1080p; score-only runs on this thread and on new
   threads, alternating; then the port's ``TruelyServer`` on a real
   socket, each request given its own hard link of a clip (the server
   deletes its inputs): ``POST /analyze-video`` (fakeScore, not 0, equal
   to ``det.run``'s, the ``.avi`` output another file, byte-equal to
   ``det.run``'s output, drawn where the solo run draws and byte-equal to
   the source elsewhere), ``/view`` and a 1024-byte Range of ``/video``,
   ``/analyze-combined``, 8 ``/jobs/analyze-video`` jobs, one on each
   clip, queued behind a gate job (one group, each equal to its clip's
   solo run, each output checked as above), 8 sync requests in a row, and
   ``/metrics``; K1-K4 must launch in each and K5 not.  Then ``python -m
   truely_tpu_torch serve --weights`` in its own process with ``--warmup
   1080x1920`` (seconds until ``/health`` reports it done, and its first
   request) and without (its first request: the cold cost); both answer
   with the in-process fakeScore;
10. cross-checks of card against CPU: at float32, GOLDEN_CONFIG (frame_batch
   16, TF32 off) over 16 synthetic 640x360 frames, the propagate path
   (``detect_interval=4``, ``use_fused_crops=1``) and the multi-face path
   at K=4 over 16 stable ones, and a 2-stream scheduler at K=4; at bf16,
   ``analyze_video`` on a small I420 AVI, held to the bounds of the bf16
   drift gate (``DRIFT_BOUNDS``);
11. device times: ``device_ms`` of every kernel form and library call, the
   kernels' own time from torch.profiler over 20 calls, then one batch's
   track fold under torch.profiler (its ATen calls, device kernels, device
   and wall time).  It runs last, after phase 12: once the profiler has
   traced the card, every launch costs the host more for the rest of the
   process, which would slow the phases above;
12. parallel (runs between phases 10 and 11), on meshes whose positions all
   name CUDA device 0 (``truely_tpu_torch/parallel``): the score path at
   the bf16 defaults on nets that find faces (``serve_weights``), solo and
   on 2 and 4 positions (16 and 8 rows a shard) on the score phase's
   frames: every kernel launches once per shard (n times the solo run's
   count) and K5 not, the records stay within ``DRIFT_BOUNDS`` of the solo
   run's (the count of differing records printed), and the sampled
   frames/s of the three runs are printed together; the propagate path at
   K=4 and "auto" on 16 positions (2 rows a shard, fewer than the
   interval) under the propagate phase's conditions: K1, K2, K4, K5 and no
   K3 kernel, the ladder climbs, records within ``DRIFT_BOUNDS`` of the
   solo run's; ``StreamScheduler`` with 8 streams x 4 frames on a (2, 1)
   mesh; training at full width (Inception-ResNet-v1 and the landmark
   head, float32, batch 64 of seeded 80x80 crops, 10 steps: the loss
   falls, steps/s printed), its first step held to the CPU's step on the
   same params and batch, and the DP (2, 1) and TP (1, 2) steps to the
   single-device one (``TRAIN_LOSS_RTOL``, ``TRAIN_GRAD_TOL``), and a
   checkpoint round trip; ``pipeline_block17`` (2 stages, 8 microbatches)
   ``torch.equal`` per microbatch to the sequential chain;
   ``sharded_temporal`` equal to the unsharded fold; and
   ``parallel.dryrun.dryrun_multichip`` on two positions;
13. native (runs after phase 12): the host C++ (``media/host_build.py``):
   the compiler, whether the libav headers were found, the linked
   libavcodec's version, whether it has libx264, and whether cv2 reads the
   bundled mp4; each framepack function at 1080p byte-equal to its numpy
   version and both timed (host ms); the bf16 pyramid without the cascade
   (``--exact-pyramid``) on a 1080p batch, every level P-Net sees on the
   card ``torch.equal`` to the CPU's ``resize_area_u8``; ``analyze_video``
   at the bf16 defaults on the bundled mp4v clip (``tests/fixtures/
   veo3_360p.mp4``), printing ``VideoReader.decoder`` and ``yuv_ingest``:
   through the native decoder where it is built (K1 must launch, and every
   record must equal the same file read with ``yuv_ingest=False``), else
   through cv2; where the native writer is built, also with an ``.mp4``
   output, which must be H.264 (where libx264 is there) with the source's
   frame count.  A library that cannot be built for want of libav headers
   is printed as such.

The script's wall time is printed before the last two lines.  The line
before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits non-zero and prints no result.  ``--profile DIR`` also
traces one score-path batch and one K=4 propagate cycle (four batches) with
``torch.profiler`` and writes their kernel tables and Chrome traces into
DIR.  ``--kernels-only`` runs phases 1-3 and 11 and prints no result: copied
into another tree of the port, it times that tree's kernels the same way
(a tree whose K5 reads a planar copy of the frames gets that copy as two
forms of K5 with bound 0, one per step).  ``--sweep`` also times K2 at
every cluster size and K5 at every count of y-bins per CTA, after the
device times.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM3 bandwidth and float32 rate outside the tensor cores.  The bound of a
# kernel is the larger of bytes / HBM_BYTES_PER_S and ops / F32_OPS_PER_S.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PEAKS = "H100 SXM peaks: 3.35 TB/s HBM, 67 TFLOP/s float32 (700 W)"

STEP_B, STEP_H, STEP_W = 32, 1080, 1920
E2E_BATCHES = 4
PROP_BATCHES = 16  # four keyframe cycles at K=4
MAX_TRACKS = 4
MF_BATCHES = 4       # the multi-face path's timed batches at K=1
MF_PROP_BATCHES = 8  # and at K=4 and "auto": two keyframe cycles at K=4
# The stream path: 8 streams x 4 frames a step (32 rows), 40 sampled frames
# a stream (fewer for some, see stream_content): 10 steps.
STREAMS, STREAM_FRAMES, STREAM_LEN = 8, 4, 40
FPS = 7  # sample_interval(7) == 1: every frame is a sampled frame
# The seeded random nets are no face detectors: at the default thresholds
# they pass nothing on synthetic content.  The float32 cross-check lowers
# the R-Net and O-Net thresholds so that some frames carry a face and the
# boxes, crops, embeddings and similarities are compared too.
XCHECK_THRESHOLDS = (0.5, 0.1, 0.3)
# The propagate phase passes every candidate (the seeded nets' scores are
# no face scores), so that most frames carry a face and the ladder climbs.
PROP_THRESHOLDS = (0.0, 0.0, 0.0)
# The seeded R-Net/O-Net box regressions throw a refined box far off its
# candidate (inverted, off the frame), so refinement would lose every seed
# and the propagate path would only run its fallback.  Its runs scale both
# regression heads by this factor: refined boxes stay near their candidates.
PROP_REGRESSION_SCALE = 0.1
SCORE, PROPAGATE, MULTIFACE, STREAM, FILE, SERVE, PARALLEL, NATIVE, CLASSIFIER = (
    "score", "propagate", "multiface", "stream", "file", "serve", "parallel", "native",
    "classifier")
PATHS = (SCORE, PROPAGATE, MULTIFACE, STREAM, FILE, SERVE, CLASSIFIER)
# The classifier path's crop (K7) side and box growth (a third).
CLASSIFIER_SIZE, CLASSIFIER_MARGIN = 380, 3
# The file path: a 1080p uncompressed I420 AVI at fps 14 (sample interval 2,
# so unsampled frames are skipped, or carried to the writer), 128 frames:
# 64 sampled frames, two batches of 32; read by 8 streams at once.
FILE_FPS, FILE_FRAMES, FILE_STREAMS = 14, 128, 8
# The serve phase's P-, R- and O-Net, saved into a weights directory that
# the in-process server and the CLI's servers both load (``--weights``), so
# that at the default thresholds the sampled frames carry faces, frames
# flag and the scores are not 0.  Each face head's logits are scaled by
# SERVE_HEAD_SCALE (a power of two, so exactly) and its face logit raised
# by SERVE_FACE_SHIFT: the candidates keep the order of their scores and
# pass every default threshold, as under PROP_THRESHOLDS.  The box
# regressions are scaled as steady_regression scales them.
SERVE_HEAD_SCALE, SERVE_FACE_SHIFT = 1 / 16, 4.0
# The serve phase's clips: prefixes of the file path's clip, one length
# for each of its 8 jobs, so that each job's output has a frame count of
# its own.  The 128-frame clip's flagged frames lie past its 88th frame
# (on the card: prefixes of 96 frames and fewer score 2 or 0), so the
# prefixes stay above 96.
SERVE_LENGTHS = tuple(FILE_FRAMES - 4 * i for i in range(FILE_STREAMS))
# Score-only analyses on this thread and on a new thread, alternating.
SERVE_THREAD_PAIRS = 4
# How far from its box's outline a drawn pixel may lie: the 2 px line, and
# the 2x2 chroma block around a changed pixel.
OUTLINE_PX = 4
ROOT = os.path.dirname(os.path.abspath(__file__))
# Candidate clusters per frame of the refine steps' call forms: the 4
# candidates around one seed, the 16 around 4 track seeds.
REFINE_CLUSTERS = {4: 1, 16: 4}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    """A check that stays under ``python -O`` (unlike ``assert``)."""
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn: Callable[[], object], window_ms: float = 100.0) -> float:
    """Mean milliseconds of ``fn`` from CUDA events over back-to-back calls
    that fill about ``window_ms`` (3 to 1000 calls), after a warm-up call
    and a 3-call estimate: a 30 us kernel timed over 20 calls reads the
    clocks' ramp as much as the kernel."""
    def mean_ms(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    fn()
    torch.cuda.synchronize()
    estimate = mean_ms(3)
    return mean_ms(min(1000, max(3, int(window_ms / max(estimate, 1e-3)))))


def device_events(prof) -> List:
    """The device-side entries of a torch.profiler run's key averages."""
    return [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]


def profiled_device_us(prof) -> float:
    """Microseconds of every device kernel in a torch.profiler run (the
    attribute's name changed across PyTorch versions)."""
    return sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
               for e in device_events(prof))


def device_ms(fn: Callable[[], object], calls: int = 20) -> Optional[float]:
    """The device's own milliseconds per call of ``fn``: the sum of the
    kernel times torch.profiler records over ``calls`` calls after a
    warm-up, divided by the calls.  Unlike ``cuda_ms`` it leaves out what
    issuing a call costs the host.  A window whose profile holds fewer
    device events than calls (the profiler lost kernels) is taken once
    more; if that one is short too, the count is printed and the result
    is None, never a time that leaves kernels out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sum(e.count for e in device_events(prof))
        if events >= calls:
            return profiled_device_us(prof) / 1e3 / calls
    log(f"device_ms: {events} device events recorded for {calls} calls, twice; reported as null")
    return None


def host_ms(fn: Callable[[], object], calls: int = 50) -> float:
    """Host milliseconds per call of ``fn`` issued back to back, with no
    synchronisation inside the window: what issuing a call costs."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / calls


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_i420(n: int, h: int, w: int, seed: int, block: int = 20) -> np.ndarray:
    """Packed I420 (n, 3h/2, w) uint8: block x block flat patches of seeded
    random luma and chroma (the pyramid keeps structure at every level)."""
    rng = np.random.default_rng(seed)

    def plane(ph, pw):
        small = rng.integers(16, 236, (n, -(-ph // block), -(-pw // block)), np.uint8)
        return np.repeat(np.repeat(small, block, axis=1), block, axis=2)[:, :ph, :pw]

    y = plane(h, w)
    u = plane(h // 2, w // 2).reshape(n, h // 4, w)
    v = plane(h // 2, w // 2).reshape(n, h // 4, w)
    return np.ascontiguousarray(np.concatenate([y, u, v], axis=1))


def stable_i420(n: int, h: int, w: int, seed: int, n_base: int = 4, hold: int = 64) -> np.ndarray:
    """n packed I420 frames of stable content: each of n_base seeded base
    frames holds for ``hold`` frames, shifted right by 0-14 px (even, so the
    chroma planes shift with it)."""
    base = synthetic_i420(n_base, h, w, seed)
    out = np.empty((n, h * 3 // 2, w), np.uint8)
    q = h // 4
    for i in range(n):
        src, s = base[(i // hold) % n_base], 2 * (i % 8)
        out[i, :h] = np.roll(src[:h], s, axis=1)
        for lo in (h, h + q):  # the U plane, then the V plane
            plane = src[lo:lo + q].reshape(h // 2, w // 2)
            out[i, lo:lo + q] = np.roll(plane, s // 2, axis=1).reshape(q, w)
    return out


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------


class Form(NamedTuple):
    """One call form of a kernel at the shapes a path gives it."""

    kernel: str
    label: str
    paths: Tuple[str, ...]          # of PATHS; () = comparison only
    run: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    library: Optional[Callable[[], object]]
    nbytes: float
    ops: float
    same_as: Optional[Callable[[], torch.Tensor]] = None  # another kernel, equal result
    # (equal, max abs error) of run's result against plain's, where the
    # result is no single tensor held bit for bit
    check: Optional[Callable[[object, object], Tuple[bool, float]]] = None


def random_boxes(g, b, k, h, w, device, clusters=8):
    """(b, k, 4) float32 boxes of 12..800 px sides, clustered around a few
    centres per frame as cascade candidates are around faces."""
    def u(*shape, lo=0.0, hi=1.0):
        return torch.empty(shape, device=device).uniform_(lo, hi, generator=g)

    cid = torch.randint(0, clusters, (b, k), generator=g, device=device)
    cx = torch.gather(u(b, clusters, lo=0, hi=w), 1, cid)
    cy = torch.gather(u(b, clusters, lo=0, hi=h), 1, cid)
    side = torch.exp(torch.gather(u(b, clusters, lo=math.log(12), hi=math.log(800)), 1, cid))
    side = side * u(b, k, lo=0.8, hi=1.25)
    cx = cx + side * u(b, k, lo=-0.3, hi=0.3)
    cy = cy + side * u(b, k, lo=-0.3, hi=0.3)
    return torch.stack([cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2], -1)


def covered_pixels(x0, y0, x1, y1, h, w) -> int:
    """Pixels of (b, h, w) frames inside the union of each frame's
    half-open rectangles (b, k), by a 2-D difference array."""
    b = x0.shape[0]
    diff = torch.zeros((b, h + 1, w + 1), dtype=torch.int32, device=x0.device)
    nonempty = (x1 > x0) & (y1 > y0)
    bi = torch.arange(b, device=x0.device)[:, None].expand_as(x0)[nonempty]
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        vals = torch.full((int(nonempty.sum()),), sign, dtype=torch.int32, device=x0.device)
        diff.index_put_((bi, ys[nonempty], xs[nonempty]), vals, accumulate=True)
    cover = diff.cumsum(1, dtype=torch.int32).cumsum(2, dtype=torch.int32)[:, :h, :w]
    return int((cover > 0).sum())


# ---------------------------------------------------------------------------
# Edge inputs of K2 and K5: comparison-only forms here, and the inputs on
# which tests/test_torch_nms_edges.py and tests/test_torch_crop_fused_edges.py
# hold the plain versions to the JAX package.  numpy, from a seed.


def np_boxes(rng, b, k, h=STEP_H, w=STEP_W, clusters=8) -> np.ndarray:
    """numpy counterpart of ``random_boxes``: (b, k, 4) float32 boxes of
    12..800 px sides clustered around a few centres per frame."""
    cid = rng.integers(0, clusters, (b, k))
    take = lambda v: np.take_along_axis(v, cid, 1)
    side = np.exp(take(rng.uniform(math.log(12), math.log(800), (b, clusters))))
    side = side * rng.uniform(0.8, 1.25, (b, k))
    cx = take(rng.uniform(0, w, (b, clusters))) + side * rng.uniform(-0.3, 0.3, (b, k))
    cy = take(rng.uniform(0, h, (b, clusters))) + side * rng.uniform(-0.3, 0.3, (b, k))
    return np.stack([cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2],
                    -1).astype(np.float32)


# The shift s of box [s, 0, 99 + s, h] against [0, 0, 99, h] at which
# their IoU is the threshold: (100 - s) / (100 + s) for 'union',
# (100 - s) / 100 for 'min'.
THRESHOLD_SHIFT = {("union", 0.5): 100 / 3, ("union", 0.7): 30 / 1.7, ("min", 0.7): 30.0}


def pair_iou(a: np.ndarray, b: np.ndarray, method: str) -> np.ndarray:
    """float32 IoU of box pairs (n, 4), +1 convention, in the plain
    version's order of operations."""
    one, zero = np.float32(1), np.float32(0)
    ix = np.maximum(zero, np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]) + one)
    iy = np.maximum(zero, np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]) + one)
    inter = ix * iy
    area = lambda p: (p[:, 2] - p[:, 0] + one) * (p[:, 3] - p[:, 1] + one)
    denom = np.minimum(area(a), area(b)) if method == "min" else area(a) + area(b) - inter
    return inter / np.maximum(denom, np.float32(1e-12))


def nms_threshold_pairs(method: str, thr: float, k: int = 256, seed: int = 8):
    """Two frames of k/2 independent pairs (one group each): box a =
    [0, 0, 99, h] and box b shifted right by s, with s within 1e-4 of
    THRESHOLD_SHIFT and h random, chosen so that a quarter of the pairs'
    float32 IoUs each are the threshold float, the float below and the
    float above, and the rest lie near them.  Frame 0 ranks a first,
    frame 1 b.  Returns (boxes, scores, valid, groups)."""
    rng = np.random.default_rng(seed)
    n, m = k // 2, 20000
    s = (THRESHOLD_SHIFT[(method, thr)] + rng.uniform(-1e-4, 1e-4, m)).astype(np.float32)
    h = rng.uniform(50, 150, m).astype(np.float32)
    a = np.stack([0 * s, 0 * s, 0 * s + np.float32(99), h], -1)
    b = np.stack([s, 0 * s, np.float32(99) + s, h], -1)
    iou = pair_iou(a, b, method)
    f = np.float32(thr)
    near = (np.nextafter(f, np.float32(0)), f, np.nextafter(f, np.float32(2)))
    picks = [np.flatnonzero(iou == x)[:n // 4] for x in near]
    picks.append(np.flatnonzero(~np.isin(iou, near))[:n - sum(len(p) for p in picks)])
    idx = np.concatenate(picks)
    boxes = np.zeros((2, k, 4), np.float32)
    boxes[:, 0::2], boxes[:, 1::2] = a[idx], b[idx]
    scores = np.tile(np.array([1.0, 0.5], np.float32), (2, n))
    scores[1] = 1.5 - scores[1]
    groups = np.tile(np.arange(k, dtype=np.int32) // 2, (2, 1))
    return boxes, scores, np.ones((2, k), bool), groups


def nms_edge_inputs(seed: int = 5):
    """K2's edge cases: [(label, boxes, scores, valid, groups or None,
    dict(iou_threshold, method, max_rounds))], numpy arrays."""
    rng = np.random.default_rng(seed)
    cases = []

    def add(label, boxes, scores, valid, groups=None, thr=0.5, method="union", max_rounds=64):
        cases.append((label, boxes, scores, valid, groups,
                      dict(iou_threshold=thr, method=method, max_rounds=max_rounds)))

    def ranked(b, k):  # scores on a 1/64 grid (ties) and a fifth of the slots invalid
        return (np.floor(rng.uniform(0.6, 1.0, (b, k)) * 64) / 64).astype(np.float32), \
            rng.random((b, k)) > 0.2

    # A chain 128 rounds deep: each box overlaps the next (IoU 0.57) and
    # not the one after (0.29).
    x = np.arange(256, dtype=np.float32)[None].repeat(2, 0) * 3.0
    chain = np.stack([x, x * 0, x + 10.0, x * 0 + 10.0], -1)
    desc = np.linspace(1.0, 0.1, 256, dtype=np.float32)[None].repeat(2, 0)
    for rounds in (4, 64):
        add(f"chain of 256 max_rounds={rounds}", chain, desc, np.ones((2, 256), bool),
            max_rounds=rounds)
    boxes = np_boxes(rng, 4, 256)
    add("K=256 all scores tied", boxes, np.full((4, 256), 0.75, np.float32),
        rng.random((4, 256)) > 0.2)
    add("K=256 every slot invalid", boxes, ranked(4, 256)[0], np.zeros((4, 256), bool))
    for k, method, thr, grouped in ((1, "union", 0.7, False), (37, "min", 0.7, False),
                                    (100, "union", 0.5, True)):
        scores, valid = ranked(4, k)
        groups = rng.integers(0, 6, (4, k)).astype(np.int32) if grouped else None
        add(f"K={k} {method} {thr}{' grouped' if grouped else ''}", np_boxes(rng, 4, k),
            scores, valid, groups, thr=thr, method=method)
    for (method, thr) in THRESHOLD_SHIFT:
        add(f"IoU at {method} {thr} and one float either side",
            *nms_threshold_pairs(method, thr), thr=thr, method=method)
    return cases


def crop_edge_inputs(b: int = 4, h: int = STEP_H, w: int = STEP_W, seed: int = 6):
    """K5's edge cases: [(label, (h, w) of the frames, bounds (b, K, 4)
    int32, O)], numpy; all on (h, w) frames but the last, whose rows are no
    multiple of 16 bytes.  Only "partly outside the frame" has bounds
    outside it (a part outside adds nothing); the cascade's bounds
    (ops.boxes.pad_crop_bounds) never leave the frame."""
    rng = np.random.default_rng(seed)

    def rep(rows):
        return np.tile(np.asarray(rows, np.int32)[None], (b, 1, 1))

    x0 = rng.integers(0, w - 12, (b, 16))
    y0 = rng.integers(0, h - 12, (b, 16))
    narrow = np.stack([x0, y0, x0 + 12, y0 + 12], -1).astype(np.int32)
    side = rng.integers(50, 400, (b, 16))
    near = rng.integers(-200, 100, (b, 16, 2))
    far = np.array([w, h]) - near  # by the opposite edges
    lo = np.where((np.arange(16) % 2 == 0)[None, :, None], near, far - side[..., None])
    outside = np.concatenate([np.concatenate([lo, lo + side[..., None]], -1),
                              rep([[w, 0, w + 10, 10], [-20, 5, -1, 30]])], 1).astype(np.int32)
    empty = rep([[10, 10, 10, 50], [10, 10, 50, 10], [50, 50, 40, 60], [w, 0, w, 10],
                 [0, h, 10, h], [w - 20, h - 10, w - 120, h - 90], [5, 5, 5, 5],
                 [100, 200, 99, 100]])
    r = np.arange(16)
    residues = rep(np.stack([512 + r, 300 + 0 * r, 512 + r + 17 + 13 * r, 340 + 0 * r], -1))
    wide = rep([[0, 100, w, 900]])
    hs, ws = 50, 70
    x0 = rng.integers(0, ws, (2, 12))
    y0 = rng.integers(0, hs, (2, 12))
    odd = np.stack([x0, y0, np.minimum(x0 + rng.integers(0, 40, (2, 12)), ws),
                    np.minimum(y0 + rng.integers(0, 30, (2, 12)), hs)], -1).astype(np.int32)
    odd[:, 0] = [0, 0, ws, hs]
    return [("12 px crops", (h, w), narrow, 48), ("partly outside the frame", (h, w), outside, 24),
            ("empty boxes", (h, w), empty, 24), ("x0 at every residue mod 16", (h, w), residues, 48),
            (f"one crop {w} px wide", (h, w), wide, 48),
            (f"{ws} px rows (no multiple of 16 bytes)", (hs, ws), odd, 24)]


def kernel_forms(device) -> List[Form]:
    from truely_tpu_torch.ops import crop_area_fused, nms, resize, yuv
    from truely_tpu_torch.ops.boxes import pad_crop_bounds, rerec

    g = torch.Generator(device=device).manual_seed(1234)
    # The multi-face forms draw from a generator of their own, so that the
    # earlier forms keep the inputs they had before these were added.
    g_multi = torch.Generator(device=device).manual_seed(4321)
    b, h, w = STEP_B, STEP_H, STEP_W
    forms: List[Form] = []

    # K1: one packed I420 batch -> BGR; per output byte an integer
    # multiply-add, a shift, an add and a clip.
    packed = torch.randint(0, 256, (b, h * 3 // 2, w), generator=g, device=device,
                           dtype=torch.uint8)
    forms.append(Form(
        "i420_to_bgr", f"({b},{h * 3 // 2},{w}) u8", PATHS,
        lambda: yuv.i420_to_bgr(packed), lambda: yuv.i420_to_bgr_plain(packed), None,
        nbytes=packed.numel() + b * h * w * 3, ops=b * h * w * 3 * 4))

    # K2: the cascade's four NMS calls (every path's full or keyframe
    # step), the single-face refine step's two over the 4 candidates around
    # one face, and the multi-face refine step's two over the 16 around 4
    # faces, on clustered candidates with tied scores (multiples of 1/64)
    # and a fifth of the slots invalid.
    refine1, refine4 = (PROPAGATE, STREAM), (MULTIFACE, STREAM)
    for k, thr, method, grouped, paths in (
            (256, 0.5, "union", True, PATHS), (256, 0.7, "union", False, PATHS),
            (64, 0.7, "union", False, PATHS), (32, 0.7, "min", False, PATHS),
            (4, 0.7, "union", False, refine1), (4, 0.7, "min", False, refine1),
            (16, 0.7, "union", False, refine4), (16, 0.7, "min", False, refine4)):
        gk = g_multi if k == 16 else g
        boxes = random_boxes(gk, b, k, h, w, device, clusters=REFINE_CLUSTERS.get(k, 8))
        scores = torch.floor(torch.empty((b, k), device=device).uniform_(
            0.6, 1.0, generator=gk) * 64) / 64
        valid = torch.rand((b, k), generator=gk, device=device) > 0.2
        groups = (torch.randint(0, 12, (b, k), generator=gk, device=device, dtype=torch.int32)
                  if grouped else None)
        kw = dict(iou_threshold=thr, method=method, max_rounds=64, groups=groups)
        idx = torch.arange(k, device=device)
        outranks = (scores[:, :, None] > scores[:, None, :]) | (
            (scores[:, :, None] == scores[:, None, :]) & (idx[:, None] < idx[None, :]))
        pairs = outranks & valid[:, :, None] & valid[:, None, :]
        if grouped:
            pairs &= groups[:, :, None] == groups[:, None, :]
        # 14 float operations per IoU test of a valid pair (2 min, 2 max,
        # 4 add/sub, 2 clamps, 1 mul, 2 for the denominator, 1 div).
        forms.append(Form(
            "nms_masked_batch", f"K={k} {method} iou={thr}{' grouped' if grouped else ''}", paths,
            lambda bx=boxes, s=scores, v=valid, kw=kw: nms.nms_masked_batch(bx, s, v, **kw),
            lambda bx=boxes, s=scores, v=valid, kw=kw: nms.nms_masked_batch_plain(bx, s, v, **kw),
            None, nbytes=b * k * (16 + 4 + 1 + 1 + (4 if grouped else 0)),
            ops=14 * int(pairs.sum())))
    for label, bx, sc, va, gr, kw in nms_edge_inputs():
        t = [None if a is None else torch.from_numpy(a).to(device) for a in (bx, sc, va, gr)]
        kw = dict(kw, groups=t[3])
        forms.append(Form(
            "nms_masked_batch", label, (),
            lambda t=t, kw=kw: nms.nms_masked_batch(t[0], t[1], t[2], **kw),
            lambda t=t, kw=kw: nms.nms_masked_batch_plain(t[0], t[1], t[2], **kw),
            None, nbytes=t[1].numel() * (16 + 4 + 1 + 1 + (4 if gr is not None else 0)),
            ops=14 * bx.shape[0] * bx.shape[1] * (bx.shape[1] - 1) // 2))

    frames = torch.randint(0, 256, (b, h, w, 3), generator=g, device=device, dtype=torch.uint8)

    # K3: stage crops, R-Net (K=64, 24x24) and O-Net (K=32, 48x48), at the
    # bf16 default's q=4 (the score path, the multi-face K=1 run and every
    # stream run's full steps) and at GOLDEN_CONFIG's exact q=1; the refine
    # steps' K=4 (single face) and K=16 (4 tracks) forms at q=4 (the stream
    # runs at K=4; the propagate runs driven here take K5).  K5: the same
    # exact crops, the keyframe step's (K=64, K=32) and the refine steps'
    # (K=4, K=16) forms, each held to K3 at q=1 too.  A tree whose K5 reads a planar
    # copy of the frames (run with --kernels-only for before/after timings)
    # also times that copy, once per step of each kind, as forms with bound 0.
    planar_k5 = hasattr(crop_area_fused, "prep_frames_for_fused_crops")
    k5_frames = crop_area_fused.prep_frames_for_fused_crops(frames) if planar_k5 else frames

    def crop_bytes(bounds, o, quant):
        x0, y0, x1, y1 = resize.snapped_bounds(bounds, quant)
        cover = covered_pixels(x0 * quant, y0 * quant, x1 * quant, y1 * quant, h, w)
        return cover * 3 + bounds.numel() * 4 + b * bounds.shape[1] * o * o * 3 * 4

    def crop_ops(bounds, o, quant):
        x0, y0, x1, y1 = resize.snapped_bounds(bounds, quant)
        sy, ey = resize.bin_edges(y0, y1 - y0, o)
        sx, ex = resize.bin_edges(x0, x1 - x0, o)
        summed = (ey - sy).sum(-1) * (ex - sx).sum(-1) * quant * quant  # pixels added
        return int(summed.sum()) * 3 + b * bounds.shape[1] * o * o * 3

    def crop_bounds(k):
        boxes = random_boxes(g_multi if k == 16 else g, b, k, h, w, device,
                             clusters=REFINE_CLUSTERS.get(k, 8))
        return pad_crop_bounds(rerec(boxes), w, h)

    # K3 is a prep (the integral image, once per frame step: bound 0, its
    # bytes are no work the crops must do) and a crop per stage crop, timed
    # from a prepared integral so that the prep counts once per step.
    integrals = {}
    for quant, paths in ((4, (SCORE, MULTIFACE, STREAM, FILE, SERVE)), (1, ())):
        integrals[quant] = resize.crop_area_integral(frames, quant)
        forms.append(Form(
            "crop_resize_area", f"prep q={quant}", paths,
            lambda q=quant: resize.crop_area_integral(frames, q),
            lambda q=quant: resize.crop_area_integral_plain(frames, q), None, nbytes=0, ops=0))
    full_q4 = (SCORE, MULTIFACE, STREAM, FILE, SERVE)
    for quant, k, o, paths in ((4, 64, 24, full_q4), (4, 32, 48, full_q4),
                               (4, 4, 24, (STREAM,)), (4, 4, 48, (STREAM,)),
                               (4, 16, 24, (STREAM,)), (4, 16, 48, (STREAM,)),
                               (1, 64, 24, ()), (1, 32, 48, ())):
        bounds = crop_bounds(k)
        forms.append(Form(
            "crop_resize_area", f"K={k} O={o} q={quant}", paths,
            lambda bd=bounds, o=o, q=quant: resize.crop_resize_area_from_integral(
                integrals[q], bd, o, quant=q),
            lambda bd=bounds, o=o, q=quant: resize.crop_resize_area_from_integral_plain(
                integrals[q], bd, o, quant=q),
            None, nbytes=crop_bytes(bounds, o, quant), ops=crop_ops(bounds, o, quant)))
    for step in ("keyframe", "refine") if planar_k5 else ():
        forms.append(Form(
            "crop_resize_area_fused", f"planar copy ({step} step)", (PROPAGATE,),
            lambda: crop_area_fused.prep_frames_for_fused_crops(frames),
            lambda: frames.permute(0, 3, 1, 2).contiguous(), None, nbytes=0, ops=0))
    for k, o, paths in ((64, 24, (PROPAGATE, MULTIFACE)), (32, 48, (PROPAGATE, MULTIFACE)),
                        (4, 24, (PROPAGATE,)), (4, 48, (PROPAGATE,)),
                        (16, 24, (MULTIFACE,)), (16, 48, (MULTIFACE,))):
        bounds = crop_bounds(k)
        plain = lambda bd=bounds, o=o: crop_area_fused.crop_resize_area_fused_plain(
            k5_frames, bd, o, src_hw=(h, w))
        k3 = lambda bd=bounds, o=o: resize.crop_resize_area(frames, bd, o, quant=1)
        forms.append(Form(
            "crop_resize_area_fused", f"K={k} O={o}", paths,
            lambda bd=bounds, o=o: crop_area_fused.crop_resize_area_fused(
                k5_frames, bd, o, src_hw=(h, w)),
            plain, None, nbytes=crop_bytes(bounds, o, 1), ops=crop_ops(bounds, o, 1),
            same_as=k3))
    for label, (eh, ew), bounds_np, o in crop_edge_inputs(h=h, w=w):
        bounds = torch.from_numpy(bounds_np).to(device)
        eb = bounds.shape[0]
        src = frames[:eb] if (eh, ew) == (h, w) else torch.randint(
            0, 256, (eb, eh, ew, 3), generator=g, device=device, dtype=torch.uint8)
        if planar_k5:
            src = crop_area_fused.prep_frames_for_fused_crops(src)
        x0, y0, x1, y1 = bounds.to(torch.int64).unbind(-1)
        inside = covered_pixels(x0.clamp(0, ew), y0.clamp(0, eh), x1.clamp(0, ew),
                                y1.clamp(0, eh), eh, ew)
        forms.append(Form(
            "crop_resize_area_fused", f"{label} K={bounds.shape[1]} O={o}", (),
            lambda s=src, bd=bounds, o=o, hw=(eh, ew): crop_area_fused.crop_resize_area_fused(
                s, bd, o, src_hw=hw),
            lambda s=src, bd=bounds, o=o, hw=(eh, ew): crop_area_fused.crop_resize_area_fused_plain(
                s, bd, o, src_hw=hw),
            None, nbytes=inside * 3 + bounds.numel() * 4 + bounds.shape[:2].numel() * o * o * 12,
            ops=bounds.shape[:2].numel() * o * o * 3))

    # K4: the 80x80 face crop, one box per frame (single face) or four
    # (multi-face, T = 4), clamped as the embed tail clamps them; three
    # lerps of three operations per output value.  Library yardstick:
    # grid_sample over float frames at the same sample positions (bilinear,
    # border padding), a frame's K crops stacked into one output.
    o = 80
    i = torch.arange(o, device=device, dtype=torch.float32)
    frames_f = frames.permute(0, 3, 1, 2).float()

    def positions(lo, hi):  # (b, k, o) sample coordinates in the frame
        n = (hi - lo).float()[..., None]
        s = torch.minimum(((i + 0.5) * n / o - 0.5).clamp_min(0), (n - 1).clamp_min(0))
        return lo.float()[..., None] + s

    def distinct(a, size):  # per crop, the source rows (or columns) read
        idx = torch.cat([a.floor(), a.floor() + 1], -1).clamp(0, size - 1).flatten(0, 1)
        return [torch.unique(r).numel() for r in idx]

    for k, paths in ((1, (SCORE, PROPAGATE, STREAM, FILE, SERVE)), (4, (MULTIFACE, STREAM))):
        bi = random_boxes(g_multi if k > 1 else g, b, k, h, w, device, clusters=k).to(torch.int32)
        bounds = torch.stack([bi[..., 0].clamp_min(0), bi[..., 1].clamp_min(0),
                              bi[..., 2].clamp_max(w), bi[..., 3].clamp_max(h)], -1)
        ax = positions(bounds[..., 0], bounds[..., 2])
        ay = positions(bounds[..., 1], bounds[..., 3])
        pixels_read = sum(r * c for r, c in zip(distinct(ay, h), distinct(ax, w)))
        grid = torch.stack([((ax + 0.5) * 2 / w - 1)[:, :, None, :].expand(b, k, o, o),
                            ((ay + 0.5) * 2 / h - 1)[:, :, :, None].expand(b, k, o, o)],
                           -1).reshape(b, k * o, o, 2)
        forms.append(Form(
            "crop_resize_bilinear", f"K={k} O={o}", paths,
            lambda bd=bounds: resize.crop_resize_bilinear(frames, bd, o),
            lambda bd=bounds: resize.crop_resize_bilinear_plain(frames, bd, o),
            lambda gr=grid: torch.nn.functional.grid_sample(
                frames_f, gr, mode="bilinear", padding_mode="border", align_corners=False),
            nbytes=pixels_read * 3 + bounds.numel() * 4 + b * k * o * o * 3 * 4,
            ops=b * k * o * o * 3 * 9))

    # K7: the classifier's crop of the multi-face path's T = 4 boxes a
    # frame, a fifth masked, each grown by a third and put on a 380x380
    # canvas in bf16.  Bytes: the output of every slot, and each valid
    # crop's grown source rectangle read once (three bytes a pixel); no
    # operations counted (integer sums of a few taps a value).
    from truely_tpu_torch.ops import crop_classifier as k7

    t, s_ = MAX_TRACKS, CLASSIFIER_SIZE
    cboxes = random_boxes(g_multi, b, t, h, w, device, clusters=t)
    keep = torch.rand((b, t), generator=g_multi, device=device) > 0.2
    rects = [k7.geometry(box, h, w, s_, CLASSIFIER_MARGIN) for box, on in zip(
        cboxes.reshape(-1, 4).tolist(), keep.flatten().tolist()) if on]
    reads = sum((r.y1 - r.y0) * (r.x1 - r.x0) for r in rects if r is not None)
    forms.append(Form(
        "crop_classifier", f"B={b} T={t} S={s_}", (CLASSIFIER,),
        lambda: k7.crop_classifier(frames, cboxes, keep, s_, CLASSIFIER_MARGIN, False),
        lambda: k7.crop_classifier_plain(frames, cboxes, keep, s_, CLASSIFIER_MARGIN, False),
        None, nbytes=b * t * s_ * s_ * 3 * 2 + 3 * reads, ops=0.0))

    # K6: the track fold of a batch, held to its plain version (the ATen
    # loop, on the card too) by ``fold_held``.  The multi-face path's and
    # the file path's (one stream, 32 frames, T = K = 4, bf16 512-d
    # embeddings, an int n_valid), the same with an (S,) tensor of n_valid
    # and a padded tail, and the stream path's (8 streams x 4 frames, a
    # tensor of n_valid, one stream idle and one short).  Bytes: the state
    # read and written, the detections (float32 embeddings) and the
    # per-frame outputs; operations: 14 per IoU and 6 per embedding element
    # of each track's dot product and norms.
    from truely_tpu_torch.pipeline import tracks

    t, d = MAX_TRACKS, 512
    for s, f, n_valid, paths in ((1, b, b, (MULTIFACE, FILE)),
                                 (1, b, torch.tensor([b - 3], device=device), ()),
                                 (STREAMS, STREAM_FRAMES, torch.tensor(
                                     [4, 4, 3, 4, 0, 4, 4, 4], device=device), (STREAM,))):
        boxes, valid, emb = fold_inputs(g_multi, s, f, t, d, device)
        state = tracks.init_track_state(t, d, streams=s, device=device)
        forms.append(Form(
            "track_timeline", f"S={s} F={f} T=K={t} D={d} n_valid "
            + ("int" if isinstance(n_valid, int) else "(S,) tensor"), paths,
            lambda a=(state, boxes, valid, emb, n_valid): tracks.track_timeline(*a),
            lambda a=(state, boxes, valid, emb, n_valid): tracks.track_timeline_plain(*a),
            None, nbytes=2 * s * t * (22 + 4 * d + 20) + s * f * t * (17 + 4 * d)
            + s * f * t * 23 + s * 4, ops=s * f * t * (14 * t + 6 * d), check=fold_held))
    return forms


# track_sim's tolerance: K6 sums the dot product and norms of 512 float32
# products in another order than ATen.
FOLD_SIM_ATOL = 1e-6


def fold_held(got, want) -> Tuple[bool, float]:
    """K6's (state, per-frame outputs) against the plain version's: every
    field equal bit for bit but ``track_sim``, within ``FOLD_SIM_ATOL``;
    the error is track_sim's."""
    (gs, go), (ws, wo) = got, want
    exact = all(torch.equal(a, b) for a, b in zip(gs, ws)) and all(
        torch.equal(getattr(go, n), getattr(wo, n)) for n in go._fields if n != "track_sim")
    err = float((go.track_sim.double() - wo.track_sim.double()).abs().max())
    return exact and err <= FOLD_SIM_ATOL, err


def fold_inputs(g, s: int, f: int, k: int, d: int, device):
    """(boxes (S, F, K, 4), valid (S, F, K), emb (S, F, K, D) bf16) for the
    track fold: K faces a stream in a 1080p frame, 60-250 px, that drift
    a pixel a frame, listed in a shuffled order, a fifth of them missed;
    embeddings at cosine about 0.995 to a face's identity, so that the
    counters both reset and run.  The last face leaves for 12 frames (more than
    max_misses 10) and comes back 400 px away, so its track retires and a
    new one spawns."""
    def u(*shape, lo=0.0, hi=1.0):
        return torch.empty(shape, device=device).uniform_(lo, hi, generator=g)

    side = u(s, 1, k, lo=60, hi=250)
    x0 = u(s, 1, k, lo=0, hi=1200) + torch.arange(f, device=device)[None, :, None]
    y0 = u(s, 1, k, lo=0, hi=800) + u(s, f, k, lo=-2, hi=2)
    i = torch.arange(f, device=device)
    x0[:, :, -1] += 400 * (i >= 20)[None, :]
    boxes = torch.stack([x0, y0, x0 + side, y0 + side], -1)
    ident = torch.nn.functional.normalize(
        torch.randn((s, 1, k, d), generator=g, device=device), dim=-1)
    noise = torch.randn((s, f, k, d), generator=g, device=device) * (0.1 / math.sqrt(d))
    emb = torch.nn.functional.normalize(ident + noise, dim=-1)
    valid = u(s, f, k) > 0.2
    valid[:, 8:20, -1] = False
    order = torch.argsort(u(s, f, k), -1)
    take = lambda x: torch.gather(x, 2, order.reshape(order.shape + (1,) * (x.dim() - 3))
                                  .expand_as(x))
    return take(boxes), torch.gather(valid, 2, order), take(emb).to(torch.bfloat16)


SOURCES = {
    "i420_to_bgr": ("truely_tpu_torch/csrc/yuv.cu", "truely_tpu/ops/yuv.py:190"),
    "nms_masked_batch": ("truely_tpu_torch/csrc/nms.cu", "truely_tpu/ops/nms_pallas.py:124"),
    "crop_resize_area": ("truely_tpu_torch/csrc/crop_area.cu",
                         "truely_tpu/ops/crop_fused2.py:166"),
    "crop_resize_bilinear": ("truely_tpu_torch/csrc/crop_bilinear.cu",
                             "truely_tpu/ops/crop_pallas.py:188"),
    "crop_resize_area_fused": ("truely_tpu_torch/csrc/crop_area_fused.cu",
                               "truely_tpu/ops/crop_area_fused.py:155"),
    # no Pallas kernel: the JAX package folds tracks with a lax.scan
    "track_timeline": ("truely_tpu_torch/csrc/tracks.cu", "truely_tpu/pipeline/tracks.py:209"),
    # no counterpart: the JAX package has no classifier
    "crop_classifier": ("truely_tpu_torch/csrc/crop_classifier.cu", "none"),
}
# K6, the track fold, runs on the multi-face paths alone; K7, the
# classifier's crop, on the classifier path alone.
TRACK_FOLD = "track_timeline"
CLASSIFIER_CROP = "crop_classifier"
# K3's prep: counted apart from its crops, and reported beside them.
K3_PREP = "crop_area_integral"
K3_PARTS = ("crop_resize_area", K3_PREP)
# The path whose run gives a kernel's "launches" and whose forms give its
# per-step times in the kernels line.
MAIN_PATH = {name: SCORE for name in (*SOURCES, K3_PREP)}
MAIN_PATH["crop_resize_area_fused"] = PROPAGATE
MAIN_PATH[TRACK_FOLD] = MULTIFACE
MAIN_PATH[CLASSIFIER_CROP] = CLASSIFIER


def kernel_phase(forms: List[Form]) -> List[dict]:
    """Every form checked and timed on the host's side: its issue rate,
    its plain version's and library call's, the host's cost per call, and
    its bound.  Returns one row per form."""
    rows, failures = [], []
    for f in forms:
        got, want = f.run(), f.plain()
        other = f.same_as() if f.same_as else want
        torch.cuda.synchronize()
        if f.check:
            equal, err = f.check(got, want)
        else:
            equal = torch.equal(got, want) and torch.equal(got, other)
            err = (float((got.double() - want.double()).abs().max()) if got.shape == want.shape
                   else math.inf)
        ms = cuda_ms(f.run)
        plain_ms = cuda_ms(f.plain)
        lib_ms = cuda_ms(f.library) if f.library else None
        h_ms = host_ms(f.run)
        lib_h_ms = host_ms(f.library) if f.library else None
        b_ms, by = bound_ms(f.nbytes, f.ops)
        rows.append(dict(kernel=f.kernel, form=f.label, paths=list(f.paths), equal=equal,
                         max_abs_err=err, ms=ms, host_ms=h_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, library_host_ms=lib_h_ms, bound_ms=b_ms, bound_by=by,
                         bytes=f.nbytes, ops=f.ops))
        log(f"kernel {f.kernel} [{f.label}] paths={'+'.join(f.paths) or 'none'}: "
            f"equal={equal}{' (to plain and to K3 q=1)' if f.same_as else ''} "
            f"max_abs_err={err} ms={ms:.4f} host_ms={h_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"library_host_ms={'null' if lib_h_ms is None else f'{lib_h_ms:.4f}'} "
            f"bound_ms={b_ms:.5f} ({by}: {f.nbytes:.3e} B, {f.ops:.3e} ops)")
        if not equal:
            failures.append(f"{f.kernel} [{f.label}] differs from its plain version (max {err})")
    require(not failures, "; ".join(failures))
    log(f"kernels: all {len(rows)} forms equal to their plain versions; bounds from {PEAKS}")
    return rows


def fmt(ms: Optional[float]) -> str:
    return "null" if ms is None else f"{ms:.4f}"


def device_phase(forms: List[Form], rows: List[dict]) -> None:
    """Each form's and library call's device time, from torch.profiler,
    into ``rows``.  It runs last: once the profiler has traced the card, a
    launch costs the host more for the rest of the process."""
    for f, row in zip(forms, rows):
        row["device_ms"] = device_ms(f.run)
        row["library_device_ms"] = device_ms(f.library) if f.library else None
        log(f"kernel {f.kernel} [{f.label}]: device_ms={fmt(row['device_ms'])} "
            f"library_device_ms={fmt(row['library_device_ms'])}")


def sweep(forms: List[Form]) -> None:
    """The launch shapes the wrappers choose, against the others their
    kernels take: K2's K=256 score forms at each cluster size (CTAs per
    frame), K5's propagate forms at each count of y-bins per CTA.  Each
    setting is held equal to the plain version and timed."""
    from truely_tpu_torch.ops import crop_area_fused, nms

    fixed = lambda n: (lambda *_: n)
    for module, knob, values, kernel, first in (
            (nms, "LARGE_K_CLUSTER", (1, 2, 4, 8), "nms_masked_batch", "K=256"),
            (crop_area_fused, "y_bins_per_cta", map(fixed, (1, 2, 3, 4, 6, 8)),
             "crop_resize_area_fused", "K=")):
        chosen = getattr(module, knob)
        for value in values:
            setattr(module, knob, value)
            shown = value if isinstance(value, int) else value()
            for f in forms:
                if f.kernel == kernel and f.label.startswith(first) and f.paths:
                    require(torch.equal(f.run(), f.plain()), f"{kernel} at {knob}={shown} differs")
                    log(f"sweep {knob}={shown} [{f.label}] ms={cuda_ms(f.run):.4f} "
                        f"device_ms={fmt(device_ms(f.run))}")
        setattr(module, knob, chosen)


def kernel_summary(rows: List[dict]) -> dict:
    """Kernel name -> summary, with per-path times: the sum over the forms
    a path makes, one call of each (for the propagate path one keyframe
    step's and one refine step's; the multiface and stream paths add the
    forms of each of their runs' steps)."""
    summary = {}
    for name in SOURCES:
        mine = [r for r in rows if r["kernel"] == name]
        per_path = {}
        for path in PATHS:
            on = [r for r in mine if path in r["paths"]]
            if not on:
                continue

            def total(key):
                vals = [r[key] for r in on]
                return None if None in vals else sum(vals)

            per_path[path] = dict(
                ms=total("ms"), device_ms=total("device_ms"), plain_ms=total("plain_ms"),
                bound_ms=total("bound_ms"),
                bound_by=max(on, key=lambda r: r["bound_ms"])["bound_by"],
                library_ms=total("library_ms"), library_device_ms=total("library_device_ms"))
        summary[name] = dict(
            max_abs_err=max(r["max_abs_err"] for r in mine), paths=per_path,
            forms=[{k: r[k] for k in ("form", "paths", "ms", "device_ms", "host_ms", "plain_ms",
                                      "library_ms", "library_device_ms", "library_host_ms",
                                      "bound_ms", "bound_by")} for r in mine])
        log(f"kernel {name} per step: " + json.dumps(per_path))
    return summary


def launch_floor(device) -> Dict[str, float]:
    """Host microseconds per call, issued back to back, of K4's wrapper at
    the score path's shape and of its parts: the output's allocation and
    the bare launch through ``cuda_build.launch``."""
    from truely_tpu_torch.ops import cuda_build, resize

    b, o = STEP_B, 80
    frames = torch.zeros((b, STEP_H, STEP_W, 3), dtype=torch.uint8, device=device)
    bounds = torch.tensor([[[100, 200, 500, 600]]] * b, dtype=torch.int32, device=device)
    out = torch.empty((b, 1, o, o, 3), dtype=torch.float32, device=device)
    P, I = cuda_build.P, cuda_build.I
    args = (frames.data_ptr(), bounds.data_ptr(), out.data_ptr(), b, STEP_H, STEP_W, 1, o)
    parts = {
        "wrapper": lambda: resize.crop_resize_bilinear(frames, bounds, o),
        "new_empty of the output": lambda: frames.new_empty((b, 1, o, o, 3), dtype=torch.float32),
        "cuda_build.launch alone": lambda: cuda_build.launch(
            "crop_bilinear", "tt_crop_bilinear", [P, P, P, I, I, I, I, I], *args,
            device=frames.device),
        "an empty Python call": lambda: None,
    }
    us = {name: host_ms(fn, calls=500) * 1e3 for name, fn in parts.items()}
    log("launch floor (host us per call, back to back, K4 at B=32 O=80): " + json.dumps(us))
    return us


# ---------------------------------------------------------------------------
# End-to-end phase
# ---------------------------------------------------------------------------


def launch_counters():
    from truely_tpu_torch.ops import crop_area_fused, crop_classifier, nms, resize, yuv
    from truely_tpu_torch.pipeline import tracks

    return {"i420_to_bgr": yuv.i420_to_bgr, "nms_masked_batch": nms.nms_masked_batch,
            "crop_resize_area": resize.crop_resize_area_from_integral,
            K3_PREP: resize.crop_area_integral,
            "crop_resize_bilinear": resize.crop_resize_bilinear,
            "crop_resize_area_fused": crop_area_fused.crop_resize_area_fused,
            TRACK_FOLD: tracks.track_timeline,
            CLASSIFIER_CROP: crop_classifier.crop_classifier}


def reset_launches() -> dict:
    """Every kernel wrapper's launch count set to 0; returns the wrappers."""
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def read_launches(counters: dict) -> Dict[str, int]:
    return {name: fn.launches for name, fn in counters.items()}


def require_launched(launches: Dict[str, int], label: str, k5: bool) -> None:
    """K1, K2, K4 and either K5 (``k5``) or both K3 kernels launched, and
    the other stage-crop kernel not.  K6 is checked against the folds
    (``require_folds``), K7 by the classifier path."""
    crops = ("crop_resize_area_fused",) if k5 else K3_PARTS
    unused = K3_PARTS if k5 else ("crop_resize_area_fused",)
    silent = [k for k, v in launches.items()
              if v <= 0 and k not in (*unused, TRACK_FOLD, CLASSIFIER_CROP)]
    require(not silent, f"{label}: kernels not launched: {silent}")
    require(all(launches[k] == 0 for k in unused),
            f"{label}: {'K3' if k5 else 'K5'} launched where {crops} should run")


def counted_folds(det) -> List[int]:
    """Wraps ``det.track_fold`` on the instance to count its calls (every
    multi-face path folds through it) in the returned one-item list."""
    calls, fold = [0], det.track_fold

    def counted(*args, **kwargs):
        calls[0] += 1
        return fold(*args, **kwargs)

    det.track_fold = counted
    return calls


def require_folds(launches: Dict[str, int], folds: int, label: str) -> None:
    """One K6 launch per track fold, and no fold that did not launch it."""
    require(launches[TRACK_FOLD] == folds,
            f"{label}: {launches[TRACK_FOLD]} K6 launches for {folds} track folds")


def add_launches(total: Dict[str, int], launches: Dict[str, int]) -> Dict[str, int]:
    return {k: total.get(k, 0) + v for k, v in launches.items()}


def sync_ms(fn) -> Tuple[object, float]:
    """(result, host milliseconds) of ``fn`` with the device synchronised
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def stage_times(det, packed: torch.Tensor) -> dict:
    """Milliseconds of each stage of one frame step, synchronised around
    each stage (so the stages do not overlap as they do in a plain run)."""
    from truely_tpu_torch.ops.temporal import init_temporal_state
    from truely_tpu_torch.ops.yuv import i420_to_bgr
    from truely_tpu_torch.pipeline import mtcnn
    from truely_tpu_torch.pipeline.detector import embed_tail

    cfg, dtype = det.config, det.dtype
    times = {}

    def timed(name, fn):
        out, times[name] = sync_ms(fn)
        return out

    with torch.inference_mode():
        frames = timed("i420_to_bgr", lambda: i420_to_bgr(packed))
        boxes, scores, valid = timed("stage1 (pyramid, P-Net, top-k, NMS x2)",
                                     lambda: mtcnn._stage1(det.nets.mtcnn, frames, cfg.mtcnn, dtype))
        k2 = min(cfg.mtcnn.rnet_capacity, boxes.shape[1])
        dets = timed("stages 2-3 (crops, R-Net, O-Net, NMS x2)", lambda: mtcnn._stages23(
            det.nets.mtcnn, mtcnn.prep_crop_frames(frames, cfg.mtcnn, dtype), boxes, scores,
            valid, cfg.mtcnn, k2=k2, k3=min(cfg.mtcnn.onet_capacity, k2), dtype=dtype))
        box, _score, has_face = mtcnn.select_primary_face(dets)
        out = timed("embed (face crop, FaceNet, landmarks)", lambda: embed_tail(
            det.nets, frames, box, has_face, cfg, dtype))
        timed("temporal", lambda: det.temporal(
            out, packed.shape[0], init_temporal_state(det.embedding_dim, det.device)))
    return times


def propagate_stage_times(det, packed: torch.Tensor) -> dict:
    """Milliseconds of the propagate path's two steps on one batch,
    synchronised around each: the cascade-only seed step of a keyframe
    batch, and the refine step (I420, seeded stages 2-3, embed tail)."""
    from truely_tpu_torch.pipeline import detector

    k = 4
    (seed_box, seed_hf), t_seed = sync_ms(lambda: det._run(detector.frame_step_detect_yuv, packed))
    _, t_refine = sync_ms(lambda: det._run(
        detector.frame_step_propagate_yuv, packed, seed_box[::k], seed_hf[::k], k=k))
    return {"seed step (I420, cascade)": t_seed,
            "refine step (I420, stages 2-3 on 4 candidates, embed)": t_refine}


def profile_run(det, packed: np.ndarray, out_dir: str, name: str) -> None:
    """torch.profiler over ``analyze_i420(packed)``: the kernel table and a
    Chrome trace into ``out_dir`` as ``<name>.txt`` and ``<name>.json``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.analyze_i420(packed, fps=FPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}.json"))
    device_us = profiled_device_us(prof)
    log(f"profile {name}: {packed.shape[0]} frames {wall * 1e3:.2f} ms wall, "
        f"{device_us / 1e3:.2f} ms of device kernels (idle share {1 - device_us / 1e6 / wall:.3f}); "
        f"table in {out_dir}/{name}.txt")
    log("\n".join(table.splitlines()[:30]))


def steady_regression(det):
    """Scale the R-Net and O-Net box-regression heads of ``det`` by
    PROP_REGRESSION_SCALE (see there)."""
    with torch.no_grad():
        for layer in (det.nets.mtcnn.rnet.dense5_2, det.nets.mtcnn.onet.dense6_2):
            layer.weight.mul_(PROP_REGRESSION_SCALE)
            layer.bias.mul_(PROP_REGRESSION_SCALE)
    return det


def allocator_counts() -> Dict[str, int]:
    """The CUDA caching allocator's counts of device allocations and frees
    (cudaMalloc, cudaFree) and of retries after a failed allocation, each
    of which synchronises the device."""
    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(k, 0)) for k in ("num_device_alloc", "num_device_free",
                                              "num_alloc_retries")}


def drive(det, packed: np.ndarray, n_warm: int, label: str) -> Tuple[object, Dict[str, int]]:
    """``analyze_i420`` on the first ``n_warm`` frames (warm-up), then, with
    every launch count set to 0 just before, on the rest; checks the
    records and returns (result, launches of the timed run)."""
    det.analyze_i420(packed[:n_warm], fps=FPS)
    torch.cuda.synchronize()
    fallback0 = det.fallback_segments
    counters = reset_launches()
    alloc0 = allocator_counts()
    t0 = time.perf_counter()
    res = det.analyze_i420(packed[n_warm:], fps=FPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    allocs = {k: v - alloc0[k] for k, v in allocator_counts().items()}

    n = res.total_processed
    b = det.config.frame_batch
    require(n == packed.shape[0] - n_warm == len(res.records), f"{n} sampled, {len(res.records)} records")
    sims = np.array([r.similarity for r in res.records])
    require(bool(np.isfinite(sims).all() and (np.abs(sims) <= 1.0 + 1e-5).all()),
            f"similarities out of range: {sims}")
    require(0 <= res.fake_score <= 100, f"fake_score {res.fake_score}")
    faces = sum(r.has_face for r in res.records)
    log(f"e2e {label}: {n} sampled frames in {wall:.4f} s = {n / wall:.2f} sampled frames/s "
        f"({n // b} batches of {b}); frames with a face: {faces}; segments re-run by the "
        f"propagate fallback: {det.fallback_segments - fallback0}; "
        f"fake_score {res.fake_score}; host timings {json.dumps(res.timings)}; caching "
        f"allocator during the run: {json.dumps(allocs)}")
    log(json.dumps({"path": label, "launches": launches}))
    return res, launches


def e2e_phase(profile_dir: Optional[str]) -> Dict[str, int]:
    """The score path; returns each kernel's launch count over its timed
    batches."""
    from truely_tpu_torch.config import DetectorConfig
    from truely_tpu_torch.pipeline.detector import Detector

    cfg = DetectorConfig()  # the bf16 defaults
    b = cfg.frame_batch
    t0 = time.perf_counter()
    det = Detector(cfg)
    packed = synthetic_i420(b * (1 + E2E_BATCHES), STEP_H, STEP_W, seed=7)
    log(f"e2e: Detector({cfg.compute_dtype}, frame_batch {b}) and {packed.shape[0]} frames "
        f"of {STEP_W}x{STEP_H} I420 ready in {time.perf_counter() - t0:.1f} s")
    _, launches = drive(det, packed, b, SCORE)
    require_launched(launches, "score path", k5=False)

    step = torch.from_numpy(packed[b:2 * b]).to(det.device)
    stage_times(det, step)  # warm
    times = stage_times(det, step)
    log("e2e stages (ms, one batch of 32, synchronised per stage): "
        + json.dumps({k: round(v, 3) for k, v in times.items()}))
    if profile_dir:
        profile_run(det, packed[b:2 * b], profile_dir, "score_batch")
    return launches


def propagate_phase(profile_dir: Optional[str]) -> Dict[str, int]:
    """The propagate path at K=4 and "auto"; returns each kernel's launch
    count over the K=4 run's timed batches."""
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
    from truely_tpu_torch.pipeline.detector import Detector

    mt = MTCNNConfig(stage_crop_quant=1, use_fused_crops=1, thresholds=PROP_THRESHOLDS)
    b = DetectorConfig().frame_batch
    t0 = time.perf_counter()
    packed = stable_i420(b * (4 + PROP_BATCHES), STEP_H, STEP_W, seed=21)
    log(f"propagate: {packed.shape[0]} stable frames of {STEP_W}x{STEP_H} I420 ready in "
        f"{time.perf_counter() - t0:.1f} s")
    fixed = None
    for interval in (4, "auto"):
        det = steady_regression(Detector(DetectorConfig(detect_interval=interval, mtcnn=mt)))
        _, launches = drive(det, packed, 4 * b, f"propagate K={interval}")
        require_launched(launches, f"propagate K={interval}", k5=True)
        if interval == "auto":
            log(f"propagate auto telemetry (warm-up and timed runs): rung "
                f"{det.auto_interval_current}, keyframe segments {det.auto_keyframe_segments}, "
                f"refine segments {det.auto_refine_segments}")
            require(det.auto_refine_segments > 0 and det.auto_interval_current > 1,
                    "the auto ladder did not climb")
        else:
            fixed = launches
            step = torch.from_numpy(packed[:b]).to(det.device)
            propagate_stage_times(det, step)  # warm
            log("propagate stages (ms, one batch of 32, synchronised per step): " + json.dumps(
                {k: round(v, 3) for k, v in propagate_stage_times(det, step).items()}))
            if profile_dir:
                profile_run(det, packed[:4 * b], profile_dir, "propagate_cycle")
    return fixed


# ---------------------------------------------------------------------------
# Multi-face path
# ---------------------------------------------------------------------------


def multiface_stage_times(det, packed: torch.Tensor, k: Optional[int] = None) -> dict:
    """Milliseconds of each stage of one multi-face batch, synchronised
    around each: I420->BGR, the cascade (with ``k``: the seed step of a
    keyframe batch, then the refine of its rows on T x 4 candidates), the
    tail (K4 at K = T, FaceNet on B x T crops) and the track fold of the
    batch's frames."""
    from truely_tpu_torch.pipeline import detector as tdet
    from truely_tpu_torch.pipeline.mtcnn import detect_faces, refine_faces_multi
    from truely_tpu_torch.pipeline.tracks import init_track_state

    cfg, dtype, t = det.config, det.dtype, det.config.max_tracks
    times = {}

    def timed(name, fn):
        out, times[name] = sync_ms(fn)
        return out

    with torch.inference_mode(), tdet.precision(det.dtype):
        frames = timed("i420_to_bgr", lambda: tdet.to_frames(packed, cfg))
        if k is None:
            boxes, valid = timed("cascade (full, top 4 by area)", lambda: tdet.multiface_select(
                detect_faces(det.nets.mtcnn, frames, cfg.mtcnn, dtype=dtype), t))
        else:
            sb, sv = timed("seed step (cascade)", lambda: tdet.multiface_detect(
                det.nets, frames, cfg, dtype))
            sb, sv = sb[::k].repeat_interleave(k, 0), sv[::k].repeat_interleave(k, 0)
            boxes, valid = timed(f"refine (stages 2-3 on {t * 4} candidates)",
                                 lambda: tdet.multiface_select(refine_faces_multi(
                                     det.nets.mtcnn, frames, sb, sv, cfg.mtcnn, dtype=dtype), t))
        boxes, valid, emb = timed(f"tail (K4 at K={t}, FaceNet on {packed.shape[0] * t} crops)",
                                  lambda: tdet.multiface_tail(det.nets, frames, boxes, valid,
                                                              cfg, dtype))
    state = init_track_state(t, det.embedding_dim, device=det.device)
    timed(f"track fold ({packed.shape[0]} frames)", lambda: det.track_fold(
        state, boxes[None], valid[None], emb[None], packed.shape[0]))
    return times


def fold_profile(device) -> None:
    """Five calls of one batch's track fold (one stream, 32 frames, 4
    tracks, bf16 512-d embeddings from ``fold_inputs``) under
    torch.profiler, by K6 and by its plain version: the top-level ATen
    calls, device kernels, device time and wall time of a call of each.  It runs after the device times, as they do,
    since the profiler slows later launches."""
    from torch.profiler import ProfilerActivity, profile
    from truely_tpu_torch.pipeline import tracks

    g = torch.Generator(device=device).manual_seed(5)
    f, t, d = STEP_B, MAX_TRACKS, 512
    boxes, valid, emb = fold_inputs(g, 1, f, t, d, device)
    state = tracks.init_track_state(t, d, device=device)
    calls = 5
    for label, fold in (("K6", tracks.track_timeline), ("plain", tracks.track_timeline_plain)):
        def run(fold=fold):
            with torch.inference_mode():
                for _ in range(calls):
                    fold(state, boxes, valid, emb, f)

        run()
        torch.cuda.synchronize()
        for _ in range(2):  # a window that lost kernels is taken once more, as in device_ms
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, wall = sync_ms(run)
            kernels = sum(e.count for e in device_events(prof))
            if kernels >= calls:
                break
        aten = [e for e in prof.events() if e.name.startswith("aten::")
                and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
        log(f"track fold profile, {label} ({f} frames, {t} tracks), per call of {calls}: "
            f"{len(aten) / calls:.1f} top-level ATen calls, {kernels / calls:.1f} device kernels "
            f"and copies, {profiled_device_us(prof) / 1e3 / calls:.3f} ms of device time in "
            f"{wall / calls:.3f} ms wall")


def log_stages(label: str, times: dict) -> None:
    fold = next(v for name, v in times.items() if name.startswith("track fold"))
    log(f"multiface stages {label} (ms, one batch of {STEP_B}, synchronised per stage): "
        + json.dumps({k: round(v, 3) for k, v in times.items()})
        + f"; the track fold's share of the batch: {fold / sum(times.values()):.4f}")


def drive_tracks(det, packed: np.ndarray, n_warm: int, label: str) -> Dict[str, int]:
    """``analyze_i420_tracks`` on the first ``n_warm`` frames (warm-up),
    then, with every launch count set to 0 just before, on the rest;
    checks the result and returns the launches of the timed run."""
    det.analyze_i420_tracks(packed[:n_warm], fps=FPS)
    torch.cuda.synchronize()
    fallback0 = det.fallback_segments
    folds = counted_folds(det)
    counters = reset_launches()
    t0 = time.perf_counter()
    agg, per_track, state = det.analyze_i420_tracks(packed[n_warm:], fps=FPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    n, t = packed.shape[0] - n_warm, det.config.max_tracks
    require(all(x.device.type == det.device.type for x in state),
            f"multiface {label}: state off {det.device}")
    require(per_track.shape == (t,) and per_track.min() >= 0 and per_track.max() <= 100
            and agg == per_track.max(), f"multiface {label}: scores {per_track}, {agg}")
    require(bool(torch.isfinite(state.box).all() and torch.isfinite(state.embedding).all()),
            f"multiface {label}: non-finite track state")
    require(int(state.processed.max()) < n, f"multiface {label}: processed {state.processed}")
    require(folds[0] > 0, f"multiface {label}: no track fold")
    require_folds(launches, folds[0], f"multiface {label}")
    log(f"multiface {label}: {n} sampled frames in {wall:.4f} s = {n / wall:.2f} sampled "
        f"frames/s ({n // det.config.frame_batch} batches); active tracks "
        f"{int(state.active.sum())}/{t}; counter updates per track {state.processed.tolist()}; "
        f"per-track scores {per_track.tolist()}, aggregate {agg}; segments re-run by the "
        f"propagate fallback: {det.fallback_segments - fallback0}")
    log(json.dumps({"path": f"{MULTIFACE} {label}", "launches": launches}))
    return launches


def multiface_phase() -> Dict[str, int]:
    """The multi-face path: ``analyze_i420_tracks`` at the bf16 defaults
    (K=1), then at K=4 and "auto" on the exact crop chain; returns each
    kernel's launches summed over the three timed runs."""
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
    from truely_tpu_torch.pipeline.detector import Detector

    cfg = DetectorConfig(multi_face=True, max_tracks=MAX_TRACKS)
    b = cfg.frame_batch
    det = Detector(cfg)
    packed = synthetic_i420(b * (1 + MF_BATCHES), STEP_H, STEP_W, seed=31)
    total = drive_tracks(det, packed, b, "K=1")
    require_launched(total, "multiface K=1", k5=False)
    step = torch.from_numpy(packed[:b]).to(det.device)
    multiface_stage_times(det, step)  # warm
    log_stages("K=1", multiface_stage_times(det, step))

    mt = MTCNNConfig(stage_crop_quant=1, use_fused_crops=1, thresholds=PROP_THRESHOLDS)
    packed = stable_i420(b * (4 + MF_PROP_BATCHES), STEP_H, STEP_W, seed=33)
    for interval in (4, "auto"):
        det = steady_regression(Detector(DetectorConfig(
            multi_face=True, max_tracks=MAX_TRACKS, detect_interval=interval, mtcnn=mt)))
        launches = drive_tracks(det, packed, 4 * b, f"K={interval}")
        require_launched(launches, f"multiface K={interval}", k5=True)
        total = add_launches(total, launches)
        if interval == "auto":
            log(f"multiface auto telemetry (warm-up and timed runs): rung "
                f"{det.auto_interval_current}, keyframe segments {det.auto_keyframe_segments}, "
                f"refine segments {det.auto_refine_segments}")
            require(det.auto_refine_segments > 0 and det.auto_interval_current > 1,
                    "the multi-face auto ladder did not climb")
        else:
            step = torch.from_numpy(packed[:b]).to(det.device)
            multiface_stage_times(det, step, k=4)  # warm
            log_stages("K=4", multiface_stage_times(det, step, k=4))
    return total


def classifier_phase() -> Dict[str, int]:
    """The classifier on the multi-face path: ``analyze_i420_tracks`` at
    K=4 under the propagate path's conditions with a one-member ensemble
    (the seeded init), one warm-up cycle and four timed batches; K7 once
    per batch, K1 once more per batch (the crops' frames), the crop mask
    the slots with a face, finite logits and a score in [0, 1].  Returns
    the timed run's launches."""
    from truely_tpu_torch.config import ClassifierConfig, DetectorConfig, MTCNNConfig
    from truely_tpu_torch.pipeline.detector import Detector

    cfg = DetectorConfig(multi_face=True, max_tracks=MAX_TRACKS, detect_interval=4,
                         mtcnn=MTCNNConfig(thresholds=PROP_THRESHOLDS),
                         classifier=ClassifierConfig(ensemble=1))
    b = cfg.frame_batch
    det = steady_regression(Detector(cfg))
    packed = stable_i420(b * 8, STEP_H, STEP_W, seed=35)
    det.analyze_i420_tracks(packed[:4 * b], fps=FPS)
    torch.cuda.synchronize()
    counters = reset_launches()
    t0 = time.perf_counter()
    agg, per_track, state, got = det.analyze_i420_tracks(packed[4 * b:], fps=FPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    n, t = 4 * b, MAX_TRACKS
    require(launches[CLASSIFIER_CROP] == 4, f"classifier: K7 launched {launches[CLASSIFIER_CROP]}")
    require(got.mask.shape == (n, t) and got.logits.shape == (1, n, t) and got.mask.any(),
            f"classifier: mask {got.mask.shape} {int(got.mask.sum())}, logits {got.logits.shape}")
    require(bool(np.isfinite(got.logits).all()) and 0.0 <= got.score <= 1.0,
            f"classifier: logits finite {np.isfinite(got.logits).all()}, score {got.score}")
    crops, logits = int(got.mask.sum()), got.logits[0][got.mask]
    log(f"classifier K=4: {n} sampled frames in {wall:.4f} s = {n / wall:.2f} sampled frames/s, "
        f"{crops} crops ({crops / wall:.1f} a second through one B7); score {got.score:.4f}; "
        f"logits {float(logits.min()):.3f}..{float(logits.max()):.3f}")
    log(json.dumps({"path": CLASSIFIER, "launches": launches}))
    return launches


# ---------------------------------------------------------------------------
# Stream path
# ---------------------------------------------------------------------------


def stream_content(n_streams: int, n: int, h: int, w: int, seed: int) -> List[np.ndarray]:
    """Each stream its own stable content: one seeded base frame shifted by
    0-14 px; stream i has n - (i % 3) frames, so the last steps pad."""
    return [stable_i420(n - i % 3, h, w, seed=seed + i, n_base=1) for i in range(n_streams)]


def feed_streams(sched, content: List[np.ndarray]) -> Tuple[list, list]:
    """Push the streams' frames round robin, a step whenever a whole batch
    is queued, then drain.  Returns (events, the "auto" rung after each
    step, or None)."""
    events, rungs = [], []
    rows = sched.n_streams * sched.frames_per_stream

    def step():
        events.extend(sched.step())
        rungs.append(getattr(sched, "_cur_k", None))

    for t in range(max(len(c) for c in content)):
        for i, c in enumerate(content):
            if t < len(c):
                sched.push(i, c[t])
        if sched.pending() >= rows:
            step()
    while sched.pending():
        step()
    return events, rungs


def drive_stream(det, content: List[np.ndarray], label: str, **kw):
    """A ``StreamScheduler`` over the streams (I420, one warm-up scheduler
    on their first 12 frames), the launch counts set to 0 just before the
    timed run; checks one event per pushed sampled frame.  Returns
    (scheduler, launches, rungs)."""
    from truely_tpu_torch.pipeline.streaming import StreamScheduler

    def scheduler():
        return StreamScheduler(det, len(content), frames_per_stream=STREAM_FRAMES, fps=FPS,
                               yuv=True, **kw)

    feed_streams(scheduler(), [c[:3 * STREAM_FRAMES] for c in content])
    torch.cuda.synchronize()
    sched = scheduler()
    folds = counted_folds(det)
    counters = reset_launches()
    t0 = time.perf_counter()
    events, rungs = feed_streams(sched, content)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    require(all(x.device.type == det.device.type for x in sched._states),
            f"stream {label}: state off {det.device}")
    require((folds[0] > 0) == sched.multi_face, f"stream {label}: {folds[0]} track folds")
    require_folds(launches, folds[0], f"stream {label}")
    pushed = sum(len(c) for c in content)
    require(sorted((e.stream_id, e.frame_index) for e in events)
            == [(i, t) for i, c in enumerate(content) for t in range(len(c))],
            f"stream {label}: {len(events)} events for {pushed} pushed sampled frames")
    sims = np.array([e.track_sim if sched.multi_face else e.similarity for e in events])
    require(bool(np.isfinite(sims).all() and (np.abs(sims) <= 1.0 + 1e-5).all()),
            f"stream {label}: similarities out of range")
    scores = [sched.score(i) for i in range(len(content))]
    require(all(0 <= s <= 100 for s in scores), f"stream {label}: scores {scores}")
    per_track = ([sched.track_scores_for(i).tolist() for i in range(len(content))]
                 if sched.multi_face else None)
    log(f"stream {label}: {pushed} sampled frames of {len(content)} streams in {wall:.4f} s = "
        f"{pushed / wall:.2f} sampled frames/s; steps {sched.steps_run}, keyframe steps "
        f"{sched.keyframe_steps}, padded rows {sched.frames_padded}; frames with a face "
        f"{sum(e.has_face for e in events)}; scores {scores}"
        + (f"; per-track scores {per_track}" if per_track else "")
        + (f"; rungs {rungs}" if sched.auto_interval else ""))
    log(json.dumps({"path": f"{STREAM} {label}", "launches": launches}))
    return sched, launches, rungs


def stream_phase() -> Dict[str, int]:
    """The stream path: 8 streams x 4 frames a step at 1080p, I420,
    single-face at the defaults, at K=4 and at "auto", and multi-face at
    K=4; returns each kernel's launches summed over the four timed runs."""
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
    from truely_tpu_torch.pipeline.detector import Detector

    t0 = time.perf_counter()
    content = stream_content(STREAMS, STREAM_LEN, STEP_H, STEP_W, seed=41)
    log(f"stream: {STREAMS} streams of stable {STEP_W}x{STEP_H} I420 ready in "
        f"{time.perf_counter() - t0:.1f} s")
    _, total, _ = drive_stream(Detector(DetectorConfig()), content, "single-face K=1")
    require_launched(total, "stream single-face K=1", k5=False)
    mt = MTCNNConfig(thresholds=PROP_THRESHOLDS)
    for label, cfg in (
            ("single-face K=4", DetectorConfig(detect_interval=4, mtcnn=mt)),
            ("single-face auto", DetectorConfig(detect_interval="auto", mtcnn=mt)),
            ("multi-face K=4", DetectorConfig(detect_interval=4, multi_face=True,
                                              max_tracks=MAX_TRACKS, mtcnn=mt))):
        sched, launches, rungs = drive_stream(steady_regression(Detector(cfg)), content, label)
        require_launched(launches, f"stream {label}", k5=False)
        require(0 < sched.keyframe_steps < sched.steps_run, f"stream {label}: no refine step ran")
        if sched.auto_interval:
            require(max(rungs) > 1, "the stream auto ladder did not climb")
        total = add_launches(total, launches)
    return total


# ---------------------------------------------------------------------------
# File path
# ---------------------------------------------------------------------------


def write_avi(path: str, packed: np.ndarray, fps: int) -> str:
    """Packed I420 frames as an uncompressed I420 AVI (the port's writer)."""
    from truely_tpu_torch.media.rawavi import RawAviWriter

    out = RawAviWriter(path, fps, packed.shape[2], packed.shape[1] * 2 // 3)
    for p in packed:
        out.write_i420(p)
    out.close()
    return path


def compare_exact(label: str, got, want) -> None:
    """Two analyses of the same frames on the card: records, counters and
    score equal; otherwise prints by how much and fails."""
    if got.records == want.records and (got.fake_score, got.flagged_count, got.final_counter) \
            == (want.fake_score, want.flagged_count, want.final_counter):
        return
    d = drift(want.records, got.records) if len(got.records) == len(want.records) else {}
    box = sim = None
    if d:
        box = float(np.abs(np.array([r.box for r in got.records])
                           - np.array([r.box for r in want.records])).max())
        sim = float(np.abs(np.array([r.similarity for r in got.records])
                           - np.array([r.similarity for r in want.records])).max())
    raise RuntimeError(f"{label}: {len(got.records)} records against {len(want.records)}; "
                       f"drift {d}; max box diff {box}, max sim diff {sim}; scores "
                       f"{got.fake_score} / {want.fake_score}, flagged {got.flagged_count} / "
                       f"{want.flagged_count}, final counter {got.final_counter} / "
                       f"{want.final_counter}")


def near_outline(h: int, w: int, box, m: int) -> np.ndarray:
    """(h, w) mask of the pixels within ``m`` of the outline of ``box``."""
    x0, y0, x1, y1 = (int(v) for v in box)
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    on_v = (np.minimum(np.abs(xs - x0), np.abs(xs - x1)) <= m) & (ys >= y0 - m) & (ys <= y1 + m)
    on_h = (np.minimum(np.abs(ys - y0), np.abs(ys - y1)) <= m) & (xs >= x0 - m) & (xs <= x1 + m)
    return on_v | on_h


def drawn_area(h: int, w: int, box, flagged: bool, frame_index: int, m: int) -> np.ndarray:
    """(h, w) mask of where ``overlay.annotate_frame`` may draw for one
    box: within ``m`` of its outline, and with cv2 around its text (the
    overlay's text, at the overlay's place)."""
    from truely_tpu_torch.media import overlay

    area = near_outline(h, w, box, m)
    cv2 = overlay.cv2
    if cv2 is not None:
        text, (x, y), scale = ((f"AI Detected - Frame {frame_index}", (10, 30), 1) if flagged
                               else ("Real Frame", (int(box[0]), int(box[1]) - 10), 0.5))
        (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, 2)
        area[max(0, y - th - m):max(0, y + base + m + 1),
             max(0, x - m):max(0, x + tw + m + 1)] = True
    return area


def check_output(label: str, out: str, packed: np.ndarray, drawn: Dict[int, tuple],
                 sampled: List[int]) -> int:
    """The annotated output: every frame of the source; each frame not
    drawn on byte-equal to the source picture; a drawn frame (every 8th
    one is checked) equal to the source converted as the writer converts,
    except where its boxes are drawn (``drawn_area``).  ``drawn``: frame
    index -> its (box, flagged) pairs, or None where they are not known
    (multi-face: then every unsampled frame must be untouched).  Returns
    the number of frames that changed."""
    from truely_tpu_torch.media import rawavi
    from truely_tpu_torch.media.native import i420_to_bgr_host

    reader = rawavi.RawAviReader(out)
    try:
        require(reader.frame_count == packed.shape[0],
                f"{label}: {reader.frame_count} frames written of {packed.shape[0]}")
        changed = [k for k in range(packed.shape[0])
                   if not np.array_equal(reader.read(k), packed[k])]
        if drawn is None:
            require(set(changed) <= set(sampled), f"{label}: unsampled frames changed: "
                    f"{sorted(set(changed) - set(sampled))}")
            return len(changed)
        require(set(changed) <= set(drawn), f"{label}: frames not drawn on changed: "
                f"{sorted(set(changed) - set(drawn))}")
        h, w = packed.shape[1] * 2 // 3, packed.shape[2]
        for k in sorted(drawn)[::8]:
            got = i420_to_bgr_host(reader.read(k))
            want = i420_to_bgr_host(rawavi.bgr_to_i420(i420_to_bgr_host(packed[k])))
            diff = (got != want).any(axis=-1)
            near = np.zeros((h, w), bool)
            for box, flagged in drawn[k]:
                near |= drawn_area(h, w, box, flagged, k, OUTLINE_PX)
            require(diff.any(), f"{label}: frame {k} has a box but nothing was drawn")
            require(not (diff & ~near).any(), f"{label}: frame {k} differs at "
                    f"{int((diff & ~near).sum())} pixels away from its boxes")
        return len(changed)
    finally:
        reader.close()


def file_phase() -> Dict[str, int]:
    """The file path: ``analyze_video`` score-only, with an annotated
    output, ``analyze_video_multiface`` with one, the CLI, ``stream_videos``
    over 8 readers and ``analyze_videos``; returns each kernel's launches
    summed over the timed runs (the CLI's run in its own process aside)."""
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
    from truely_tpu_torch.pipeline.batch import analyze_videos
    from truely_tpu_torch.pipeline.detector import Detector
    from truely_tpu_torch.pipeline.stream_files import stream_videos

    t_phase = time.perf_counter()
    packed = stable_i420(FILE_FRAMES, STEP_H, STEP_W, seed=51)
    sampled = list(range(0, FILE_FRAMES, DetectorConfig().sample_interval(FILE_FPS)))
    n = len(sampled)
    mt = MTCNNConfig(thresholds=PROP_THRESHOLDS)
    total: Dict[str, int] = {}

    def timed(label: str, fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after; K1-K4 must have launched and K5 not."""
        nonlocal total
        counters = reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(counters)
        require_launched(launches, f"file {label}", k5=False)
        log(json.dumps({"path": f"{FILE} {label}", "launches": launches}))
        total = add_launches(total, launches)
        return out, wall

    def rate(label: str, frames: int, wall: float, extra: str = "") -> None:
        log(f"file {label}: {frames} sampled frames in {wall:.4f} s = {frames / wall:.2f} "
            f"sampled frames/s{extra}")

    def timings(res) -> str:
        return "; timings " + json.dumps({k: round(v, 4) for k, v in res.timings.items()})

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        clip = write_avi(os.path.join(tmp, "clip.avi"), packed, FILE_FPS)
        log(f"file: {FILE_FRAMES} frames of {STEP_W}x{STEP_H} I420 at fps {FILE_FPS} made and "
            f"written ({os.path.getsize(clip) / 1e6:.1f} MB) in "
            f"{time.perf_counter() - t_phase:.1f} s, the write {time.perf_counter() - t0:.2f} s")

        # Score only, at the bf16 defaults, against analyze_i420 on the same frames.
        det = Detector(DetectorConfig())
        det.analyze_video(clip)  # warm-up
        score_only, wall = timed("score-only", lambda: det.analyze_video(clip))
        require(score_only.yuv_ingest and score_only.frame_count == FILE_FRAMES
                and score_only.total_processed == n,
                f"file score-only: {score_only.frame_count} frames, "
                f"{score_only.total_processed} sampled, yuv {score_only.yuv_ingest}")
        t0 = time.perf_counter()
        in_memory = det.analyze_i420(packed, fps=FILE_FPS)
        torch.cuda.synchronize()
        mem_wall = time.perf_counter() - t0
        compare_exact("file score-only against analyze_i420", score_only, in_memory)
        rate("score-only", n, wall, f"; records equal to analyze_i420's, which reads "
             f"{n / mem_wall:.2f} sampled frames/s on the same frames from memory; "
             f"fake_score {score_only.fake_score}" + timings(score_only))

        # With an output, under thresholds that give every frame a box.
        det1 = steady_regression(Detector(DetectorConfig(mtcnn=mt)))
        out = os.path.join(tmp, "out.avi")
        res, wall = timed("with output", lambda: det1.analyze_video(clip, out))
        drawn = {r.frame_index: ((r.box, r.flagged),) for r in res.records if r.annotated}
        require(len(drawn) > n // 2, f"file with output: {len(drawn)} of {n} frames drawn")
        changed = check_output("file with output", out, packed, drawn, sampled)
        rate("with output", n, wall, f"; {len(drawn)} frames drawn, {changed} changed, the "
             f"other {FILE_FRAMES - changed} byte-equal to the source" + timings(res))

        # Multi-face, K=4, 4 tracks, with an output.
        det = steady_regression(Detector(DetectorConfig(
            multi_face=True, max_tracks=MAX_TRACKS, detect_interval=4, mtcnn=mt)))
        (agg, per_track, state), wall = timed(
            "multi-face K=4", lambda: det.analyze_video_multiface(clip, out))
        require(int(state.processed.max()) > 0 and 0 <= agg <= 100,
                f"file multi-face: processed {state.processed.tolist()}, score {agg}")
        changed = check_output("file multi-face", out, packed, None, sampled)
        require(changed > 0, "file multi-face: no frame drawn")
        rate("multi-face K=4", n, wall, f"; active tracks {int(state.active.sum())}/"
             f"{MAX_TRACKS}; per-track scores {per_track.tolist()}; {changed} frames drawn")

        # The CLI, in its own process, at the defaults.
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "truely_tpu_torch", "analyze", clip,
                               "--compact"], cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        require(proc.returncode == 0, f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        payload = json.loads(proc.stdout.strip().splitlines()[-1])
        want = dict(fakeScore=score_only.fake_score, frameCount=FILE_FRAMES, processedFrames=n,
                    flaggedFrames=score_only.flagged_count,
                    suspiciousFrames=score_only.suspicious_frames)
        require({k: payload[k] for k in want} == want, f"CLI {payload} against {want}")
        log(f"file CLI: python -m truely_tpu_torch analyze in {time.perf_counter() - t0:.1f} s "
            f"(its own process): fakeScore {payload['fakeScore']} equal to analyze_video's; "
            f"timings {json.dumps(payload['timings'])}")

        # 8 streams of the file and the batch API at K=1, each equal to the
        # solo run with an output above (the same detector settings).
        key = lambda s: (s.fake_score, s.flagged_count, s.suspicious_frames, s.frame_count)
        want = (res.fake_score, res.flagged_count, res.suspicious_frames, res.frame_count)
        stats: dict = {}
        summaries, wall = timed(f"{FILE_STREAMS} streams K=1", lambda: stream_videos(
            det1, [clip] * FILE_STREAMS, frames_per_stream=4, scheduler_stats=stats))
        require(all(key(s) == want and s.processed == n and s.yuv_ingest for s in summaries),
                f"file streams K=1: {[key(s) for s in summaries]} against the solo run's {want}")
        rate(f"{FILE_STREAMS} streams K=1", n * FILE_STREAMS, wall,
             f"; each equal to the solo run (score {res.fake_score}, flagged "
             f"{res.flagged_count}); p50/p95 lag {summaries[0].p50_lag_s:.4f}/"
             f"{summaries[0].p95_lag_s:.4f} s; scheduler {json.dumps(stats)}")
        results, wall = timed(f"batch of {FILE_STREAMS} K=1", lambda: analyze_videos(
            det1, [clip] * FILE_STREAMS, frames_per_video=4))
        require(all((r.fake_score, r.flagged_count, r.suspicious_frames, r.frame_count) == want
                    for r in results), "file batch: results differ from the solo run")
        rate(f"batch of {FILE_STREAMS} K=1", n * FILE_STREAMS, wall,
             "; each equal to the solo run")

        # At K=4 a stream refines every row from its carried seed, where a
        # solo run passes each keyframe's box through: the JAX package's
        # scheduler makes the same decisions as the port's, and they may
        # differ from a solo run's (truely_tpu/cli.py, serve
        # --detect-interval).  So the 8 streams must agree with each other,
        # and the solo run at K=4 is printed beside them.
        det4 = steady_regression(Detector(DetectorConfig(detect_interval=4, mtcnn=mt)))
        solo = det4.analyze_video(clip)
        stats = {}
        summaries, wall = timed(f"{FILE_STREAMS} streams K=4", lambda: stream_videos(
            det4, [clip] * FILE_STREAMS, frames_per_stream=4, scheduler_stats=stats))
        require(all(key(s) == key(summaries[0]) and s.processed == n for s in summaries),
                f"file streams K=4: the streams differ: {[key(s) for s in summaries]}")
        rate(f"{FILE_STREAMS} streams K=4", n * FILE_STREAMS, wall,
             f"; the 8 equal (score {summaries[0].fake_score}, flagged "
             f"{summaries[0].flagged_count}); the solo analyze_video at K=4: score "
             f"{solo.fake_score}, flagged {solo.flagged_count}; scheduler {json.dumps(stats)}")
    log(f"file phase: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Serve path
# ---------------------------------------------------------------------------


def http_call(url: str, body: Optional[dict] = None, headers: Optional[dict] = None,
              timeout: float = 120.0) -> Tuple[int, dict, bytes]:
    """(status, headers, body) of a GET, or of a POST of ``body`` as JSON."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_server(tmp: str, name: str, *extra: str):
    """``python -m truely_tpu_torch serve`` in its own process on a free
    port, its output into ``tmp``; returns (process, base URL, log path)."""
    port = free_port()
    log_path = os.path.join(tmp, f"{name}.log")
    with open(log_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "truely_tpu_torch", "serve", "--host",
                                 "127.0.0.1", "--port", str(port), *extra], cwd=ROOT,
                                stdout=out, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", log_path


def wait_health(proc, url: str, log_path: str, done, timeout: float = 180.0) -> dict:
    """Poll ``/health`` until ``done(payload)``; fails if the server exits
    or the time runs out."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if proc.poll() is not None:
            break
        try:
            payload = json.loads(http_call(url + "/health", timeout=10)[2])
            if done(payload):
                return payload
        except OSError:
            pass
        time.sleep(0.1)
    with open(log_path) as f:
        tail = f.read()[-3000:]
    raise RuntimeError(f"serve: {url} not ready (exit {proc.poll()}): {tail}")


def stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def serve_weights(out_dir: str) -> str:
    """Write the serve phase's P-, R- and O-Net (SERVE_HEAD_SCALE) into
    ``out_dir`` as the ``.npz`` files that ``--weights`` reads; returns it."""
    from truely_tpu_torch.models import weights

    heads = {"pnet": ("conv4_1", None), "rnet": ("dense5_1", "dense5_2"),
             "onet": ("dense6_1", "dense6_2")}
    for name, (face, regression) in heads.items():
        net = weights.init_params(name)
        with torch.no_grad():
            head = getattr(net, face)
            head.weight.mul_(SERVE_HEAD_SCALE)
            head.bias.mul_(SERVE_HEAD_SCALE)
            head.bias[1] += SERVE_FACE_SHIFT
            if regression:
                getattr(net, regression).weight.mul_(PROP_REGRESSION_SCALE)
                getattr(net, regression).bias.mul_(PROP_REGRESSION_SCALE)
        weights.save_params(os.path.join(out_dir, f"{name}.npz"), net)
    return out_dir


def serve_phase() -> Dict[str, int]:
    """The serve path: the port's ``TruelyServer`` over a real socket, then
    ``python -m truely_tpu_torch serve`` in its own process, warmed and
    cold, all on the nets of ``serve_weights``; returns each kernel's
    launches summed over the in-process requests."""
    import filecmp

    from truely_tpu_torch.config import DetectorConfig
    from truely_tpu_torch.pipeline.detector import Detector
    from truely_tpu_torch.serve.app import TruelyServer
    from truely_tpu_torch.serve.http import make_server, serve_forever_in_thread

    t_phase = time.perf_counter()
    try:
        import httpx
        log(f"serve: httpx {httpx.__version__} imports")
    except ImportError:
        log("serve: httpx does not import (the fact-check agents are unavailable; every video "
            "endpoint works without them)")
    packed = stable_i420(FILE_FRAMES, STEP_H, STEP_W, seed=51)
    total: Dict[str, int] = {}

    with tempfile.TemporaryDirectory() as tmp:
        wdir = serve_weights(tmp)
        clips = [write_avi(os.path.join(tmp, f"src{n}.avi"), packed[:n], FILE_FPS)
                 for n in SERVE_LENGTHS]
        src = clips[0]
        names = itertools.count()

        def link(i: int) -> str:
            """A new name of clip ``i``: the server deletes the inputs it
            is handed (they lie in the temp dir)."""
            path = os.path.join(tmp, f"in{next(names)}.avi")
            os.link(clips[i], path)
            return path

        det = Detector(DetectorConfig(), weights_dir=wdir)  # the bf16 defaults
        _, warm_s = sync_ms(lambda: det.warmup(STEP_H, STEP_W))
        # Each clip's solo analysis: its score, its sampled frames and the
        # frames its output is drawn on.
        solo = [det.analyze_video(c) for c in clips]
        wants = [r.fake_score for r in solo]
        sampled = [r.total_processed for r in solo]
        drawn = [{r.frame_index: ((r.box, r.flagged),) for r in res.records if r.annotated}
                 for res in solo]
        require(all(w > 0 for w in wants) and all(drawn),
                f"serve: solo scores {wants}, drawn frames {[len(d) for d in drawn]}")
        want, n = wants[0], sampled[0]
        solo_out = os.path.join(tmp, "solo_out.avi")
        t0 = time.perf_counter()
        got = det.run(src, solo_out)
        run_wall = time.perf_counter() - t0
        require(got == want, f"serve: det.run gave {got}, analyze_video {want}")
        # The server runs each request on a thread of its own.
        here, new = [], []
        for _ in range(SERVE_THREAD_PAIRS):
            here.append(det.analyze_video(src).timings)
            box: list = []
            worker = threading.Thread(target=lambda: box.append(det.analyze_video(src).timings))
            worker.start()
            worker.join()
            new.append(box[0])
        log(f"serve: Detector.warmup({STEP_H}, {STEP_W}) in this process (after the earlier "
            f"phases) {warm_s / 1e3:.4f} s; solo scores of the {FILE_STREAMS} clips "
            f"({', '.join(map(str, SERVE_LENGTHS))} frames) {wants}; det.run with an output: "
            f"{n} sampled frames in {run_wall:.4f} s = {n / run_wall:.2f} sampled frames/s, "
            f"{len(drawn[0])} frames drawn")
        for label, runs in (("this thread", here), ("a new thread", new)):
            log(f"serve: score-only analyze_video on {label}, alternating: total s "
                f"{[round(t['total'], 4) for t in runs]}, device s "
                f"{[round(t['device'], 4) for t in runs]}")
        app = TruelyServer(detector=det)
        httpd = make_server(app.router, "127.0.0.1", 0)
        serve_forever_in_thread(httpd)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"

        def counted(label: str, fn):
            """``fn()`` with the launch counts set to 0 just before and read
            just after; K1-K4 must have launched and K5 not."""
            nonlocal total
            counters = reset_launches()
            t0 = time.perf_counter()
            out = fn()
            wall = time.perf_counter() - t0
            launches = read_launches(counters)
            require_launched(launches, f"serve {label}", k5=False)
            log(json.dumps({"path": f"{SERVE} {label}", "launches": launches}))
            total = add_launches(total, launches)
            return out, wall

        def analyze(i: int = 0, route: str = "/analyze-video") -> Tuple[dict, str]:
            """One request on clip ``i``; its fakeScore must equal the
            clip's solo score.  Returns (payload, the stored output path)."""
            path = link(i)
            status, _, raw = http_call(url + route, {"videoPath": path})
            payload = json.loads(raw)
            require(status == 200 and payload["fakeScore"] == wants[i],
                    f"serve {route} clip {i}: {status} {payload}, solo {wants[i]}")
            out = app.store.get(payload["resultId"])["output_path"]
            require(out != path and out.endswith("_output.avi"),
                    f"serve {route}: output {out} for input {path}")
            return payload, out

        def check(label: str, i: int, out: str) -> int:
            """Clip ``i``'s output: its frames, drawn where the solo run
            draws and byte-equal to the source elsewhere."""
            changed = check_output(label, out, packed[:SERVE_LENGTHS[i]], drawn[i], [])
            require(changed > 0, f"{label}: no frame drawn")
            return changed

        try:
            (payload, out), wall = counted("sync", analyze)
            changed = check("serve sync", 0, out)
            require(filecmp.cmp(out, solo_out, shallow=False),
                    "serve sync: the output differs from det.run's")
            log(f"serve sync /analyze-video: {n} sampled frames in {wall:.4f} s (POST to response) "
                f"= {n / wall:.2f} sampled frames/s; fakeScore {payload['fakeScore']} equal to "
                f"det.run's; output {os.path.basename(out)} byte-equal to det.run's, "
                f"{changed} frames drawn")
            rid = payload["resultId"]
            status, _, raw = http_call(f"{url}/view/{rid}")
            require(status == 200 and f"{want}" in raw.decode(), f"serve /view: {status}")
            status, headers, raw = http_call(f"{url}/video/{rid}", headers={"Range": "bytes=0-1023"})
            with open(out, "rb") as f:
                head = f.read(1024)
            require(status == 206 and raw == head and headers["Content-Type"] == "video/x-msvideo"
                    and headers["Content-Range"] == f"bytes 0-1023/{os.path.getsize(out)}",
                    f"serve /video Range: {status} {headers}")
            os.unlink(out)
            os.unlink(solo_out)
            (payload, out), _ = counted("combined", lambda: analyze(0, "/analyze-combined"))
            require(payload["newsSummary"] == "No audio content provided for analysis",
                    f"serve /analyze-combined: {payload}")
            os.unlink(out)

            # 8 jobs, one on each clip, queued behind a gate job run as one group.
            gate = threading.Event()
            app.jobs.submit("gate", lambda: gate.wait(300) and {})
            ids = []
            for i in range(FILE_STREAMS):
                status, _, raw = http_call(url + "/jobs/analyze-video", {"videoPath": link(i)})
                require(status == 202, f"serve job submit: {status} {raw[:200]}")
                ids.append(json.loads(raw)["jobId"])

            def group():
                gate.set()
                t_release = time.time()
                jobs = []
                for job_id in ids:
                    while True:
                        job = json.loads(http_call(f"{url}/jobs/{job_id}")[2])
                        if job["status"] in ("done", "failed"):
                            break
                        require(time.time() - t_release < 300, f"serve jobs: {job} after 300 s")
                        time.sleep(0.05)
                    jobs.append(job)
                return jobs, t_release

            (jobs, t_release), _ = counted(f"{FILE_STREAMS} jobs", group)
            require(all(j["status"] == "done" and j["fakeScore"] == w for j, w in zip(jobs, wants)),
                    f"serve jobs: {[(j['status'], j.get('fakeScore'), j.get('error')) for j in jobs]}"
                    f" against the solo scores {wants}")
            require(len({j["startedAt"] for j in jobs}) == 1,
                    f"serve jobs: {len({j['startedAt'] for j in jobs})} groups, not one")
            wall = max(j["finishedAt"] for j in jobs) - t_release
            changed = []
            for i, j in enumerate(jobs):
                out = app.store.get(j["resultId"])["output_path"]
                changed.append(check(f"serve job {i}", i, out))
                os.unlink(out)
            log(f"serve {FILE_STREAMS} grouped jobs: {sum(sampled)} sampled frames in "
                f"{wall:.4f} s (gate released to the last job done) = "
                f"{sum(sampled) / wall:.2f} sampled frames/s; one group, each fakeScore equal "
                f"to its clip's solo score; frames drawn in the outputs {changed}")

            def in_a_row():
                walls = []
                for i in range(FILE_STREAMS):
                    t0 = time.perf_counter()
                    out = analyze(i)[1]
                    walls.append(time.perf_counter() - t0)
                    os.unlink(out)
                return sorted(walls)

            walls, wall = counted(f"{FILE_STREAMS} sync in a row", in_a_row)
            log(f"serve {FILE_STREAMS} sync requests in a row, one on each clip: {sum(sampled)} "
                f"sampled frames in {wall:.4f} s = {sum(sampled) / wall:.2f} sampled frames/s; a "
                f"request {walls[0]:.4f}-{walls[-1]:.4f} s, median {walls[len(walls) // 2]:.4f} s")
            metrics = json.loads(http_call(url + "/metrics")[2])
            analyses = 2 + 2 * FILE_STREAMS
            require(metrics["analyses_total"] == analyses and metrics["analyses_failed"] == 0,
                    f"serve /metrics: {metrics}, {analyses} analyses made")
            log("serve /metrics: " + json.dumps({k: metrics[k] for k in (
                "analyses_total", "analysis_seconds_p50", "analysis_seconds_p95",
                "job_wait_seconds_p50", "job_run_seconds_p50")}))
        finally:
            httpd.shutdown()
            httpd.server_close()

        # The CLI's server in its own process, on the same nets: warmed, then cold.
        t0 = time.perf_counter()
        proc, base, log_path = cli_server(tmp, "warm", "--weights", wdir,
                                          "--warmup", f"{STEP_H}x{STEP_W}")
        try:
            wait_health(proc, base, log_path,
                        lambda p: p.get("warmup", {}).get("done") == [f"{STEP_H}x{STEP_W}"])
            warm_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            status, _, raw = http_call(base + "/analyze-video", {"videoPath": link(0)})
            warm_first = time.perf_counter() - t1
        finally:
            stop(proc)
        payload = json.loads(raw)
        require(status == 200 and payload["fakeScore"] == want,
                f"serve CLI warmed: {status} {payload}, in process {want}")
        t0 = time.perf_counter()
        proc, base, log_path = cli_server(tmp, "cold", "--weights", wdir)
        try:
            wait_health(proc, base, log_path, lambda p: p.get("status") == "ok")
            ready_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            status, _, raw = http_call(base + "/analyze-video", {"videoPath": link(0)})
            cold_first = time.perf_counter() - t1
        finally:
            stop(proc)
        payload = json.loads(raw)
        require(status == 200 and payload["fakeScore"] == want,
                f"serve CLI cold: {status} {payload}, in process {want}")
        log(f"serve CLI: --warmup {STEP_H}x{STEP_W} reported done in /health {warm_s:.2f} s "
            f"after the process started; its first /analyze-video {warm_first:.4f} s; without "
            f"--warmup /health answered after {ready_s:.2f} s and the first /analyze-video took "
            f"{cold_first:.4f} s (the cold cost, the kernels' libraries already built on disk); "
            f"fakeScore {payload['fakeScore']} equal to the in-process server's")
    log(f"serve phase: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# float32 cross-checks
# ---------------------------------------------------------------------------


def compare_runs(label: str, gpu, cpu) -> None:
    hf_g = [r.has_face for r in gpu.records]
    hf_c = [r.has_face for r in cpu.records]
    require(hf_g == hf_c, f"{label}: has_face differs: card {hf_g}, CPU {hf_c}")
    require(sum(hf_c) >= 2, f"{label}: cross-check needs face frames, got {sum(hf_c)}")
    box_err = float(np.abs(np.array([r.box for r in gpu.records])
                           - np.array([r.box for r in cpu.records])).max())
    sim_err = float(np.abs(np.array([r.similarity for r in gpu.records])
                           - np.array([r.similarity for r in cpu.records])).max())
    log(f"xcheck float32 {label} (thresholds {XCHECK_THRESHOLDS}, TF32 off): "
        f"{sum(hf_c)}/{len(hf_c)} frames with a face on both; max box err {box_err} px, "
        f"max sim err {sim_err:.3e}; scores {gpu.fake_score} / {cpu.fake_score}")
    require(box_err <= 1.0 and sim_err <= 2e-4, f"{label}: box err {box_err} px, sim err {sim_err}")


def compare_tracks(label: str, gpu, cpu) -> None:
    """(aggregate, per-track scores, TrackState) of a card run and a CPU
    run: scores and the discrete state equal, boxes within 1 px,
    embeddings within 2e-4."""
    require(gpu[0] == cpu[0] and np.array_equal(gpu[1], cpu[1]),
            f"{label}: scores differ: card {gpu[:2]}, CPU {cpu[:2]}")
    for name in ("active", "has_prev", "counter", "flagged_count", "processed", "misses",
                 "final_counter"):
        a, b = getattr(gpu[2], name).cpu(), getattr(cpu[2], name)
        require(torch.equal(a, b), f"{label}: {name} differs: card {a}, CPU {b}")
    require(int(cpu[2].processed.sum()) > 0, f"{label}: cross-check needs matched tracks")
    box_err = float((gpu[2].box.cpu() - cpu[2].box).abs().max())
    emb_err = float((gpu[2].embedding.cpu() - cpu[2].embedding).abs().max())
    log(f"xcheck float32 {label}: counter updates per track {cpu[2].processed.tolist()} on "
        f"both; max box err {box_err} px, max embedding err {emb_err:.3e}; per-track scores "
        f"{gpu[1].tolist()} / {cpu[1].tolist()}")
    require(box_err <= 1.0 and emb_err <= 2e-4, f"{label}: box err {box_err}, emb err {emb_err}")


def compare_events(label: str, gpu: list, cpu: list) -> None:
    keys = lambda e: (e.stream_id, e.frame_index, e.has_face, e.flagged, e.annotated, e.counter)
    require([keys(e) for e in gpu] == [keys(e) for e in cpu], f"{label}: event decisions differ")
    require(sum(e.has_face for e in cpu) >= 2, f"{label}: cross-check needs face frames")
    box_err = float(np.abs(np.array([e.box for e in gpu]) - np.array([e.box for e in cpu])).max())
    sim_err = float(np.abs(np.array([e.similarity for e in gpu])
                           - np.array([e.similarity for e in cpu])).max())
    log(f"xcheck float32 {label}: {len(cpu)} events, {sum(e.has_face for e in cpu)} with a face "
        f"on both; max box err {box_err} px, max sim err {sim_err:.3e}")
    require(box_err <= 1.0 and sim_err <= 2e-4, f"{label}: box err {box_err}, sim err {sim_err}")


# The "full fast (default)" row of PERFORMANCE.md's drift table (the bf16
# defaults against the float32 exact chain, 20 seeded weight sets x 240
# frames of the bundled clip): the bounds of a bf16 run against another
# bf16 run, on the CPU (tests/test_torch_analyze_video.py) and on the card.
DRIFT_BOUNDS = {"selection_flip_rate": 0.858, "has_face_mismatch_rate": 1134 / 4800,
                "dsim_mean": 0.0171, "dsim_p95": 0.038}


def drift(ref: list, got: list) -> dict:
    """How far ``got``'s frame records drift from ``ref``'s, in the columns
    of that table: has_face mismatches; selection flips, the frames where
    both found a face but the boxes overlap with IoU below 0.5, over the
    frames where both found one; |dsim| over the matched frames (both a
    face, IoU at least 0.5)."""
    hf_r = np.array([r.has_face for r in ref])
    hf_g = np.array([r.has_face for r in got])
    a = np.array([r.box for r in ref], np.float64).reshape(-1, 4)
    b = np.array([r.box for r in got], np.float64).reshape(-1, 4)
    iw = np.clip(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]), 0, None)
    ih = np.clip(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]), 0, None)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    inter = iw * ih
    iou = inter / np.maximum(area(a) + area(b) - inter, 1e-9)
    both = hf_r & hf_g
    flips, matched = both & (iou < 0.5), both & (iou >= 0.5)
    dsim = np.abs(np.array([r.similarity for r in ref]) - np.array([r.similarity for r in got]))
    dsim = dsim[matched]
    return dict(frames=len(ref), both_face=int(both.sum()),
                has_face_mismatches=int((hf_r != hf_g).sum()),
                has_face_mismatch_rate=float((hf_r != hf_g).mean()) if len(ref) else 0.0,
                selection_flips=int(flips.sum()),
                selection_flip_rate=float(flips.sum() / max(int(both.sum()), 1)),
                dsim_mean=float(dsim.mean()) if dsim.size else 0.0,
                dsim_p95=float(np.percentile(dsim, 95)) if dsim.size else 0.0)


def xcheck_phase() -> None:
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
    from truely_tpu_torch.pipeline.detector import Detector
    from truely_tpu_torch.pipeline.streaming import StreamScheduler

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    mt = MTCNNConfig(thresholds=XCHECK_THRESHOLDS)
    golden = DetectorConfig(frame_batch=16, compute_dtype="float32", mtcnn=mt)
    propagate = DetectorConfig(frame_batch=16, compute_dtype="float32", detect_interval=4,
                               mtcnn=MTCNNConfig(thresholds=XCHECK_THRESHOLDS, use_fused_crops=1))
    for label, cfg, packed, prep in (
            ("GOLDEN_CONFIG", golden, synthetic_i420(16, 360, 640, seed=12), lambda d: d),
            ("propagate K=4 use_fused_crops=1", propagate, stable_i420(16, 360, 640, seed=13),
             steady_regression)):
        gpu = prep(Detector(cfg)).analyze_i420(packed, fps=FPS)
        cpu = prep(Detector(cfg, device="cpu")).analyze_i420(packed, fps=FPS)
        compare_runs(label, gpu, cpu)

    multi = DetectorConfig(frame_batch=16, compute_dtype="float32", detect_interval=4,
                           multi_face=True, max_tracks=MAX_TRACKS,
                           mtcnn=MTCNNConfig(thresholds=XCHECK_THRESHOLDS, use_fused_crops=1))
    packed = stable_i420(16, 360, 640, seed=14)
    compare_tracks("multi-face K=4 use_fused_crops=1", *(
        steady_regression(Detector(multi, device=d)).analyze_i420_tracks(packed, fps=FPS)
        for d in ("cuda", "cpu")))
    stream = DetectorConfig(frame_batch=16, compute_dtype="float32", detect_interval=4,
                            mtcnn=MTCNNConfig(thresholds=XCHECK_THRESHOLDS))
    content = stream_content(2, 16, 360, 640, seed=15)
    compare_events("2-stream scheduler K=4", *(
        feed_streams(StreamScheduler(steady_regression(Detector(stream, device=d)), 2,
                                     frames_per_stream=4, fps=FPS, yuv=True), content)[0]
        for d in ("cuda", "cpu")))

    # bf16, card against CPU, through analyze_video on a small clip (every
    # frame a face, thresholds 0): the bounds of the bf16 drift gate.
    bf16 = DetectorConfig(frame_batch=16, mtcnn=MTCNNConfig(thresholds=PROP_THRESHOLDS))
    with tempfile.TemporaryDirectory() as tmp:
        clip = write_avi(os.path.join(tmp, "small.avi"), stable_i420(32, 360, 640, seed=16),
                         FILE_FPS)
        gpu, cpu = (steady_regression(Detector(bf16, device=d)).analyze_video(clip)
                    for d in ("cuda", "cpu"))
    d = drift(cpu.records, gpu.records)
    log(f"xcheck bf16 analyze_video card against CPU (16 sampled 640x360 frames): "
        f"{json.dumps(d)}; bounds {json.dumps(DRIFT_BOUNDS)}; scores {gpu.fake_score} / "
        f"{cpu.fake_score}")
    require(d["both_face"] >= 8 and all(d[k] <= v for k, v in DRIFT_BOUNDS.items()),
            f"bf16 card against CPU: {d} outside {DRIFT_BOUNDS}")


# ---------------------------------------------------------------------------
# Parallel path (phase 12)
# ---------------------------------------------------------------------------

# The score path's meshes: 2 and 4 positions of CUDA device 0 (16 and 8 rows
# a shard at frame_batch 32).  The propagate path's mesh: 16 positions, 2
# rows a shard, fewer than K=4 and than "auto"'s upper rungs.
PAR_POSITIONS = (2, 4)
PAR_PROP_POSITIONS, PAR_PROP_BATCHES = 16, 8
# Training at full width: batch 64 of 80x80 crops, float32 (TF32 off).  The
# DP (2, 1) and TP (1, 2) steps against the card's single-device step: the
# loss within TRAIN_LOSS_RTOL, each leaf's gradient within TRAIN_GRAD_TOL
# of the leaf's largest gradient plus 1e-3 relative (the tolerances of
# tests/test_torch_train.py).  The card's first step against the CPU step
# on the same params and batch: the loss within TRAIN_LOSS_RTOL, each
# leaf's gradient within TRAIN_CPU_GRAD_FRO of its norm (||card - CPU|| /
# ||CPU||).  At batch 64 a few leaves of the 1x1 Block8 stage differ by up
# to 11% of their largest gradient between the card and the CPU, while the
# card repeats its own step far closer (checked too): float32 rounding of
# two conv libraries, amplified where a ReLU gate sits near 0 and by the
# NT-Xent temperature of 0.1; the worst leaf norm differs by 2.1%.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 64, 10, 1e-4
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_CPU_GRAD_FRO = 1e-5, 1e-2, 5e-2
# pipeline_block17: 2 stages of 5 blocks, 8 microbatches of 8 rows of the
# 80x80 crop's Block17 activation (3 x 3 x 896).
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS = 2, 8, 8
# Every mesh position of phase 12 (a CPU rehearsal sets the CPU).
CARD = torch.device("cuda", 0)


def cuda_mesh(n: int, shape=None, names=("data", "model")):
    """A mesh of ``n`` positions of CARD."""
    from truely_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape or (n, 1), names, devices=[CARD] * n)


def records_differing(ref: list, got: list) -> int:
    return sum(a != b for a, b in zip(ref, got))


def mesh_score_runs(weights_dir: str) -> Dict[str, int]:
    """The score path at the bf16 defaults on nets that find faces
    (``serve_weights``), solo and on 2 and 4 positions, on the score
    phase's frames; each mesh run launches every kernel n times as often
    as the solo run (once per shard) and K5 never, and its records stay
    within DRIFT_BOUNDS of the solo run's.  Returns the 2-position run's
    launches."""
    from truely_tpu_torch.config import DetectorConfig
    from truely_tpu_torch.pipeline.detector import Detector

    cfg = DetectorConfig()
    b = cfg.frame_batch
    packed = synthetic_i420(b * (1 + E2E_BATCHES), STEP_H, STEP_W, seed=7)
    solo, solo_launches = drive(Detector(cfg, weights_dir=weights_dir), packed, b,
                                "parallel solo")
    require(sum(r.has_face for r in solo.records) >= len(solo.records) // 2,
            "parallel: the solo run found too few faces to compare")
    rates = {1: solo.total_processed / solo.timings["total"]}
    first = None
    for n in PAR_POSITIONS:
        det = Detector(cfg, weights_dir=weights_dir, mesh=cuda_mesh(n))
        res, launches = drive(det, packed, b, f"parallel mesh {n}x1")
        require(all(launches[k] == n * solo_launches[k] for k in launches),
                f"mesh {n}x1: launches {launches}, solo {solo_launches}: not once per shard")
        require_launched(launches, f"parallel mesh {n}x1", k5=False)
        d = drift(solo.records, res.records)
        log(f"parallel mesh {n}x1 against solo: {records_differing(solo.records, res.records)} "
            f"of {len(res.records)} records differ; drift {json.dumps(d)}; scores "
            f"{res.fake_score} / {solo.fake_score}")
        require(all(d[k] <= v for k, v in DRIFT_BOUNDS.items()),
                f"mesh {n}x1 against solo: {d} outside {DRIFT_BOUNDS}")
        rates[n] = res.total_processed / res.timings["total"]
        first = first or launches
    log("parallel score path, sampled frames/s (analyze_i420's own total) by mesh positions: "
        + json.dumps({str(k): round(v, 2) for k, v in rates.items()}))
    return first


def mesh_propagate_runs() -> Dict[str, int]:
    """K=4 and "auto" on PAR_PROP_POSITIONS positions (2 rows a shard)
    under the propagate phase's conditions: K1, K2, K4, K5 launch and no
    K3 kernel, the ladder climbs, and the records stay within
    DRIFT_BOUNDS of the solo run's.  Returns the K=4 run's launches."""
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
    from truely_tpu_torch.pipeline.detector import Detector

    mt = MTCNNConfig(stage_crop_quant=1, use_fused_crops=1, thresholds=PROP_THRESHOLDS)
    b = DetectorConfig().frame_batch
    packed = stable_i420(b * (4 + PAR_PROP_BATCHES), STEP_H, STEP_W, seed=21)
    fixed = None
    for interval in (4, "auto"):
        cfg = DetectorConfig(detect_interval=interval, mtcnn=mt)
        solo, _ = drive(steady_regression(Detector(cfg)), packed, 4 * b,
                        f"parallel solo K={interval}")
        det = steady_regression(Detector(cfg, mesh=cuda_mesh(PAR_PROP_POSITIONS)))
        res, launches = drive(det, packed, 4 * b,
                              f"parallel mesh {PAR_PROP_POSITIONS}x1 K={interval}")
        require_launched(launches, f"parallel mesh K={interval}", k5=True)
        d = drift(solo.records, res.records)
        log(f"parallel mesh K={interval} against solo: "
            f"{records_differing(solo.records, res.records)} of {len(res.records)} records "
            f"differ; drift {json.dumps(d)}")
        require(all(d[k] <= v for k, v in DRIFT_BOUNDS.items()),
                f"mesh K={interval} against solo: {d} outside {DRIFT_BOUNDS}")
        if interval == "auto":
            log(f"parallel mesh auto telemetry: rung {det.auto_interval_current}, keyframe "
                f"segments {det.auto_keyframe_segments}, refine segments "
                f"{det.auto_refine_segments}")
            require(det.auto_refine_segments > 0 and det.auto_interval_current > 1,
                    "the auto ladder did not climb on the mesh")
        else:
            fixed = launches
    return fixed


def mesh_stream_run() -> Dict[str, int]:
    """``StreamScheduler`` with 8 streams x 4 frames on a (2, 1) mesh at the
    defaults: K1-K4, not K5, one event per pushed sampled frame
    (``drive_stream``), each stream's processed count that of the solo
    scheduler; both schedulers' scores are printed."""
    from truely_tpu_torch.config import DetectorConfig
    from truely_tpu_torch.pipeline.detector import Detector

    content = stream_content(STREAMS, STREAM_LEN // 2, STEP_H, STEP_W, seed=41)
    solo, _, _ = drive_stream(Detector(DetectorConfig()), content, "parallel solo")
    sched, launches, _ = drive_stream(Detector(DetectorConfig(), mesh=cuda_mesh(2)), content,
                                      "parallel mesh 2x1")
    require_launched(launches, "stream parallel mesh 2x1", k5=False)
    require(sched._mesh == cuda_mesh(2), "the scheduler did not take the detector's mesh")
    pairs = [(sched.stats[i].processed, solo.stats[i].processed) for i in range(STREAMS)]
    require(all(a == b for a, b in pairs), f"stream mesh: processed {pairs}")
    scores = [(sched.score(i), solo.score(i)) for i in range(STREAMS)]
    log(f"stream parallel mesh 2x1 against solo: scores (mesh, solo) {scores}")
    return launches


def train_tree(seed: int):
    """The training tree of the port's seeded FaceNet and landmark head,
    with batchnorm scales and shifts drawn from ``seed`` (so that every
    leaf's gradient is not trivial)."""
    from truely_tpu_torch.models.weights import init_params, params_to_numpy

    rng = np.random.default_rng(seed)

    def perturb(node):
        if isinstance(node, list):
            return [perturb(v) for v in node]
        out = {}
        for k, v in node.items():
            if isinstance(v, (dict, list)):
                out[k] = perturb(v)
            elif k in ("gamma", "var"):
                out[k] = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
            elif k in ("beta", "mean"):
                out[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return {"facenet": perturb(params_to_numpy(init_params("facenet"))),
            "landmark": perturb(params_to_numpy(init_params("landmark68")))}


def tree_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def compare_steps(label: str, got, want, fro_tol: Optional[float] = None) -> None:
    """(metrics, gradient tree) of two first steps: the loss within
    TRAIN_LOSS_RTOL, and every leaf's gradient within TRAIN_GRAD_TOL of the
    leaf's largest plus 1e-3 relative, or with ``fro_tol`` within that
    share of the leaf's norm."""
    (gm, gg), (wm, wg) = got, want
    loss_err = abs(gm["loss"] - wm["loss"]) / abs(wm["loss"])
    worst, worst_fro = (0.0, ""), (0.0, "")
    bad = []
    for (path, a), (_, b) in zip(tree_leaves(gg), tree_leaves(wg)):
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max()) / max(scale, 1e-30)
        fro = float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-30)
        worst, worst_fro = max(worst, (err, path)), max(worst_fro, (fro, path))
        ok = (fro <= fro_tol if fro_tol is not None
              else np.allclose(a, b, rtol=1e-3, atol=TRAIN_GRAD_TOL * scale + 1e-12))
        if not ok:
            bad.append(path)
    log(f"train {label}: loss {gm['loss']:.6f} / {wm['loss']:.6f} (rel err {loss_err:.2e}); "
        f"largest gradient error {worst[0]:.2e} of its leaf's largest gradient, at "
        f"{worst[1]}; largest error of a leaf's norm {worst_fro[0]:.2e}, at {worst_fro[1]}; "
        f"{len(bad)} leaves outside the tolerance "
        f"({'norm ' + str(fro_tol) if fro_tol is not None else 'largest ' + str(TRAIN_GRAD_TOL)})")
    require(loss_err <= TRAIN_LOSS_RTOL and not bad,
            f"train {label}: loss rel err {loss_err}, leaves outside: {bad[:5]}")


def train_runs() -> dict:
    """Full-width training on the card: TRAIN_STEPS steps (the loss falls;
    steps/s), the first step against the CPU's, the DP and TP steps against
    the single-device one, and a checkpoint round trip."""
    from truely_tpu_torch.parallel import checkpoint
    from truely_tpu_torch.parallel.sharding import tp_shard_facenet
    from truely_tpu_torch.parallel.train import (
        make_train_step, numpy_batch, train_params_from_numpy, train_params_to_numpy,
    )

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    tree = train_tree(31)
    batch = numpy_batch(np.random.default_rng(32), TRAIN_BATCH)

    def first_step(init_fn, step_fn, params):
        state, m = step_fn(init_fn(params), batch)
        return state, ({k: float(v) for k, v in m.items()},
                       train_params_to_numpy(state.params, grads=True))

    init_fn, step_fn = make_train_step(learning_rate=TRAIN_LR)
    state, card = first_step(init_fn, step_fn, train_params_from_numpy(tree))
    losses = [card[0]["loss"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS - 1):
        state, m = step_fn(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    rate = (TRAIN_STEPS - 1) / (time.perf_counter() - t0)
    losses = [float(v) for v in losses]
    compare_steps("card against itself", first_step(init_fn, step_fn,
                                                   train_params_from_numpy(tree))[1], card)
    log(f"train: Inception-ResNet-v1 + landmark head, float32, batch {TRAIN_BATCH} of 80x80, "
        f"{TRAIN_STEPS} steps: {rate:.2f} steps/s (steps 2-{TRAIN_STEPS}); losses "
        f"{[round(v, 5) for v in losses]}")
    require(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")

    t0 = time.perf_counter()
    cpu_init, cpu_step = make_train_step(learning_rate=TRAIN_LR, device="cpu")
    _, cpu = first_step(cpu_init, cpu_step, train_params_from_numpy(tree))
    log(f"train: the CPU's first step took {time.perf_counter() - t0:.1f} s")
    compare_steps("card against CPU", card, cpu, fro_tol=TRAIN_CPU_GRAD_FRO)
    dp_init, dp_step = make_train_step(cuda_mesh(2), learning_rate=TRAIN_LR)
    compare_steps("DP (2, 1) against one device",
                  first_step(dp_init, dp_step, train_params_from_numpy(tree))[1], card)
    tp_mesh = cuda_mesh(2, (1, 2))
    tp_init, tp_step = make_train_step(tp_mesh, learning_rate=TRAIN_LR)
    compare_steps("TP (1, 2) against one device",
                  first_step(tp_init, tp_step,
                             tp_shard_facenet(tp_mesh, train_params_from_numpy(tree)))[1], card)

    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_train_state(tmp, state)
        require(checkpoint.latest_step(tmp) == TRAIN_STEPS, "checkpoint: latest step")
        back = checkpoint.restore_train_state(tmp, init_fn(train_params_from_numpy(tree)))
    same = all(torch.equal(p, q) for a, b in zip(state.params.values(), back.params.values())
               for p, q in zip(a.parameters(), b.parameters()))
    same_moments = all(
        torch.equal(state.opt_state.state[p][k], back.opt_state.state[q][k])
        for a, b in zip(state.params.values(), back.params.values())
        for p, q in zip(a.parameters(), b.parameters()) for k in ("exp_avg", "exp_avg_sq"))
    log(f"train: checkpoint round trip of step {back.step}: values equal {same}, Adam moments "
        f"equal {same_moments}")
    require(same and same_moments and back.step == TRAIN_STEPS, "checkpoint round trip")
    return {"steps_per_s": rate, "losses": losses}


def toolkit_runs() -> None:
    """pipeline_block17 (2 stages, 8 microbatches) ``torch.equal`` per
    microbatch to the sequential chain; sharded_temporal equal to the
    unsharded fold; the dry run of every sharded program."""
    from truely_tpu_torch.models.weights import init_params
    from truely_tpu_torch.ops.temporal import temporal_consistency
    from truely_tpu_torch.parallel.dryrun import dryrun_multichip
    from truely_tpu_torch.parallel.pipeline import pipeline_block17
    from truely_tpu_torch.parallel.sharding import sharded_temporal
    from truely_tpu_torch.pipeline.detector import full_float32

    dev = CARD
    blocks = list(init_params("facenet").to(dev).repeat_2)
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.normal(size=(PIPE_MICRO * PIPE_ROWS, 3, 3, 896)).astype(
        np.float32)).to(dev)
    stages, fn = pipeline_block17(cuda_mesh(PIPE_STAGES, (PIPE_STAGES,), ("stage",)), blocks,
                                  n_microbatches=PIPE_MICRO)
    with torch.inference_mode(), full_float32():
        out = fn(stages, x)
        ref = []
        for piece in x.chunk(PIPE_MICRO):
            for blk in blocks:
                piece = blk(piece.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            ref.append(piece)
        equal = [torch.equal(a, b) for a, b in zip(out.chunk(PIPE_MICRO), ref)]
    log(f"pipeline_block17: {len(blocks)} blocks over {PIPE_STAGES} stages, {PIPE_MICRO} "
        f"microbatches of {tuple(ref[0].shape)}: equal per microbatch {equal}")
    require(all(equal), "pipeline_block17 differs from the sequential chain")

    emb = torch.from_numpy(rng.normal(size=(512, 512)).astype(np.float32)).to(dev)
    # near neighbours (similarity about 0.9996) and far ones (about 0.96):
    # runs below the 0.99 threshold form, flag and reset
    scale = torch.from_numpy(rng.choice([0.02, 0.2], size=(512, 1)).astype(np.float32))
    emb = emb[:1] + scale.to(dev) * emb
    has_face = torch.from_numpy(rng.random(512) > 0.1).to(dev)
    got = sharded_temporal(cuda_mesh(4))(emb, has_face, 500)
    with torch.inference_mode():
        want = temporal_consistency(emb, has_face, 500)
    same = all(torch.equal(a, b) for a, b in zip(got[:7], want[:7])) and all(
        torch.equal(a, b) for a, b in zip(got.state, want.state))
    log(f"sharded_temporal over 4 positions, 512 frames: equal to the unsharded fold {same}; "
        f"final counter {int(got.final_counter)}, flagged {int(got.flagged_count)}")
    require(same, "sharded_temporal differs from the unsharded fold")
    dryrun_multichip([dev, dev])


def parallel_phase() -> Dict[str, int]:
    """Phase 12: the score, propagate and stream paths on meshes of CUDA
    device 0, training at full width, and the rest of the toolkit.
    Returns each kernel's launches summed over the mesh runs of the score
    (2 positions), propagate (K=4) and stream paths."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        total = mesh_score_runs(serve_weights(tmp))
    total = add_launches(total, mesh_propagate_runs())
    total = add_launches(total, mesh_stream_run())
    train_runs()
    toolkit_runs()
    log(f"parallel phase: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Native host layer (phase 13)
# ---------------------------------------------------------------------------

# The bundled mp4v clip (MPEG-4 Part 2; 640x360, 30 fps, 960 frames, yuv420p, untagged
# colour): the mp4 the native decoder reads on the card.
NATIVE_CLIP = os.path.join(ROOT, "tests", "fixtures", "veo3_360p.mp4")
# framepack at 1080p: one device batch of BGR frames packed, the rest on one
# frame; each function timed over this many calls after one warm-up call.
NATIVE_PACK_B, NATIVE_REPS = 32, 5
# The exact bf16 pyramid (pyramid_cascade=False) card against CPU: frames.
PYRAMID_B = 2


def median_ms(fn: Callable[[], object], reps: int = NATIVE_REPS) -> float:
    """Median host milliseconds of ``fn`` over ``reps`` calls, after one."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def libav_status() -> dict:
    """The host build: the compiler, each library's state, the linked
    libavcodec's version and whether it has libx264; cv2 and whether it
    reads the bundled mp4."""
    from truely_tpu_torch.media import decode, host_build, videodec, videoenc

    host_build.load("framepack")
    cxx = host_build.compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[0]
    out = {"compiler": f"{cxx}: {version}", "flags": " ".join(host_build.CXX_FLAGS),
           "libav_headers": {name: host_build.missing_headers(name) or "found"
                             for name in ("videodec", "videoenc")},
           "videodec": videodec.available(), "videoenc": videoenc.available(),
           "avcodec": videodec.avcodec_version(), "libx264": videoenc.has_x264()}
    out["status"] = host_build.status()
    cv2 = decode.cv2
    reads = False
    if cv2 is not None:
        cap = cv2.VideoCapture(NATIVE_CLIP)
        reads = bool(cap.isOpened() and cap.read()[0])
        cap.release()
    out["cv2"] = None if cv2 is None else cv2.__version__
    out["cv2_reads_mp4"] = reads
    return out


def framepack_runs() -> None:
    """Each framepack function at 1080p byte-equal to its numpy version, and
    the milliseconds of both (host time: these run on the host)."""
    from truely_tpu_torch.media import native

    rng = np.random.default_rng(61)
    frames = [rng.integers(0, 256, (STEP_H, STEP_W, 3), np.uint8) for _ in range(4)]
    srcs = [frames[i % 4] for i in range(NATIVE_PACK_B)]
    offsets = list(range(NATIVE_PACK_B))[::-1]
    packed = synthetic_i420(1, STEP_H, STEP_W, seed=62)[0]
    # Each side's output: the packed batch, a converted frame, a frame drawn
    # on (a box inside the frame and one partly outside), a swapped frame.
    out = {side: {"pack": np.zeros((NATIVE_PACK_B, STEP_H, STEP_W, 3), np.uint8),
                  "draw": frames[0].copy(), "swap": frames[1].copy()}
           for side in ("native", "plain")}

    def draw(side, fn):
        fn(out[side]["draw"], 311, 207, 1402, 969, (0, 0, 255))
        fn(out[side]["draw"], -40, 500, 2000, 1100, (1, 2, 3), thickness=3)

    def convert(side, fn, rgb):
        out[side][f"bgr{rgb}"] = fn(packed, rgb=rgb)

    cases = [
        ("pack_frames (32 frames)", "pack",
         lambda: native.pack_frames(out["native"]["pack"], srcs, offsets),
         lambda: native.pack_frames_plain(out["plain"]["pack"], srcs, offsets)),
        ("i420_to_bgr_host", "bgrFalse",
         lambda: convert("native", native.i420_to_bgr_host, False),
         lambda: convert("plain", native.i420_to_bgr_host_plain, False)),
        ("i420_to_bgr_host rgb", "bgrTrue",
         lambda: convert("native", native.i420_to_bgr_host, True),
         lambda: convert("plain", native.i420_to_bgr_host_plain, True)),
        ("draw_rect (2 boxes)", "draw", lambda: draw("native", native.draw_rect),
         lambda: draw("plain", native.draw_rect_plain)),
        ("bgr_to_rgb", "swap", lambda: native.bgr_to_rgb(out["native"]["swap"]),
         lambda: native.bgr_to_rgb_plain(out["plain"]["swap"])),
    ]
    for name, key, run, plain in cases:
        run()
        plain()
        require(np.array_equal(out["native"][key], out["plain"][key]),
                f"framepack {name}: not equal to its numpy version")
        log(f"native framepack {name} at {STEP_W}x{STEP_H}: {median_ms(run):.4f} ms, numpy "
            f"{median_ms(plain):.4f} ms (median of {NATIVE_REPS}, equal; {card_line()})")
    require(np.array_equal(out["native"]["pack"][NATIVE_PACK_B - 1], frames[0]),
            "framepack pack_frames: row 31 is not frame 0")


def pyramid_check() -> None:
    """The bf16 pyramid without the cascade (``--exact-pyramid``) on a
    1080p batch: the levels P-Net sees on the card ``torch.equal`` to the
    CPU's ``resize_area_u8``."""
    from truely_tpu_torch.config import MTCNNConfig
    from truely_tpu_torch.media import native
    from truely_tpu_torch.models.weights import init_params
    from truely_tpu_torch.ops.resize import resize_area_u8
    from truely_tpu_torch.pipeline import mtcnn
    from truely_tpu_torch.pipeline.pyramid import pyramid_schedule

    packed = synthetic_i420(PYRAMID_B, STEP_H, STEP_W, seed=63)
    frames = torch.from_numpy(np.stack([native.i420_to_bgr_host(p) for p in packed]))
    nets = mtcnn.MTCNNNets(*(init_params(n).to(CARD) for n in ("pnet", "rnet", "onet")))
    seen = []
    trunk = nets.pnet.trunk
    nets.pnet.trunk = lambda x, dtype: seen.append(x) or trunk(x, dtype)
    with torch.inference_mode():
        mtcnn._stage1(nets, frames.to(CARD), MTCNNConfig(pyramid_cascade=False), torch.bfloat16)
    levels = pyramid_schedule(STEP_H, STEP_W)
    require(len(seen) == len(levels), f"pyramid: {len(seen)} levels, want {len(levels)}")
    differing = 0
    for x, lvl in zip(seen, levels):
        want = (resize_area_u8(frames, (lvl.height, lvl.width)).float() - 127.5) * 0.0078125
        differing += int((x.cpu() != want).sum())
    log(f"native pyramid: bf16 pyramid_cascade=False, {len(levels)} levels of {PYRAMID_B} "
        f"frames at {STEP_W}x{STEP_H}: {differing} values differ between the card and the CPU")
    require(differing == 0, "pyramid: the card's exact bf16 levels differ from the CPU's")


def native_phase() -> Dict[str, int]:
    """Phase 13: the native host layer on the card's machine.  Returns the
    kernels' launches of the timed mp4 run (through videodec where it is
    built, else through cv2)."""
    from truely_tpu_torch.config import DetectorConfig
    from truely_tpu_torch.media import videodec
    from truely_tpu_torch.media.decode import VideoReader
    from truely_tpu_torch.pipeline.detector import Detector

    t_phase = time.perf_counter()
    status = libav_status()
    log("native host build: " + json.dumps(status))
    framepack_runs()
    pyramid_check()

    # Nets that find faces at the default thresholds (``serve_weights``), so
    # that the records carry boxes and the output has frames drawn on.
    with tempfile.TemporaryDirectory() as wdir:
        det = Detector(DetectorConfig(), weights_dir=serve_weights(wdir))
        with VideoReader(NATIVE_CLIP, yuv=True) as reader:
            decoder, meta = reader.decoder, reader.meta
        log(f"native mp4: {NATIVE_CLIP} {meta.width}x{meta.height} fps {meta.fps_exact} "
            f"{meta.frame_count} frames: VideoReader(yuv=True).decoder {decoder}")
        require(decoder == ("videodec" if status["videodec"] else "cv2"),
                f"native mp4: decoder {decoder} with videodec {status['videodec']}")
        require(decoder == "videodec" or status["cv2_reads_mp4"],
                "native mp4: neither the native decoder nor cv2 reads the mp4")
        det.analyze_video(NATIVE_CLIP)  # warm-up

        def run(label, detector, *args):
            counters = reset_launches()
            t0 = time.perf_counter()
            res = detector.analyze_video(NATIVE_CLIP, *args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches(counters)
            log(f"native mp4 {label}: decoder {decoder if detector is det else 'cv2'}, yuv_ingest "
                f"{res.yuv_ingest}, {res.frame_count} frames, {res.total_processed} sampled in "
                f"{wall:.4f} s = {res.total_processed / wall:.2f} sampled frames/s; score "
                f"{res.fake_score}; timings "
                + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
                + f"; launches {json.dumps(launches)}")
            return res, launches

        got, launches = run("bf16 defaults", det)
        require(got.yuv_ingest == (decoder == "videodec") and got.frame_count == meta.frame_count,
                f"native mp4: yuv_ingest {got.yuv_ingest}, {got.frame_count} frames")
        require_launched({k: v for k, v in launches.items()
                          if k != "i420_to_bgr" or decoder == "videodec"}, "native mp4", k5=False)
        if decoder == "videodec":
            if status["cv2_reads_mp4"]:
                bgr = Detector(DetectorConfig(yuv_ingest=False), weights_dir=wdir)
                want, bgr_launches = run("yuv_ingest=False (cv2)", bgr)
                require(bgr_launches["i420_to_bgr"] == 0, "native mp4: K1 launched on the BGR path")
                compare_exact("native mp4 videodec against cv2", got, want)
            else:
                with VideoReader(NATIVE_CLIP, yuv=True) as reader:
                    pictures = np.stack([p for _, p in reader.yuv_frames()])
                compare_exact("native mp4 videodec against analyze_i420", got,
                              det.analyze_i420(pictures, fps=meta.fps))
            log(f"native mp4: {len(got.records)} records equal across the two decoders")
        if status["videoenc"]:
            with tempfile.TemporaryDirectory() as tmp:
                out = os.path.join(tmp, "out.mp4")
                res, _ = run("with -o out.mp4", det, out)
                compare_exact("native mp4 with output", res, got)
                hnd, w, h, fn, fd, _nb = videodec.open(out)
                codec, n = videodec.codec(hnd), 0
                while videodec.skip(hnd):
                    n += 1
                videodec.close(hnd)
                log(f"native mp4 output: {codec} {w}x{h} at {fn}/{fd}, {n} frames "
                    f"({os.path.getsize(out) / 1e6:.2f} MB)")
                require(n == meta.frame_count and (w, h) == (meta.width, meta.height),
                        f"native mp4 output: {n} frames of {w}x{h}")
                require(codec == "h264" or not status["libx264"],
                        f"native mp4 output: codec {codec} with libx264 present")
        else:
            log("native mp4 output: videoenc not built ("
                + status["status"]["videoenc"] + "): an mp4 output takes cv2's fourcc chain")
    log(f"native phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also trace one score-path batch and one K=4 propagate cycle into DIR")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase and the launch floor (no result line); "
                         "for timing another tree's kernels beside this one's")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K2 and K5 at every launch shape they take, after the rest")
    args = ap.parse_args(argv)
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from truely_tpu_torch.ops import cuda_build

    log(card_line())
    name = torch.cuda.get_device_name(0)
    from truely_tpu_torch.media import overlay

    log("cv2: " + ("not installed: only uncompressed I420 AVI is read and written"
                   if overlay.cv2 is None else f"{overlay.cv2.__version__} (boxes carry text)"))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    cuda_build.build()
    log(f"build: {len(cuda_build.SOURCES)} kernel sources (nvcc {' '.join(cuda_build.NVCC_FLAGS[:4])}) "
        f"in {time.perf_counter() - t0:.1f} s")
    for src, report in sorted(cuda_build.build_log.items()):
        regs = [ln.strip().replace("ptxas info    : ", "") for ln in report.splitlines()
                if "registers" in ln or "entry function" in ln]
        log(f"build {src}: {'; '.join(regs)}")

    forms = kernel_forms("cuda")
    rows = kernel_phase(forms)
    launch_floor("cuda")
    if not args.kernels_only:
        launches = {SCORE: e2e_phase(args.profile), PROPAGATE: propagate_phase(args.profile),
                    MULTIFACE: multiface_phase(), CLASSIFIER: classifier_phase(),
                    STREAM: stream_phase(), FILE: file_phase(),
                    SERVE: serve_phase()}
        xcheck_phase()
        launches[PARALLEL] = parallel_phase()
        launches[NATIVE] = native_phase()
    device_phase(forms, rows)
    if not args.kernels_only:
        fold_profile("cuda")
    summary = kernel_summary(rows)
    if args.sweep:
        sweep(forms)
    if args.kernels_only:
        return 0

    kernels = []
    for kname, (source, replaces) in SOURCES.items():
        s, path = summary[kname], MAIN_PATH[kname]
        main_path = s["paths"][path]
        entry = dict(
            name=kname, route="cuda", source=source, replaces=replaces, path=path,
            launches=launches[path][kname], max_abs_err=s["max_abs_err"], ms=main_path["ms"],
            device_ms=main_path["device_ms"], plain_ms=main_path["plain_ms"],
            bound_ms=main_path["bound_ms"], bound_by=main_path["bound_by"],
            library_ms=main_path["library_ms"],
            library_device_ms=main_path["library_device_ms"],
            launches_by_path={p: launches[p][kname] for p in launches},
            per_path=s["paths"], forms=s["forms"])
        if kname == "crop_resize_area":
            entry["prep_launches"] = launches[path][K3_PREP]
            entry["prep_launches_by_path"] = {p: launches[p][K3_PREP] for p in launches}
        kernels.append(entry)
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s of wall time, the build included")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
