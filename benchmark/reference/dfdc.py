"""The plain reference of the DFDC winner's classifier stage
(github.com/selimsef/dfdc_deepfake_challenge) on the multi-face analysis:
the batch loop of ``analysis.analyze_tracks``, and on every batch's first
``n_valid`` rows the crops of the boxes and ``valid`` mask that go to the
track fold, each member's logit, and the video's score.

- ``crop_u8``: the solution's crop of one face (``FaceExtractor``'s
  integer box grown by ``w // 3`` and ``h // 3`` and sliced, then
  ``isotropically_resize_image`` and ``put_to_center`` of
  ``kernel_utils.py``), with the resize in exact integer arithmetic: area
  as the exact mean of the covered source area rounded half up, cubic as
  cv2's fixed-point scheme (float32 ``interpolateCubic`` coefficients
  rounded to shorts of scale 2048, edge taps clamped, ``(v + 2^21) >>
  22``).  cv2's own rounding differs from it by at most 1 on the 0-255
  scale.  A short side that would truncate to 0 is taken as 1.
- ``normalise``: RGB, ``(x / 255 - mean) / std`` in float32.
- ``confident_strategy``: the solution's, transcribed.

Inside ``fp8_matmuls()`` the control puts float8 in the classifier's
nets only: the detector runs as in the sound reference, so that the boxes
agree and the classifier's numbers have crops to compare (a float8
detector moves the boxes; cell 2's limits were set on its readings).
"""

from __future__ import annotations

import itertools
import math
from typing import List, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from . import layers
from .analysis import TrackResult, _batches, _precision
from .config import DetectorConfig
from .efficientnet import DeepFakeClassifier
from .params import _load
from .steps import steps_for, to_frames
from .tracks import init_track_state, stream_state, track_scores, track_timeline

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class Classified(NamedTuple):
    """The classifier's answer for one clip of N sampled frames, T slots."""

    score: float
    logits: np.ndarray   # (M, N, T) float32, 0 where the mask is unset
    mask: np.ndarray     # (N, T) bool
    boxes: np.ndarray    # (N, T, 4) float32


def net_from_tree(tree) -> DeepFakeClassifier:
    module = DeepFakeClassifier()
    n = _load(module, tree, "classifier")
    if n != len(module.state_dict()):
        raise ValueError(f"classifier: tree sets {n} tensors, module has "
                         f"{len(module.state_dict())}")
    return module.eval()


def _area(src: int, dst: int) -> np.ndarray:
    """(dst, src) overlaps of output cells [j*src, (j+1)*src) with input
    pixels [i*dst, (i+1)*dst)."""
    w = np.zeros((dst, src), np.int64)
    for j in range(dst):
        for i in range(j * src // dst, -(-(j + 1) * src // dst)):
            w[j, i] = min((i + 1) * dst, (j + 1) * src) - max(i * dst, j * src)
    return w


def _cubic(src: int, dst: int) -> np.ndarray:
    """(dst, src) fixed-point weights of cv2's INTER_CUBIC along one axis."""
    f = np.float32
    a = f(-0.75)
    scale = 1.0 / (dst / src)
    w = np.zeros((dst, src), np.int64)
    for j in range(dst):
        x = f((j + 0.5) * scale - 0.5)
        sx = math.floor(x)
        x = f(x - f(sx))
        c0 = ((a * (x + f(1)) - f(5) * a) * (x + f(1)) + f(8) * a) * (x + f(1)) - f(4) * a
        c1 = ((a + f(2)) * x - (a + f(3))) * x * x + f(1)
        c2 = ((a + f(2)) * (f(1) - x) - (a + f(3))) * (f(1) - x) * (f(1) - x) + f(1)
        c3 = f(1) - c0 - c1 - c2
        for k, c in enumerate((c0, c1, c2, c3)):
            w[j, min(max(sx - 1 + k, 0), src - 1)] += int(np.rint(c * f(2048)))
    return w


def isotropic_resize(img: np.ndarray, size: int, device="cpu") -> np.ndarray:
    """``isotropically_resize_image(img, size)`` (INTER_AREA down,
    INTER_CUBIC up), in integer arithmetic (its sums on ``device``)."""
    h, w = img.shape[:2]
    if max(w, h) == size:
        return img
    if w > h:
        scale = size / w
        h, w = h * scale, size
    else:
        scale = size / h
        h, w = size, w * scale
    nh, nw = max(int(h), 1), max(int(w), 1)
    if scale > 1:
        num = _sums(_cubic(img.shape[0], nh), _cubic(img.shape[1], nw), img, device)
        out = (num + (1 << 21)) >> 22
    else:
        num = _sums(_area(img.shape[0], nh), _area(img.shape[1], nw), img, device)
        den = img.shape[0] * img.shape[1]
        out = (2 * num + den) // (2 * den)
    return np.clip(out, 0, 255).astype(np.uint8)


def _sums(wy: np.ndarray, wx: np.ndarray, img: np.ndarray, device) -> np.ndarray:
    """(nh, nw, 3) int64 sums of wy[y, s] * wx[x, t] * img[s, t, c]: float64
    matrix products on ``device``, exact in any order (every partial sum is
    an integer below 2**53), rounded back to integers."""
    f64 = dict(device=device, dtype=torch.float64)
    src = torch.from_numpy(img).to(**f64)
    rows = torch.tensordot(torch.from_numpy(wy).to(**f64), src, dims=([1], [0]))
    both = torch.tensordot(rows, torch.from_numpy(wx).to(**f64), dims=([1], [1]))  # (nh, 3, nw)
    return torch.round(both).permute(0, 2, 1).cpu().numpy().astype(np.int64)


def put_to_center(img: np.ndarray, size: int) -> np.ndarray:
    img = img[:size, :size]
    image = np.zeros((size, size, 3), dtype=np.uint8)
    start_w = (size - img.shape[1]) // 2
    start_h = (size - img.shape[0]) // 2
    image[start_h:start_h + img.shape[0], start_w:start_w + img.shape[1], :] = img
    return image


def crop_u8(frame: np.ndarray, box, size: int, margin: int, device="cpu"):
    """The (size, size, 3) uint8 canvas of one face of an (H, W, 3) frame,
    in the frame's channel order; None where the grown slice is empty."""
    xmin, ymin, xmax, ymax = (int(b) for b in box)
    w, h = xmax - xmin, ymax - ymin
    p_h, p_w = h // margin, w // margin
    crop = frame[max(ymin - p_h, 0):ymax + p_h, max(xmin - p_w, 0):xmax + p_w]
    if crop.shape[0] == 0 or crop.shape[1] == 0:
        return None
    return put_to_center(isotropic_resize(crop, size, device), size)


def normalise(canvas: np.ndarray, rgb_in: bool) -> torch.Tensor:
    """(N, S, S, 3) uint8 canvases -> float32 RGB, (x / 255 - mean) / std."""
    x = torch.from_numpy(canvas if rgb_in else canvas[..., ::-1].copy()).float()
    return (x / torch.tensor(255.0) - torch.tensor(MEAN)) / torch.tensor(STD)


def confident_strategy(pred, t=0.8, real=0.2, min_fakes=11):
    pred = np.array(pred)
    sz = len(pred)
    fakes = np.count_nonzero(pred > t)
    if fakes > sz // 2.5 and fakes > min_fakes:
        return np.mean(pred[pred > t])
    elif np.count_nonzero(pred < real) > 0.9 * sz:
        return np.mean(pred[pred < real])
    else:
        return np.mean(pred)


def logits_of(members: Sequence[DeepFakeClassifier], crops: torch.Tensor, device,
              block: int) -> np.ndarray:
    """(M, N) float32 logits of (N, S, S, 3) crops, ``block`` crops at a
    time, float32 without TF32."""
    out = np.zeros((len(members), crops.shape[0]), np.float32)
    with torch.inference_mode(), _precision(torch.float32):
        for i, net in enumerate(members):
            for s in range(0, crops.shape[0], block):
                out[i, s:s + block] = net(crops[s:s + block].to(device)).cpu().numpy()
    return out


def classify(members, frames: np.ndarray, boxes: np.ndarray, mask: np.ndarray,
             cls: Mapping, rgb_in: bool, device, block: int = 16) -> Classified:
    """The classifier's answer on one clip's (N, H, W, 3) frames and (N, T)
    boxes and mask."""
    n, t = mask.shape
    canvases, slots = [], []
    for i, k in itertools.product(range(n), range(t)):
        if mask[i, k]:
            c = crop_u8(frames[i], boxes[i, k], cls["input_size"], cls["margin"], device)
            if c is not None:
                canvases.append(c)
                slots.append((i, k))
    held = np.zeros((n, t), bool)
    logits = np.zeros((len(members), n, t), np.float32)
    if slots:
        got = logits_of(members, normalise(np.stack(canvases), rgb_in), device, block)
        idx = tuple(np.array(slots).T)
        held[idx] = True
        logits[:, idx[0], idx[1]] = got
    if held.any():
        probs = 1.0 / (1.0 + np.exp(-logits[:, held].astype(np.float64)))
        score = float(np.mean([confident_strategy(p.astype(np.float32), cls["fake_threshold"],
                                                  cls["real_threshold"], cls["min_fakes"])
                               for p in probs]))
    else:
        score = 0.5
    return Classified(score, logits, held, boxes.astype(np.float32))


def analyze_tracks(nets, members, frames: np.ndarray, fps: int, cfg: DetectorConfig,
                   cls: Mapping, *, yuv: bool, device):
    """``analysis.analyze_tracks`` at a fixed K, and the classifier on each
    batch's first ``n_valid`` rows: (TrackResult, Classified).  The
    detector runs with float8 off even inside ``fp8_matmuls()``."""
    if not isinstance(cfg.detect_interval, int):
        raise NotImplementedError("the reference runs a fixed detect_interval")
    dtype = getattr(torch, cfg.compute_dtype)
    b, k = cfg.frame_batch, cfg.detect_interval
    steps = steps_for(yuv, multi_face=True)
    n = frames.shape[0]
    sampled = list(range(0, n, cfg.sample_interval(fps)))
    state = init_track_state(cfg.max_tracks, nets.facenet.last_linear.out_features,
                             device=device)
    seen: List[tuple] = []   # (BGR frames, boxes, valid) of each batch's valid rows

    def fold(out, dev, n_valid):
        boxes, valid, emb = out
        rows = to_frames(dev[:n_valid], cfg) if yuv else dev[:n_valid]
        seen.append((rows.cpu().numpy(), boxes[:n_valid].float().cpu().numpy(),
                     valid[:n_valid].cpu().numpy()))
        return track_timeline(state, boxes[None], valid[None], emb[None], n_valid,
                              similarity_threshold=cfg.similarity_threshold,
                              run_length_threshold=cfg.run_length_threshold)[0]

    token = layers._fp8.set(False)
    try:
        with torch.inference_mode(), _precision(dtype):
            batches = _batches(frames, sampled, b, device)
            while True:
                cycle = list(itertools.islice(batches, k))
                if not cycle:
                    break
                if k == 1:
                    chunk, dev = cycle[0]
                    state = fold(steps.full(nets, dev, cfg, dtype), dev, len(chunk))
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
                    out = steps.propagate(nets, dev, seed_box[rows], seed_found[rows], cfg,
                                          dtype, k=k)
                    if cfg.propagate_fallback:
                        found = out[1][: len(chunk)].cpu().numpy()
                        sv = np.repeat(sv_host[rows], k, axis=0)[: len(chunk)]
                        seeded, lost = int(sv.sum()), int((sv & ~found).sum())
                        if seeded and lost * 2 > seeded:
                            out = steps.full(nets, dev, cfg, dtype)
                    state = fold(out, dev, len(chunk))
    finally:
        layers._fp8.reset(token)
    per_track = track_scores(state, n, fps, run_length_threshold=cfg.run_length_threshold,
                             long_video_seconds=cfg.long_video_seconds)[0]
    final = {f: v.cpu().numpy() for f, v in stream_state(state, 0)._asdict().items()}
    tracks = TrackResult(score=int(per_track.max(initial=0)), per_track=per_track, state=final)
    got = classify(members, np.concatenate([s[0] for s in seen]),
                   np.concatenate([s[1] for s in seen]), np.concatenate([s[2] for s in seen]),
                   cls, not cfg.reference_compat, device)
    return tracks, got
