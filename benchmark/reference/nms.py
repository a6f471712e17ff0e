"""Frozen copy of ``truely_tpu_torch/ops/nms.py``, with
every kernel wrapper calling its plain version (no CUDA kernel of the
port runs here).

Masked fixed-capacity NMS: kernel K2 and its plain version (counterpart
of ``truely_tpu/ops/nms.py`` and ``truely_tpu/ops/nms_pallas.py``).

Greedy NMS over K score-ranked candidates per frame, computed as a
round-parallel fixpoint: in each round every undecided candidate whose
overlapping higher-ranked candidates are all suppressed is kept, then every
undecided candidate that a kept one overlaps is suppressed.  This gives the
greedy result while the suppression chains are at most ``max_rounds`` deep;
past that, the tail rule keeps every undecided candidate no kept one
overlaps.  ``groups`` confines suppression to same-group pairs (the
per-scale P-Net NMS on the mixed candidate set).

Kernel: ``csrc/nms.cu`` replaces the Pallas kernel
``truely_tpu/ops/nms_pallas.py:nms_masked_batch_pallas``: a cluster of
CTAs per frame builds the K x K overlap bitmask (one ballot word per warp
step), the CTAs share it through distributed shared memory, and each runs
the rounds on it; bound by operations (K^2 IoU tests per frame), tiny at
K <= 256.  The kernel compares the IoU with the threshold without a
division (:func:`iou_cut`), exactly as the plain version's division and
compare decide it, so the wrapper takes thresholds in [0, FLT_MAX).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


from .boxes import iou_matrix
from .topk import exact_topk_lastdim

NEG_INF = -1e30
MAX_K = 256  # the kernel's shared-memory capacity
# CTAs per frame (a thread-block cluster) above SMALL_K candidates; one CTA
# sized to K at and below it.
LARGE_K_CLUSTER = 2
SMALL_K = 64


@functools.lru_cache(maxsize=64)
def iou_cut(iou_threshold: float) -> Tuple[float, bool]:
    """The division-free form of ``RN32(inter / d) > f32(iou_threshold)``
    for finite float32 ``inter`` and ``d > 0``: ``inter > d * m`` in float64,
    or ``inter == d * m`` and ``tie_up``.  ``m`` is the midpoint of the
    threshold and the next float32 above it, where round-to-nearest turns
    from the threshold to its successor; the product of d's 24-bit and m's
    25-bit significands is exact in a double.  At ``inter / d == m`` exactly
    round-to-nearest-even goes up iff the successor's significand is even
    (``tie_up``).  Returns (m, tie_up); raises for a threshold outside
    [0, FLT_MAX), where the form does not hold."""
    thr = np.float32(iou_threshold)
    if not (np.isfinite(thr) and 0.0 <= thr < np.finfo(np.float32).max):
        raise ValueError(f"iou_threshold must lie in [0, FLT_MAX), got {iou_threshold!r}")
    up = np.nextafter(thr, np.float32(np.inf))
    return (float(thr) + float(up)) / 2.0, int(up.view(np.uint32)) % 2 == 0


def cluster_size(k: int) -> int:
    return LARGE_K_CLUSTER if k > SMALL_K else 1


def _overlap(boxes, scores, valid, iou_threshold, method, groups):
    k = boxes.shape[1]
    iou = iou_matrix(boxes, method=method)  # (B, K, K), [b, j, i]
    idx = torch.arange(k, device=boxes.device)
    # "j outranks i": strictly higher score, ties to the lower index.
    outranks = (scores[:, :, None] > scores[:, None, :]) | (
        (scores[:, :, None] == scores[:, None, :]) & (idx[:, None] < idx[None, :])
    )
    overlap = (iou > iou_threshold) & outranks & valid[:, :, None]
    if groups is not None:
        overlap = overlap & (groups[:, :, None] == groups[:, None, :])
    return overlap


def _hit(overlap, mask):
    """hit[b, i] = any_j overlap[b, j, i] & mask[b, j]."""
    return (overlap & mask[:, :, None]).any(dim=1)


def nms_masked_batch_plain(boxes, scores, valid, *, iou_threshold: float,
                           method: str = "union", max_rounds: int = 0,
                           groups: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: (B, K, 4) boxes, (B, K) scores/valid ->
    (B, K) bool keep mask."""
    overlap = _overlap(boxes, scores, valid, iou_threshold, method, groups)
    kept = torch.zeros_like(valid)
    suppressed = ~valid
    r = 0
    while True:
        undecided = ~(kept | suppressed)
        if not bool(undecided.any()) or (max_rounds > 0 and r >= max_rounds):
            break
        blocked = _hit(overlap, kept | undecided)
        kept = kept | (undecided & ~blocked)
        suppressed = suppressed | (undecided & _hit(overlap, kept))
        r += 1
    if max_rounds > 0:
        undecided = ~(kept | suppressed)
        kept = kept | (undecided & ~_hit(overlap, kept))
    return kept


def nms_masked_batch(boxes, scores, valid, *, iou_threshold: float,
                     method: str = "union", max_rounds: int = 0,
                     groups: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched masked NMS by the plain version, on any device.  Returns the
    (B, K) bool keep mask in the original order."""
    if method not in ("union", "min"):
        raise ValueError(f"method must be 'union' or 'min', got {method!r}")
    return nms_masked_batch_plain(boxes, scores, valid, iou_threshold=iou_threshold,
                                  method=method, max_rounds=max_rounds, groups=groups)


def nms_masked(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, *,
               iou_threshold: float, method: str = "union") -> torch.Tensor:
    """Exact greedy NMS of one image's (K, 4) boxes with a validity mask
    (``truely_tpu/ops/nms.py:nms_masked``): the (K,) bool keep mask in the
    original order; invalid entries are never kept, ties go to the lower
    index.  :func:`nms_masked_batch` over a batch of one, with no round
    cap (kernel K2 on CUDA tensors, for K <= MAX_K)."""
    return nms_masked_batch(boxes[None], scores[None], valid[None], iou_threshold=iou_threshold,
                            method=method)[0]


def topk_select(scores: torch.Tensor, valid: torch.Tensor, k_out: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k_out`` highest-score valid entries of (..., K) scores
    (``truely_tpu/ops/nms.py:topk_select``): (indices (..., k_out),
    valid_out (..., k_out)); an invalid slot's index is to be ignored."""
    masked = torch.where(valid, scores, NEG_INF)
    flat = masked.reshape(-1, masked.shape[-1])
    vals, idx = exact_topk_lastdim(flat, k_out)
    shape = masked.shape[:-1] + (idx.shape[-1],)
    return idx.reshape(shape), (vals > NEG_INF / 2).reshape(shape)
