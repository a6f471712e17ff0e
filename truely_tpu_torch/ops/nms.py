"""Masked fixed-capacity NMS: kernel K2 and its plain version (counterpart
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
``truely_tpu/ops/nms_pallas.py:nms_masked_batch_pallas``, one CTA per frame
with the K x K overlap bitmask in shared memory; bound by operations (K^2
IoU tests per frame), tiny at K <= 256.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from truely_tpu_torch.ops import cuda_build
from truely_tpu_torch.ops.boxes import iou_matrix

NEG_INF = -1e30
MAX_K = 256  # the kernel's shared-memory capacity


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
    """Batched masked NMS: kernel K2 on CUDA tensors, the plain version on
    CPU tensors.  Returns the (B, K) bool keep mask in the original order."""
    if method not in ("union", "min"):
        raise ValueError(f"method must be 'union' or 'min', got {method!r}")
    if boxes.device.type == "cpu":
        return nms_masked_batch_plain(
            boxes, scores, valid, iou_threshold=iou_threshold, method=method,
            max_rounds=max_rounds, groups=groups)
    b, k = scores.shape
    if boxes.shape != (b, k, 4) or valid.shape != (b, k):
        raise ValueError(f"shape mismatch: boxes {tuple(boxes.shape)}, scores {(b, k)}, "
                         f"valid {tuple(valid.shape)}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"the NMS kernel takes 1..{MAX_K} candidates, got {k}")
    cuda_build.require_cuda("nms_masked_batch", boxes, scores, valid, groups)
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    if groups is not None:
        if groups.shape != (b, k):
            raise ValueError(f"groups shape {tuple(groups.shape)} != {(b, k)}")
        groups = groups.to(torch.int32).contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    P, I = cuda_build.P, cuda_build.I
    cuda_build.launch("nms", "tt_nms", [P, P, P, P, P, I, I, ctypes.c_float, I, I],
                      boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
                      groups.data_ptr() if groups is not None else None, keep.data_ptr(),
                      b, k, float(iou_threshold), int(method == "min"), int(max_rounds),
                      device=boxes.device)
    nms_masked_batch.launches += 1
    return keep


nms_masked_batch.launches = 0
