"""Least bytes and operations of each launch of the port's hand-written
kernels K1-K4, per kind of frame step, from shapes alone.

The formulas are ``chip_smoke.py``'s (``kernel_forms``, copied) with
every term that depends on the boxes left out, since a run does not see
them: K2's IoU tests (14 operations a valid pair), K3's covered frame
pixels and K4's source pixels.  What is left is the least the launch must
move or compute whatever the boxes are, so a roofline share built on it
is a lower bound and can never pass 100%.  K3's prep (the integral image)
counts 0, as in ``chip_smoke.py``: its bytes are no work the crops need.

A kernel's least time is the larger of its bytes over the HBM bandwidth
and its operations over the float32 rate outside the tensor cores.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

from benchmark.counts import F32_OPS_PER_S, HBM_BYTES_PER_S
from benchmark.reference.mtcnn import PROPAGATE_SCALES

# Kernel -> the CUDA kernel names (substrings of the trace's names) whose
# device time is its own.
KERNEL_NAMES = {
    "i420_to_bgr": ("i420_to_bgr_kernel",),
    "nms_masked_batch": ("nms_kernel",),
    "crop_resize_area": ("integral_rows_kernel", "integral_cols_kernel", "crop_area_kernel"),
    "crop_resize_bilinear": ("crop_bilinear_kernel",),
}


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def k1(b: int, h: int, w: int) -> Tuple[float, float]:
    """I420 -> BGR: packed in, BGR out; a multiply-add, a shift, an add
    and a clip per output byte."""
    return b * (h * 3 // 2) * w + b * h * w * 3, b * h * w * 3 * 4


def k2(b: int, k: int, grouped: bool) -> Tuple[float, float]:
    """NMS of K candidates: boxes, scores, validity (and groups) in, the
    keep mask out."""
    return b * k * (16 + 4 + 1 + 1 + (4 if grouped else 0)), 0.0


def k3_crop(b: int, k: int, o: int) -> Tuple[float, float]:
    """A stage crop of K boxes to O x O: the bounds in, float32 bins out,
    one division per bin and channel."""
    return b * k * 16 + b * k * o * o * 3 * 4, b * k * o * o * 3


def k4(b: int, k: int, o: int) -> Tuple[float, float]:
    """The face crop of K boxes to O x O: the bounds in, float32 samples
    out, three lerps of three operations per value."""
    return b * k * 16 + b * k * o * o * 3 * 4, b * k * o * o * 3 * 9


def step_forms(detector: Mapping, kind: str, b: int, h: int, w: int,
               yuv: bool) -> List[Tuple[str, float, float]]:
    """[(kernel, bytes, operations), ...] of one frame step of ``kind``
    ("full", "detect" or "propagate") over ``b`` rows, on the q > 1 stage
    crops of K3 (the bf16 defaults; K5 takes exact crops)."""
    mtcnn = detector["mtcnn"]
    faces = detector["max_tracks"] if detector["multi_face"] else 1
    forms = [("i420_to_bgr", *k1(b, h, w))] if yuv else []
    if kind in ("full", "detect"):
        k2_ = min(mtcnn["rnet_capacity"], mtcnn["pnet_topk_total"])
        k3_ = min(mtcnn["onet_capacity"], k2_)
        forms += [("nms_masked_batch", *k2(b, mtcnn["pnet_topk_total"], True)),
                  ("nms_masked_batch", *k2(b, mtcnn["pnet_topk_total"], False))]
    else:
        k2_ = k3_ = faces * len(PROPAGATE_SCALES)
    forms += [("crop_resize_area", *k3_crop(b, k2_, 24)), ("nms_masked_batch", *k2(b, k2_, False)),
              ("crop_resize_area", *k3_crop(b, k3_, 48)), ("nms_masked_batch", *k2(b, k3_, False))]
    if kind != "detect":
        forms.append(("crop_resize_bilinear", *k4(b, faces, detector["crop_size"])))
    return forms


def launches_of(forms: List[Tuple[str, float, float]]) -> Dict[str, int]:
    """Launches per kernel wrapper of a list of forms; K3's crops count
    on ``crop_resize_area_from_integral`` and its one prep a step on
    ``crop_area_integral``."""
    out: Dict[str, int] = {}
    for name, _, _ in forms:
        out[name] = out.get(name, 0) + 1
    if "crop_resize_area" in out:
        out["crop_area_integral"] = 1
    return out
