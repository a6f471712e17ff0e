"""Kernel K2's edge cases and its division-free IoU compare.

The plain version (``truely_tpu_torch/ops/nms.py``) is held to the JAX
package's ``nms_masked_batch`` (and, where it takes the inputs, to the
Pallas kernel in interpret mode) on the same edge inputs that
``chip_smoke.py`` gives the CUDA kernel on the card: chains deeper than
``max_rounds``, tied scores, K that is no multiple of 32, every slot
invalid, and pairs whose IoU is the threshold float or one of its
neighbours.  The kernel decides ``RN32(inter / d) > thr`` without the
division, through ``nms.iou_cut``; a numpy model of that compare is held
to the division on about 10^6 pairs.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from truely_tpu.ops import nms as jnms
from truely_tpu.ops.nms_pallas import nms_masked_batch_pallas
from truely_tpu_torch.ops import nms as tnms
from truely_tpu_torch.ops.boxes import iou_matrix

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the edge inputs of the card's forms)

torch.set_num_threads(2)

EDGES = chip_smoke.nms_edge_inputs()
# Inputs the Pallas kernel takes (no groups) at sizes its interpreter runs quickly.
PALLAS = {"K=256 all scores tied", "K=256 every slot invalid", "K=1 union 0.7", "K=37 min 0.7"}


def t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("case", range(len(EDGES)), ids=[e[0] for e in EDGES])
def test_nms_edges_match_jax(case):
    label, boxes, scores, valid, groups, kw = EDGES[case]
    want = np.asarray(jnms.nms_masked_batch(j(boxes), j(scores), j(valid), groups=j(groups), **kw))
    got = tnms.nms_masked_batch(t(boxes), t(scores), t(valid), groups=t(groups), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    if label in PALLAS:
        ref = np.asarray(nms_masked_batch_pallas(j(boxes), j(scores), j(valid), interpret=True,
                                                 **kw))
        np.testing.assert_array_equal(got, ref)


def test_nms_edge_cases_do_what_they_say():
    cases = {e[0]: e for e in EDGES}
    _, boxes, scores, valid, _, kw = cases["chain of 256 max_rounds=4"]
    bounded = tnms.nms_masked_batch(t(boxes), t(scores), t(valid), **kw).numpy()
    exact = tnms.nms_masked_batch(t(boxes), t(scores), t(valid), iou_threshold=0.5).numpy()
    assert not np.array_equal(bounded, exact)  # the tail rule ran
    assert (exact[:, 0::2]).all() and not (exact[:, 1::2]).any()  # greedy keeps every other box
    _, boxes, scores, valid, _, kw = cases["K=256 every slot invalid"]
    assert not tnms.nms_masked_batch(t(boxes), t(scores), t(valid), **kw).numpy().any()
    assert {e[1].shape[1] for e in EDGES} >= {1, 37, 100}


@pytest.mark.parametrize("method,thr", list(chip_smoke.THRESHOLD_SHIFT))
def test_threshold_pairs_cross_the_threshold_float(method, thr):
    """The pairs' IoU, as the plain version computes it, takes the threshold
    float and both of its neighbours; the kernel keeps b exactly where
    RN(IoU) <= thr."""
    boxes, scores, valid, groups = chip_smoke.nms_threshold_pairs(method, thr)
    iou = iou_matrix(t(boxes[0]), method=method).numpy()
    pair = np.array([iou[2 * p, 2 * p + 1] for p in range(boxes.shape[1] // 2)])
    f = np.float32(thr)
    for target in (np.nextafter(f, np.float32(0)), f, np.nextafter(f, np.float32(2))):
        assert (pair == target).any(), (method, thr, target)
    keep = tnms.nms_masked_batch(t(boxes), t(scores), t(valid), iou_threshold=thr, method=method,
                                 groups=t(groups)).numpy()
    np.testing.assert_array_equal(keep[0, 1::2], pair <= f)
    np.testing.assert_array_equal(keep[1, 0::2], pair <= f)  # frame 1 ranks b first


def model_hit(inter, denom, thr):
    """The kernel's compare in numpy: float64 product with iou_cut's m."""
    m, tie_up = tnms.iou_cut(thr)
    d = np.maximum(denom, np.float32(1e-12)).astype(np.float64)
    dm = d * m
    x = inter.astype(np.float64)
    return (x > dm) | (tie_up & (x == dm))


def division_hit(inter, denom, thr):
    return inter / np.maximum(denom, np.float32(1e-12)) > np.float32(thr)


def random_pairs(rng, n):
    """inter and the 'union' and 'min' denominators of n random box pairs,
    coordinates in [-50, 2000], in float32 in the kernel's order."""
    a = np.sort(rng.uniform(-50, 2000, (n, 2, 2)).astype(np.float32), axis=1)  # x1 <= x2, y1 <= y2
    b = np.sort(rng.uniform(-50, 2000, (n, 2, 2)).astype(np.float32), axis=1)
    one = np.float32(1)
    side = lambda p, c: p[:, 1, c] - p[:, 0, c] + one
    ix = np.maximum(np.float32(0), np.minimum(a[:, 1, 0], b[:, 1, 0])
                    - np.maximum(a[:, 0, 0], b[:, 0, 0]) + one)
    iy = np.maximum(np.float32(0), np.minimum(a[:, 1, 1], b[:, 1, 1])
                    - np.maximum(a[:, 0, 1], b[:, 0, 1]) + one)
    inter = ix * iy
    area_a, area_b = side(a, 0) * side(a, 1), side(b, 0) * side(b, 1)
    return inter, (area_a + area_b) - inter, np.minimum(area_a, area_b)


@pytest.mark.parametrize("thr", [0.5, 0.7, 0.3, 0.0, 1.0])
def test_division_free_compare_matches_division(thr):
    rng = np.random.default_rng(int(thr * 10) + 11)
    # Boxes near each other, so that many pairs overlap and the IoU spreads.
    inter, union, smaller = random_pairs(rng, 500_000)
    for denom in (union, smaller):
        np.testing.assert_array_equal(model_hit(inter, denom, thr), division_hit(inter, denom, thr))
    assert division_hit(inter, union, thr).any() or thr >= 1.0


@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_division_free_compare_at_the_rounding_boundary(thr):
    """Quotients within a few float steps of the threshold, of the midpoint
    where rounding turns, and of the threshold's neighbours."""
    rng = np.random.default_rng(3)
    f = np.float32(thr)
    lo, hi = np.nextafter(f, np.float32(0)), np.nextafter(f, np.float32(2))
    m, _ = tnms.iou_cut(thr)
    d = rng.uniform(1.0, 4.2e6, 40_000).astype(np.float32)
    inters = []
    for q in (float(lo), float(f), m, float(hi)):
        base = (d.astype(np.float64) * q).astype(np.float32)
        for step in range(-3, 4):
            inters.append((base.view(np.int32) + step).view(np.float32))
    inter = np.concatenate(inters)
    denom = np.tile(d, len(inters))
    hit = division_hit(inter, denom, thr)
    np.testing.assert_array_equal(model_hit(inter, denom, thr), hit)
    q = inter / denom
    assert (q == f).any() and (q == hi).any() and hit.any() and not hit.all()


@pytest.mark.parametrize("bad", [-0.1, float("nan"), float("inf"), float(np.finfo(np.float32).max)])
def test_wrapper_rejects_thresholds_outside_the_compare(bad):
    boxes = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="iou_threshold"):
        tnms.nms_masked_batch(boxes, torch.zeros((1, 4)), torch.ones((1, 4), dtype=torch.bool),
                              iou_threshold=bad)
