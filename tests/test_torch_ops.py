"""The port's plain op versions against the JAX functions on the CPU.

Every input is made from a seed with numpy and handed to both packages.
Integer-exact ops (I420 conversion, NMS keep masks, area crops, top-k, the
run-length counter and the score) must be bit-equal; the bilinear face
crop is bit-equal in float32 because every operation rounds in the same
order.  Each Pallas kernel on the path is also held to, in interpret mode.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from truely_tpu.ops import boxes as jboxes
from truely_tpu.ops import nms as jnms
from truely_tpu.ops import resize as jresize
from truely_tpu.ops import temporal as jtemporal
from truely_tpu.ops import yuv as jyuv
from truely_tpu.ops.boxes import pad_crop_bounds as j_pad_crop_bounds
from truely_tpu.ops.crop_fused2 import crop_resize_area_fused2, prep_frames_fused2
from truely_tpu.ops.crop_pallas import crop_resize_bilinear_pallas
from truely_tpu.ops.nms_pallas import nms_masked_batch_pallas
from truely_tpu.ops.topk import exact_topk_lastdim as j_topk
from truely_tpu_torch.ops import boxes as tboxes
from truely_tpu_torch.ops import nms as tnms
from truely_tpu_torch.ops import resize as tresize
from truely_tpu_torch.ops import temporal as ttemporal
from truely_tpu_torch.ops import yuv as tyuv
from truely_tpu_torch.ops.topk import exact_topk_lastdim as t_topk

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# I420 -> BGR (K1)


def all_triples_i420():
    """64 packed (768, 512) frames whose 256x256 chroma planes list all
    65,536 (u, v) pairs and whose four luma values per quad step through
    0..255 across the frames: every (y, u, v) triple occurs."""
    u, v = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                       indexing="ij")
    frames = np.empty((64, 768, 512), np.uint8)
    for f in range(64):
        quad = (4 * f + np.arange(4, dtype=np.uint8)).reshape(2, 2)
        frames[f, :512] = np.tile(quad, (256, 256))
        frames[f, 512:640] = u.reshape(128, 512)
        frames[f, 640:] = v.reshape(128, 512)
    return frames


@pytest.mark.parametrize("rgb", [False, True])
def test_i420_all_triples_bit_equal(rgb):
    packed = all_triples_i420()
    ours = tyuv.i420_to_bgr(t(packed), rgb=rgb).numpy()
    ref = np.asarray(jyuv.i420_to_bgr(jnp.asarray(packed), rgb=rgb))
    np.testing.assert_array_equal(ours, ref)


def test_i420_pallas_interpret_bit_equal():
    packed = all_triples_i420()[::16]
    ours = tyuv.i420_to_bgr(t(packed)).numpy()
    ref = np.asarray(jyuv.i420_to_bgr_pallas(jnp.asarray(packed), interpret=True))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("yuv", [(0, 0, 0), (255, 255, 255), (0, 255, 0), (255, 0, 255),
                                 (16, 128, 128), (235, 128, 128)])
def test_i420_extreme_values(yuv):
    y0, u0, v0 = yuv
    w, h = 8, 8
    flat = np.concatenate([np.full(w * h, y0, np.uint8), np.full(w * h // 4, u0, np.uint8),
                           np.full(w * h // 4, v0, np.uint8)]).reshape(1, h * 3 // 2, w)
    ours = tyuv.i420_to_bgr(t(flat)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jyuv.i420_to_bgr(jnp.asarray(flat))))


@pytest.mark.parametrize("wrapper", ["yuv", "nms", "crop_area", "crop_bilinear", "crop_integral",
                                     "crop_from_integral"])
def test_kernel_wrappers_never_fall_back_off_the_cpu(wrapper):
    """A wrapper takes its plain version only for CPU tensors; any other
    device must reach the kernel (or raise), never the plain version."""
    meta = {"device": "meta"}
    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, **meta)
    bounds = torch.zeros((1, 1, 4), dtype=torch.int32, **meta)
    calls = {
        "yuv": lambda: tyuv.i420_to_bgr(torch.zeros((1, 12, 8), dtype=torch.uint8, **meta)),
        "nms": lambda: tnms.nms_masked_batch(torch.zeros((1, 4, 4), **meta), torch.zeros((1, 4), **meta),
                                             torch.ones((1, 4), dtype=torch.bool, **meta),
                                             iou_threshold=0.5),
        "crop_area": lambda: tresize.crop_resize_area(frames, bounds, 4),
        "crop_bilinear": lambda: tresize.crop_resize_bilinear(frames, bounds, 4),
        "crop_integral": lambda: tresize.crop_area_integral(frames, 4),
        "crop_from_integral": lambda: tresize.crop_resize_area_from_integral(
            torch.zeros((1, 3, 3, 3), dtype=torch.int32, **meta), bounds, 4, quant=4),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[wrapper]()


def test_i420_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tyuv.i420_to_bgr(torch.zeros((1, 9, 8), dtype=torch.uint8))   # H = 6
    with pytest.raises(ValueError):
        tyuv.i420_to_bgr(torch.zeros((1, 12, 7), dtype=torch.uint8))  # odd W


# ---------------------------------------------------------------------------
# NMS (K2)


def nms_case(seed, b=3, k=96, ties=False, chain=False):
    rng = np.random.default_rng(seed)
    if chain:
        # A deep suppression chain: each box overlaps the next one a lot.
        x = np.arange(k, dtype=np.float32)[None].repeat(b, 0) * 3.0
        boxes = np.stack([x, x * 0, x + 10.0, x * 0 + 10.0], -1)
        scores = np.linspace(1.0, 0.1, k, dtype=np.float32)[None].repeat(b, 0)
    else:
        xy = rng.uniform(0, 120, (b, k, 2))
        wh = rng.uniform(2, 50, (b, k, 2))
        boxes = np.concatenate([xy, xy + wh], -1)
        scores = rng.uniform(0.1, 1.0, (b, k))
    if ties:
        scores = np.round(scores * 4) / 4
        boxes = np.round(boxes / 8) * 8
    valid = rng.random((b, k)) > 0.2
    groups = rng.integers(0, 4, (b, k)).astype(np.int32)
    return boxes.astype(np.float32), scores.astype(np.float32), valid, groups


@pytest.mark.parametrize("case", ["random", "ties", "chain"])
@pytest.mark.parametrize("method", ["union", "min"])
@pytest.mark.parametrize("max_rounds", [0, 3, 64])
@pytest.mark.parametrize("grouped", [False, True])
def test_nms_bit_equal(case, method, max_rounds, grouped):
    boxes, scores, valid, groups = nms_case(
        7, ties=case == "ties", chain=case == "chain", k=128 if case == "chain" else 96)
    g = groups if grouped else None
    ref = np.asarray(jnms.nms_masked_batch(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), iou_threshold=0.3,
        method=method, max_rounds=max_rounds, groups=None if g is None else jnp.asarray(g)))
    ours = tnms.nms_masked_batch(
        t(boxes), t(scores), t(valid), iou_threshold=0.3, method=method,
        max_rounds=max_rounds, groups=None if g is None else t(g)).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("method", ["union", "min"])
@pytest.mark.parametrize("max_rounds", [0, 64])
def test_nms_matches_pallas_interpret(method, max_rounds):
    boxes, scores, valid, _ = nms_case(3, k=128, ties=True)
    ref = np.asarray(nms_masked_batch_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), iou_threshold=0.5,
        method=method, max_rounds=max_rounds, interpret=True))
    ours = tnms.nms_masked_batch(t(boxes), t(scores), t(valid), iou_threshold=0.5,
                                 method=method, max_rounds=max_rounds).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_nms_chain_deeper_than_max_rounds_uses_tail_rule():
    """A chain deeper than max_rounds must take the tail rule, not the
    sequential greedy answer: the two differ here."""
    boxes, scores, valid, _ = nms_case(0, b=1, k=128, chain=True)
    valid[:] = True
    bounded = tnms.nms_masked_batch(t(boxes), t(scores), t(valid), iou_threshold=0.3,
                                    max_rounds=3).numpy()
    exact = tnms.nms_masked_batch(t(boxes), t(scores), t(valid), iou_threshold=0.3).numpy()
    ref = np.asarray(jnms.nms_masked_batch(jnp.asarray(boxes), jnp.asarray(scores),
                                           jnp.asarray(valid), iou_threshold=0.3, max_rounds=3))
    np.testing.assert_array_equal(bounded, ref)
    assert not np.array_equal(bounded, exact)


def test_iou_matrix_plus_one_convention():
    boxes = np.array([[[0, 0, 9, 9], [5, 5, 14, 14], [20, 20, 20, 20]]], np.float32)
    iou = tboxes.iou_matrix(t(boxes)).numpy()[0]
    assert iou[0, 0] == 1.0 and iou[2, 2] == 1.0
    np.testing.assert_allclose(iou[0, 1], 25.0 / (100 + 100 - 25), rtol=1e-6)


# ---------------------------------------------------------------------------
# Area crops (K3)


def crop_case(seed, h, w, b=2, k=12):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, h, w, 3), np.uint8)
    x0 = rng.uniform(-20, w, (b, k))
    y0 = rng.uniform(-20, h, (b, k))
    s = rng.uniform(0, 1.2 * min(h, w), (b, k))
    boxes = np.stack([x0, y0, x0 + s, y0 + s * rng.uniform(0.5, 1.5, (b, k))], -1)
    boxes[:, 0] = [10.0, 10.0, 9.0, 50.0]         # empty after the clamp
    boxes[:, 1] = [-30.0, -30.0, -5.0, -5.0]      # entirely outside
    boxes[:, 2] = [0.0, 0.0, float(w), float(h)]  # whole frame
    bounds = np.asarray(j_pad_crop_bounds(jnp.asarray(boxes.astype(np.float32)), w, h))
    return frames, boxes.astype(np.float32), bounds


def test_pad_crop_bounds_bit_equal():
    _, boxes, bounds = crop_case(0, 64, 88)
    np.testing.assert_array_equal(tboxes.pad_crop_bounds(t(boxes), 88, 64).numpy(), bounds)


@pytest.mark.parametrize("o", [24, 48])
@pytest.mark.parametrize("hw", [(64, 88), (90, 122)])
def test_crop_area_exact_bit_equal(o, hw):
    h, w = hw
    frames, _, bounds = crop_case(1, h, w)
    ours = tresize.crop_resize_area(t(frames), t(bounds), o, quant=1).numpy()
    ref = np.asarray(jresize.crop_resize_area(jresize.integral_image(jnp.asarray(frames)),
                                              jnp.asarray(bounds), o))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("o", [24, 48])
def test_crop_area_matches_fused2_interpret(o):
    h, w = 72, 104
    frames, _, bounds = crop_case(2, h, w, k=8)
    ours = tresize.crop_resize_area(t(frames), t(bounds), o).numpy()
    prepped = prep_frames_fused2(jnp.transpose(jnp.asarray(frames), (0, 3, 1, 2)))
    ref = np.asarray(crop_resize_area_fused2(prepped, jnp.asarray(bounds), o, src_hw=(h, w),
                                             interpret=True))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("o", [24, 48])
@pytest.mark.parametrize("hw", [(64, 88), (92, 120)])
def test_crop_area_quant4_bit_equal(o, hw):
    h, w = hw
    frames, _, bounds = crop_case(3, h, w)
    ours = tresize.crop_resize_area(t(frames), t(bounds), o, quant=4).numpy()
    ref = np.asarray(jresize.crop_resize_area_mxu_quant(jnp.asarray(frames), jnp.asarray(bounds),
                                                        o, quant=4))
    np.testing.assert_array_equal(ours, ref)
    assert not ours[:, 0].any()  # the empty box stays empty


def test_crop_area_rejects_indivisible_quant():
    with pytest.raises(ValueError):
        tresize.crop_resize_area(torch.zeros((1, 10, 12, 3), dtype=torch.uint8),
                                 torch.zeros((1, 1, 4), dtype=torch.int32), 24, quant=4)


# ---------------------------------------------------------------------------
# Bilinear face crop (K4)


def face_bounds(boxes, w, h):
    """The detector's clamp of a face box (trunc, clamp to the frame)."""
    bi = boxes.astype(np.int32)
    return np.stack([np.maximum(bi[..., 0], 0), np.maximum(bi[..., 1], 0),
                     np.minimum(bi[..., 2], w), np.minimum(bi[..., 3], h)], -1).astype(np.int32)


@pytest.mark.parametrize("o", [80, 24])
@pytest.mark.parametrize("hw", [(61, 83), (120, 160)])
def test_crop_bilinear_bit_equal(o, hw):
    h, w = hw
    frames, boxes, _ = crop_case(4, h, w, k=10)
    bounds = face_bounds(boxes, w, h)
    ours = tresize.crop_resize_bilinear(t(frames), t(bounds), o).numpy()
    ref = np.asarray(jresize.crop_resize_bilinear(jnp.asarray(frames), jnp.asarray(bounds), o))
    np.testing.assert_array_equal(ours, ref)
    assert not ours[:, 0].any()  # empty box -> zeros


def test_crop_bilinear_close_to_pallas_interpret():
    """The Pallas kernel computes its sample positions as (i+0.5)*(len/O)
    and lerps as t*(1-f) + b*f, so it rounds differently from the XLA
    function the port matches bit for bit; on pixel values up to 255 the
    two agree to 1e-2."""
    h, w = 40, 56
    frames, boxes, _ = crop_case(5, h, w, b=1, k=4)
    bounds = face_bounds(boxes[:, 2:], w, h)  # the whole frame and a random box
    ours = tresize.crop_resize_bilinear(t(frames), t(bounds), 24).numpy()
    ref = np.asarray(crop_resize_bilinear_pallas(jnp.asarray(frames), jnp.asarray(bounds), 24,
                                                 interpret=True))
    np.testing.assert_allclose(ours, ref, atol=1e-2)


# ---------------------------------------------------------------------------
# Top-k


@pytest.mark.parametrize("n,k", [(200, 16), (5000, 64), (70000, 256)])
@pytest.mark.parametrize("tied", [False, True])
def test_topk_matches_lax_top_k(n, k, tied):
    rng = np.random.default_rng(n + k)
    p = rng.random((3, n)).astype(np.float32)
    if tied:
        p = np.round(p * 8) / 8
        p[1, :] = 0.5
        p[2, rng.random(n) < 0.5] = -1e30
    vals, idx = t_topk(t(p), k)
    jv, ji = jax.lax.top_k(jnp.asarray(p), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    jv2, ji2 = j_topk(jnp.asarray(p), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji2))


# ---------------------------------------------------------------------------
# Temporal scan and score


def timeline(seed, n=90, dim=16):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=dim)
    emb = (base + rng.normal(scale=0.08, size=(n, dim)) * (rng.random((n, 1)) < 0.7)
           ).astype(np.float32)
    has_face = rng.random(n) > 0.15
    return emb, has_face


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_temporal_matches_jax_and_folds(seed):
    emb, has_face = timeline(seed)
    n, dim = emb.shape
    ref = jtemporal.temporal_consistency(jnp.asarray(emb), jnp.asarray(has_face), n)
    one = ttemporal.temporal_consistency(t(emb), t(has_face), n)
    for name in ("counter", "flagged", "annotated", "has_face"):
        np.testing.assert_array_equal(getattr(one, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(one.similarity.numpy(), np.asarray(ref.similarity), atol=1e-6)
    assert int(one.flagged_count) == int(ref.flagged_count)
    assert int(one.final_counter) == int(ref.final_counter)

    # Batch by batch through the carried state, the last batch padded.
    state = ttemporal.init_temporal_state(dim)
    parts = []
    bsz = 16
    for s in range(0, n, bsz):
        e = np.zeros((bsz, dim), np.float32)
        hf = np.zeros(bsz, bool)
        m = min(bsz, n - s)
        e[:m], hf[:m] = emb[s:s + m], has_face[s:s + m]
        res = ttemporal.temporal_consistency(t(e), t(hf), m, state=state)
        state = res.state
        parts.append((res, m))
    for name in ("counter", "flagged", "annotated", "similarity"):
        folded = np.concatenate([getattr(r, name).numpy()[:m] for r, m in parts])
        np.testing.assert_array_equal(folded, getattr(one, name).numpy())
    assert int(state.counter) == int(one.final_counter)


def test_run_length_counter_with_carry():
    rng = np.random.default_rng(4)
    update = rng.random(64) > 0.3
    below = rng.random(64) > 0.2
    for initial in (0, 5):
        ref = np.asarray(jtemporal.resettable_run_length(
            jnp.asarray(update), jnp.asarray(below), jnp.int32(initial)))
        ours = ttemporal.resettable_run_length(t(update), t(below), torch.tensor(initial))
        np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("args", [
    (0, 0, 0, 0, 30), (3, 7, 40, 120, 30), (12, 16, 50, 1000, 30), (17, 31, 45, 901, 30),
    (5, 20, 7, 30, 7), (40, 40, 40, 2000, 24), (1, 1, 3, 3, 1),
])
def test_weighted_score_bit_equal(args):
    flagged, final, total, frames, fps = args
    ref = int(jtemporal.weighted_score(jnp.int32(flagged), jnp.int32(final), jnp.int32(total),
                                       jnp.int32(frames), jnp.int32(fps)))
    assert ttemporal.weighted_score(flagged, final, total, frames, fps) == ref


# ---------------------------------------------------------------------------
# Public names of the JAX ops modules: clip_boxes, nms_masked, topk_select,
# resize_bilinear, resize_area_u8


def test_clip_boxes_bit_equal():
    boxes = np.random.default_rng(11).uniform(-40, 160, (3, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(tboxes.clip_boxes(t(boxes), 120, 90).numpy(),
                                  np.asarray(jboxes.clip_boxes(jnp.asarray(boxes), 120, 90)))


@pytest.mark.parametrize("case", ["random", "ties", "chain"])
@pytest.mark.parametrize("method", ["union", "min"])
def test_nms_masked_equals_jax(case, method):
    """One image: the exact greedy NMS of ``truely_tpu/ops/nms.py:nms_masked``."""
    boxes, scores, valid, _ = nms_case(13, ties=case == "ties", chain=case == "chain", b=1,
                                       k=64)
    ref = np.asarray(jnms.nms_masked(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                                     jnp.asarray(valid[0]), iou_threshold=0.4, method=method))
    ours = tnms.nms_masked(t(boxes[0]), t(scores[0]), t(valid[0]), iou_threshold=0.4,
                           method=method).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("k_out", [1, 10, 40])
def test_topk_select_equals_jax(k_out):
    rng = np.random.default_rng(k_out)
    scores = (np.round(rng.random(40) * 6) / 6).astype(np.float32)   # ties
    valid = rng.random(40) > 0.3
    ref_idx, ref_valid = (np.asarray(a) for a in jnms.topk_select(
        jnp.asarray(scores), jnp.asarray(valid), k_out))
    idx, ok = (a.numpy() for a in tnms.topk_select(t(scores), t(valid), k_out))
    np.testing.assert_array_equal(ok, ref_valid)
    np.testing.assert_array_equal(idx[ok], ref_idx[ref_valid])


@pytest.mark.parametrize("out_hw", [(20, 31), (45, 60), (90, 121)])
def test_resize_bilinear_close_to_jax(out_hw):
    """float32 matrix products that sum in another order: within 1e-4 on
    pixel values up to 255."""
    x = np.random.default_rng(12).integers(0, 256, (2, 45, 61, 3), np.uint8)
    ours = tresize.resize_bilinear(t(x), out_hw).numpy()
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out_hw))
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("hw", [(135, 241), (64, 88)])
def test_resize_area_u8_bit_equal(hw):
    """Every pyramid level: exact integer bin sums and one IEEE division, in
    bfloat16 equal to the JAX function's bits as it runs op by op (the
    float32 averaging path cast to bfloat16 differs from it in the last bit
    of some values).  Under ``jax.jit`` XLA turns the division by the
    constant area into a multiply by its reciprocal, which rounds otherwise
    at some levels (ROADMAP §C); the port keeps the function's division."""
    from truely_tpu_torch.pipeline.pyramid import pyramid_schedule

    h, w = hw
    x = np.random.default_rng(h).integers(0, 256, (1, h, w, 3), np.uint8)
    for lvl in pyramid_schedule(h, w):
        ours = tresize.resize_area_u8(t(x), (lvl.height, lvl.width))
        ref = jresize.resize_area_u8(jnp.asarray(x), (lvl.height, lvl.width))
        assert ours.dtype == torch.bfloat16
        np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_resize_area_u8_rejects_wide_bins_and_float_input():
    with pytest.raises(ValueError, match="exceed 127"):
        tresize.resize_area_u8(torch.zeros((1, 256, 20, 3), dtype=torch.uint8), (2, 20))
    with pytest.raises(ValueError, match="uint8"):
        tresize.resize_area_u8(torch.zeros((1, 20, 20, 3)), (10, 10))
