"""Kernel K5's edge cases: its plain version (``truely_tpu_torch/ops/
crop_area_fused.py``), which takes the (B, H, W, 3) frames as the kernel
does, held to the JAX package's exact area crop (``crop_resize_area`` over
``integral_image``) on the same edge bounds that ``chip_smoke.py`` gives
the CUDA kernel on the card: crops narrower than O, empty, at every x0
residue mod 16, as wide as the frame, and rows that are no multiple of 16
bytes.  Crops partly outside the frame, where the JAX functions are not
held to one answer, go against a loop over the bins.  And the cascade's
crop source on the exact crop chain is held to the JAX cascade's stage
crops.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from truely_tpu.config import MTCNNConfig as JMTCNNConfig
from truely_tpu.ops.crop_area_fused import (
    crop_resize_area_fused as j_crop_fused,
    prep_frames_for_fused_crops as j_prep,
)
from truely_tpu.ops.resize import crop_resize_area as j_crop_area, integral_image
from truely_tpu.pipeline import mtcnn as jmtcnn
from truely_tpu_torch.config import MTCNNConfig
from truely_tpu_torch.ops import crop_area_fused as tfused
from truely_tpu_torch.pipeline import mtcnn as tmtcnn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the edge inputs of the card's forms)

torch.set_num_threads(2)

EDGES = chip_smoke.crop_edge_inputs(b=2)


def frames_for(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (2, *hw, 3), dtype=np.uint8)


OUTSIDE = "partly outside the frame"
INSIDE = [i for i, e in enumerate(EDGES) if e[0] != OUTSIDE]


@pytest.mark.parametrize("case", INSIDE, ids=[EDGES[i][0] for i in INSIDE])
def test_fused_edges_match_jax(case):
    label, hw, bounds, o = EDGES[case]
    frames = frames_for(hw, case)
    want = np.asarray(j_crop_area(integral_image(jnp.asarray(frames)), jnp.asarray(bounds), o))
    got = tfused.crop_resize_area_fused(torch.from_numpy(frames), torch.from_numpy(bounds), o,
                                        src_hw=hw).numpy()
    np.testing.assert_array_equal(got, want)
    if hw != (chip_smoke.STEP_H, chip_smoke.STEP_W):  # small frames: the Pallas kernel too
        ref = j_crop_fused(j_prep(jnp.transpose(jnp.asarray(frames), (0, 3, 1, 2))),
                           jnp.asarray(bounds), o, src_hw=hw, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_fused_edges_outside_the_frame_sum_the_inside():
    """Bounds that leave the frame, which the cascade never gives K5 (its
    bounds are clipped) and on which the JAX functions disagree with each
    other (a negative gather index wraps; the Pallas kernel counts an
    outside pixel as 128): each bin is the sum of its part inside the frame
    over its whole area, checked against a loop over the bins."""
    label, hw, bounds, o = next(e for e in EDGES if e[0] == OUTSIDE)
    frames = frames_for(hw, 0)
    got = tfused.crop_resize_area_fused(torch.from_numpy(frames), torch.from_numpy(bounds), o,
                                        src_hw=hw).numpy()
    h, w = hw
    want = np.zeros_like(got)
    edges = lambda a, n: [(a + i * n // o, max(a + -(-(i + 1) * n // o), a + i * n // o))
                          for i in range(o)]
    for bi, ki in np.ndindex(bounds.shape[:2]):
        x0, y0, x1, y1 = (int(v) for v in bounds[bi, ki])
        for oy, (sy, ey) in enumerate(edges(y0, max(y1 - y0, 0))):
            for ox, (sx, ex) in enumerate(edges(x0, max(x1 - x0, 0))):
                area = (ey - sy) * (ex - sx)
                if area > 0:
                    part = frames[bi, max(sy, 0):max(min(ey, h), 0), max(sx, 0):max(min(ex, w), 0)]
                    want[bi, ki, oy, ox] = (part.reshape(-1, 3).sum(0, dtype=np.int64)
                                            .astype(np.float32) / np.float32(area))
    np.testing.assert_array_equal(got, want)
    assert got[:, -2:].sum() == 0 and got.any()  # the two boxes off the frame give zeros


def test_fused_edge_cases_do_what_they_say():
    cases = {e[0]: e for e in EDGES}
    w = chip_smoke.STEP_W
    _, _, narrow, o = cases["12 px crops"]
    assert (narrow[..., 2] - narrow[..., 0] == 12).all() and o == 48
    _, hw, outside, _ = cases["partly outside the frame"]
    lo_out = (outside[..., :2] < 0).any(-1)
    hi_out = (outside[..., 2] > hw[1]) | (outside[..., 3] > hw[0])
    assert lo_out.any() and hi_out.any()
    _, _, residues, _ = cases["x0 at every residue mod 16"]
    assert sorted(set(residues[0, :, 0] % 16)) == list(range(16))
    _, _, wide, _ = cases[f"one crop {w} px wide"]
    assert wide[0, 0, 2] - wide[0, 0, 0] == w
    label, hw, _, _ = EDGES[-1]
    assert (3 * hw[1]) % 16 != 0, label
    _, hw, empty, o = cases["empty boxes"]
    assert ((empty[..., 2] <= empty[..., 0]) | (empty[..., 3] <= empty[..., 1])).all()
    got = tfused.crop_resize_area_fused(torch.from_numpy(frames_for(hw, 0)),
                                        torch.from_numpy(empty), o, src_hw=hw)
    assert not got.any()


@pytest.mark.parametrize("out_size", [24, 48])
def test_crop_source_of_the_exact_chain_matches_jax(out_size):
    """The cascade's K5 crop source (``use_fused_crops=1`` at q=1: the
    frames themselves, no planar copy) against the JAX cascade's stage
    crops on the same frames and boxes."""
    rng = np.random.default_rng(out_size)
    h, w = 72, 104
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    xy = rng.uniform(-20, 90, (2, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(3, 60, (2, 6, 2))], -1).astype(np.float32)
    src = tmtcnn.prep_crop_frames(torch.from_numpy(frames), MTCNNConfig(use_fused_crops=1),
                                  torch.float32)
    assert src.integral is None  # K5 reads the frames themselves
    got = tmtcnn._stage_crops(src, torch.from_numpy(boxes), out_size).numpy()
    frames_chw, fused, quant, crop_dtype = jmtcnn._prep_crop_frames(
        jnp.asarray(frames), JMTCNNConfig(use_fused_crops=1), dtype=jnp.float32, precision=None)
    want = jmtcnn._stage_crops(frames_chw, jnp.asarray(boxes), w, h, out_size, crop_dtype,
                               frames_fused=fused, quant=quant)
    np.testing.assert_array_equal(got, np.asarray(want))
