"""Kernel K5's plain version (``truely_tpu_torch/ops/crop_area_fused.py``)
against the JAX package's fused stage-crop kernel in interpret mode and the
port's own exact area crop: the bin sums are exact integers and the one
float32 division is the same expression, so the results must be equal,
bit for bit."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from truely_tpu.ops.crop_area_fused import (
    crop_resize_area_fused as j_crop_fused,
    prep_frames_for_fused_crops as j_prep,
)
from truely_tpu_torch.ops import crop_area_fused as tfused
from truely_tpu_torch.ops import resize as tresize

torch.set_num_threads(2)


def edge_bounds(rng, b, k, w, h):
    """Random boxes inside the frame with the edge cases of the JAX
    package's fused-kernel test in the first six slots."""
    x0 = rng.integers(0, w, (b, k))
    y0 = rng.integers(0, h, (b, k))
    x1 = np.minimum(w, x0 + rng.integers(0, w, (b, k)))
    y1 = np.minimum(h, y0 + rng.integers(0, h, (b, k)))
    bounds = np.stack([x0, y0, x1, y1], axis=-1).astype(np.int32)
    bounds[:, 0] = [0, 0, w, h]          # full frame
    bounds[:, 1] = [3, 5, 4, 6]          # single pixel
    bounds[:, 2] = [7, 2, 7, 9]          # empty (x0 == x1)
    bounds[:, 3] = [0, 0, 1, h]          # full-height sliver
    bounds[:, 4] = [0, 0, w, 1]          # full-width sliver
    bounds[:, 5] = [w - 2, h - 2, w, h]  # bottom-right corner
    return bounds


def port_fused(frames, bounds, o):
    h, w = frames.shape[1:3]
    return tfused.crop_resize_area_fused(torch.from_numpy(frames), torch.from_numpy(bounds), o,
                                         src_hw=(h, w)).numpy()


SHAPES = [
    (40, 56, 8, 24),    # small frame, R-Net size
    (40, 56, 8, 48),    # O-Net size: bins wider than the crop, pixels in several bins
    (72, 96, 16, 24),
    (131, 200, 6, 24),  # sides that are no multiple of 128
]


@pytest.mark.parametrize("h,w,k,o", SHAPES)
def test_fused_matches_jax_interpret(h, w, k, o):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    bounds = edge_bounds(rng, 2, k, w, h)
    ref = j_crop_fused(j_prep(jnp.transpose(jnp.asarray(frames), (0, 3, 1, 2))),
                       jnp.asarray(bounds), o, src_hw=(h, w), interpret=True)
    np.testing.assert_array_equal(port_fused(frames, bounds, o), np.asarray(ref))


@pytest.mark.parametrize("h,w,k,o", SHAPES)
def test_fused_matches_exact_area_crop(h, w, k, o):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    bounds = edge_bounds(rng, 2, k, w, h)
    want = tresize.crop_resize_area_plain(torch.from_numpy(frames), torch.from_numpy(bounds),
                                          o, quant=1).numpy()
    got = port_fused(frames, bounds, o)
    np.testing.assert_array_equal(got, want)
    assert not got[:, 2].any()  # the empty box gives zeros


def test_fused_max_value_pixels_exact():
    """All-255 frames: the largest bin sums, and every nonempty bin is 255."""
    h, w, o = 64, 128, 24
    frames = np.full((1, h, w, 3), 255, dtype=np.uint8)
    bounds = np.array([[[0, 0, w, h], [1, 1, w - 1, h - 1], [0, 0, 5, 64],
                        [3, 7, 100, 20]]], dtype=np.int32)
    ref = j_crop_fused(j_prep(jnp.transpose(jnp.asarray(frames), (0, 3, 1, 2))),
                       jnp.asarray(bounds), o, src_hw=(h, w), interpret=True)
    got = port_fused(frames, bounds, o)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert np.all(got == 255.0)


def test_fused_wrapper_plain_on_cpu_raises_elsewhere():
    """On a CPU tensor the wrapper takes the plain version (no launch is
    counted); on any other device it must reach the kernel or raise."""
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (1, 16, 20, 3), dtype=np.uint8)
    bounds = np.array([[[2, 3, 15, 14]]], np.int32)
    before = tfused.crop_resize_area_fused.launches
    got = tfused.crop_resize_area_fused(torch.from_numpy(frames), torch.from_numpy(bounds), 4,
                                        src_hw=(16, 20))
    want = tfused.crop_resize_area_fused_plain(torch.from_numpy(frames),
                                               torch.from_numpy(bounds), 4, src_hw=(16, 20))
    assert torch.equal(got, want)
    assert tfused.crop_resize_area_fused.launches == before
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="CUDA"):
        tfused.crop_resize_area_fused(torch.zeros((1, 8, 8, 3), dtype=torch.uint8, **meta),
                                      torch.zeros((1, 1, 4), dtype=torch.int32, **meta), 4,
                                      src_hw=(8, 8))


def test_fused_rejects_bad_inputs():
    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    bounds = torch.zeros((1, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="src_hw"):
        tfused.crop_resize_area_fused(frames, bounds, 4, src_hw=(8, 9))
    with pytest.raises(ValueError):  # float frames
        tfused.crop_resize_area_fused(frames.float(), bounds, 4, src_hw=(8, 8))
    with pytest.raises(ValueError):  # planar (B, C, H, W) frames are no longer taken
        tfused.crop_resize_area_fused(torch.zeros((1, 3, 8, 8), dtype=torch.uint8), bounds, 4,
                                      src_hw=(3, 8))
