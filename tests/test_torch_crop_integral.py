"""Kernel K3 in two steps, the prep ``crop_area_integral`` and the crop
``crop_resize_area_from_integral`` (``truely_tpu_torch/ops/resize.py``),
against the JAX package on the CPU; the cascade's crop source; and the
prepared-function cache of the kernels' launch path.

The bin sums are exact integers and the one float32 division is the same
expression, so every comparison is bit for bit."""

import ctypes

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from truely_tpu.ops import resize as jresize
from truely_tpu.ops.boxes import pad_crop_bounds as j_pad_crop_bounds
from truely_tpu_torch.config import MTCNNConfig
from truely_tpu_torch.ops import cuda_build
from truely_tpu_torch.ops import resize as tresize
from truely_tpu_torch.ops.boxes import pad_crop_bounds
from truely_tpu_torch.pipeline import mtcnn as tmtcnn

torch.set_num_threads(2)


def edge_case(seed, h, w, b=2, k=10):
    """Seeded frames and clipped bounds of random boxes, with an empty box,
    one entirely outside the frame and the whole frame in the first three
    slots."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, h, w, 3), np.uint8)
    x0 = rng.uniform(-20, w, (b, k))
    y0 = rng.uniform(-20, h, (b, k))
    s = rng.uniform(0, 1.2 * min(h, w), (b, k))
    boxes = np.stack([x0, y0, x0 + s, y0 + s * rng.uniform(0.5, 1.5, (b, k))], -1)
    boxes[:, 0] = [10.0, 10.0, 9.0, 50.0]         # empty after the clamp
    boxes[:, 1] = [-30.0, -30.0, -5.0, -5.0]      # entirely outside
    boxes[:, 2] = [0.0, 0.0, float(w), float(h)]  # whole frame
    bounds = np.array(j_pad_crop_bounds(jnp.asarray(boxes.astype(np.float32)), w, h))
    return frames, bounds


def block_integral(frames, q):
    """numpy restatement: int64 integral image of the q x q block sums."""
    b, h, w, c = frames.shape
    s = frames.astype(np.int64).reshape(b, h // q, q, w // q, q, c).sum(axis=(2, 4))
    out = np.zeros((b, h // q + 1, w // q + 1, c), np.int64)
    out[:, 1:, 1:] = s.cumsum(1).cumsum(2)
    return out


@pytest.mark.parametrize("hw", [(64, 88), (90, 122)])
def test_integral_q1_equals_jax_integral_image(hw):
    frames, _ = edge_case(0, *hw)
    ours = tresize.crop_area_integral(torch.from_numpy(frames), 1)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jresize.integral_image(jnp.asarray(frames))))


@pytest.mark.parametrize("q,hw", [(4, (64, 88)), (4, (92, 120)), (2, (30, 46))])
def test_integral_quant_equals_numpy_block_integral(q, hw):
    frames, _ = edge_case(1, *hw)
    ours = tresize.crop_area_integral(torch.from_numpy(frames), q).numpy()
    np.testing.assert_array_equal(ours, block_integral(frames, q))


@pytest.mark.parametrize("o", [24, 48])
@pytest.mark.parametrize("hw", [(64, 88), (90, 122)])
def test_crop_from_integral_q1_equals_jax(o, hw):
    frames, bounds = edge_case(2, *hw)
    integral = tresize.crop_area_integral(torch.from_numpy(frames), 1)
    ours = tresize.crop_resize_area_from_integral(integral, torch.from_numpy(bounds), o).numpy()
    ref = np.asarray(jresize.crop_resize_area(jresize.integral_image(jnp.asarray(frames)),
                                              jnp.asarray(bounds), o))
    np.testing.assert_array_equal(ours, ref)
    assert not ours[:, 0].any() and not ours[:, 1].any()  # empty and outside boxes give zeros


@pytest.mark.parametrize("o", [24, 48])
@pytest.mark.parametrize("hw", [(64, 88), (92, 120)])
def test_crop_from_integral_q4_equals_jax_mxu_quant(o, hw):
    frames, bounds = edge_case(3, *hw)
    integral = tresize.crop_area_integral(torch.from_numpy(frames), 4)
    ours = tresize.crop_resize_area_from_integral(integral, torch.from_numpy(bounds), o,
                                                  quant=4).numpy()
    ref = np.asarray(jresize.crop_resize_area_mxu_quant(jnp.asarray(frames), jnp.asarray(bounds),
                                                        o, quant=4))
    np.testing.assert_array_equal(ours, ref)
    assert not ours[:, 0].any() and not ours[:, 1].any()


@pytest.mark.parametrize("q", [1, 4])
def test_crop_from_wrapped_integral_is_unchanged(q):
    """The corner differences are taken modulo 2^32: an integral shifted by
    a constant past the int32 range (as a frame too large for 31 bits
    wraps) cuts the same crops."""
    frames, bounds = edge_case(4, 64, 88)
    integral = tresize.crop_area_integral(torch.from_numpy(frames), q)
    shifted = ((integral.to(torch.int64) + (2**31 + 12345)) % 2**32).to(torch.int32)
    assert (shifted < 0).any()  # some entries wrapped
    want = tresize.crop_resize_area_from_integral(integral, torch.from_numpy(bounds), 24, quant=q)
    got = tresize.crop_resize_area_from_integral(shifted, torch.from_numpy(bounds), 24, quant=q)
    assert torch.equal(got, want)


@pytest.mark.parametrize("q", [1, 4])
def test_crop_resize_area_is_the_composition(q):
    frames, bounds = edge_case(5, 64, 88)
    f, bd = torch.from_numpy(frames), torch.from_numpy(bounds)
    want = tresize.crop_resize_area_from_integral(tresize.crop_area_integral(f, q), bd, 48, quant=q)
    assert torch.equal(tresize.crop_resize_area(f, bd, 48, quant=q), want)
    assert torch.equal(tresize.crop_resize_area_plain(f, bd, 48, quant=q), want)


@pytest.mark.parametrize("fused,dtype,quant,kind", [
    (0, torch.bfloat16, 4, "integral"),   # the score path's q=4 crops
    (0, torch.float32, 1, "integral"),    # GOLDEN_CONFIG's exact crops
    (1, torch.float32, 1, "planar"),      # the exact crop chain through K5 (no planar copy now)
    (1, torch.bfloat16, 4, "integral"),   # use_fused_crops=1 does not apply at q=4
])
def test_prep_crop_frames_builds_what_its_kernel_reads(fused, dtype, quant, kind):
    frames, _ = edge_case(6, 64, 88)
    f = torch.from_numpy(frames)
    src = tmtcnn.prep_crop_frames(f, MTCNNConfig(use_fused_crops=fused), dtype)
    assert src.quant == quant
    if kind == "integral":
        assert torch.equal(src.integral, tresize.crop_area_integral(f, quant))
    else:  # K5 reads the frames themselves
        assert src.integral is None and src.frames is f
    boxes = torch.from_numpy(np.asarray(
        [[[5.0, 6.0, 40.0, 50.0], [0.0, 0.0, 88.0, 64.0]]] * 2, np.float32))
    got = tmtcnn._stage_crops(src, boxes, 24)
    want = tresize.crop_resize_area_plain(
        f, pad_crop_bounds(boxes, 88, 64), 24, quant=quant)
    assert torch.equal(got, want)


def test_new_wrappers_reject_bad_inputs():
    frames = torch.zeros((1, 8, 12, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="quant"):
        tresize.crop_area_integral(frames, 5)
    with pytest.raises(ValueError):
        tresize.crop_area_integral(frames.float(), 1)
    integral = tresize.crop_area_integral(frames, 4)
    with pytest.raises(ValueError):
        tresize.crop_resize_area_from_integral(integral.long(), torch.zeros((1, 1, 4)), 4, quant=4)
    with pytest.raises(ValueError):
        tresize.crop_resize_area_from_integral(integral, torch.zeros((2, 1, 4)), 4, quant=4)


# ---------------------------------------------------------------------------
# The launch path's prepared functions, with a stand-in library


class StandInFn:
    """A ctypes function stand-in: counts how often its argtypes are set
    and returns the queued codes."""

    def __init__(self, codes):
        self.codes, self.calls, self.argtypes_set = list(codes), [], 0
        self.restype = None
        self._argtypes = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.argtypes_set += 1
        self._argtypes = value

    def __call__(self, *args):
        self.calls.append(args)
        return self.codes.pop(0)


class StandInLib:
    def __init__(self, codes):
        self.fn, self.lookups = StandInFn(codes), 0

    def __getattr__(self, name):
        if name != "tt_stand_in":
            raise AttributeError(name)
        self.lookups += 1
        return self.fn

    def tt_error_string(self, code):
        return f"stand-in error {code}".encode()


@pytest.fixture
def stand_in(monkeypatch):
    lib = StandInLib([0, 0, 0, 0, 7])
    guards = []

    class Guard:
        def __init__(self, index):
            guards.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setitem(cuda_build._libs, "stand_in", lib)
    monkeypatch.setattr(cuda_build, "_fns", {})
    monkeypatch.setattr(cuda_build, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(cuda_build, "_current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    return lib, guards


def test_launch_resolves_each_symbol_once_and_raises_on_error(stand_in):
    lib, guards = stand_in
    argtypes = [cuda_build.P, cuda_build.I]
    for i in range(3):
        cuda_build.launch("stand_in", "tt_stand_in", argtypes, 11, i, device=torch.device("cuda", 0))
    assert lib.lookups == 1 and lib.fn.argtypes_set == 1
    assert lib.fn.argtypes == [cuda_build.P, cuda_build.I, cuda_build.P]
    assert lib.fn.restype is ctypes.c_int
    assert lib.fn.calls == [(11, 0, 1000), (11, 1, 1000), (11, 2, 1000)]
    assert guards == []  # the current device: no guard entered
    cuda_build.launch("stand_in", "tt_stand_in", argtypes, 12, 3, device=torch.device("cuda", 1))
    assert guards == [1] and lib.fn.calls[-1] == (12, 3, 1001)
    with pytest.raises(RuntimeError, match="tt_stand_in: CUDA error 7: stand-in error 7"):
        cuda_build.launch("stand_in", "tt_stand_in", argtypes, 13, 4, device=torch.device("cuda", 0))
    assert lib.lookups == 1 and lib.fn.argtypes_set == 1
