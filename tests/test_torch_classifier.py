"""The DFDC winner's classifier on the port's multi-face path
(github.com/selimsef/dfdc_deepfake_challenge):

- K7's plain version (``ops/crop_classifier.py``) against a transcript of
  the solution's ``isotropically_resize_image`` and ``put_to_center``
  through ``cv2.resize``, on boxes that shrink, grow, touch each edge and
  grow to a long side of exactly 380: within 1 on the 0-255 scale (cv2
  rounds its area sums in float, half to even, and its vertical cubic sum
  in float with FMA; the port's arithmetic is exact integers), and equal
  to the benchmark reference's crop (``benchmark/reference/dfdc.py``) bit
  for bit;
- ``confident_strategy`` against a transcript of the solution's on
  hand-made probability lists, each branch and the float floor of
  ``len // 2.5``;
- the port's EfficientNet-B7 at its published widths against the float32
  reference (``benchmark/reference/efficientnet.py``) on seeded weights,
  whole at 64x64 and one MBConv block of each form;
- the seeded init's logits spread by about 1;
- the stage in ``analyze_frames_tracks``: with the classifier unset the
  analysis returns and launches what it did; set, it adds its result and
  its counters and leaves the tracks alone.
"""

import cv2
import numpy as np
import pytest
import torch

from benchmark.reference import dfdc as ref_dfdc
from truely_tpu_torch.config import ClassifierConfig, DetectorConfig, MTCNNConfig
from truely_tpu_torch.models import efficientnet as E
from truely_tpu_torch.models.weights import params_to_numpy
from truely_tpu_torch.ops import crop_classifier as K7
from truely_tpu_torch.pipeline import classifier as C
from truely_tpu_torch.pipeline import detector as D

SIZE = 380


# --- the solution's code, transcribed (kernel_utils.py, FaceExtractor) ---

def isotropically_resize_image(img, size, interpolation_down=cv2.INTER_AREA,
                               interpolation_up=cv2.INTER_CUBIC):
    h, w = img.shape[:2]
    if max(w, h) == size:
        return img
    if w > h:
        scale = size / w
        h = h * scale
        w = size
    else:
        scale = size / h
        w = w * scale
        h = size
    interpolation = interpolation_up if scale > 1 else interpolation_down
    resized = cv2.resize(img, (int(w), int(h)), interpolation=interpolation)
    return resized


def put_to_center(img, input_size):
    img = img[:input_size, :input_size]
    image = np.zeros((input_size, input_size, 3), dtype=np.uint8)
    start_w = (input_size - img.shape[1]) // 2
    start_h = (input_size - img.shape[0]) // 2
    image[start_h:start_h + img.shape[0], start_w: start_w + img.shape[1], :] = img
    return image


def solution_crop(frame, bbox):
    xmin, ymin, xmax, ymax = [int(b) for b in bbox]
    w = xmax - xmin
    h = ymax - ymin
    p_h = h // 3
    p_w = w // 3
    crop = frame[max(ymin - p_h, 0):ymax + p_h, max(xmin - p_w, 0):xmax + p_w]
    return put_to_center(isotropically_resize_image(crop, SIZE), SIZE)


def confident_strategy(pred, t=0.8):
    pred = np.array(pred)
    sz = len(pred)
    fakes = np.count_nonzero(pred > t)
    # 11 frames are detected as fakes with high probability
    if fakes > sz // 2.5 and fakes > 11:
        return np.mean(pred[pred > t])
    elif np.count_nonzero(pred < 0.2) > 0.9 * sz:
        return np.mean(pred[pred < 0.2])
    else:
        return np.mean(pred)


# --- K7 -------------------------------------------------------------------

H, W = 720, 1280
# (x0, y0, x1, y1) float boxes: their grown crops shrink, grow, touch each
# edge, come out wide or tall, and reach a long side of exactly 380
# (228 px grown by 2 x 76).
BOXES = {
    "shrink": (400.7, 150.2, 820.9, 600.4),
    "grow": (600.3, 300.8, 680.1, 390.6),
    "grow_wide": (100.5, 500.5, 260.2, 540.9),
    "left_top": (-30.6, -12.2, 150.3, 160.7),
    "right_bottom": (1150.2, 610.9, 1290.4, 735.1),
    "full_height": (500.0, 5.0, 900.0, 715.0),
    "long_380": (300.2, 200.9, 528.9, 428.4),
    "tiny": (50.9, 60.2, 53.1, 63.8),
}


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(20261019)
    blocks = rng.integers(0, 256, (H // 8, W // 8, 3), np.uint8)
    smooth = np.repeat(np.repeat(blocks, 8, 0), 8, 1).astype(np.int16)
    return np.clip(smooth + rng.integers(-20, 21, (H, W, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(BOXES))
def test_crop_against_cv2_and_the_reference(frame, name):
    box = BOXES[name]
    frames = torch.from_numpy(frame)[None]
    boxes = torch.tensor([[box]], dtype=torch.float32)
    canvas, filled = K7.crop_classifier_u8(frames, boxes, torch.ones((1, 1), dtype=torch.bool),
                                           SIZE, 3)
    got = canvas[0].numpy()
    assert bool(filled[0])
    want = solution_crop(frame, np.float32(box))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.array_equal(got, ref_dfdc.crop_u8(frame, np.float32(box), SIZE, 3))


def test_long_side_380_is_copied(frame):
    g = K7.geometry(np.float32(BOXES["long_380"]), H, W, SIZE, 3)
    assert (g.y1 - g.y0, g.x1 - g.x0) == (380, 380) and (g.nh, g.nw) == (380, 380)
    assert np.array_equal(frame[g.y0:g.y1, g.x0:g.x1], solution_crop(frame, BOXES["long_380"]))


def test_crop_normalised_and_masked(frame):
    """Two frames of two slots, one masked: the masked slot is zeros, the
    others the reference's normalised crops rounded to bf16 (RGB from BGR)."""
    frames = torch.from_numpy(np.stack([frame, frame[::-1].copy()]))
    names = ("shrink", "grow", "left_top", "right_bottom")
    boxes = torch.tensor([[BOXES[n] for n in names[:2]], [BOXES[n] for n in names[2:]]],
                         dtype=torch.float32)
    mask = torch.tensor([[True, False], [True, True]])
    out = K7.crop_classifier(frames, boxes, mask, SIZE, 3, rgb_in=False)
    assert out.shape == (4, SIZE, SIZE, 3) and out.dtype == torch.bfloat16
    assert not out[1].any()
    for slot, (i, k) in ((0, (0, 0)), (2, (1, 0)), (3, (1, 1))):
        canvas = ref_dfdc.crop_u8(frames[i].numpy(), boxes[i, k].numpy(), SIZE, 3)
        want = ref_dfdc.normalise(canvas[None], rgb_in=False)[0]
        assert torch.equal(out[slot], want.to(torch.bfloat16))


@pytest.mark.parametrize("src,dst", [(41, 380), (380, 97), (1000, 380), (7, 9)])
def test_resize_weights_rows(src, dst):
    """Each area row sums to the source length (a mean), each cubic row to
    2048 (cv2 keeps the fixed-point coefficients' sum where they are not
    rounded apart by more than one)."""
    assert (K7.area_weights(src, dst).sum(1) == src).all()
    sums = K7.cubic_weights(src, dst).sum(1)
    assert (np.abs(sums - 2048) <= 2).all()


# --- the strategy ---------------------------------------------------------

PREDS = {
    "fakes": [0.9] * 20 + [0.1] * 10,                        # 20 > 12.0 and > 11
    "fakes_floor_at": [0.95] * 12 + [0.5] * 18,              # 12 > 30 // 2.5 fails
    "fakes_floor_past": [0.95] * 13 + [0.5] * 17,            # 13 > 12.0
    "fakes_not_11": [0.99] * 11 + [0.1],                     # 11 > 4.0 but not > 11
    "real": [0.1] * 95 + [0.5] * 5,                          # 95 > 90.0
    "real_at": [0.1] * 90 + [0.5] * 10,                      # 90 > 90.0 fails
    "mixed": [0.3, 0.6, 0.85, 0.15, 0.5],
    "one": [0.7],
}


@pytest.mark.parametrize("name", sorted(PREDS))
def test_strategy_against_the_solution(name):
    pred = np.asarray(PREDS[name], np.float32)
    want = confident_strategy(pred)
    assert C.confident_strategy(pred) == want
    assert ref_dfdc.confident_strategy(pred) == want


def test_strategy_branches_are_taken():
    def branch(name):
        return float(confident_strategy(np.float32(PREDS[name])))

    assert branch("fakes") == pytest.approx(0.9, abs=1e-6)                # the fakes' mean
    assert branch("fakes_floor_past") == pytest.approx(0.95, abs=1e-6)
    assert branch("fakes_floor_at") == pytest.approx(0.68, abs=1e-6)      # the mean of all
    assert branch("real") == pytest.approx(0.1, abs=1e-6)                 # the reals' mean
    assert branch("real_at") == pytest.approx(0.14, abs=1e-6)


def test_video_score_means_the_members():
    cfg = ClassifierConfig(ensemble=2)
    probs = np.stack([np.full((4, 2), 0.3, np.float32), np.full((4, 2), 0.9, np.float32)])
    mask = np.array([[True, False]] * 4)
    score, members = C.video_score(probs, mask, cfg)
    assert np.allclose(members, [0.3, 0.9]) and score == pytest.approx(0.6)
    assert C.video_score(probs, np.zeros_like(mask), cfg)[0] == C.NO_FACE_SCORE


# --- the net --------------------------------------------------------------

def test_published_widths():
    specs = [s for stage in E.block_specs() for s in stage]
    assert len(specs) == 55
    assert [len(stage) for stage in E.block_specs()] == [4, 7, 7, 10, 10, 13, 4]
    assert [stage[-1][1] for stage in E.block_specs()] == [32, 48, 80, 160, 224, 384, 640]
    assert [stage[0][2:] for stage in E.block_specs()] == [
        (3, 1, 1), (3, 2, 6), (5, 2, 6), (3, 2, 6), (5, 1, 6), (5, 2, 6), (3, 1, 6)]
    m = E.DeepFakeClassifier()
    assert m.encoder.conv_stem.out_channels == 64 and m.encoder.conv_head.out_channels == 2560
    assert m.fc.in_features == 2560 and m.fc.out_features == 1
    for stage, spec in zip(m.encoder.blocks, E.block_specs()):
        for blk, (cin, _cout, k, s, e) in zip(stage, spec):
            assert blk.se.conv_reduce.out_channels == max(1, cin // 4)
            assert blk.conv_dw.kernel_size == (k, k) and blk.conv_dw.stride == (s, s)
    assert 63e6 < sum(p.numel() for p in m.parameters()) < 64e6


@pytest.mark.parametrize("size,kernel,stride", [(380, 3, 2), (190, 3, 2), (95, 5, 2),
                                                (24, 5, 2), (48, 3, 1), (12, 5, 1)])
def test_same_padding_as_tensorflow(size, kernel, stride):
    lo, hi = E.same_pad(size, kernel, stride)
    out = -(-size // stride)   # TF "same": ceil(size / stride) outputs
    assert (size + lo + hi - kernel) // stride + 1 == out and hi - lo in (0, 1)


@pytest.fixture(scope="module")
def seeded():
    """A seeded member (the port's init), its param tree, and the reference
    net built from that tree."""
    torch.manual_seed(0)
    module = E.init_classifier(5)
    tree = params_to_numpy(module)
    return module, tree, ref_dfdc.net_from_tree(tree)


# Tolerances of the port's folded net against the float32 reference:
# float32, the fold reorders the batchnorm's multiply and add (the logits
# agree within 1e-5 on the seeds tried); bf16, eight bits of mantissa
# through 55 blocks (0.04-0.12 on six seeds at 64x64, logits spread by
# about 1).
F32_TOL, BF16_TOL = 1e-4, 0.25


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
def test_b7_against_the_reference(seeded, dtype, tol):
    module, tree, ref = seeded
    crops = E.calibration_crops(31, n=2, size=64, block=6)
    with torch.inference_mode():
        want = ref(crops)
        got = E.FoldedClassifier(module, dtype)(crops)
        unfolded = module(crops)
    assert got.shape == (2,) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= tol
    assert float((unfolded - want).abs().max()) <= 1e-5


FORMS = {  # a block index per (kernel, stride, expansion, residual) form
    "k3_s1_e1_first": (0, 0), "k3_s1_e1_skip": (0, 1), "k3_s2_e6": (1, 0),
    "k3_s1_e6_skip": (1, 1), "k5_s2_e6": (2, 0), "k5_s1_e6_skip": (2, 1),
    "k5_s1_e6_widen": (4, 0), "k3_s1_e6_widen": (6, 0),
}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("side", [16, 17])
def test_block_against_the_reference(seeded, form, side):
    module, _, ref = seeded
    si, bi = FORMS[form]
    folded = E.FoldedClassifier(module, torch.float32)
    offset = sum(len(s) for s in E.block_specs()[:si])
    cin = E.block_specs()[si][bi][0]
    x = torch.randn((2, cin, side, side), generator=torch.Generator().manual_seed(side))
    with torch.inference_mode():
        got = folded.block(folded.blocks[offset + bi], x)
        want = ref.encoder.blocks[si][bi](x, lambda m, y: m(y))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("seed", [107, 113])
def test_seeded_logits_spread_by_about_one(seed):
    """Not saturated: over fresh crops the logits spread by 0.3-3 and stay
    within 8 of 0, so the sigmoid reads between 3e-4 and 1 - 3e-4."""
    module = E.init_classifier(seed)
    with torch.inference_mode():
        logits = module(E.calibration_crops(seed + 1000, n=16, size=64, block=7))
    assert 0.3 <= float(logits.std()) <= 3.0 and float(logits.abs().max()) < 8.0


# --- the stage ------------------------------------------------------------

def _config(classifier):
    return DetectorConfig(frame_batch=8, compute_dtype="float32", multi_face=True, max_tracks=4,
                          detect_interval=4, mtcnn=MTCNNConfig(thresholds=(0.0, 0.0, 0.0)),
                          classifier=classifier)


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(7)
    return np.repeat(np.repeat(rng.integers(16, 236, (20, 6, 8, 3), np.uint8), 20, 1), 20, 2)


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(D, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(D, name, counted)
    return calls


def test_stage_off_and_on(monkeypatch, clip):
    off = D.Detector(_config(None), device="cpu")
    assert off.classifier is None
    k7, k1 = _counting(monkeypatch, "crop_classifier"), _counting(monkeypatch, "to_frames")
    plain = off.analyze_frames_tracks(clip, 7)
    assert len(plain) == 3 and not k7 and not k1
    cc = ClassifierConfig(input_size=32, ensemble=2, compute_dtype="float32")
    on = D.Detector(_config(cc), device="cpu")
    got = on.analyze_frames_tracks(clip, 7)
    assert len(got) == 4 and len(k7) == 3 and not k1   # 20 frames: 3 segments; BGR: no K1
    assert got[0] == plain[0] and np.array_equal(got[1], plain[1])
    for a, b in zip(got[2], plain[2]):
        assert torch.equal(a, b)
    res = got[3]
    assert res.logits.shape == (2, 20, 4) and res.mask.shape == (20, 4)
    assert on.classified_crops == int(res.mask.sum()) > 0
    assert on.classifier_rows == 20 * 4
    assert np.allclose(res.probs, 1 / (1 + np.exp(-res.logits.astype(np.float64))), atol=1e-6)
    score, members = C.video_score(res.probs, res.mask, cc)
    assert res.score == score and np.array_equal(res.member_scores, members)


def test_stage_on_i420_converts_once_per_segment(monkeypatch, clip):
    cc = ClassifierConfig(input_size=32, ensemble=1, compute_dtype="float32")
    det = D.Detector(_config(cc), device="cpu")
    packed = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420) for f in clip])
    k1 = _counting(monkeypatch, "to_frames")
    yuv = det.analyze_i420_tracks(packed, 7)
    steps = len(k1)
    assert len(yuv) == 4 and yuv[3].mask.shape == (20, 4)
    plain = D.Detector(_config(None), device="cpu")
    k1.clear()
    plain.analyze_i420_tracks(packed, 7)
    assert steps - len(k1) == 3   # one more K1 per segment, for the crops


def test_classifier_needs_the_multi_face_path():
    with pytest.raises(ValueError, match="multi-face"):
        D.Detector(DetectorConfig(classifier=ClassifierConfig(ensemble=1)), device="cpu")


# --- the CLI and the server ------------------------------------------------

def test_cli_classifier_needs_multi_face(tmp_path, capsys):
    from truely_tpu_torch import cli

    clip = tmp_path / "clip.avi"
    clip.write_bytes(b"x")
    assert cli.main(["analyze", str(clip), "--classifier", "--device", "cpu"]) == 1
    assert "--multi-face" in capsys.readouterr().err


def test_server_returns_the_classifier_score(tmp_path):
    """A classifying detector's /analyze-video adds ``classifierScore``,
    and its jobs run solo (no batch key for the grouped runner)."""
    from tests.test_torch_serve import call, make_server_obj, make_video

    class Classifying:
        config = DetectorConfig(multi_face=True, classifier=ClassifierConfig(ensemble=1))

        def run_classified(self, video_in, video_out):
            with open(video_out, "wb") as f:
                f.write(b"fake-video-bytes")
            return 17, 0.25

    server = make_server_obj(tmp_path, detector=Classifying())
    resp, payload = call(server, "POST", "/analyze-video",
                         body={"videoPath": make_video(tmp_path, "in0.mp4")})
    assert resp.status == 200 and payload["fakeScore"] == 17
    assert payload["classifierScore"] == 0.25
    plain = make_server_obj(tmp_path)
    assert "classifierScore" not in call(plain, "POST", "/analyze-video",
                                         body={"videoPath": make_video(tmp_path, "in1.mp4")})[1]
    assert server._classifying() and not plain._classifying()
