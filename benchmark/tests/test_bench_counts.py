"""``benchmark.counts`` against operations and bytes counted by hand, and
the roofline sum of ``metrics/kernels_roofline.py``."""

import copy
import json
import os

import pytest

from benchmark import spec
from benchmark.closed_loop import steps_of
from benchmark.counts import BF16_FLOPS_PER_S, HBM_BYTES_PER_S, kernels, nets
from benchmark.outcome import Outcome
from benchmark.trace import TraceSummary

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "facenet_single.json")


def detector(**kw):
    with open(CONFIG) as f:
        d = json.load(f)["detector"]
    d.update(kw)
    return d


def conv_flops(h, w, cin, cout, k, stride=1):
    """2 x multiply-adds of a valid convolution, by hand."""
    oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    return 2 * oh * ow * cout * cin * k * k


def test_pnet_trunk_by_hand():
    import torch

    from benchmark.reference.mtcnn_nets import PNet

    with torch.device("meta"):
        p = PNet()
        got = nets.flops(lambda: p.trunk(torch.empty(1, 100, 120, 3), torch.bfloat16))
    # conv1 3->10 k3, ceil pool 2x2, conv2 10->16 k3, conv3 16->32 k3, conv4_1 32->2 k1
    want = (conv_flops(100, 120, 3, 10, 3) + conv_flops(49, 59, 10, 16, 3)
            + conv_flops(47, 57, 16, 32, 3) + conv_flops(45, 55, 32, 2, 1))
    assert got == want == 37_086_480


def test_rnet_by_hand():
    import torch

    from benchmark.reference.mtcnn_nets import RNet

    with torch.device("meta"):
        r = RNet()
        got = nets.flops(lambda: r(torch.empty(5, 24, 24, 3), torch.bfloat16))
    # conv 3->28 k3 (22), pool 3/2 ceil (11), conv 28->48 k3 (9), pool 3/2 (4), conv 48->64 k2 (3)
    want = 5 * (conv_flops(24, 24, 3, 28, 3) + conv_flops(11, 11, 28, 48, 3)
                + conv_flops(4, 4, 48, 64, 2) + 2 * (576 * 128 + 128 * 2 + 128 * 4))
    assert got == want


def test_pyramid_bin_sums_by_hand():
    m = {"min_face_size": 20, "scale_factor": 0.709}
    # 40x60: scales 0.6 (25x37), 0.4254 (18x26), 0.3016 (13x19); 40 * 0.6 * 0.709^3 < 12
    cascade = nets.pyramid_bin_sums(40, 60, m, cascade=True)
    assert cascade == 3 * 60 * (40 + 25) + 3 * 37 * (25 + 18) + 3 * 26 * (18 + 13)
    direct = nets.pyramid_bin_sums(40, 60, m, cascade=False)
    assert direct == 3 * 60 * (40 + 25) + 3 * 60 * (40 + 18) + 3 * 60 * (40 + 13)


def test_steps_add_up():
    rows = nets.row_flops(detector(), 120, 160)
    assert rows["full"] > rows["detect"] > rows["propagate"] > 0
    multi = nets.row_flops(detector(multi_face=True), 120, 160)
    # four faces embedded, no landmark head
    assert multi["detect"] == rows["detect"] and multi["full"] != rows["full"]


def test_kernel_bytes_by_hand():
    assert kernels.k1(2, 4, 6) == (2 * 6 * 6 + 2 * 4 * 6 * 3, 2 * 4 * 6 * 3 * 4)
    assert kernels.k2(2, 8, True) == (2 * 8 * 26, 0.0)
    assert kernels.k3_crop(1, 2, 3) == (1 * 2 * 16 + 2 * 9 * 12, 2 * 9 * 3)
    assert kernels.bound_s(HBM_BYTES_PER_S, 0) == 1.0
    forms = kernels.step_forms(detector(), "full", 32, 1080, 1920, yuv=True)
    assert kernels.launches_of(forms) == {
        "i420_to_bgr": 1, "nms_masked_batch": 4, "crop_resize_area": 2,
        "crop_resize_bilinear": 1, "crop_area_integral": 1}
    bound_ms = 1e3 * sum(kernels.bound_s(b, o) for _, b, o in forms)
    assert bound_ms == pytest.approx(0.1027, abs=5e-4)  # K1 0.0891 + K3 0.0127 + ...


def outcome(**kw):
    base = dict(setup_s=1.0, window_s=10.0, units=[], traced_units=0, host_from=0.0,
                launches={}, spans={}, trace_summary=None, numbers={}, limits={}, attempted=0,
                failed=0, memory_peak_bytes=0, cards=1, checked=0)
    base.update(kw)
    return Outcome(**base)


class U:
    def __init__(self, frames, k=1, fallback=0):
        self.frames, self.fallback = frames, fallback
        self.steps = steps_of(frames, 32, k, fallback)


def cell(**det):
    c = spec.load("single_1080p_i420")
    c = c._replace(config=copy.deepcopy(c.config))
    c.config["detector"].update(det)
    return c


def test_roofline_sums_bound_over_device_time():
    c = cell()
    units = [U(64), U(40)]  # 2 + 2 full steps
    forms = kernels.step_forms(c.config["detector"], "full", 32, 1080, 1920, yuv=True)
    bound = 4 * sum(kernels.bound_s(b, o) for _, b, o in forms)
    launches = {"i420_to_bgr": 4, "nms_masked_batch": 16, "crop_area_integral": 4,
                "crop_resize_area_from_integral": 8, "crop_resize_bilinear": 4,
                "crop_resize_area_fused": 0}
    ops = [("void i420_to_bgr_kernel<false>(...)", 0.001, 4), ("nms_kernel", 0.0005, 16),
           ("crop_area_kernel", 0.0007, 8), ("integral_rows_kernel", 0.0002, 4),
           ("integral_cols_kernel", 0.0002, 4), ("crop_bilinear_kernel", 0.0001, 4),
           ("ampere_bf16_gemm", 0.5, 100)]
    s = TraceSummary(1.0, 0.6, 1, ops, [])
    read = spec.metric_reader("kernels_roofline")
    got = read(c, outcome(units=units, traced_units=2, launches=launches, trace_summary=s))
    assert got == pytest.approx(100 * bound / 0.0027)
    # the launches do not match the steps (another path ran): not read
    off = dict(launches, crop_resize_area_fused=4)
    assert read(c, outcome(units=units, traced_units=2, launches=off, trace_summary=s)) is None
    assert read(c, outcome(units=units, traced_units=0, launches=launches, trace_summary=s)) \
        is None


def test_step_mfu_counts_every_sampled_frame_of_the_window():
    c = cell()
    units = [U(64), U(40)]
    rows = nets.row_flops(c.config["detector"], 1080, 1920)
    got = spec.metric_reader("step_mfu")(c, outcome(units=units, window_s=2.0))
    assert got == pytest.approx(100 * 104 * rows["full"] / 2.0 / BF16_FLOPS_PER_S)
    k4 = [U(200, k=4, fallback=1)]  # 7 segments: 2 seed steps, 7 propagate, 1 fallback
    assert k4[0].steps == {"full": 1, "detect": 2, "propagate": 7}
    assert spec.metric_reader("fallback_share")(c, outcome(units=k4)) == pytest.approx(100 / 7)
    c4 = cell(detect_interval=4)
    rows4 = nets.row_flops(c4.config["detector"], 1080, 1920)
    # 6 full segments of 32 and one of 8: 6 x 8 + 2 keyframes; the fallback is not counted
    want = 50 * rows4["detect"] + 200 * rows4["propagate"]
    got = spec.metric_reader("step_mfu")(c4, outcome(units=k4, window_s=2.0))
    assert got == pytest.approx(100 * want / 2.0 / BF16_FLOPS_PER_S)
