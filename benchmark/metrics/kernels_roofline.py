"""kernels_roofline: the least time of every K1-K4 launch in the traced
part (the model's ``step_forms``: bytes and operations from shapes, without
the terms that depend on the boxes; ``benchmark.counts.kernels``) over the
device time of those kernels in the trace, as a share (%).

The launches are worked out from the frame steps of the traced clips and
must equal the launch counters of ``outcome.COUNTERS``; where they do not
(the program took another path), or K5 launched, the metric is not read."""

from benchmark import spec
from benchmark.counts.kernels import KERNEL_NAMES, bound_s, launches_of

COUNTER = {"crop_resize_area": "crop_resize_area_from_integral"}


def read(cell, out):
    s = out.trace_summary
    if s is None or not out.traced_units or not out.launches:
        return None
    det, mix = cell.config["detector"], cell.traffic
    dp = cell.config["dp"]
    rows = det["frame_batch"] // dp
    step_forms = spec.model(cell.config).step_forms
    expected = {name: 0 for name in out.launches}
    bound = 0.0
    for u in out.units[:out.traced_units]:
        for kind, n in u.steps.items():
            forms = step_forms(det, kind, rows, mix["height"], mix["width"])
            bound += n * dp * sum(bound_s(b, o) for _, b, o in forms)
            for name, count in launches_of(forms).items():
                name = COUNTER.get(name, name)
                expected[name] = expected.get(name, 0) + n * dp * count
    if expected != out.launches:
        return None
    names = [n for group in KERNEL_NAMES.values() for n in group]
    device = sum(sec for name, sec, _ in s.device_ops if any(n in name for n in names))
    return 100.0 * bound / device if device > 0 else None
