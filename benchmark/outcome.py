"""What a run found, and its result line.

Every metric, end to end or per layer, is read by ``metrics/<name>.py``
(``read(cell, outcome)``, a number or None); a per-layer reader that
finds nothing to read returns None and the metric is left out of the
line.  The compared numbers go last: on standard error, one line each,
and under ``checks`` at the end of the result line.
"""

from __future__ import annotations

import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

from benchmark import check, spec
from benchmark.trace import TraceSummary

# Modules that may not be loaded in the process that prints a result,
# compared by their whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "truely_tpu", "chip_smoke")
# The launch counters of the port's kernel wrappers (``<fn>.launches``).
COUNTERS = {
    "i420_to_bgr": ("truely_tpu_torch.ops.yuv", "i420_to_bgr"),
    "nms_masked_batch": ("truely_tpu_torch.ops.nms", "nms_masked_batch"),
    "crop_area_integral": ("truely_tpu_torch.ops.resize", "crop_area_integral"),
    "crop_resize_area_from_integral": ("truely_tpu_torch.ops.resize",
                                       "crop_resize_area_from_integral"),
    "crop_resize_bilinear": ("truely_tpu_torch.ops.resize", "crop_resize_bilinear"),
    "crop_resize_area_fused": ("truely_tpu_torch.ops.crop_area_fused", "crop_resize_area_fused"),
}


class Outcome(NamedTuple):
    setup_s: float
    window_s: float
    units: list                  # closed loop: the clips analysed in the window
    traced_units: int            # how many of them the trace covers
    host_from: float             # seconds into the window at which the trace had stopped
    launches: Dict[str, int]     # kernel launches in the traced part
    spans: Dict[str, List[float]]  # after the trace: span name -> each span's host seconds
    trace_summary: Optional[TraceSummary]
    numbers: Dict[str, float]    # what the check compared
    limits: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    cards: int
    checked: int                 # clips the reference checked
    control: Optional[Dict[str, float]] = None  # the control's numbers (calibration only)


def kernel_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count so far."""
    import importlib

    return {name: getattr(getattr(importlib.import_module(mod), fn), "launches", 0)
            for name, (mod, fn) in COUNTERS.items()}


def forbidden_modules() -> List[str]:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def report(cell: spec.Cell, out: Outcome, traced: bool) -> Tuple[dict, List[str]]:
    """(the result line, the check's lines for standard error)."""
    import torch

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric_reader(m["name"])(cell, out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": out.cards,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": check.judge(out.numbers, out.limits), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    s = out.trace_summary
    if traced and s is not None:
        device["busy_s"] = s.busy_s
        device["window_s"] = s.window_s
        line["breakdown"] = {
            "device_ops": [[name, sec] for name, sec, _ in s.device_ops[:10]],
            "idle_gaps": [[label, sec] for label, sec in s.idle_gaps[:10]]}
    line["checks"] = {k: {"value": out.numbers.get(k), "limit": v}
                      for k, v in out.limits.items()}
    lines = [f"checked {out.checked} of {out.attempted}"] + check.lines(out.numbers, out.limits)
    return line, lines
