"""step_mfu: the whole frame step's share (%) of the cards' bf16 peak:
the operations that the window's sampled frames need (counted from the
configuration's shapes by its model's ``row_flops``, per frame and kind
of step, padding and fallback re-runs left out) over the time they took
and the peak of the cards used.  In a traced run, only the clips after
the trace are counted, over the time from the trace's end."""

from benchmark import spec
from benchmark.closed_loop import frame_rows
from benchmark.counts import BF16_FLOPS_PER_S


def read(cell, out):
    units = out.units[out.traced_units:]
    if not units:
        return None
    det, mix = cell.config["detector"], cell.traffic
    per_row = spec.model(cell.config).row_flops(det, mix["height"], mix["width"])
    k = det["detect_interval"]
    total = sum(n * per_row[kind] for u in units
                for kind, n in frame_rows(u.frames, det["frame_batch"], k).items())
    return 100.0 * total / (out.window_s - out.host_from) / (BF16_FLOPS_PER_S * out.cards)
