"""dfdc_step_mfu: the whole step's share (%) of the cards' bf16 peak,
computed as ``step_mfu`` is, with the classifier: the operations the
sampled frames after the trace need (the model's ``row_flops``), plus the
valid crops' operations through every member (``counts.dfdc``), over the
time from the trace's end and the peak of the cards used."""

from benchmark import spec
from benchmark.closed_loop import frame_rows
from benchmark.counts import BF16_FLOPS_PER_S


def read(cell, out):
    from benchmark.counts.dfdc import crop_flops, valid_crops

    units = out.units[out.traced_units:]
    if not units:
        return None
    det, mix, cls = cell.config["detector"], cell.traffic, cell.config["classifier"]
    per_row = spec.model(cell.config).row_flops(det, mix["height"], mix["width"])
    total = sum(n * per_row[kind] for u in units
                for kind, n in frame_rows(u.frames, det["frame_batch"],
                                          det["detect_interval"]).items())
    total += (sum(valid_crops(u.result) for u in units) * crop_flops(cls["input_size"])
              * cls["ensemble"])
    return 100.0 * total / (out.window_s - out.host_from) / (BF16_FLOPS_PER_S * out.cards)
