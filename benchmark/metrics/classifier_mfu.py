"""classifier_mfu: the ensemble's share (%) of the card's bf16 peak while it
ran: the valid crops of the traced clips (``counts.dfdc.valid_crops``), times
one member's operations on a crop (``counts.dfdc.crop_flops``) and the
members, over the device time launched under ``classifier.net`` and 989
TFLOP/s.  None without the span or the classifier's answers."""

from benchmark.counts import BF16_FLOPS_PER_S
from benchmark.program_spans import _row


def read(cell, out):
    from benchmark.counts.dfdc import crop_flops, valid_crops

    _, row = _row(out, "classifier.net")
    units = out.units[:out.traced_units]
    crops = sum(valid_crops(u.result) for u in units)
    if row is None or not row.launches or row.device_s <= 0 or not crops:
        return None
    cls = cell.config["classifier"]
    flops = crops * crop_flops(cls["input_size"]) * cls["ensemble"]
    return 100.0 * flops / row.device_s / BF16_FLOPS_PER_S
