"""crop380_roofline: the least time of the traced part's launches of the
classifier's crop kernel K7 over their device time in the trace
(``crop_classifier_kernel``), as a share (%).  The least bytes of a launch
(``counts.dfdc.k7_bytes``): its bf16 output, every row of the batch, and
each valid crop's grown source rectangle read once, from the boxes and
masks of the traced clips' answers; over the HBM bandwidth.  None without
K7 in the trace or without the classifier's answers."""

from benchmark.counts import HBM_BYTES_PER_S

KERNEL = "crop_classifier_kernel"


def read(cell, out):
    from benchmark.counts.dfdc import k7_bytes

    s = out.trace_summary
    units = out.units[:out.traced_units]
    if s is None or not units or any(len(u.result) < 4 for u in units):
        return None
    device = sum(sec for name, sec, _ in s.device_ops if KERNEL in name)
    if device <= 0:
        return None
    mix, batch = cell.traffic, cell.config["detector"]["frame_batch"]
    nbytes = sum(sum(k7_bytes(u.result, u.frames, batch, cell.config["classifier"],
                              mix["height"], mix["width"])) for u in units)
    return 100.0 * nbytes / HBM_BYTES_PER_S / device
