"""device_idle.batch: the share (%) of the traced window in which no
operation ran on the device, averaged over the cards (closed-loop
cells)."""


def read(cell, out):
    s = out.trace_summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
