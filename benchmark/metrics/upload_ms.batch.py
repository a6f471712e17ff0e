"""upload_ms.batch: device milliseconds per sampled frame of the copies
from the host to the device (the trace's ``Memcpy HtoD`` operations,
on every card), over the sampled frames of the traced clips.  The copy's
own time on the device: not the host's staging, nor its wait for the
kernels that are queued before it."""

PREFIX = "Memcpy HtoD"


def read(cell, out):
    s = out.trace_summary
    frames = sum(u.frames for u in out.units[:out.traced_units])
    if s is None or not frames:
        return None
    copy_s = sum(sec for name, sec, _ in s.device_ops if name.startswith(PREFIX))
    return 1e3 * copy_s / frames if copy_s > 0 else None
