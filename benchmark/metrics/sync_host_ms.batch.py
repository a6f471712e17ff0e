"""sync_host_ms.batch: host milliseconds of the program's ``detector.sync``
spans (the propagate cycle's count syncs) per sampled frame, over the clips
after the trace.
(``benchmark.program_spans``; None without the span.)"""

from benchmark.program_spans import host_ms_per_frame


def read(cell, out):
    return host_ms_per_frame(out, "detector.sync")
