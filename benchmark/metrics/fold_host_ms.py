"""fold_host_ms: host milliseconds of one call of ``Detector.track_fold``
(one batch of a multi-face analysis), from the benchmark's span around
that method, averaged over the calls after the trace (the profiler's
overhead left out)."""


def read(cell, out):
    spans = out.spans.get("track_fold") or []
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
