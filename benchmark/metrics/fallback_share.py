"""fallback_share: the share (%) of propagate steps whose segment the
propagate fallback re-ran through the full step (``Detector.
fallback_segments``), over the window's clips."""


def read(cell, out):
    segments = sum(u.steps.get("propagate", 0) for u in out.units)
    if not segments:
        return None
    return 100.0 * sum(u.fallback for u in out.units) / segments
