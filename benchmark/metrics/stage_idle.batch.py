"""stage_idle.batch: the share (%) of the traced window in which the first
card was idle while ``detector.stage`` was the innermost program range open
on the window's thread.
(``benchmark.program_spans``; None without the span.)"""

from benchmark.program_spans import idle_share


def read(cell, out):
    return idle_share(out, "detector.stage")
