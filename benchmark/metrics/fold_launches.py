"""fold_launches: device operations launched while ``tracks.fold`` was the
innermost program range, per call of the track fold in the traced clips.
(``benchmark.program_spans``; None without the span.)"""

from benchmark.program_spans import launches_per_call


def read(cell, out):
    return launches_per_call(out, "tracks.fold")
