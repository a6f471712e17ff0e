"""classifier_device_ms.batch: device milliseconds of the operations launched
while ``classifier.net`` (the ensemble's forwards) was the innermost program
range, per sampled frame of the traced clips.
(``benchmark.program_spans``; None without the span.)"""

from benchmark.program_spans import device_ms_per_frame


def read(cell, out):
    return device_ms_per_frame(out, "classifier.net")
