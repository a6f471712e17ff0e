"""classifier_idle.batch: the share (%) of the traced window in which the first
card was idle while a ``classifier.*`` range (``classifier.crop``,
``classifier.net``, ``classifier.score``) was the innermost program range
open on the window's thread.
(``benchmark.program_spans``; None without the spans.)"""

from benchmark.program_spans import idle_share

SPANS = ("classifier.crop", "classifier.net", "classifier.score")


def read(cell, out):
    shares = [s for s in (idle_share(out, name) for name in SPANS) if s is not None]
    return sum(shares) if shares else None
