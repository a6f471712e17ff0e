"""setup_s: seconds from the process's start to the window's start
(weights, content, the detector, its warm-up and one analysis at the
cell's shapes; in a checkout's first run, the kernels' build too)."""


def read(cell, out):
    return out.setup_s
