"""The general generator of the traffic mixes in ``traffic/*.json``.

Every run gets the same work: clip lengths are the midpoints of
equal-probability strata of the mix's distribution, and their order comes
from the mix's own ``order_seed``.  A run's seed picks only the clips'
content (and, elsewhere, the weights).

Closed loop (``"loop": "closed"``): clips of ``lengths`` sampled frames
(``strata`` of them, all of one cycle before the next, each cycle in a
new order), each starting at a seeded frame of the mix's content.
"""

from __future__ import annotations

from typing import Iterator, List, Mapping, NamedTuple

import numpy as np


def strata(dist: Mapping, n: int) -> List[float]:
    """The midpoints (in probability) of ``n`` equal strata of ``dist``,
    ``{"dist": "uniform", "low", "high"}``."""
    if dist["dist"] != "uniform":
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return [dist["low"] + (dist["high"] - dist["low"]) * (i + 0.5) / n for i in range(n)]


def lengths(traffic: Mapping) -> List[int]:
    """The clip lengths of one cycle of the mix, in sampled frames."""
    return [int(round(x)) for x in strata(traffic["lengths"], traffic["lengths"]["strata"])]


class Clip(NamedTuple):
    start: int    # first frame, an index into the mix's content
    frames: int


def closed_clips(traffic: Mapping, seed: int) -> Iterator[Clip]:
    """The closed loop's clips, one after another, forever: lengths in the
    mix's order, starts from ``seed``."""
    order = np.random.default_rng(traffic["order_seed"])
    starts = np.random.default_rng(seed)
    sizes = lengths(traffic)
    while True:
        for i in order.permutation(len(sizes)):
            yield Clip(int(starts.integers(1 << 30)), sizes[i])
