"""Frozen copy of ``truely_tpu_torch/pipeline/pyramid.py``.

Static image-pyramid schedule (restated from ``truely_tpu/pipeline/pyramid.py``)."""

from __future__ import annotations

from typing import List, NamedTuple


class PyramidLevel(NamedTuple):
    scale: float
    height: int
    width: int


def pyramid_schedule(height: int, width: int, min_face_size: int = 20,
                     factor: float = 0.709) -> List[PyramidLevel]:
    """Scales and resampled sizes of the upstream loop: scale_0 =
    12/min_face_size, scale_{i+1} = scale_i * factor while min(h, w) *
    scale >= 12; level size = int(dim * scale + 1)."""
    m = 12.0 / min_face_size
    minl = min(height, width) * m
    scale = m
    levels = []
    while minl >= 12.0:
        levels.append(PyramidLevel(scale=scale, height=int(height * scale + 1),
                                   width=int(width * scale + 1)))
        scale *= factor
        minl *= factor
    return levels
