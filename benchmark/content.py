"""Seeded video content.

``synthetic_i420`` and ``stable_i420`` are frozen copies of
``chip_smoke.py``'s generators: packed I420 frames of 20x20 flat blocks
of seeded random luma and chroma, and shots of such a frame held for
``hold`` frames and shifted right by 0-14 px.

A ``Ring`` holds a traffic mix's distinct frames followed by the first
``longest`` of them again, so that every clip, a run of consecutive
frames from any start, is a view of one array and costs no copy.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def synthetic_i420(n: int, h: int, w: int, seed: int, block: int = 20) -> np.ndarray:
    """Packed I420 (n, 3h/2, w) uint8: block x block flat patches of seeded
    random luma and chroma (the pyramid keeps structure at every level)."""
    rng = np.random.default_rng(seed)

    def plane(ph, pw):
        small = rng.integers(16, 236, (n, -(-ph // block), -(-pw // block)), np.uint8)
        return np.repeat(np.repeat(small, block, axis=1), block, axis=2)[:, :ph, :pw]

    y = plane(h, w)
    u = plane(h // 2, w // 2).reshape(n, h // 4, w)
    v = plane(h // 2, w // 2).reshape(n, h // 4, w)
    return np.ascontiguousarray(np.concatenate([y, u, v], axis=1))


def stable_i420(n: int, h: int, w: int, seed: int, n_base: int = 4, hold: int = 64) -> np.ndarray:
    """n packed I420 frames of stable content: each of n_base seeded base
    frames holds for ``hold`` frames, shifted right by 0-14 px (even, so the
    chroma planes shift with it)."""
    base = synthetic_i420(n_base, h, w, seed)
    out = np.empty((n, h * 3 // 2, w), np.uint8)
    q = h // 4
    for i in range(n):
        src, s = base[(i // hold) % n_base], 2 * (i % 8)
        out[i, :h] = np.roll(src[:h], s, axis=1)
        for lo in (h, h + q):  # the U plane, then the V plane
            plane = src[lo:lo + q].reshape(h // 2, w // 2)
            out[i, lo:lo + q] = np.roll(plane, s // 2, axis=1).reshape(q, w)
    return out


class Ring:
    """The distinct frames of a mix, then its first ``longest`` frames
    again: ``clip(start, n)`` is frames start, start + 1, ... (mod the
    distinct count) as a view."""

    def __init__(self, distinct: np.ndarray, longest: int):
        self.period = distinct.shape[0]
        self.frames = np.take(distinct, np.arange(self.period + longest) % self.period, axis=0)

    def clip(self, start: int, n: int) -> np.ndarray:
        s = start % self.period
        return self.frames[s:s + n]


def distinct_frames(content: Mapping, h: int, w: int, seed: int) -> np.ndarray:
    """A mix's distinct frames: ``{"kind": "pool", "frames": n}`` is n
    unrelated synthetic frames; ``{"kind": "stable", "bases": b, "hold":
    m}`` is b shots of m frames each (``stable_i420``)."""
    if content["kind"] == "pool":
        return synthetic_i420(content["frames"], h, w, seed)
    if content["kind"] == "stable":
        b, m = content["bases"], content["hold"]
        return stable_i420(b * m, h, w, seed, n_base=b, hold=m)
    raise ValueError(f"unknown content kind {content['kind']!r}")
