"""The DFDC classifier's work, from shapes and from what a run's answers
say: the valid crops of a result, one crop's operations through one
member, and the least bytes of each launch of the crop kernel K7.

A crop's operations are the reference's module on the meta device under
``torch.utils.flop_counter`` (2 operations a multiply-add of every
convolution and of the dense layer; the activations, the pooling and the
squeeze-excitation's scaling are not counted).  K7's bytes: its output,
every row of the launch (``n_valid`` frames times the tracks), written in
bf16, and each valid crop's source rectangle (the box grown by ``w //
margin`` and ``h // margin``, clipped to the frame) read once as three
bytes a pixel; the boxes, the mask and the 1.5 KB table are left out.
"""

from __future__ import annotations

import functools
from typing import List, Mapping

import numpy as np

OUT_BYTES = 2   # bf16


def valid_crops(result) -> int:
    """The crops a program result classified (each once, whatever the
    ensemble); 0 for a result without the classifier's."""
    return int(np.asarray(result[3].mask).sum()) if len(result) > 3 else 0


@functools.lru_cache(maxsize=None)
def crop_flops(size: int) -> int:
    """Operations of one member's forward on one size x size crop."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.efficientnet import DeepFakeClassifier

    with torch.device("meta"):
        net = DeepFakeClassifier()
        with FlopCounterMode(display=False) as counter:
            net(torch.empty(1, size, size, 3))
    return int(counter.get_total_flops())


def rectangle_pixels(box, h: int, w: int, margin: int) -> int:
    """Pixels of a box's grown rectangle, clipped as numpy slicing clips."""
    xmin, ymin, xmax, ymax = (int(v) for v in box)
    p_w, p_h = (xmax - xmin) // margin, (ymax - ymin) // margin

    def length(lo, hi, n):
        hi = hi + n if hi < 0 else hi
        return max(min(max(hi, 0), n) - min(lo, n), 0)

    return length(max(ymin - p_h, 0), ymax + p_h, h) * length(max(xmin - p_w, 0), xmax + p_w, w)


def k7_bytes(result, frames: int, batch: int, classifier: Mapping, h: int, w: int) -> List[float]:
    """The least bytes of each K7 launch of one clip of ``frames`` sampled
    frames in batches of ``batch`` (one launch a batch), from the result's
    boxes and mask."""
    got = result[3]
    size, margin = classifier["input_size"], classifier["margin"]
    tracks = got.mask.shape[1]
    out = []
    for start in range(0, frames, batch):
        rows = min(batch, frames - start)
        reads = sum(rectangle_pixels(got.boxes[i, k], h, w, margin)
                    for i in range(start, start + rows) for k in range(tracks) if got.mask[i, k])
        out.append(rows * tracks * size * size * 3 * OUT_BYTES + 3 * reads)
    return out
