"""Floating-point operations of one row (one sampled frame) of each kind
of frame step, counted from the configuration's shapes.

The nets are the reference's modules on the meta device, so nothing is
computed and nothing is allocated: ``torch.utils.flop_counter`` counts
every convolution and matrix product at its shapes (2 operations a
multiply-add).  The pyramid's resampling is counted as the bin sums an
area resize needs (each input value added once in each of its two
separable passes), not as the dense products the port happens to run it
as.  Steps:

- ``full``: the cascade (pyramid, P-Net trunk on every level, the
  regression head on the top-k cells, R-Net on ``rnet_capacity`` crops,
  O-Net on ``onet_capacity`` crops) and the embed tail (FaceNet on one
  face and the landmark head; multi-face: FaceNet on ``max_tracks``
  faces);
- ``detect``: the cascade only (a keyframe batch's seed step);
- ``propagate``: stages 2-3 on the refinement candidates of each seed
  (4 a seed) and the embed tail.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.mtcnn import PROPAGATE_SCALES
from benchmark.reference.params import NETS
from benchmark.reference.pyramid import pyramid_schedule


def flops(fn) -> int:
    """Operations of ``fn()`` run on meta tensors."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def pyramid_bin_sums(h: int, w: int, mtcnn: Mapping, cascade: bool) -> int:
    """Additions of the area pyramid of an (h, w, 3) frame: each level
    sums its source along H, then the H-resampled rows along W."""
    total = 0
    src_h, src_w = h, w
    for lvl in pyramid_schedule(h, w, mtcnn["min_face_size"], mtcnn["scale_factor"]):
        total += 3 * src_w * (src_h + lvl.height)
        if cascade:
            src_h, src_w = lvl.height, lvl.width
    return total


def row_flops(detector: Mapping, h: int, w: int) -> Dict[str, int]:
    """{"full", "detect", "propagate"} -> operations of one row of that
    step at an (h, w) frame under the ``detector`` settings of a
    configuration file."""
    mtcnn = detector["mtcnn"]
    dtype = getattr(torch, detector["compute_dtype"])
    multi = detector["multi_face"]
    faces = detector["max_tracks"] if multi else 1
    with torch.device("meta"):
        nets = {name: cls() for name, cls in NETS.items()}

        def trunk():
            for lvl in pyramid_schedule(h, w, mtcnn["min_face_size"], mtcnn["scale_factor"]):
                nets["pnet"].trunk(torch.empty(1, lvl.height, lvl.width, 3), dtype)
            nets["pnet"].reg_from_features(torch.empty(mtcnn["pnet_topk_total"], 32), dtype)

        def stages23(k2: int, k3: int) -> int:
            return (flops(lambda: nets["rnet"](torch.empty(k2, 24, 24, 3), dtype))
                    + flops(lambda: nets["onet"](torch.empty(k3, 48, 48, 3), dtype)))

        crops = torch.empty(faces, detector["crop_size"], detector["crop_size"], 3)
        embed = flops(lambda: nets["facenet"](crops, dtype))
        if not multi:
            embed += flops(lambda: nets["landmark68"](crops, dtype))
        cascade = mtcnn["pyramid_cascade"] and dtype == torch.bfloat16
        k2 = min(mtcnn["rnet_capacity"], mtcnn["pnet_topk_total"])
        stage1 = flops(trunk) + pyramid_bin_sums(h, w, mtcnn, cascade)
        detect = stage1 + stages23(k2, min(mtcnn["onet_capacity"], k2))
        cands = faces * len(PROPAGATE_SCALES)
        return {"full": detect + embed, "detect": detect,
                "propagate": stages23(cands, cands) + embed}
