"""The five nets' weights, drawn from the run's seed.

One draw of a ``torch.Generator`` on the run's device fills every conv
and dense weight of all five nets (N(0, 2/fan_in), the seeded init's
distribution), in float32, the type the detector keeps its parameters
in; biases are 0, PReLU slopes 0.25, batchnorms the identity.  The
configuration's ``assumed`` head scaling is then applied, the scaling of
``chip_smoke.py``'s ``serve_weights`` and ``steady_regression`` (copied
here): random nets find no face at the default thresholds, so each face
head's logits are scaled by ``head_scale`` and its face logit raised by
``face_shift``, and the R- and O-Net box regressions are scaled by
``regression_scale`` so that refined boxes stay near their candidates.

The result is a param tree per net (numpy, the JAX layouts), which the
port takes as ``Detector(params=...)`` and from which the reference
builds its own modules.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
import torch.nn as nn

from benchmark.reference.layers import FrozenBN
from benchmark.reference.params import NETS, tree_of

# net -> (face head, regression head or None)
HEADS = {"pnet": ("conv4_1", None), "rnet": ("dense5_1", "dense5_2"),
         "onet": ("dense6_1", "dense6_2")}


def seeded_trees(seed: int, device, assumed: Mapping[str, float]) -> Dict[str, object]:
    """name -> param tree of every net, drawn from ``seed`` on ``device``
    and scaled as ``assumed`` says (``head_scale``, ``face_shift``,
    ``regression_scale``)."""
    nets = {name: cls() for name, cls in NETS.items()}
    layers = [m for net in nets.values() for m in net.modules()
              if isinstance(m, (nn.Conv2d, nn.Linear))]
    sizes = [m.weight.numel() for m in layers]
    scales = torch.tensor([math.sqrt(2.0 / m.weight[0].numel()) for m in layers],
                          device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    draw *= scales.repeat_interleave(torch.tensor(sizes, device=device))
    host = draw.cpu().numpy()
    offset = 0
    with torch.no_grad():
        for m, n in zip(layers, sizes):
            m.weight.copy_(torch.from_numpy(host[offset:offset + n]).view_as(m.weight))
            offset += n
            if m.bias is not None:
                m.bias.zero_()
        for net in nets.values():
            for m in net.modules():
                if isinstance(m, nn.PReLU):
                    m.weight.fill_(0.25)
                elif isinstance(m, FrozenBN):
                    m.gamma.fill_(1.0)
                    m.beta.zero_()
                    m.mean.zero_()
                    m.var.fill_(1.0)
        for name, (face, regression) in HEADS.items():
            head = getattr(nets[name], face)
            head.weight.mul_(assumed["head_scale"])
            head.bias.mul_(assumed["head_scale"])
            head.bias[1] += assumed["face_shift"]
            if regression:
                reg = getattr(nets[name], regression)
                reg.weight.mul_(assumed["regression_scale"])
                reg.bias.mul_(assumed["regression_scale"])
    return {name: tree_of(net) for name, net in nets.items()}
