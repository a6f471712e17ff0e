"""The five nets from JAX-layout param trees, and back: frozen copy of
``truely_tpu_torch/models/weights.py`` (``_copy``, ``_load``,
``params_from_numpy``, ``params_to_numpy``).

A param tree is a nested dict/list of numpy arrays keyed by the module
names: conv ``{"w": HWIO, "b"}``, dense ``{"w": (in, out), "b"}``,
batchnorm ``{"gamma", "beta", "mean", "var"}``, PReLU ``{"alpha"}``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from .inception_resnet_v1 import InceptionResnetV1
from .landmark68 import Landmark68
from .layers import FrozenBN
from .mtcnn_nets import ONet, PNet, RNet

NETS = {"pnet": PNet, "rnet": RNet, "onet": ONet, "facenet": InceptionResnetV1,
        "landmark68": Landmark68}
BN_KEYS = ("beta", "gamma", "mean", "var")


def _copy(dst: torch.Tensor, src, path: str) -> None:
    arr = torch.from_numpy(np.array(src, dtype=np.float32, order="C"))
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{path}: shape {tuple(arr.shape)} != module {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(arr)


def _load(module: nn.Module, node, path: str) -> int:
    """Copy ``node`` into ``module``; returns the number of tensors set."""
    if isinstance(node, (list, tuple)):
        return sum(_load(module[i], v, f"{path}/{i}") for i, v in enumerate(node))
    keys = set(node)
    if keys <= {"w", "b"}:
        w = np.asarray(node["w"])
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T  # HWIO->OIHW, (in,out)->(out,in)
        _copy(module.weight, w, path + "/w")
        if "b" in keys:
            _copy(module.bias, node["b"], path + "/b")
        elif module.bias is not None:
            raise ValueError(f"{path}: tree has no bias, module has one")
        return len(keys)
    if keys == set(BN_KEYS):
        for k in BN_KEYS:
            _copy(getattr(module, k), node[k], f"{path}/{k}")
        return 4
    if keys == {"alpha"}:
        _copy(module.weight, node["alpha"], path + "/alpha")
        return 1
    return sum(_load(getattr(module, k), v, f"{path}/{k}") for k, v in node.items())


def net_from_tree(name: str, tree) -> nn.Module:
    """The net ``name`` with the weights of a param tree.  Raises on a
    shape mismatch and on any module tensor the tree leaves unset."""
    module = NETS[name]()
    n = _load(module, tree, name)
    expected = len(module.state_dict())
    if n != expected:
        raise ValueError(f"{name}: tree sets {n} tensors, module has {expected}")
    return module.eval()


def nets_from_trees(trees: Mapping[str, object], device) -> Dict[str, nn.Module]:
    return {name: net_from_tree(name, trees[name]).to(device) for name in NETS}


def tree_of(module: nn.Module):
    """The param tree of ``module`` as numpy (the inverse of
    :func:`net_from_tree`)."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    def walk(m: nn.Module):
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = leaf(m.weight)
            node = {"w": w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T}
            if m.bias is not None:
                node["b"] = leaf(m.bias)
            return node
        if isinstance(m, FrozenBN):
            return {k: leaf(getattr(m, k)) for k in BN_KEYS}
        if isinstance(m, nn.PReLU):
            return {"alpha": leaf(m.weight)}
        if isinstance(m, nn.ModuleList):
            return [walk(c) for c in m]
        return {k: walk(c) for k, c in m.named_children()}

    return walk(module)
