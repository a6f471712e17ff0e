"""Weights of the five nets: conversion from the JAX param trees, the flat
``.npz`` reader, and a seeded init (counterpart of
``truely_tpu/models/weights.py``).

A param tree is the JAX package's nested dict/list of arrays, keyed by the
upstream module names.  The modules here use the same names, so loading is
a walk: conv ``{"w": HWIO, "b"}`` -> ``nn.Conv2d`` (OIHW); dense
``{"w": (in, out), "b"}`` -> ``nn.Linear`` ((out, in)); ``{"gamma",
"beta", "mean", "var"}`` -> ``FrozenBN``; ``{"alpha"}`` -> ``nn.PReLU``.
``convert_torch_state_dict`` reads the public facenet-pytorch checkpoints
(``python -m truely_tpu_torch.models.convert`` writes them as ``.npz``).
"""

from __future__ import annotations

import copy
import math
import os
from typing import Dict, Mapping, Optional, Set, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from truely_tpu_torch.models.inception_resnet_v1 import InceptionResnetV1
from truely_tpu_torch.models.landmark68 import Landmark68
from truely_tpu_torch.models.layers import FrozenBN
from truely_tpu_torch.models.mtcnn_nets import ONet, PNet, RNet

WEIGHTS_ENV = "TRUELY_TPU_WEIGHTS"
# The JAX package's seeds (truely_tpu/models/weights.py:_SEEDS).
SEEDS = {"pnet": 101, "rnet": 102, "onet": 103, "facenet": 104, "landmark68": 105}
NETS = {"pnet": PNet, "rnet": RNet, "onet": ONet, "facenet": InceptionResnetV1,
        "landmark68": Landmark68}
_SEP = "/"
_BN_KEYS = {"gamma", "beta", "mean", "var"}


def load_params(path: str):
    """Read the flat ``.npz`` that ``truely_tpu.models.weights.save_params``
    writes: keys are paths joined with '/', integer segments are list
    indices.  Returns the nested tree of numpy arrays."""
    root: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split(_SEP)
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params(path: str, module: nn.Module) -> None:
    """Write ``module``'s weights as the flat ``.npz`` that
    :func:`load_params` reads and ``truely_tpu.models.weights.save_params``
    writes: keys are module paths joined with '/', in the JAX layouts."""
    flat = {}
    for name, m in module.named_modules():
        key = name.replace(".", _SEP)
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight.detach().cpu().numpy()
            flat[key + "/w"] = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
            if m.bias is not None:
                flat[key + "/b"] = m.bias.detach().cpu().numpy()
        elif isinstance(m, FrozenBN):
            for k in _BN_KEYS:
                flat[f"{key}/{k}"] = getattr(m, k).detach().cpu().numpy()
        elif isinstance(m, nn.PReLU):
            flat[key + "/alpha"] = m.weight.detach().cpu().numpy()
    with open(path, "wb") as f:
        np.savez(f, **flat)


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
    if keys == _BN_KEYS:
        for k in sorted(keys):
            _copy(getattr(module, k), node[k], f"{path}/{k}")
        return 4
    if keys == {"alpha"}:
        _copy(module.weight, node["alpha"], path + "/alpha")
        return 1
    return sum(_load(getattr(module, k), v, f"{path}/{k}") for k, v in node.items())


def params_from_numpy(name: str, tree) -> nn.Module:
    """The net ``name`` with the weights of a JAX param tree (as numpy or
    anything ``np.asarray`` takes).  Raises on a shape mismatch and on any
    module tensor the tree leaves unset."""
    module = NETS[name]()
    n = _load(module, tree, name)
    expected = len(module.state_dict())
    if n != expected:
        raise ValueError(f"{name}: tree sets {n} tensors, module has {expected}")
    return module.eval()


def params_to_numpy(module: nn.Module, grads: bool = False):
    """The JAX-layout param tree of ``module`` as numpy (the inverse of
    :func:`params_from_numpy`); ``grads=True``: the tree of the leaves'
    gradients instead.  A module whose projection is column-split
    (``parallel.sharding.ColumnParallelLinear``) gives the whole weight."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.grad if grads else t
        if t is None:
            raise ValueError("a leaf has no gradient")
        # a copy: the numpy view of a CPU tensor would follow its training
        return t.detach().cpu().numpy().copy()

    def walk(m: nn.Module):
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = leaf(m.weight)
            node = {"w": w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T}
            if m.bias is not None:
                node["b"] = leaf(m.bias)
            return node
        if hasattr(m, "full_weight"):  # column slices, concatenated
            return {"w": np.concatenate([leaf(w) for w in m.shards]).T}
        if isinstance(m, FrozenBN):
            return {k: leaf(getattr(m, k)) for k in sorted(_BN_KEYS)}
        if isinstance(m, nn.PReLU):
            return {"alpha": leaf(m.weight)}
        if isinstance(m, nn.ModuleList):
            return [walk(c) for c in m]
        return {k: walk(c) for k, c in m.named_children()}

    return walk(module)


def convert_torch_state_dict(name_or_module: Union[str, nn.Module],
                             state_dict: Mapping[str, object]) -> nn.Module:
    """The net (a name of ``NETS``, or a module to fill) with the weights of
    an upstream facenet-pytorch state dict (torch tensors or numpy arrays),
    as ``truely_tpu.models.weights.convert_torch_state_dict`` converts it:
    the module path is the dotted torch name; a conv or dense layer takes
    ``.weight`` (and ``.bias`` where it has one), a batchnorm ``.weight``,
    ``.bias``, ``.running_mean`` and ``.running_var``, a PReLU ``.weight``.
    Keys it does not need (``logits.*``, ``num_batches_tracked``) are
    ignored.  Raises KeyError on a missing entry and ValueError on a shape
    mismatch."""
    module = NETS[name_or_module]() if isinstance(name_or_module, str) else name_or_module

    def fetch(key: str, dst: torch.Tensor) -> None:
        if key not in state_dict:
            raise KeyError(f"missing key in torch state_dict: {key}")
        v = state_dict[key]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        _copy(dst, v, key)

    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fetch(f"{name}.weight", m.weight)
            if m.bias is not None:
                fetch(f"{name}.bias", m.bias)
        elif isinstance(m, FrozenBN):
            for ours, theirs in (("gamma", "weight"), ("beta", "bias"), ("mean", "running_mean"),
                                 ("var", "running_var")):
                fetch(f"{name}.{theirs}", getattr(m, ours))
        elif isinstance(m, nn.PReLU):
            fetch(f"{name}.weight", m.weight)
    return module.eval()


def fold_batchnorm(module: nn.Module, eps: float = 1e-3) -> nn.Module:
    """A copy of ``module`` with every inference batchnorm that follows a
    bias-less convolution (a module holding ``conv`` and ``bn``) folded
    into it, as ``truely_tpu.models.weights.fold_batchnorm`` folds a tree:
    ``w' = w * gamma / sqrt(var + eps)`` per output channel, ``b' = beta -
    mean * gamma / sqrt(var + eps)``, and the batchnorm made an identity
    (gamma 1, beta 0, mean 0, var 1 - eps).  The arithmetic is numpy's
    float32, as in the JAX function (PyTorch's CPU ``sqrt`` is not always
    correctly rounded), so the folded leaves equal the JAX fold's.  A
    utility for export; the Detector does not use it."""
    module = copy.deepcopy(module)
    for m in module.modules():
        conv, bn = getattr(m, "conv", None), getattr(m, "bn", None)
        if not (isinstance(conv, nn.Conv2d) and conv.bias is None and isinstance(bn, FrozenBN)):
            continue
        gamma, beta, mean, var = (t.detach().cpu().numpy() for t in (bn.gamma, bn.beta, bn.mean,
                                                                      bn.var))
        scale = gamma / np.sqrt(var + np.float32(eps))
        w = conv.weight.detach().cpu().numpy() * scale[:, None, None, None]  # OIHW: per O
        dev = conv.weight.device
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(w))
            conv.bias = nn.Parameter(torch.from_numpy(beta - mean * scale).to(dev))
            bn.gamma.fill_(1.0)
            bn.beta.zero_()
            bn.mean.zero_()
            bn.var.copy_(torch.ones_like(bn.var) - eps)
    return module


def init_params(name: str, seed: Optional[int] = None) -> nn.Module:
    """Seeded init with the JAX package's distributions: convs and dense
    weights N(0, 2/fan_in), zero biases, identity batchnorm, PReLU 0.25.

    The values differ from the JAX seeded init: ``torch.Generator`` and
    ``jax.random`` give different numbers for the same seed.  Tests that
    compare the two packages convert the JAX trees with
    :func:`params_from_numpy` instead.
    """
    module = NETS[name]()
    gen = torch.Generator().manual_seed(SEEDS[name] if seed is None else seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0, generator=gen).mul_(math.sqrt(2.0 / fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)
            elif isinstance(m, FrozenBN):
                m.gamma.fill_(1.0)
                m.beta.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
    return module.eval()


def load_or_init(name: str, weights_dir: Optional[str] = None) -> Tuple[nn.Module, bool]:
    """``<weights_dir>/<name>.npz`` (``weights_dir`` defaults to
    ``$TRUELY_TPU_WEIGHTS``) if present, else the seeded init.  Returns
    (module, loaded)."""
    weights_dir = weights_dir or os.environ.get(WEIGHTS_ENV, "")
    if weights_dir:
        path = os.path.join(weights_dir, f"{name}.npz")
        if os.path.exists(path):
            return params_from_numpy(name, load_params(path)), True
    return init_params(name), False


def load_all(params: Optional[Mapping[str, object]] = None,
             weights_dir: Optional[str] = None) -> Tuple[Dict[str, nn.Module], Set[str]]:
    """All five nets: from ``params`` (name -> param tree) where given,
    else from :func:`load_or_init`.  Returns (nets, the names whose weights
    were given rather than drawn from the seeded init)."""
    out, given = {}, set()
    for name in NETS:
        if params is not None and name in params:
            out[name] = params_from_numpy(name, params[name])
            given.add(name)
        else:
            out[name], loaded = load_or_init(name, weights_dir)
            if loaded:
                given.add(name)
    return out, given
