"""Training step of the detector's learnable heads over a device mesh
(counterpart of ``truely_tpu/parallel/train.py``).

Two parts of the pipeline are products of training rather than converted
checkpoints:

- the 68-landmark head (L2 on crop-normalised coordinates), and
- the FaceNet embedder (NT-Xent: embeddings of two views of the same face
  pulled together, different faces pushed apart, over the whole batch).

Every leaf of the JAX param trees is trained, batchnorm's ``gamma``,
``beta``, ``mean`` and ``var`` included: the JAX step differentiates them
all.  The inference modules keep those four as buffers, so
``train_params_from_numpy`` builds modules whose batchnorm leaves are
parameters.  The optimiser is ``torch.optim.Adam`` with optax's ``adam``
defaults.

With a mesh, the batch is split over ``data_axis``: each shard runs on its
device's replica of the nets, both views' embeddings are gathered on the
mesh's first device before the (B, B) logits (a mean of per-shard losses
would be another loss), each replica's gradients are summed onto the
master, and after the update the master's values are copied to the
replicas.  Positions on one device share one replica, so there the step is
one autograd graph.  A ``tp_shard_facenet`` copy of the nets trains its
projection's column slices where they lie.
"""

from __future__ import annotations

import weakref
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from truely_tpu_torch.models.layers import FrozenBN
from truely_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from truely_tpu_torch.parallel.mesh import Mesh, canonical_device
from truely_tpu_torch.parallel.sharding import dp_spec, replicate, place_column_slices

# training tree key -> the net's name in models/weights.py
NETS = {"facenet": "facenet", "landmark": "landmark68"}


class TrainState(NamedTuple):
    params: Dict[str, nn.Module]   # {"facenet": ..., "landmark": ...}, trained in place
    opt_state: torch.optim.Adam
    step: int


class Batch(NamedTuple):
    crops_a: torch.Tensor    # (B, S, S, 3) f32 in [0, 1]
    crops_b: torch.Tensor    # (B, S, S, 3) second view of the same faces
    landmarks: torch.Tensor  # (B, 68, 2) targets in [0, 1]


def trainable_bn(module: nn.Module) -> nn.Module:
    """``module`` with every batchnorm's four buffers made parameters."""
    for m in module.modules():
        if isinstance(m, FrozenBN):
            for k in ("gamma", "beta", "mean", "var"):
                m.register_parameter(k, nn.Parameter(m._buffers.pop(k)))
    return module


def train_params_from_numpy(tree, device=None) -> Dict[str, nn.Module]:
    """The ``{"facenet", "landmark"}`` training tree of JAX-layout numpy
    params as trainable modules (every leaf a parameter) on ``device``."""
    out = {}
    for key, name in NETS.items():
        m = trainable_bn(params_from_numpy(name, tree[key]))
        out[key] = m.to(device) if device is not None else m
    return out


def train_params_to_numpy(params: Dict[str, nn.Module], grads: bool = False):
    """The inverse: the JAX-layout numpy trees (``grads=True``: of the
    leaves' gradients), which the JAX package's nets take as they are."""
    return {key: params_to_numpy(m, grads=grads) for key, m in params.items()}


def _loss(emb_a, emb_b, pred, landmarks, temperature: float):
    # NT-Xent across the global batch: the positives are (a_i, b_i).
    logits = (emb_a @ emb_b.T) / temperature  # (B, B), embeddings unit-norm
    labels = torch.arange(logits.shape[0], device=logits.device)
    nce = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    lmk = torch.mean(torch.square(pred - landmarks))
    loss = nce + lmk
    return loss, {"loss": loss.detach(), "nce": nce.detach(), "landmark_mse": lmk.detach()}


def make_train_step(
    mesh: Optional[Mesh] = None,
    *,
    learning_rate: float = 1e-4,
    temperature: float = 0.1,
    compute_dtype: torch.dtype = torch.float32,
    data_axis: str = "data",
    device=None,
):
    """Build ``(init_fn, step_fn)``.

    ``init_fn(params)``: params are the training tree's modules (from
    ``train_params_from_numpy``, or a ``tp_shard_facenet`` copy) or its
    numpy trees; they move to the step's device (the mesh's first device,
    else ``device``, CUDA by default) and are trained in place.
    ``step_fn(state, batch) -> (state, metrics)``: one Adam step; after it
    each leaf's ``.grad`` holds the step's gradient.  Float32 steps run
    without TF32."""
    from truely_tpu_torch.pipeline.detector import precision

    if mesh is not None:
        device = mesh.first_device
        spec = dp_spec(mesh, data_axis)
    else:
        device = canonical_device("cuda" if device is None else device)
        spec = None
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to train on the CPU")
    # master modules -> their replicas on the mesh's other devices
    replica_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def init_fn(params) -> TrainState:
        if not all(isinstance(m, nn.Module) for m in params.values()):
            params = train_params_from_numpy(params)
        for m in params.values():
            m.to(device)
            if mesh is not None:  # column slices back onto the model axis
                place_column_slices(mesh, m, (0,) * mesh.devices.ndim)
        leaves = [p for m in params.values() for p in m.parameters()]
        opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(params=params, opt_state=opt, step=0)

    def replicas_of(params) -> dict:
        master = params["facenet"]
        if master not in replica_cache:
            replica_cache[master] = replicate(mesh, params)
        return replica_cache[master]

    def forward(params, batch: Batch):
        if mesh is None:
            fn, lm = params["facenet"], params["landmark"]
            return (fn(batch.crops_a, compute_dtype), fn(batch.crops_b, compute_dtype),
                    lm(batch.crops_a, compute_dtype))
        replicas = replicas_of(params)
        outs = []
        for (d, xa, _), (_, xb, _) in zip(spec.split(batch.crops_a), spec.split(batch.crops_b)):
            fn, lm = replicas[d]["facenet"], replicas[d]["landmark"]
            outs.append((fn(xa, compute_dtype), fn(xb, compute_dtype), lm(xa, compute_dtype)))
        return spec.gather(outs)

    def sync_replicas(params, grads: bool) -> None:
        """Sum each other replica's gradients onto the master (``grads``),
        or copy the master's values to them."""
        for d, rep in replicas_of(params).items():
            if rep is params:
                continue
            with torch.no_grad():
                for key, m in params.items():
                    for mp, rp in zip(m.parameters(), rep[key].parameters()):
                        if grads:
                            mp.grad += rp.grad.to(mp.device)
                            rp.grad = None
                        else:
                            rp.copy_(mp.to(rp.device))

    def step_fn(state: TrainState, batch: Batch):
        params, opt = state.params, state.opt_state
        opt.zero_grad(set_to_none=True)
        batch = Batch(*(t.to(device) for t in batch))
        with precision(compute_dtype):
            emb_a, emb_b, pred = forward(params, batch)
            loss, metrics = _loss(emb_a, emb_b, pred, batch.landmarks, temperature)
            loss.backward()
        if mesh is not None:
            sync_replicas(params, grads=True)
        opt.step()
        if mesh is not None:
            sync_replicas(params, grads=False)
        return TrainState(params, opt, state.step + 1), metrics

    return init_fn, step_fn


def numpy_batch(rng: np.random.Generator, b: int, size: int = 80) -> Batch:
    """A batch of seeded uniform crops and landmark targets (float32), as
    the JAX package's training tests and dry run make them."""
    return Batch(
        crops_a=torch.from_numpy(rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)),
        crops_b=torch.from_numpy(rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)),
        landmarks=torch.from_numpy(rng.uniform(0, 1, (b, 68, 2)).astype(np.float32)),
    )
