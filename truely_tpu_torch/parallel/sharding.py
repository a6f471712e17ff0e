"""The detector over a device mesh (counterpart of
``truely_tpu/parallel/sharding.py``).

- **DP over frames** ('data' axis): ``replicate`` makes one replica of the
  nets per distinct device of the mesh, and ``shard_frame_step`` splits a
  batch's frame axis into one equal shard per data position, runs the
  port's step function on each shard with its device's replica, and
  gathers the outputs on the mesh's first device, where the folds run.
  Seeds of the propagate and refine steps go whole to every shard, and each
  shard takes its rows by its global row offset (``row0``), as XLA slices
  the replicated seeds of the JAX step: a shard may hold fewer rows than a
  keyframe interval, or start inside a group.
- **SP over the timeline**: ``sharded_temporal`` folds the timeline shard
  by shard, carrying the ``TemporalState`` across, so the result equals the
  unsharded fold exactly.
- **TP over the embedder** ('model' axis): ``tp_shard_facenet`` splits the
  1792x512 embedding projection into column slices on the model-axis
  devices; the slices' outputs are concatenated before the batchnorm and
  the normalisation.
"""

from __future__ import annotations

import copy
from functools import partial
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from truely_tpu_torch.config import DetectorConfig
from truely_tpu_torch.ops.temporal import (
    TemporalResult, TemporalState, init_temporal_state, temporal_consistency,
)
from truely_tpu_torch.parallel.mesh import Mesh

Replicas = Dict[torch.device, Any]


class DataSpec(NamedTuple):
    """The frame axis split over ``axis`` of ``mesh``: shard i holds rows
    ``[i*b/n, (i+1)*b/n)`` on the device of data position i (index 0 of
    the other axes)."""

    mesh: Mesh
    axis: str

    def split(self, x: torch.Tensor) -> List[Tuple[torch.device, torch.Tensor, int]]:
        """(device, rows on that device, global offset of the first row)
        for each shard.  Raises unless the rows divide evenly."""
        devices = self.mesh.axis_devices(self.axis)
        b = x.shape[0]
        if b % len(devices):
            raise ValueError(f"batch of {b} rows does not divide over the '{self.axis}' "
                             f"mesh axis ({len(devices)})")
        per = b // len(devices)
        return [(d, x[i * per:(i + 1) * per].to(d), i * per) for i, d in enumerate(devices)]

    def gather(self, parts: List[Any]) -> Any:
        """The shards' outputs (tensors, or tuples and NamedTuples of them)
        concatenated along the first axis on the mesh's first device."""
        first = parts[0]
        if isinstance(first, torch.Tensor):
            device = self.mesh.first_device
            return torch.cat([p.to(device) for p in parts])
        fields = [self.gather([p[i] for p in parts]) for i in range(len(first))]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def dp_spec(mesh: Mesh, axis: str = "data") -> DataSpec:
    return DataSpec(mesh, axis)


class ColumnParallelLinear(nn.Module):
    """A bias-free ``nn.Linear`` split by output columns: slice t of the
    weight lies on ``devices[t]``, computes its columns there, and the
    slices' outputs are concatenated on the input's device."""

    def __init__(self, weight: torch.Tensor, devices: List[torch.device], axis: str):
        super().__init__()
        if weight.shape[0] % len(devices):
            raise ValueError(f"{weight.shape[0]} output columns do not divide over "
                             f"{len(devices)} '{axis}' positions")
        self.axis = axis
        self.shards = nn.ParameterList([
            nn.Parameter(w.detach().to(d).clone(), requires_grad=weight.requires_grad)
            for w, d in zip(weight.chunk(len(devices), dim=0), devices)])

    def full_weight(self) -> torch.Tensor:
        """The (out, in) weight, gathered on the first slice's device."""
        d = self.shards[0].device
        return torch.cat([w.to(d) for w in self.shards])

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = dtype or torch.float32
        return torch.cat([F.linear(x.to(w.device).to(dt), w.to(dt)).float().to(x.device)
                          for w in self.shards], dim=-1)


def _map(fn: Callable[[Any], Any], tree):
    """``fn`` applied to every ``nn.Module`` and tensor of a tree of
    NamedTuples, tuples, lists and dicts."""
    if isinstance(tree, (nn.Module, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _devices_of(tree) -> set:
    found = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            found.add(x.device)
            return x
        # column slices lie on the model axis's devices, not the replica's
        sliced = {id(p) for m in x.modules() if isinstance(m, ColumnParallelLinear)
                  for p in m.parameters()}
        found.update(t.device for t in (*x.parameters(), *x.buffers()) if id(t) not in sliced)
        return x

    _map(visit, tree)
    return found


def place_column_slices(mesh: Mesh, module: nn.Module, position: tuple) -> None:
    """Move each ``ColumnParallelLinear`` slice t of ``module`` to the
    device at index t of its axis, through ``position``."""
    for m in module.modules():
        if isinstance(m, ColumnParallelLinear) and m.axis in mesh.axis_names:
            i = mesh.axis_names.index(m.axis)
            index = list(position)
            for t, w in enumerate(m.shards):
                index[i] = t
                w.data = w.data.to(mesh.devices[tuple(index)])


def replicate(mesh: Mesh, tree) -> Replicas:
    """One replica of ``tree`` (modules and tensors) per distinct device of
    the mesh: ``{device: tree}``.  The tree itself stands for the device it
    already lies on; the others get copies.  A TP-sharded module's column
    slices go to the model-axis devices of the replica's position."""
    home = _devices_of(tree)
    replicas: Replicas = {}
    for device in mesh.distinct_devices():
        if home == {device}:
            replicas[device] = tree
            continue
        position = next(zip(*(a.tolist() for a in (mesh.devices == device).nonzero())))

        def copy_to(x, device=device, position=position):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            m = copy.deepcopy(x).to(device)
            place_column_slices(mesh, m, position)
            return m

        replicas[device] = _map(copy_to, tree)
    return replicas


def tp_shard_facenet(mesh: Mesh, params, axis: str = "model"):
    """A copy of ``params`` whose FaceNet embedding projection is
    column-split over ``axis``: each of the T model-axis devices holds a
    (512/T, 1792) slice.  ``params`` is the detector's ``DetectorNets``, a
    training dict with a "facenet" entry, or the FaceNet module itself."""
    if isinstance(params, nn.Module):
        facenet = copy.deepcopy(params)
        facenet.last_linear = ColumnParallelLinear(
            params.last_linear.weight, mesh.axis_devices(axis), axis)
        return facenet
    if isinstance(params, dict):
        return {**params, "facenet": tp_shard_facenet(mesh, params["facenet"], axis)}
    return params._replace(facenet=tp_shard_facenet(mesh, params.facenet, axis))


def run_sharded(spec: DataSpec, step: Callable, replicas: Replicas, frames: torch.Tensor,
                *seeds: torch.Tensor, cfg: DetectorConfig, dtype, **kw):
    """``step(nets, rows, *seeds, cfg, dtype, **kw)`` on each data shard of
    ``frames`` with its device's replica, the outputs gathered on the
    mesh's first device.  Seeds go whole to every shard, with the shard's
    global row offset as ``row0``."""
    outs = []
    for device, rows, row0 in spec.split(frames):
        nets = replicas[device]
        if seeds:
            outs.append(step(nets, rows, *(s.to(device) for s in seeds), cfg, dtype,
                             row0=row0, **kw))
        else:
            outs.append(step(nets, rows, cfg, dtype, **kw))
    return spec.gather(outs)


def shard_frame_step(
    mesh: Mesh,
    config: Optional[DetectorConfig] = None,
    *,
    data_axis: str = "data",
    yuv: bool = False,
    propagate: bool = False,
    refine_rows: Optional[int] = None,
    multiface: bool = False,
):
    """The per-batch detector step with the frame axis split over
    ``data_axis``.  Returns ``fn(params, frames)`` with frames (B, H, W, 3),
    or packed I420 (B, 3H/2, W) with ``yuv=True`` (K1 runs on each shard),
    B divisible by the data-axis size, and ``params`` the ``replicate``d
    nets (or the nets, replicated on the call).  ``propagate=True``
    returns the track-propagated step ``fn(params, frames, seed_boxes,
    seed_valid, k=None)``: the (B/K,) seeds go whole to every shard.
    ``multiface=True`` selects the per-track steps; ``refine_rows=F`` the
    stream scheduler's all-rows refinement of (S,) (multi-face: (S, T))
    seeds."""
    from truely_tpu_torch.pipeline import detector as D

    config = config or DetectorConfig()
    if multiface:
        steps = (D.multiface_step, D.multiface_step_propagate, D.multiface_step_refine)
        steps_yuv = (D.multiface_step_yuv, D.multiface_step_propagate_yuv,
                     D.multiface_step_refine_yuv)
    else:
        steps = (D.frame_step, D.frame_step_propagate, D.frame_step_refine)
        steps_yuv = (D.frame_step_yuv, D.frame_step_propagate_yuv, D.frame_step_refine_yuv)
    full, prop, refine = steps_yuv if yuv else steps
    if refine_rows:
        step = partial(refine, rows_per_seed=refine_rows)
    else:
        step = prop if propagate else full
    dtype = getattr(torch, config.compute_dtype)
    spec = dp_spec(mesh, data_axis)

    def fn(params, frames, *seeds, **kw):
        replicas = params if isinstance(params, dict) else replicate(mesh, params)
        with torch.inference_mode(), D.precision(dtype):
            return run_sharded(spec, step, replicas, frames, *seeds, cfg=config, dtype=dtype,
                               **kw)

    return fn


def sharded_temporal(mesh: Mesh, config: Optional[DetectorConfig] = None, *,
                     data_axis: str = "data"):
    """Whole-timeline temporal pass with the timeline split over
    ``data_axis`` (sequence parallelism): each shard folds on its device
    and hands its ``TemporalState`` to the next, so the result equals the
    unsharded fold exactly.  Returns ``fn(embeddings (T, D), has_face (T,),
    n_sampled) -> TemporalResult`` on the mesh's first device."""
    config = config or DetectorConfig()
    spec = dp_spec(mesh, data_axis)

    def fn(embeddings: torch.Tensor, has_face: torch.Tensor, n_sampled) -> TemporalResult:
        n_sampled = int(n_sampled)
        state = init_temporal_state(embeddings.shape[-1], embeddings.device)
        results = []
        with torch.inference_mode():
            for (device, emb, row0), (_, hf, _) in zip(spec.split(embeddings),
                                                       spec.split(has_face)):
                state = TemporalState(*(t.to(device) for t in state))
                res = temporal_consistency(
                    emb, hf, max(0, min(n_sampled - row0, emb.shape[0])), state=state,
                    similarity_threshold=config.similarity_threshold,
                    run_length_threshold=config.run_length_threshold)
                state = res.state
                results.append(res)
        per_frame = spec.gather([r[:5] for r in results])
        first = mesh.first_device
        state = TemporalState(*(t.to(first) for t in state))
        return TemporalResult(
            *per_frame,
            flagged_count=sum(r.flagged_count.to(first) for r in results),
            final_counter=state.counter, state=state)

    return fn
