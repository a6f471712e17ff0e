"""GPipe-style pipeline parallelism over a homogeneous block chain
(counterpart of ``truely_tpu/parallel/pipeline.py``).

The blocks' parameters are stacked along a leading "layer" axis
(``stack_block_params``), and stage s of the mesh's ``stage`` axis holds
blocks ``[s*L/S, (s+1)*L/S)`` on its device (``shard_stage_params``).
``pipeline_apply`` runs the microbatched GPipe schedule over ``M + S - 1``
ticks: at tick t, stage s runs its block group on microbatch ``t - s`` and
hands the result to stage s+1 with ``.to()``; the last stage banks it.
Launches on different devices run concurrently, since CUDA launches do not
wait for the device.

The schedule is exact: every block sees the same values in the same order
as the sequential loop, so per microbatch the result is bitwise equal to
``for p in blocks: x = block_fn(p, x)`` on the same device.  Against a
sequential pass over the unsplit batch it agrees to float32 rounding only,
because cuBLAS and cuDNN pick their algorithms by shape; that is a property
of splitting the batch, not of the pipeline.  The bubble fraction is
``(S - 1) / (M + S - 1)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
from torch.func import functional_call

from truely_tpu_torch.parallel.mesh import Mesh

Params = Dict[str, torch.Tensor]


def _tensors(block) -> Params:
    """A block's tensors by name: a module's parameters and buffers, or a
    dict as given."""
    if isinstance(block, nn.Module):
        return {k: v.detach() for k, v in block.state_dict().items()}
    return dict(block)


def stack_block_params(params_list: Sequence[Any]) -> Params:
    """Stack identically-structured blocks (modules, or dicts of tensors)
    along a new leading "layer" axis: tensor ``(a, b, ...)`` ->
    ``(L, a, b, ...)``."""
    blocks = [_tensors(b) for b in params_list]
    return {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}


def shard_stage_params(mesh: Mesh, stacked: Params, *, stage_axis: str = "stage"
                       ) -> List[Dict[torch.device, Params]]:
    """Place the stacked blocks by stage: entry s maps each device of the
    mesh's stage-s positions (one per data row) to its copy of blocks
    ``[s*L/S, (s+1)*L/S)``."""
    n_stages = mesh.shape[stage_axis]
    n_layers = next(iter(stacked.values())).shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} blocks do not divide over {n_stages} stages")
    per = n_layers // n_stages
    axis = mesh.axis_names.index(stage_axis)
    stages = []
    for s in range(n_stages):
        devices = dict.fromkeys(mesh.devices.take([s], axis=axis).flat)
        group = {k: v[s * per:(s + 1) * per] for k, v in stacked.items()}
        stages.append({d: {k: v.to(d) for k, v in group.items()} for d in devices})
    return stages


def pipeline_apply(
    mesh: Mesh,
    block_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    *,
    n_microbatches: int,
    stage_axis: str = "stage",
    data_axis: Optional[str] = None,
):
    """Build ``fn(stage_params, x) -> y`` applying the whole block chain
    under the GPipe schedule.

    ``block_fn(params_i, x)`` maps one block's (unstacked) tensors and an
    activation to an activation of the same shape (residual blocks).
    ``stage_params`` comes from ``shard_stage_params``; ``x`` is ``(B,
    ...)`` with B divisible by ``n_microbatches`` (after the split over
    ``data_axis``, where each data row runs its own pipeline over its
    stage devices).  The result lies on the mesh's first device and is
    bitwise equal, per microbatch, to the sequential chain."""
    n_stages = mesh.shape[stage_axis]
    m = n_microbatches
    stage_i = mesh.axis_names.index(stage_axis)
    data_i = mesh.axis_names.index(data_axis) if data_axis else None
    n_rows = mesh.shape[data_axis] if data_axis else 1

    def stage_devices(row: int) -> List[torch.device]:
        index = [0] * mesh.devices.ndim
        if data_i is not None:
            index[data_i] = row
        out = []
        for s in range(n_stages):
            index[stage_i] = s
            out.append(mesh.devices[tuple(index)])
        return out

    def group(local: Params, x: torch.Tensor) -> torch.Tensor:
        for i in range(next(iter(local.values())).shape[0]):
            x = block_fn({k: v[i] for k, v in local.items()}, x)
        return x

    def run_row(stage_params, x: torch.Tensor, devices: List[torch.device]) -> torch.Tensor:
        if x.shape[0] % m:
            raise ValueError(f"{x.shape[0]} rows do not divide into {m} microbatches")
        mbs = x.chunk(m)
        outputs: List[Optional[torch.Tensor]] = [None] * m
        recv: List[Optional[torch.Tensor]] = [None] * n_stages
        for t in range(m + n_stages - 1):
            sent: List[Optional[torch.Tensor]] = [None] * n_stages
            for s in range(n_stages):
                mb = t - s
                if not 0 <= mb < m:
                    continue
                x_in = mbs[mb].to(devices[0]) if s == 0 else recv[s]
                y = group(stage_params[s][devices[s]], x_in)
                if s == n_stages - 1:
                    outputs[mb] = y
                else:
                    sent[s + 1] = y.to(devices[s + 1])
            recv = sent
        return torch.cat([o.to(mesh.first_device) for o in outputs])

    def fn(stage_params, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n_rows:
            raise ValueError(f"{x.shape[0]} rows do not divide over the '{data_axis}' axis")
        rows = x.chunk(n_rows)
        return torch.cat([run_row(stage_params, r, stage_devices(i))
                          for i, r in enumerate(rows)])

    return fn


def pipeline_block17(
    mesh: Mesh,
    block17_params: Sequence[Any],
    *,
    n_microbatches: int,
    scale: float = 0.10,
    stage_axis: str = "stage",
    data_axis: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
):
    """Pipeline the Inception-ResNet-v1 Block17 repeat chain (the
    embedder's ``repeat_2``).  ``block17_params``: Block17 modules (e.g.
    ``facenet.repeat_2``) or their state dicts.  Returns
    ``(stage_params, fn)`` with ``fn(stage_params, x)`` for float32
    activations ``(B, H, W, 896)``, NHWC as in the JAX function (each block
    runs on the NCHW view, channels-last in memory, as inside the
    embedder)."""
    from truely_tpu_torch.models.inception_resnet_v1 import Block17

    template = Block17(scale=scale).to("meta")
    stages = shard_stage_params(mesh, stack_block_params(block17_params),
                                stage_axis=stage_axis)

    def block(p: Params, x: torch.Tensor) -> torch.Tensor:
        y = functional_call(template, p, (x.permute(0, 3, 1, 2), dtype))
        return y.permute(0, 2, 3, 1)

    fn = pipeline_apply(mesh, block, n_microbatches=n_microbatches,
                        stage_axis=stage_axis, data_axis=data_axis)
    return stages, fn
