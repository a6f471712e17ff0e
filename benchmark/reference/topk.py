"""Frozen copy of ``truely_tpu_torch/ops/topk.py``.

Exact large-N top-k with ties to the lowest index (counterpart of
``truely_tpu/ops/topk.py``).

``torch.topk`` promises no order among equal values, so the base case is a
stable descending sort: equal values keep their original order, which puts
the lowest index first, as ``jax.lax.top_k`` does.  For large rows the
chunk-max prefilter of the JAX module shrinks the sort: the top-k chunks by
chunk maximum (ties to the lower chunk id) are the only chunks that can
hold a top-k cell, and gathering them in ascending chunk order keeps the
tie order of the global top-k.
"""

from __future__ import annotations

import torch


def _topk_sorted(p: torch.Tensor, k: int):
    vals, idx = torch.sort(p, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def exact_topk_lastdim(p: torch.Tensor, k: int, *, chunk: int = 128):
    """Exact (values, indices) top-k over the last axis of (B, N) scores,
    ties going to the lowest index."""
    b, n = p.shape
    nc = n // chunk
    if k >= n or nc <= k or n < 4 * chunk:
        return _topk_sorted(p, min(k, n))
    pad = nc * chunk
    pc = p[:, :pad].reshape(b, nc, chunk)
    cmax = pc.amax(dim=2)
    _, cid = _topk_shrink(cmax, k)
    cid = torch.sort(cid, dim=1).values                  # ascending global order
    rows = torch.gather(pc, 1, cid[:, :, None].expand(b, k, chunk))
    flat = rows.reshape(b, k * chunk)
    idx_map = (cid[:, :, None] * chunk
               + torch.arange(chunk, device=p.device)[None, None, :]).reshape(b, k * chunk)
    if pad < n:  # remainder cells compete raw
        flat = torch.cat([flat, p[:, pad:]], dim=1)
        rest = torch.arange(pad, n, device=p.device).expand(b, n - pad)
        idx_map = torch.cat([idx_map, rest], dim=1)
    vals, i2 = _topk_shrink(flat, k)
    return vals, torch.gather(idx_map, 1, i2)


def _topk_shrink(p: torch.Tensor, k: int):
    n = p.shape[1]
    chunk = max(8, min(128, n // (16 * max(k, 1))))
    if k >= n or n // chunk <= k or n < 4 * chunk:
        return _topk_sorted(p, min(k, n))
    return exact_topk_lastdim(p, k, chunk=chunk)
