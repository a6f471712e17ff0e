"""Device meshes (counterpart of ``truely_tpu/parallel/mesh.py``).

A ``Mesh`` is an array of ``torch.device`` positions with named axes, the
shape of ``jax.sharding.Mesh``: one Python process drives every position,
as JAX's single controller drives its devices.  Positions may name the same
device (``["cpu"] * 4`` in the tests, ``[cuda:0, cuda:0]`` on one card):
every split, replicate, gather and stage hand-off then runs for real, on
fewer devices.  By default there is one position per CUDA device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def canonical_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: ``"cuda"`` names
    the current CUDA device, so that equal devices compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """``devices``: an object array of ``torch.device`` of the mesh's
    shape; ``axis_names``: one name per axis; ``shape[name]``: the size of
    an axis, as in JAX."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} axes given {len(axis_names)} names")
        flat = np.empty(devices.size, dtype=object)
        flat[:] = [canonical_device(d) for d in devices.flat]
        self.devices = flat.reshape(devices.shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first_device(self) -> torch.device:
        """Where a sharded result is gathered, and the Detector's device."""
        return self.devices.flat[0]

    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in the order of its first position."""
        return list(dict.fromkeys(self.devices.flat))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def _key(self):
        return (self.devices.shape, tuple(self.devices.flat), self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device, one position
    each; raises when there is none).  The default shape puts every
    position on the first axis ('data') and 1 on the others."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= (e.g. ['cpu'] * 4)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)
