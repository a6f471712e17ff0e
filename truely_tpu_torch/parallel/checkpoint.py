"""Checkpoint and resume of a training state (counterpart of
``truely_tpu/parallel/checkpoint.py``).

A step is saved as ``<directory>/step_%08d/state.pt`` with ``torch.save``:
the step, and per net and leaf name the value and Adam's two moments, each
whole (a column-split projection gathered under its unsplit name,
``last_linear.weight``), on the CPU.  The file is written into a temporary
directory beside the target, which ``os.replace`` then moves into place, so
a reader never sees half a checkpoint.  Restoring copies each tensor into
the template's tensors, so it lands on the template's devices and splits:
a state saved on a 2-position mesh restores on 1, and the reverse.

The JAX package checkpoints through Orbax, which the card's machine does
not have: its checkpoints cannot be read here, nor these by it (the
weights themselves convert with ``train.train_params_to_numpy``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from truely_tpu_torch.parallel.train import TrainState

_FILE = "state.pt"


def _leaves(module: nn.Module) -> Dict[str, List[nn.Parameter]]:
    """Each leaf's name and the parameters that hold it: one, or a
    column-split projection's slices in order."""
    out: Dict[str, List[nn.Parameter]] = {}
    for name, m in module.named_modules():
        if hasattr(m, "full_weight"):
            out[f"{name}.weight"] = list(m.shards)
    sliced = {id(p) for ps in out.values() for p in ps}
    for name, p in module.named_parameters():
        if id(p) not in sliced:
            out[name] = [p]
    return out


def _whole(parts: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().cpu() for t in parts]) if len(parts) > 1 else \
        parts[0].detach().cpu().clone()


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def save_train_state(directory: str, state: TrainState, step: Optional[int] = None) -> str:
    """Save ``state`` under ``directory/step_N`` (N: ``step``, default the
    state's); returns that path.  An existing step is replaced."""
    step = int(state.step) if step is None else int(step)
    opt = state.opt_state
    nets = {}
    for key, module in state.params.items():
        entry = {}
        for name, ps in _leaves(module).items():
            moments = [opt.state.get(p, {}) for p in ps]
            entry[name] = {"value": _whole(ps)}
            if all("exp_avg" in m for m in moments):
                entry[name]["exp_avg"] = _whole([m["exp_avg"] for m in moments])
                entry[name]["exp_avg_sq"] = _whole([m["exp_avg_sq"] for m in moments])
                entry[name]["adam_step"] = float(moments[0]["step"])
        nets[key] = entry
    path = _step_dir(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp_step_", dir=os.path.dirname(path))
    try:
        torch.save({"step": step, "nets": nets}, os.path.join(tmp, _FILE))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_train_state(directory: str, template: TrainState,
                        step: Optional[int] = None) -> TrainState:
    """Restore the given (or latest) step into ``template`` (from the
    step's ``init_fn``), in place: each value and moment is copied into the
    template's tensors, on their devices.  Returns the template at the
    restored step."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    saved = torch.load(os.path.join(_step_dir(directory, step), _FILE), map_location="cpu",
                       weights_only=True)
    opt = template.opt_state
    for key, module in template.params.items():
        entry = saved["nets"][key]
        leaves = _leaves(module)
        if set(leaves) != set(entry):
            raise ValueError(f"{key}: checkpoint leaves differ from the template's: "
                             f"{sorted(set(leaves) ^ set(entry))[:5]}")
        for name, ps in leaves.items():
            sizes = [p.shape[0] for p in ps]
            with torch.no_grad():
                for p, v in zip(ps, entry[name]["value"].split(sizes)):
                    p.copy_(v)
            for p in ps:
                opt.state.pop(p, None)
            if "exp_avg" in entry[name]:
                for p, m, v in zip(ps, entry[name]["exp_avg"].split(sizes),
                                   entry[name]["exp_avg_sq"].split(sizes)):
                    opt.state[p] = {"step": torch.tensor(entry[name]["adam_step"]),
                                    "exp_avg": m.to(p.device).clone(),
                                    "exp_avg_sq": v.to(p.device).clone()}
    return template._replace(step=saved["step"])
