"""Checkpoint / resume with ``torch.save`` (counterpart of
``gsplat_tpu.io.checkpoint``, which uses orbax): the training state — splat
parameters, optimizer state, step — one file per step in a directory, the
newest ``max_to_keep`` kept.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from ..train.params import FIELDS, SplatParams

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def save_checkpoint(
    directory: str,
    step: int,
    params: SplatParams,
    opt_state: Optional[torch.optim.Optimizer] = None,
    max_to_keep: int = 3,
) -> None:
    """Save (params, opt_state) at ``step``.  Blocking.  ``opt_state`` is the
    optimizer (its ``state_dict()`` is what is stored)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    payload = {"step": int(step), "params": {k: v.detach().cpu() for k, v in params.as_dict().items()}}
    if opt_state is not None:
        payload["opt_state"] = opt_state.state_dict()
    path = os.path.join(directory, f"step_{int(step)}.pt")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(os.path.join(directory, f"step_{old}.pt"))


def restore_checkpoint(
    directory: str,
    params_like: SplatParams,
    opt_state_like: Optional[torch.optim.Optimizer] = None,
    step: Optional[int] = None,
) -> Tuple[int, SplatParams, Optional[torch.optim.Optimizer]]:
    """Restore the latest (or given) step.  ``params_like`` gives the device;
    ``opt_state_like`` is an optimizer built over ``params_like``: the saved
    values are copied into ``params_like``'s tensors in place (so the
    optimizer keeps pointing at them) and the optimizer's state is loaded.
    Returns (step, params, opt_state)."""
    directory = os.path.abspath(directory)
    steps = _steps(directory)
    step = (steps[-1] if steps else None) if step is None else step
    if step is None or step not in steps:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    payload = torch.load(os.path.join(directory, f"step_{step}.pt"), map_location=params_like.device)
    with torch.no_grad():
        for name in FIELDS:
            getattr(params_like, name).copy_(payload["params"][name])
    if opt_state_like is not None:
        if "opt_state" not in payload:
            raise KeyError(f"checkpoint step {step} holds no optimizer state")
        opt_state_like.load_state_dict(payload["opt_state"])
    return step, params_like, opt_state_like
