"""Adam whose update on the card is the port's own kernel
(``ops/kernels/adam.py``): one pass over every leaf of a step.

:class:`Adam` is a ``torch.optim.Adam`` in everything but ``step`` on CUDA
parameters: the same groups and defaults, and the same state layout
(``state[p] = {"step", "exp_avg", "exp_avg_sq"}``, ``step`` a float32 0-dim
tensor on the parameter's device), so ``state_dict`` loads both ways between
the two classes and a CUDA graph that captured a step keeps reading the same
state tensors.  On CPU parameters ``step`` is ``torch.optim.Adam.step``
itself.
"""

from __future__ import annotations

import torch

from ..ops.kernels.adam import fused_adam

# Options of torch.optim.Adam that the kernel does not implement, with the
# value that leaves each off.
_OFF = {"amsgrad": False, "maximize": False, "weight_decay": 0.0, "differentiable": False}


def _check_group(group: dict) -> None:
    on = [k for k, off in _OFF.items() if group.get(k, off) != off]
    if on:
        raise ValueError(f"gsplat_tpu_torch's Adam does not implement {', '.join(on)}; use torch.optim.Adam")


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` without amsgrad, maximize, weight decay or
    differentiable steps (the constructor raises on each), whose step on
    CUDA parameters is one launch of the port's kernel for up to eight
    leaves, step counters advanced on the device: capturable in a CUDA graph
    whatever ``capturable`` says.  All parameters live on one device."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, amsgrad=False, *,
                 maximize=False, capturable=False, differentiable=False):
        _check_group(dict(amsgrad=amsgrad, maximize=maximize, weight_decay=weight_decay,
                          differentiable=differentiable))
        super().__init__(params, lr=lr, betas=betas, eps=eps, capturable=capturable)

    def add_param_group(self, param_group: dict) -> None:
        _check_group(param_group)
        super().add_param_group(param_group)

    @torch.no_grad()
    def step(self, closure=None):
        devices = {p.device for group in self.param_groups for p in group["params"]}
        if len(devices) > 1:
            raise ValueError(f"Adam's parameters lie on several devices: {sorted(map(str, devices))}")
        if not devices or next(iter(devices)).type != "cuda":
            return super().step(closure)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        leaves = ([], [], [], [], [])
        hyper = []
        for group in self.param_groups:
            _check_group(group)
            beta1, beta2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                elif state["step"].device != p.device:  # loaded from a state saved with capturable off
                    state["step"] = state["step"].to(p.device, torch.float32)
                for out, t in zip(leaves, (p, p.grad, state["exp_avg"], state["exp_avg_sq"], state["step"])):
                    out.append(t)
                hyper.append((float(group["lr"]), float(beta1), float(beta2), float(group["eps"])))
        fused_adam(*leaves, hyper)
        return loss
