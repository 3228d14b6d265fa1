"""Training loop: Adam on all splat parameters from posed images (counterpart
of the single-device half of ``gsplat_tpu.train.trainer``;
``make_sharded_train_step`` belongs to the multi-GPU slice).

PyTorch's optimizers hold their state and update parameters in place, so the
step function here is ``step(params, target) → loss`` — the JAX package's
``(params, opt_state, target) → (params, opt_state, loss)`` with the first
two carried by ``params``' tensors and the optimizer itself.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.camera import Camera
from ..render import render
from ..utils.config import RenderConfig
from .loss import render_loss
from .params import SplatParams, splats_from_params


def default_optimizer(params: SplatParams, lr_pos: float = 1.6e-4) -> torch.optim.Adam:
    """Adam with one parameter group per field, at the per-parameter learning
    rates of standard 3DGS practice (β = (0.9, 0.999), ε = 1e-8, as
    ``optax.adam``)."""
    rates = {
        "pos": lr_pos,
        "quat": 1e-3,
        "log_scale": 5e-3,
        "logit_opacity": 5e-2,
        "color": 2.5e-3,
        "sh": 2.5e-3 / 20.0,
    }
    groups = [
        {"params": [tensor], "lr": rates[name], "name": name}
        for name, tensor in params.as_dict().items()
    ]
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(
    optimizer: torch.optim.Optimizer,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    backend: str = "auto",
    lambda_dssim: float = 0.2,
) -> Callable:
    """Single-device train step: ``step(params, target_rgb) → loss`` (a 0-dim
    tensor on the parameters' device; reading it is the host
    synchronisation).  ``target_rgb``: (H, W, 3) in [0, 1].  ``params`` are
    the tensors ``optimizer`` was built over; they are updated in place."""

    def loss_fn(params, target):
        splats = splats_from_params(params)
        img = render(splats, camera, config, backend=backend)
        # composite over white background like 3DGS training convention
        rgb = img[..., :3] + (1.0 - img[..., 3:4])
        return render_loss(rgb, target, lambda_dssim)

    def step(params: SplatParams, target: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, target)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
