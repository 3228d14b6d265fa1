"""Trainable splat parameterization (counterpart of
``gsplat_tpu.train.params``).

Optimization runs in an unconstrained space:

  * ``log_scale``      — ``scale = exp(log_scale)`` (positivity)
  * ``logit_opacity``  — ``opacity = sigmoid(logit_opacity)`` ((0, 1))
  * ``quat``           — unnormalized; normalized at use (unit constraint)
  * ``pos``, ``color``, ``sh`` — raw

Same transposed SoA layout as :class:`GaussianSplats` (components × splats).
Gradients flow through the activations into the unconstrained parameters.
The six tensors are autograd leaves (``requires_grad=True``) that an
optimizer updates in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from ..models.splats import GaussianSplats

FIELDS = ("pos", "quat", "log_scale", "logit_opacity", "color", "sh")


@dataclasses.dataclass(frozen=True)
class SplatParams:
    pos: torch.Tensor            # (3, N)
    quat: torch.Tensor           # (4, N) xyzw, unnormalized
    log_scale: torch.Tensor      # (3, N)
    logit_opacity: torch.Tensor  # (N,)
    color: torch.Tensor          # (3, N)
    sh: torch.Tensor             # (45, N)

    @property
    def count(self) -> int:
        return self.pos.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in FIELDS}


def _leaves(**tensors) -> SplatParams:
    return SplatParams(
        **{k: v.detach().to(torch.float32).clone().requires_grad_(True) for k, v in tensors.items()}
    )


def params_from_splats(splats: GaussianSplats, eps: float = 1e-6) -> SplatParams:
    """Invert the activations; the result's tensors are new leaves."""
    op = torch.clamp(splats.opacity, eps, 1.0 - eps)
    return _leaves(
        pos=splats.pos,
        quat=splats.orient,
        log_scale=torch.log(torch.clamp(splats.scale, min=eps)),
        logit_opacity=torch.log(op / (1.0 - op)),
        color=splats.color,
        sh=splats.sh,
    )


def splats_from_params(params: SplatParams) -> GaussianSplats:
    norm = torch.sqrt(
        torch.clamp(torch.sum(params.quat * params.quat, dim=0, keepdim=True), min=1e-24)
    )
    return GaussianSplats(
        pos=params.pos,
        orient=params.quat / norm,
        scale=torch.exp(params.log_scale),
        opacity=torch.sigmoid(params.logit_opacity),
        color=params.color,
        sh=params.sh,
    )


def params_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> SplatParams:
    """The JAX package's ``SplatParams``, handed over as numpy arrays under
    its field names (``{f: np.asarray(getattr(p, f)) for f in FIELDS}``), as
    the port's.  ``device=None`` means the card."""
    device = "cuda" if device is None else device
    return _leaves(
        **{name: torch.from_numpy(np.array(arrays[name], dtype=np.float32)).to(device) for name in FIELDS}
    )
