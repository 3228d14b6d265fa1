"""Plain PyTorch reference of the first training steps of a splat scene.

The parameters are the splats' fields in an unconstrained space (the log of
the scale, the logit of the opacity clamped to [1e-6, 1 - 1e-6], the
quaternion normalised at use); the loss is (1 - lambda) * L1 + lambda *
(1 - SSIM) of the frame composited over white against the target, SSIM with
an 11-tap Gaussian window (sigma 1.5, zero padding, float32 throughout);
the update is Adam (beta 0.9, 0.999, eps 1e-8) with one learning rate per
field.  Gradients come from autograd through ``reference.render``.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from reference import render as ref

FIELDS = ("pos", "quat", "log_scale", "logit_opacity", "color", "sh")
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def params_of(fields: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    op = torch.clamp(fields["opacity"], 1e-6, 1.0 - 1e-6)
    p = {"pos": fields["pos"], "quat": fields["orient"], "log_scale": torch.log(torch.clamp(fields["scale"], min=1e-6)),
         "logit_opacity": torch.log(op / (1.0 - op)), "color": fields["color"], "sh": fields["sh"]}
    return {k: v.detach().to(dtype).clone().requires_grad_(True) for k, v in p.items()}


def splats_of(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    norm = torch.sqrt(torch.clamp(torch.sum(p["quat"] * p["quat"], dim=0, keepdim=True), min=1e-24))
    return {"pos": p["pos"], "orient": p["quat"] / norm, "scale": torch.exp(p["log_scale"]),
            "opacity": torch.sigmoid(p["logit_opacity"]), "color": p["color"], "sh": p["sh"]}


def _window(size: int, sigma: float, dtype, device) -> torch.Tensor:
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return torch.from_numpy(g / np.sum(g)).to(device=device, dtype=dtype)


def _blur(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(H, W, C) filtered by ``w`` along H and W, zero padding, same size."""
    c, k = x.shape[2], w.shape[0]
    y = x.permute(2, 0, 1)[None]
    y = F.conv2d(F.pad(y, (0, 0, (k - 1) // 2, k // 2)), w.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    y = F.conv2d(F.pad(y, ((k - 1) // 2, k // 2, 0, 0)), w.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return y[0].permute(1, 2, 0)


def ssim(p: torch.Tensor, t: torch.Tensor, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    w = _window(size, sigma, p.dtype, p.device)
    with torch.backends.cudnn.flags(allow_tf32=False):
        mu_p, mu_t = _blur(p, w), _blur(t, w)
        var_p = _blur(p * p, w) - mu_p * mu_p
        var_t = _blur(t * t, w) - mu_t * mu_t
        cov = _blur(p * t, w) - mu_p * mu_t
    num = (2.0 * mu_p * mu_t + c1) * (2.0 * cov + c2)
    den = (mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)


def loss_of(image: torch.Tensor, target: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    rgb = image[..., :3] + (1.0 - image[..., 3:4])
    loss = (1.0 - lambda_dssim) * torch.mean(torch.abs(rgb - target))
    return loss + lambda_dssim * (1.0 - ssim(rgb, target))


def steps(fields, views, targets, width: int, height: int, render_cfg: Dict, rates: Dict[str, float],
          lambda_dssim: float, dtype=torch.float32) -> Dict:
    """One Adam step on each view in turn from the splats ``fields``: each
    step's loss, the first gradient, the parameters' change after the last
    step (on the host, float32), and the counts of the first step's frame."""
    p = params_of(fields, dtype)
    start = {k: v.detach().clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[float] = []
    first_grad = counts = None
    for i, (pose, target) in enumerate(zip(views, targets)):
        frame = ref.render(splats_of(p), pose.view_t, pose.proj_t, pose.pos_t, width, height, render_cfg,
                           dtype=dtype, grad=True)
        loss = loss_of(frame.image, target.to(dtype), lambda_dssim)
        grads = torch.autograd.grad(loss, [p[k] for k in FIELDS])
        losses.append(float(loss.detach()))
        if i == 0:
            first_grad = {k: g.detach().float().cpu() for k, g in zip(FIELDS, grads)}
            counts = frame.counts
        del frame, loss
        t = i + 1
        with torch.no_grad():
            for k, g in zip(FIELDS, grads):
                m[k] = BETAS[0] * m[k] + (1.0 - BETAS[0]) * g
                v2[k] = BETAS[1] * v2[k] + (1.0 - BETAS[1]) * g * g
                m_hat = m[k] / (1.0 - BETAS[0] ** t)
                v_hat = v2[k] / (1.0 - BETAS[1] ** t)
                p[k] -= rates[k] * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        del grads
    change = {k: (p[k].detach() - start[k]).float().cpu() for k in FIELDS}
    return {"losses": losses, "first_grad": first_grad, "change": change, "counts": counts}


def gaps(losses, first_grad, change, run) -> Dict[str, float]:
    """The numbers compared: the worst step's relative loss gap, and the
    worst leaf's norm gap of the first gradient and of the change."""
    loss_gap = _worst(abs(a - b) / abs(b) for a, b in zip(losses, run["losses"]))
    return {"loss_gap": loss_gap, "grad_gap": norm_gap(first_grad, run["first_grad"]),
            "change_gap": norm_gap(change, run["change"], run["first_grad"])}


def norm_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor] = None):
    """The worst leaf's gap between the norms of ``got`` and ``want``, over
    the larger of the reference leaf's norm and the median leaf's.  With
    ``grads`` (the reference's first gradient), leaves whose gradient norm
    is under a thousandth of the median leaf's are left out: Adam moves
    them by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in want}
    median = statistics.median(norms.values())
    keep = list(want)
    if grads is not None:
        gn = {k: float(torch.linalg.vector_norm(grads[k].double())) for k in grads}
        gmed = statistics.median(gn.values())
        keep = [k for k in want if gn[k] >= 1e-3 * gmed]
    return _worst(abs(float(torch.linalg.vector_norm(got[k].double())) - norms[k]) / max(norms[k], median)
                  for k in keep)


def _worst(values) -> float:
    """The largest value; infinite if any is not finite."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf
