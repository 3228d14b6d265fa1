"""Training loop: Adam on all splat parameters from posed images (counterpart
of ``gsplat_tpu.train.trainer``): single-device, or SPMD over a (dp, sp) mesh
of ranks — camera batch data-parallel over ``dp``, splats and image tile rows
sharded over ``sp`` with the exchange of ``parallel/render_sharded.py``.

PyTorch's optimizers hold their state and update parameters in place, so the
step function here is ``step(params, target) → loss`` — the JAX package's
``(params, opt_state, target) → (params, opt_state, loss)`` with the first
two carried by ``params``' tensors and the optimizer itself.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from ..models.camera import Camera, camera_from_numpy
from ..parallel import collectives as C
from ..parallel.mesh import BATCH_AXIS, SPLAT_AXIS, Mesh, pad_to_multiple
from ..parallel.render_sharded import local_strip_render
from ..render import render
from ..utils.config import RenderConfig
from .loss import render_loss, ssim_strip_map
from .params import SplatParams, _leaves, splats_from_params


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


def shard_params(params: SplatParams, mesh: Mesh) -> SplatParams:
    """This rank's contiguous block of the parameters, N padded to the
    ``sp`` axis, as new leaves on the mesh's device.  Padding splats have
    logit-opacity −20 (opacity ≈ 2e-9: culled at binning) and the identity
    quaternion, as in the JAX package."""
    sp = mesh.shape[SPLAT_AXIS]
    n = params.count
    extra = pad_to_multiple(n, sp) - n
    fields = {k: v.detach() for k, v in params.as_dict().items()}
    if extra:
        fields = {k: F.pad(v, (0, extra)) for k, v in fields.items()}
        fields["logit_opacity"][n:] = -20.0
        fields["quat"][3, n:] = 1.0
    n_local = (n + extra) // sp
    lo = mesh.sp_index * n_local
    return _leaves(**{k: v[..., lo : lo + n_local].to(mesh.device) for k, v in fields.items()})


def make_sharded_train_step(
    optimizer: torch.optim.Optimizer,
    camera: Camera,
    mesh: Mesh,
    config: RenderConfig = RenderConfig(),
    backend: str = "auto",
    lambda_dssim: float = 0.2,
) -> Callable:
    """SPMD train step over a (dp, sp) mesh, called by every rank.

    Layout: each rank holds its ``sp`` block of the parameters
    (:func:`shard_params`) and ``optimizer`` (e.g. :func:`default_optimizer`
    over that block) holds only that block's moments; the camera batch is
    split over ``dp``, the image rows over ``sp``.  The render inside the
    loss is the renderer's own per-rank path
    (:func:`gsplat_tpu_torch.parallel.render_sharded.local_strip_render`),
    so its exchange policies (f32 / bf16 gather, strip exchange) apply to
    training too.  Strips are always contiguous, whatever
    ``config.row_assignment``: the SSIM windows at a strip's edge read 5
    rows of the neighbours (:func:`~gsplat_tpu_torch.train.loss.ssim_strip_map`).

    The loss is (1−λ)·L1 + λ·(1−SSIM) over the frame's real rows: each rank
    adds its strip's share of the frame's mean — the strip mean over
    ``sp`` when the height divides into the strips, as in the JAX package,
    and with the padding rows below the frame left out when it does not (the
    JAX package counts them) — and divides by its ``b_local`` cameras.
    Gradients over ``sp`` arrive summed through the exchange's transpose;
    over ``dp`` they take an ``all_reduce`` mean.  The loss returned is the
    ``sp`` sum and ``dp`` mean: the batch's mean loss, on every rank.

    Returns ``step(params, views, projs, targets) → loss`` (updating
    ``params`` in place): ``views``/``projs`` (B, 4, 4) camera matrices with
    B a multiple of dp, ``targets`` (B, H or H_pad, W, 3) in [0, 1], the
    same on every rank; each rank takes its cameras and rows.
    """
    if backend == "auto":
        backend = "cuda"
    dp, sp = mesh.shape[BATCH_AXIS], mesh.shape[SPLAT_AXIS]
    sp_group, dp_group = mesh.group(SPLAT_AXIS), mesh.group(BATCH_AXIS)
    height, width = camera.height, camera.width
    h_pad = pad_to_multiple(height, sp * config.tile_h)
    strip_h = h_pad // sp
    config = dataclasses.replace(config, row_assignment="contiguous", row_stride=1, col_stride=1)
    row0 = mesh.sp_index * strip_h
    valid = min(max(height - row0, 0), strip_h)   # this strip's rows inside the frame
    share = valid / height                        # its share of the frame's rows
    keep = (torch.arange(strip_h, device=mesh.device) < valid).to(torch.float32)[:, None, None]
    explicit = camera.explicit_camera_pos
    explicit = None if explicit is None else explicit.cpu().numpy()

    def strip_loss(params, view, proj, target):
        cam = camera_from_numpy(view, proj, width, height, explicit_camera_pos=explicit, device=mesh.device)
        strip = local_strip_render(splats_from_params(params), cam, strip_h, sp, config, backend, sp_group)
        tgt = target[row0 : row0 + strip_h].to(mesh.device, torch.float32)
        if tgt.shape[0] < strip_h:
            tgt = F.pad(tgt, (0, 0, 0, 0, 0, strip_h - tgt.shape[0]))
        # rows below the frame are zeros in both images: the full image's
        # filter sees zero padding there too
        rgb = (strip[..., :3] + (1.0 - strip[..., 3:4])) * keep
        tgt = tgt * keep
        n_px = max(valid, 1) * width * 3
        loss = (1.0 - lambda_dssim) * share * torch.sum(torch.abs(rgb - tgt)) / n_px
        if lambda_dssim > 0.0:
            smap = ssim_strip_map(rgb, tgt, sp_group, sp)
            loss = loss + lambda_dssim * share * (1.0 - torch.sum(smap[:valid]) / n_px)
        return loss

    def step(params: SplatParams, views: torch.Tensor, projs: torch.Tensor, targets: torch.Tensor):
        b = views.shape[0]
        if b % dp:
            raise ValueError(f"batch of {b} cameras does not divide over dp={dp}")
        b_local = b // dp
        first = mesh.dp_index * b_local
        views_h = views.detach().cpu().numpy()
        projs_h = projs.detach().cpu().numpy()
        optimizer.zero_grad(set_to_none=True)
        total = 0.0
        for k in range(first, first + b_local):
            total = total + strip_loss(params, views_h[k], projs_h[k], targets[k])
        loss = total / b_local
        loss.backward()
        if dp_group is not None:
            for t in params.as_dict().values():
                t.grad = C.pmean(t.grad, dp_group)
        optimizer.step()
        return C.pmean(C.psum(loss.detach(), sp_group), dp_group)

    return step
