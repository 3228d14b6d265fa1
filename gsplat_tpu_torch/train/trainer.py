"""Training loop: Adam on all splat parameters from posed images (counterpart
of ``gsplat_tpu.train.trainer``): single-device, or SPMD over a (dp, sp) mesh
of ranks — camera batch data-parallel over ``dp``, splats and image tile rows
sharded over ``sp`` with the exchange of ``parallel/render_sharded.py``.

PyTorch's optimizers hold their state and update parameters in place, so the
step function here is ``step(params, target) → loss`` — the JAX package's
``(params, opt_state, target) → (params, opt_state, loss)`` with the first
two carried by ``params``' tensors and the optimizer itself.  Where the JAX
package jits its single-device step, the port captures it in a CUDA graph
on the card (``graphs.py``); the sharded step stays eager (its collectives
run over gloo, which a graph cannot hold).
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
from .. import graphs
from ..ops.binning import RenderStats, report_stats
from ..render import render
from ..utils.config import RenderConfig
from .loss import render_loss, ssim_strip_map
from .params import SplatParams, _leaves, splats_from_params


def default_optimizer(params: SplatParams, lr_pos: float = 1.6e-4) -> torch.optim.Adam:
    """Adam with one parameter group per field, at the per-parameter learning
    rates of standard 3DGS practice (β = (0.9, 0.999), ε = 1e-8, as
    ``optax.adam``).  On CUDA parameters it is ``capturable`` (its step
    count and bias correction live on the device, in float32 as in
    ``optax.adam``), so that :func:`make_train_step` can capture its update;
    PyTorch takes no ``capturable`` Adam on CPU parameters."""
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
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8, capturable=params.device.type == "cuda")


def _require_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Turn ``capturable`` on in every group that has it off, as long as the
    optimizer holds no state yet; raise otherwise."""
    for group in optimizer.param_groups:
        if group.get("capturable", True):
            continue  # on, or an optimizer without the option
        if any(optimizer.state.get(p) for p in group["params"]):
            raise ValueError(
                "make_train_step captures the update on CUDA parameters, which needs an optimizer built "
                "with capturable=True (its state already exists, so it cannot be switched on here)"
            )
        group["capturable"] = True


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
    the tensors ``optimizer`` was built over; they are updated in place.
    Each call is one update.

    On CUDA parameters with the kernel backend (``"auto"``/``"cuda"``) the
    step is the counterpart of the JAX package's ``jax.jit(step)``: a CUDA
    graph (``graphs.py``).
      * Call 1 runs eagerly on the capture stream: it builds the kernels,
        sizes the scan's scratch and creates the optimizer's state.
      * Call 2 captures the whole update — the render with its binning,
        ``CompositeSplats`` forward and backward (the compositing kernels and
        the segment sum), the loss, ``backward()`` and ``optimizer.step()``
        — after ``zero_grad(set_to_none=True)`` (the captured backward then
        writes fresh gradients on every replay), and replays it once.
      * Every later call copies ``target_rgb`` into the graph's target
        buffer and replays.
    The loss returned is a copy: the next replay does not overwrite it.  A
    capture that fails raises; nothing runs eagerly in its place.  The
    optimizer must be ``capturable`` (:func:`default_optimizer` is): a group
    without it is switched on before any state exists, else the first call
    raises.  Several steps may share one optimizer (one a camera): each is
    its own graph, and all share one memory pool, so they replay one after
    another.

    What the graph fixes at call 2, and a caller must therefore not change
    afterwards: the parameter tensors and the optimizer's state tensors (a
    new ``SplatParams``, ``load_state_dict`` or ``restore_checkpoint``: the
    step raises — build a new step), every learning rate and the other
    Python numbers of the optimizer, the config, and the target's shape.
    The camera is read through its tensors: copying new matrices into
    ``camera.view``/``camera.proj``/``camera.derived_pos`` moves the camera
    of every later call.  The parameters' ``.grad`` are the graph's buffers,
    valid right after a call until another graph replays.  After call 2,
    ``step.graph`` is the :class:`~gsplat_tpu_torch.graphs.CapturedGraph`
    (its ``pool_bytes``, its ``launches`` a replay).

    Overflow: the render runs with ``warn_on_drop`` off, and every call
    reports the previous call's ``dropped_pairs`` (when ``config.warn_on_drop``)
    at its start — a deferred read, as ``SceneRegistry``'s, which never
    happens inside a capture — warning once while pairs drop.

    On CPU parameters, and with the ``"tiles"``/``"reference"`` oracles
    (which read device values on the host), every call is eager."""
    quiet = dataclasses.replace(config, warn_on_drop=False)

    def loss_fn(params, target):
        splats = splats_from_params(params)
        img, stats = render(splats, camera, quiet, backend=backend, with_stats=True)
        # composite over white background like 3DGS training convention
        rgb = img[..., :3] + (1.0 - img[..., 3:4])
        return render_loss(rgb, target, lambda_dssim), stats.dropped_pairs

    def update(params: SplatParams, target: torch.Tensor):
        loss, dropped = loss_fn(params, target)
        loss.backward()
        optimizer.step()
        return loss.detach(), dropped

    def eager(params: SplatParams, target: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        return update(params, target)

    st = {"calls": 0, "pending": None, "graph": None}

    def held(params: SplatParams):
        """What the graph holds the addresses of: the leaves and the
        optimizer's state tensors."""
        leaves = tuple(params.as_dict().values())
        return leaves + tuple(t for p in leaves for t in optimizer.state.get(p, {}).values()
                              if isinstance(t, torch.Tensor))

    def step(params: SplatParams, target: torch.Tensor) -> torch.Tensor:
        if st["pending"] is not None:  # the previous call's overflow counter
            report_stats(RenderStats(dropped_pairs=st["pending"]), config)
            st["pending"] = None
        st["calls"] += 1
        if not params.pos.is_cuda or backend not in ("auto", "cuda"):
            loss, st["pending"] = eager(params, target)
            return loss
        if st["calls"] == 1:
            _require_capturable(optimizer)
            loss, st["pending"] = graphs.run_on_capture_stream(eager, params, target, device=params.device)
            return loss
        if st["graph"] is None:
            target_buf = target.detach().to(params.device, torch.float32).clone()
            dropped_buf = torch.zeros((), dtype=torch.int32, device=params.device)

            def captured():
                loss, dropped = update(params, target_buf)
                dropped_buf.copy_(dropped)  # into a buffer outside the graphs' shared pool
                return loss

            optimizer.zero_grad(set_to_none=True)
            graph = graphs.capture(captured, warm_up=False, device=params.device)
            st.update(graph=graph, target=target_buf, dropped=dropped_buf, held=held(params))
            step.graph = graph
        else:
            now = held(params)
            if len(now) != len(st["held"]) or any(a is not b for a, b in zip(now, st["held"])):
                raise RuntimeError(
                    "the parameters or the optimizer's state are not the tensors this step captured "
                    "(replaced, or loaded with load_state_dict); build a new step"
                )
            if tuple(target.shape) != tuple(st["target"].shape):
                raise ValueError(f"target of shape {tuple(target.shape)}, captured {tuple(st['target'].shape)}")
            st["target"].copy_(target)
        loss = st["graph"].replay().clone()
        st["pending"] = st["dropped"]
        return loss

    step.graph = None
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
