"""Top-level render entry point (counterpart of ``gsplat_tpu.render``).

``image = render(splats, camera, config)``: project → global depth sort →
tile binning → compositing, on the device the splats live on.

Backends:
  * ``"cuda"``     — the main path: the projection, the frame's glue (the
    depth-order gather of the payload, the binning's marks and pair
    expansion), the prefix scans of the binning and the compositing go
    through the kernel wrappers (``ops/kernels``).  On CUDA
    tensors the wrappers launch the hand-written kernels; on CPU tensors they
    take their plain PyTorch versions, so a CPU run walks the same code up to
    the launch.  Differentiable: when gradients are enabled and a splat
    tensor requires one, the binning also builds the gradient map and the
    compositing runs as ``CompositeSplats`` (checkpointed forward kernel;
    backward kernel → segment-sum kernel → per-splat combine).  A render
    that needs no gradient pays for none of that.
  * ``"tiles"``    — plain-PyTorch tiled compositing (mid oracle).
  * ``"reference"``— O(N·H·W) per-pixel oracle (ground truth).
  * ``"auto"``     — ``"cuda"``.  Nothing probes for a card and quietly picks
    another backend.

Compositing into a host scene (``background_depth``, ``background_rgba``) and
the wireframe debug view (``ops/wireframe.py``) ride the same kernels in
their depth-test and band-test modes; :func:`render_strip` (one device's
strip of a sharded render, ``parallel/render_sharded.py``) in their
strided/offset tile mapping.
"""

from __future__ import annotations

import dataclasses

import torch

from .models.camera import Camera
from .models.splats import GaussianSplats
from .ops.binning import (
    RenderStats,
    bin_splats,
    count_pairs,
    gather_frame,
    tile_grid,
    warn_if_dropped,
)
from .ops.kernels.composite import composite_splats, composite_splats_diff, pack_payload
from .ops.projection import ROW_DEPTH, project_splats
from .ops.rasterize_ref import render_reference, sanitize_projected
from .ops.rasterize_tiles import build_tile_lists, composite_tile_lists, render_tiles
from .utils.config import RenderConfig


def _composite_cuda(p, binned, nty, ntx, height, width, config, need_grad, offsets=(0, 0)):
    """A strip's compositing of binned pairs (no depth test): the
    differentiable ``CompositeSplats`` when a gradient is needed, else one
    forward launch on the payload (packed into 8 int32 rows for
    ``payload_dtype="packed"``)."""
    rows = p.fields[:10]
    if need_grad:
        return composite_splats_diff(rows, binned, nty, ntx, height, width, config, offsets=offsets)
    payload = pack_payload(p.fields) if config.payload_dtype == "packed" else rows.contiguous()
    image, _used = composite_splats(
        payload, binned.pair_splat, binned.tile_base, binned.tile_phi, binned.tile_span,
        nty, ntx, height, width, config, offsets=offsets,
    )
    return image


def render_cuda(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    order: torch.Tensor = None,
    with_stats: bool = False,
    bg_depth: torch.Tensor = None,
) -> torch.Tensor:
    """Kernel-path render (the counterpart of ``render_pallas``).  Returns
    (H, W, 4) premultiplied RGBA — or ``(image, RenderStats)`` with
    ``with_stats=True``.

    ``order``: optional precomputed depth permutation (amortized sort).
    ``bg_depth``: the (H, W) view-space scene depth of ``config.depth_test``.
    """
    if config.tile_h != 32 or config.tile_w != 32:
        raise ValueError("the cuda backend requires tile_h == tile_w == 32")
    height, width = camera.height, camera.width
    leaves = (splats.pos, splats.orient, splats.scale, splats.opacity, splats.color, splats.sh)
    need_grad = torch.is_grad_enabled() and any(t.requires_grad for t in leaves)
    if splats.count == 0:
        image = torch.zeros((height, width, 4), dtype=torch.float32, device=splats.device)
        if need_grad:
            # an empty scene still hands a (zero) gradient back to its inputs
            image = image + sum(t.sum() for t in leaves if t.requires_grad) * 0.0
        zero = torch.zeros((), dtype=torch.int32, device=splats.device)
        return (image, RenderStats(dropped_pairs=zero)) if with_stats else image
    nty, ntx = tile_grid(width, height, config.tile_h, config.tile_w)
    # The projection writes sanitized, quantized fields; one gather writes
    # the payload and the binning's operands in depth order (the binning
    # then works purely in rank space, and within a tile's segment the
    # payload columns the compositor reads are nearly ascending); the
    # pairs' expansion and key are one kernel.  With a gradient the payload
    # is the float32 rows, the gather's backward the inverse gather and the
    # projection's backward takes sanitize's VJP.
    fields = project_splats(
        splats, camera, config.sh_order, tight_footprint=not config.soft_cutoff,
        only_sh=config.only_sh, payload_dtype=config.payload_dtype,
    ).fields
    if order is None:
        order = torch.argsort(fields[ROW_DEPTH].detach(), stable=True)
    glue = gather_frame(fields, order, width, height, config, differentiable=need_grad)
    binned = bin_splats(None, width, height, config, with_tiles=False, with_grad_map=need_grad,
                        operands=glue.operands)
    if need_grad:
        image = composite_splats_diff(glue.payload, binned, nty, ntx, height, width, config, bg_depth=bg_depth)
    else:
        image, _used = composite_splats(
            glue.payload, binned.pair_splat, binned.tile_base, binned.tile_phi, binned.tile_span,
            nty, ntx, height, width, config, bg_depth=bg_depth,
        )
    # After the last launch is queued: the only host read of the frame, kept
    # for direct callers.  SceneRegistry renders with warn_on_drop=False and
    # reports the returned stats at its next frame, so that its frames make
    # no device sync: do not move this read into the registry's frame.
    warn_if_dropped(binned, config)
    if with_stats:
        return image, RenderStats(dropped_pairs=binned.dropped_pairs)
    return image


def render_strip(
    projected,
    width: int,
    strip_h: int,
    row_offset: int,
    config: RenderConfig,
    backend: str = "cuda",
    n_strips: int = 1,
    col_offset: int = 0,
):
    """Bin + composite one device's strip of tile rows (the counterpart of
    the JAX package's ``parallel.render_sharded._render_strip``).

    ``projected`` is the whole sanitized, depth-sorted projected-splat set
    (``sort_by_depth``).  The strip is a (strip_h, width) image whose
    local tile (ℓy, ℓx) is the frame's tile (``row_offset + ℓy·row_stride``,
    ``col_offset + ℓx·col_stride``) under ``config``'s strides; offsets are
    in tiles.  Splat coordinates are never shifted, so a strip is bit for
    bit the matching pixels of a full-frame render that walks the same pairs
    (``transmittance_eps = 0``; with an early stop, the stop grid is anchored
    at each tile's chunk-aligned segment base, which moves with the strip).
    The pair budget is ``config.strip_pair_budget(n, n_strips)``.

    Backends: ``"cuda"`` — the scans and the compositor through the kernel
    wrappers in their strided mode, differentiable through
    ``CompositeSplats`` (the gradient map is built when the fields require a
    gradient); ``"tiles"`` — the plain tiled compositor with the same
    mapping.  Returns ``(image, dropped_pairs)``.
    """
    if config.depth_test:
        raise ValueError("a strip render takes no scene depth (config.depth_test)")
    if backend == "auto":
        backend = "cuda"
    if backend not in ("cuda", "tiles"):
        raise ValueError(f"unknown strip backend {backend!r}")
    p = projected
    cuda = backend == "cuda"
    need_grad = cuda and torch.is_grad_enabled() and p.fields.requires_grad
    binned = bin_splats(
        p, width, strip_h, config, row_offset=row_offset,
        with_tiles=not cuda, with_grad_map=need_grad,
        budget=config.strip_pair_budget(p.count, n_strips), col_offset=col_offset,
    )
    nty, ntx = tile_grid(width, strip_h, config.tile_h, config.tile_w)
    if cuda:
        image = _composite_cuda(p, binned, nty, ntx, strip_h, width, config, need_grad,
                                offsets=(row_offset, col_offset))
    else:
        lists = build_tile_lists(binned, nty * ntx, config.tile_capacity, p.count)
        image = composite_tile_lists(lists, p.fields, width, strip_h, config, row_offset=row_offset,
                                     col_offset=col_offset)
    warn_if_dropped(binned, config)
    return image, binned.dropped_pairs


def measure_pairs(
    splats: GaussianSplats, camera: Camera, config: RenderConfig = RenderConfig()
) -> int:
    """Exact (tile, splat) pair count this frame would bin (host int)."""
    p = sanitize_projected(
        project_splats(
            splats, camera, config.sh_order,
            tight_footprint=not config.soft_cutoff,
        )
    )
    return int(count_pairs(p, camera.width, camera.height, config))


def tune_pair_budget(
    splats: GaussianSplats,
    cameras,
    config: RenderConfig = RenderConfig(),
    headroom: float = 1.2,
    bucket: int = 1 << 17,
) -> RenderConfig:
    """Measure the scene's real (tile, splat) pair count and return a config
    whose static pair budget fits it, instead of the worst-case
    ``pairs_per_splat·N`` default.

    Every pair-proportional array is sized by the *static* budget, so fitting
    it cuts memory and the binning's work proportionally.  One cheap counting
    pass per camera, take the max, apply ``headroom``, round up to ``bucket``
    so nearby cameras share array sizes.  The overflow contract is unchanged:
    if a later frame exceeds the tuned budget, the farthest pairs drop and
    the cull warning fires — raise ``headroom`` then.  The measured need wins
    in BOTH directions: heavy-tailed scenes routinely exceed the
    ``pairs_per_splat`` default.

    ``cameras``: one Camera or an iterable (e.g. the training set's extremes).
    """
    if isinstance(cameras, Camera):
        cameras = [cameras]
    worst = 0
    for cam in cameras:
        worst = max(worst, measure_pairs(splats, cam, config))
    budget = -(-int(round(worst * headroom)) // bucket) * bucket
    return dataclasses.replace(config, pair_budget_override=max(budget, bucket))


def composite_over(image: torch.Tensor, background_rgba: torch.Tensor) -> torch.Tensor:
    """Under-composite a premultiplied splat layer over an opaque-or-not
    background: ``out = splat + (1 − splat_a)·bg``."""
    a = image[..., 3:4]
    return image + (1.0 - a) * background_rgba


def render(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    backend: str = "auto",
    with_stats: bool = False,
    background_rgba: torch.Tensor = None,
    background_depth: torch.Tensor = None,
) -> torch.Tensor:
    """Render a splat scene on the splats' device.  Returns (H, W, 4)
    premultiplied RGBA.

    ``with_stats=True`` returns ``(image, RenderStats)`` instead; pass the
    stats to :func:`gsplat_tpu_torch.ops.binning.report_stats`.

    Compositing into a host scene (the reference's beauty-pass contract —
    splats drawn after all opaque geometry, z-tested against the scene's
    depth buffer but not z-written, under-blended over its colour):

    * ``background_depth``: (H, W) float32 view-space scene depth — per
      pixel, splat contributions behind it are killed before blending
      (switches on ``config.depth_test``; the packed payload has no view-z
      row, so ``RenderConfig`` refuses the two together);
    * ``background_rgba``: (H, W, 4) scene colour the splat layer is
      under-composited over (with or without the depth test).

    ``config.wireframe`` runs the compositor's band test on this pass's
    payload, as the JAX package's kernel path does (forward only); the
    wireframe debug view itself is :func:`gsplat_tpu_torch.ops.wireframe.render_wireframe`.
    """
    if config.row_stride != 1 or config.col_stride != 1:
        raise ValueError(
            "row_stride/col_stride map a sharded render's strips (render_strip, "
            "parallel.render_sharded); a full frame takes strides 1"
        )
    if background_depth is not None and not config.depth_test:
        config = dataclasses.replace(config, depth_test=True)
    if config.depth_test and background_depth is None:
        raise ValueError("config.depth_test requires background_depth")
    if backend == "auto":
        backend = "cuda"
    if backend == "cuda":
        out = render_cuda(splats, camera, config, with_stats=with_stats, bg_depth=background_depth)
    elif backend == "tiles":
        out = render_tiles(splats, camera, config, with_stats=with_stats, bg_depth=background_depth)
    elif backend == "reference":
        image = render_reference(splats, camera, config, bg_depth=background_depth)
        if with_stats:
            # the O(N·H·W) oracle composites every splat — nothing can drop
            zero = torch.zeros((), dtype=torch.int32, device=image.device)
            out = (image, RenderStats(dropped_pairs=zero))
        else:
            out = image
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if background_rgba is not None:
        if with_stats:
            out = (composite_over(out[0], background_rgba), out[1])
        else:
            out = composite_over(out, background_rgba)
    return out
