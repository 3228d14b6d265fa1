"""Wireframe debug rendering: splat quad outlines (counterpart of
``gsplat_tpu.ops.wireframe``).

A per-pixel band test on the quad-basis coordinates: pixels within about
``line_px`` of the quad's ±2 edge take the splat's colour; the nearest splat
wins (opaque lines, like depth-tested GL lines).

Backends:
  * ``"cuda"`` — the compositing kernel in wireframe mode (an opaque band
    test replaces the Gaussian falloff; front-to-back order and the early
    stop give nearest-splat-wins) on the beauty pass's sort and binning.  On
    CPU tensors the kernel wrapper takes its plain version.
  * ``"reference"`` — O(N·H·W) per-pixel scan (the debug oracle).
  * ``"auto"`` — ``"cuda"``; nothing probes for a card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.camera import Camera
from ..models.splats import GaussianSplats
from ..utils.config import RenderConfig
from .covariance import QUAD_EXTENT
from .projection import ROW_DEPTH, ROW_HX, ROW_HY, ROW_OP, ROW_VALID, ProjectedSplats, project_splats
from .rasterize_ref import sanitize_projected
from .rasterize_tiles import sort_by_depth


def _background(background, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(background, dtype=torch.float32, device=like.device)


def render_wireframe(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    line_px: float = 1.0,
    background=None,
    backend: str = "auto",
) -> torch.Tensor:
    """Render quad outlines.  Returns (H, W, 4); alpha 1 where a line covers.
    ``background``: RGB that fills the uncovered pixels' colour."""
    if backend == "auto":
        backend = "cuda"
    if backend == "cuda":
        return _wireframe_cuda(splats, camera, config, line_px, background)
    if backend != "reference":
        raise ValueError(f"unknown wireframe backend {backend!r}")
    p = sort_by_depth(sanitize_projected(project_splats(splats, camera, 0)))
    rows = p.fields.T  # (N, 16)

    h, w = camera.height, camera.width
    dev = rows.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None]
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :]
    px = xs.expand(h, w)
    py = ys.expand(h, w)

    color = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    covered = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for row in rows:
        # quad-basis coords from A = v1/|v1|², B = v2/|v2|²: q = d·A, d·B
        dx = px - row[0]
        dy = py - row[1]
        qx = dx * row[2] + dy * row[3]
        qy = dx * row[4] + dy * row[5]
        # |A| = 1/|v1| → band half-width in quad units for ~line_px on screen
        wq1 = line_px * torch.sqrt(row[2] * row[2] + row[3] * row[3])
        wq2 = line_px * torch.sqrt(row[4] * row[4] + row[5] * row[5])
        m = torch.maximum(torch.abs(qx), torch.abs(qy))
        wq = torch.where(torch.abs(qx) > torch.abs(qy), wq1, wq2)
        on_edge = (torch.abs(m - QUAD_EXTENT) <= wq) & (m <= QUAD_EXTENT + wq)
        hit = on_edge & ~covered
        color = torch.where(hit[..., None], row[6:9], color)
        covered = covered | on_edge
    alpha = covered.to(torch.float32)
    if background is not None:
        color = torch.where(covered[..., None], color, _background(background, color))
    return torch.cat([color, alpha[..., None]], dim=-1)


def _wireframe_projected(splats, camera, line_px) -> ProjectedSplats:
    """The sanitized fields the wireframe pass bins and composites, in
    storage order (the image carries no gradient: the band test has none)."""
    with torch.no_grad():
        f = project_splats(splats, camera, 0, payload_dtype="float32").fields
        # The reference draws wireframes regardless of opacity and the band
        # extends ``line_px`` past the ±2 quad: neutralise the opacity cull
        # and grow the binning bbox by the line width (in place: the fields
        # keep the projection's layout, which the gather reads fastest).
        f[ROW_OP] = f[ROW_VALID]
        f[ROW_HX : ROW_HY + 1] += line_px
    return ProjectedSplats(fields=f)


def _wireframe_inputs(splats, camera, config, line_px):
    """The compositor's arguments of the wireframe pass: ``(args, binned)``
    with ``args`` = (payload, pair_splat, tile_base, tile_phi, tile_span,
    nty, ntx, height, width, config)."""
    from .binning import bin_splats, gather_frame, tile_grid

    if config.tile_h != 32 or config.tile_w != 32:
        raise ValueError("the cuda backend requires tile_h == tile_w == 32")
    # Wireframe skips quantize_payload (it rewrites opacity to the validity
    # flag), so the packed-payload policy would bit-truncate unrounded
    # colours: the float32 payload always.  No depth test either: the band
    # test does not take one.
    cfg = dataclasses.replace(
        config, wireframe=True, line_px=float(line_px), payload_dtype="float32", depth_test=False,
    )
    f = _wireframe_projected(splats, camera, line_px).fields
    # the payload and the binning operands in depth order, in one gather;
    # binning skips the exact-coverage cull in wireframe mode
    glue = gather_frame(f, torch.argsort(f[ROW_DEPTH], stable=True), camera.width, camera.height, cfg)
    binned = bin_splats(None, camera.width, camera.height, cfg, with_tiles=False, operands=glue.operands)
    nty, ntx = tile_grid(camera.width, camera.height, cfg.tile_h, cfg.tile_w)
    args = (glue.payload, binned.pair_splat, binned.tile_base, binned.tile_phi,
            binned.tile_span, nty, ntx, camera.height, camera.width, cfg)
    return args, binned


def _wireframe_cuda(splats, camera, config, line_px, background) -> torch.Tensor:
    """Wireframe on the production tile pipeline (project → sort → bin →
    compositing kernel in band-test mode).  The same nearest-wins image as
    the oracle: an opaque band hit saturates the pixel, so later (farther)
    splats contribute exactly zero."""
    from .kernels.composite import composite_splats

    args, _binned = _wireframe_inputs(splats, camera, config, line_px)
    img, _used = composite_splats(*args)
    if background is not None:
        covered = img[..., 3:4] > 0.5
        img = torch.cat([torch.where(covered, img[..., :3], _background(background, img)), img[..., 3:4]], dim=-1)
    return img


def render_wire_over(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    line_px: float = 1.0,
    backend: str = "auto",
) -> torch.Tensor:
    """Wire-over-shaded: quad outlines drawn ON TOP of the beauty pass.

    The reference draws the line quads during the native geometry pass and
    then composites the splats with the under operator, so a line pixel
    enters the blend with its destination alpha already saturated: splat
    contributions are scaled by ``1 − wire.a`` there and the lines stay fully
    visible.  Exactly that algebra: ``out = wire + beauty · (1 − wire.a)``,
    the beauty pass rendered by ``render(..., backend=backend)`` with
    ``config``, the lines by the kernel (``"cuda"``/``"auto"``) or the oracle
    (any other backend).

    Returns (H, W, 4) premultiplied RGBA.
    """
    from ..render import render  # local import: render imports this module's siblings

    if backend == "auto":
        backend = "cuda"
    wire_backend = "cuda" if backend == "cuda" else "reference"
    wire = render_wireframe(splats, camera, config, line_px=line_px, backend=wire_backend)
    beauty = render(splats, camera, config, backend=backend)
    return wire + beauty * (1.0 - wire[..., 3:4])
