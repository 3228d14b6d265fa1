"""Reference (oracle) rasterizer: unfused, per-pixel, runs anywhere
(counterpart of ``gsplat_tpu.ops.rasterize_ref``).

One loop over splats in global depth order:

  * sort: ascending squared world distance to camera;
  * fragment: quad-basis coordinates (qx, qy) with footprint |q|≤2, falloff
    ``α = exp(−(qx²+qy²))·opacity`` clamped then cut at 1/255;
  * blend: front-to-back "under" operator —
    ``C += rgb·α·(1−A); A += α·(1−A)``, premultiplied output.

O(N·H·W) — the ground truth for image tests, not a production path.
"""

from __future__ import annotations

import functools

import torch

from ..models.camera import Camera
from ..models.splats import GaussianSplats
from ..utils.config import RenderConfig
from .covariance import ALPHA_CUTOFF, QUAD_EXTENT
from .projection import ROW_DEPTH, ROW_VALID, ROW_VIEWZ, ProjectedSplats, project_splats

# Benign per-field replacement values for invalid (behind-camera) splats:
# far-offscreen center, unit quad basis, zero color/opacity, +inf depth.
_BENIGN = (
    -1e7, -1e7, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0,
    float("inf"), 0.0, 0.0, 0.0, 0.0, 0.0,
)


@functools.lru_cache(maxsize=8)
def _benign_column(device: torch.device) -> torch.Tensor:
    return torch.tensor(_BENIGN, dtype=torch.float32, device=device)[:, None]


def sanitize_projected(p: ProjectedSplats) -> ProjectedSplats:
    """Replace invalid (behind-camera) splats' payload with benign values so
    masked-out lanes can't contribute NaN/Inf."""
    valid = p.fields[ROW_VALID : ROW_VALID + 1] > 0.5
    fields = torch.where(valid, p.fields, _benign_column(p.fields.device))
    return ProjectedSplats(fields=fields)


class _RoundBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 → bf16-rounded f32 (round to nearest even) with a STRAIGHT-THROUGH
    gradient, as the JAX package's ``round_bf16`` (identity VJP).  PyTorch
    runs eagerly and never elides the convert pair, so the plain cast is the
    JAX package's integer-bit rounding bit for bit on finite values; but
    autograd through the cast pair would round the *cotangent* to bf16 on the
    way back, so the backward is spelled out as the identity."""
    return _RoundBF16.apply(x)


def quantize_payload(p: ProjectedSplats, config) -> ProjectedSplats:
    """Apply the configured payload precision policy: round the 10 compositor
    payload rows to ``config.payload_dtype``, keeping the geometry rows (depth
    key, validity, footprint) float32.  Applied uniformly in every backend so
    cross-backend parity is preserved under quantization.

    ``"packed"`` rounds only the color+opacity rows (6..9) to bf16, keeping
    the geometric rows (center, quad basis) f32 — the precision split the
    kernel path's pairwise bit-packing needs."""
    if config.payload_dtype == "float32":
        return p
    if config.payload_dtype == "packed":
        q = round_bf16(p.fields[6:10])
        return ProjectedSplats(
            fields=torch.cat([p.fields[:6], q, p.fields[10:]], dim=0)
        )
    q = round_bf16(p.fields[:10])
    return ProjectedSplats(fields=torch.cat([q, p.fields[10:]], dim=0))


def splat_alpha_image(
    cx, cy, ax, ay, bx, by, opacity, px, py, max_alpha, soft_cutoff=False
):
    """Per-pixel alpha of one splat over a pixel grid.

    (ax, ay) = v1/|v1|², (bx, by) = v2/|v2|² — the quad-basis rows, so
    ``qx = d·A, qy = d·B``.  With ``soft_cutoff=False`` applies the quad-extent
    mask and the 1/255 discard.
    """
    dx = px - cx
    dy = py - cy
    qx = dx * ax + dy * ay
    qy = dx * bx + dy * by
    power = qx * qx + qy * qy
    alpha = torch.clamp(torch.exp(-power) * opacity, 0.0, max_alpha)
    if soft_cutoff:
        return alpha
    inside = (torch.abs(qx) <= QUAD_EXTENT) & (torch.abs(qy) <= QUAD_EXTENT)
    keep = inside & (alpha >= ALPHA_CUTOFF)
    return torch.where(keep, alpha, 0.0)


def composite_reference(
    projected: ProjectedSplats,
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
    bg_depth: torch.Tensor = None,
) -> torch.Tensor:
    """Depth-sort + front-to-back composite.  Returns (H, W, 4) premultiplied
    RGBA (alpha channel = 1 − final transmittance).

    ``bg_depth``: optional (H, W) view-space scene depth — splat
    contributions whose view-z lies behind it are killed per pixel (the
    host scene's z-tested beauty pass)."""
    p = sanitize_projected(projected)
    order = torch.argsort(p.fields[ROW_DEPTH], stable=True)
    rows = p.fields[:, order].T  # (N, 16)
    dev = rows.device

    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    px = xs.expand(height, width)
    py = ys.expand(height, width)

    color_acc = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    transmittance = torch.ones((height, width), dtype=torch.float32, device=dev)
    for row in rows:
        alpha = splat_alpha_image(
            row[0], row[1], row[2], row[3], row[4], row[5], row[9],
            px, py, config.max_alpha, config.soft_cutoff,
        )
        if bg_depth is not None:
            alpha = torch.where(row[ROW_VIEWZ] <= bg_depth, alpha, 0.0)
        weight = alpha * transmittance
        color_acc = color_acc + weight[..., None] * row[6:9]
        transmittance = transmittance * (1.0 - alpha)
    return torch.cat([color_acc, (1.0 - transmittance)[..., None]], dim=-1)


def render_reference(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    bg_depth: torch.Tensor = None,
) -> torch.Tensor:
    """End-to-end oracle render: project → sort → composite.  (H, W, 4).
    ``bg_depth``: optional (H, W) scene depth (see :func:`composite_reference`)."""
    projected = project_splats(splats, camera, config.sh_order, only_sh=config.only_sh)
    projected = quantize_payload(projected, config)
    return composite_reference(projected, camera.width, camera.height, config, bg_depth=bg_depth)
