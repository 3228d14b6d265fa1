"""EWA covariance projection and 2×2 eigen-decomposition (counterpart of
``gsplat_tpu.ops.covariance``).

* :func:`ewa_project` — EWA Splatting (Zwicker et al. 2002) eq. 31 with the
  reference's constants: ±1.3·tanFov view-space clamp, focal = screenW·P00/2,
  and a +0.3 px low-pass dilation on the 2D covariance diagonal.
* :func:`decompose_covariance` — closed-form 2×2 eigen decomposition giving
  the pixel-space splat axes: λ₂ ≥ 0.1, axis length √(2λ) capped at 4096 px,
  with the y-flip into image (y-down) coordinates built in.

Everything is vectorised over a leading splat dimension and written as
explicit per-component arithmetic in the JAX package's order.
"""

from __future__ import annotations

from typing import Tuple

import torch

FOV_CLAMP = 1.3          # view-space frustum clamp multiplier
COV2D_DILATION = 0.3     # low-pass filter: min ~1px splat size
LAMBDA2_MIN = 0.1        # min minor eigenvalue
AXIS_MAX_PX = 4096.0     # max axis length in pixels
QUAD_EXTENT = 2.0        # quad spans ±2 units in the (v1, v2) eigen basis
ALPHA_CUTOFF = 1.0 / 255.0  # fragment discard threshold


def ewa_project(
    world_pos: torch.Tensor,
    cov3d: torch.Tensor,
    view: torch.Tensor,
    proj: torch.Tensor,
    screen_w: float,
) -> torch.Tensor:
    """Project ``(N, 3, 3)`` 3D covariances at ``(N, 3)`` centers to ``(N, 3)``
    packed 2D covariances ``(cov_xx, cov_xy, cov_yy)`` including the +0.3
    dilation, in view-aligned (y-up) screen coordinates."""
    p00 = proj[0, 0]
    p11 = proj[1, 1]
    # tanFovY algebraically equals tanFovX here (1/(P11·(P00/P11)) = 1/P00),
    # reproduced exactly as the JAX package does.
    aspect = p00 / p11
    lim_x = FOV_CLAMP * (1.0 / p00)
    lim_y = FOV_CLAMP * (1.0 / (p11 * aspect))

    view_pos = (
        world_pos[..., 0:1] * view[:3, 0]
        + world_pos[..., 1:2] * view[:3, 1]
        + world_pos[..., 2:3] * view[:3, 2]
        + view[:3, 3]
    )
    vz = torch.clamp(view_pos[..., 2], max=-1e-6)
    vx = torch.clamp(view_pos[..., 0] / vz, min=-lim_x, max=lim_x) * vz
    vy = torch.clamp(view_pos[..., 1] / vz, min=-lim_y, max=lim_y) * vz

    focal = screen_w * p00 / 2.0

    rv = view[:3, :3]
    tmp = [[None] * 3 for _ in range(3)]
    for k in range(3):
        for j in range(3):
            acc = rv[j, 0] * cov3d[..., k, 0]
            acc = acc + rv[j, 1] * cov3d[..., k, 1]
            acc = acc + rv[j, 2] * cov3d[..., k, 2]
            tmp[k][j] = acc
    c = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            c[i][j] = (
                rv[i, 0] * tmp[0][j] + rv[i, 1] * tmp[1][j] + rv[i, 2] * tmp[2][j]
            )

    inv_z = 1.0 / vz
    a = focal * inv_z
    gx = -focal * vx * inv_z * inv_z
    gy = -focal * vy * inv_z * inv_z
    cu0 = [a * c[i][0] + gx * c[i][2] for i in range(3)]
    cu1 = [a * c[i][1] + gy * c[i][2] for i in range(3)]
    cxx = a * cu0[0] + gx * cu0[2] + COV2D_DILATION
    cxy = a * cu1[0] + gx * cu1[2]
    cyy = a * cu1[1] + gy * cu1[2] + COV2D_DILATION
    return torch.stack([cxx, cxy, cyy], dim=-1)


def decompose_covariance(cov2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(N, 3)`` packed (cov_xx, cov_xy, cov_yy) → ``(v1, v2)``, each
    ``(N, 2)`` axis vectors in image space (x right, y **down**), lengths
    ``min(√(2λᵢ), 4096)`` with λ₂ clamped to ≥ 0.1."""
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    mid = 0.5 * (a + c)
    radius_sq = torch.square((a - c) / 2.0) + torch.square(b)
    radius = torch.sqrt(torch.clamp(radius_sq, min=1e-18))
    lambda1 = mid + radius
    lambda2 = torch.clamp(mid - radius, min=LAMBDA2_MIN)
    ex = b
    ey = lambda1 - a
    norm_sq = ex * ex + ey * ey
    safe = norm_sq > 1e-24
    inv_norm = torch.where(safe, torch.rsqrt(torch.where(safe, norm_sq, 1.0)), 0.0)
    dx = torch.where(safe, ex * inv_norm, 1.0)
    dy = torch.where(safe, ey * inv_norm, 0.0)
    dy = -dy  # image-space y-flip
    len1 = torch.clamp(torch.sqrt(2.0 * lambda1), max=AXIS_MAX_PX)
    len2 = torch.clamp(torch.sqrt(2.0 * lambda2), max=AXIS_MAX_PX)
    v1 = torch.stack([len1 * dx, len1 * dy], dim=-1)
    v2 = torch.stack([len2 * dy, -len2 * dx], dim=-1)
    return v1, v2
