"""Per-splat projection: world splats → screen-space 2D Gaussians
(counterpart of ``gsplat_tpu.ops.projection``).

All math runs on (N,)-component vectors and the result is a single ``(16, N)``
field matrix that *is* the compositor payload:

  row  0..1   cx, cy        pixel-space center (x right, y down)
  row  2..3   Ax, Ay        A = v1/|v1|²  (quad-basis row 1: qx = d·A)
  row  4..5   Bx, By        B = v2/|v2|²  (quad-basis row 2: qy = d·B)
  row  6..8   r, g, b       SH-shaded color
  row  9      opacity
  row 10      depth_sq      squared world distance to camera (sort key)
  row 11      valid         1.0 in front of camera, else 0.0
  row 12..13  half_x/half_y quad bbox half-extents in pixels (binning)
  row 14      view_z        POSITIVE view-space depth of the center
  row 15      zero padding

Everything is written as explicit per-component arithmetic in the JAX
package's order (no ``matmul``/``einsum``): each PyTorch op rounds once, as
each XLA op does, so CPU results stay within a few ulp of the JAX package's
(the transcendental functions differ by an ulp between the two libraries).
Differentiable with respect to every splat field.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.camera import Camera
from ..models.splats import GaussianSplats
from .covariance import (
    ALPHA_CUTOFF,
    AXIS_MAX_PX,
    COV2D_DILATION,
    FOV_CLAMP,
    LAMBDA2_MIN,
    QUAD_EXTENT,
)
from .sh import SH_C1, SH_C2, SH_C3, max0

N_FIELDS = 16
ROW_CX, ROW_CY = 0, 1
ROW_AX, ROW_AY = 2, 3
ROW_BX, ROW_BY = 4, 5
ROW_R, ROW_G, ROW_B = 6, 7, 8
ROW_OP = 9
ROW_DEPTH = 10
ROW_VALID = 11
ROW_HX, ROW_HY = 12, 13
ROW_VIEWZ = 14


@dataclasses.dataclass(frozen=True)
class ProjectedSplats:
    """Screen-space splats: the (16, N) payload every rasterizer consumes."""

    fields: torch.Tensor  # (16, N) float32

    @property
    def count(self) -> int:
        return self.fields.shape[-1]

    # --- per-quantity views (tests / oracle convenience) ---
    @property
    def mean2d(self) -> torch.Tensor:  # (N, 2)
        return self.fields[ROW_CX : ROW_CY + 1].T

    @property
    def axis_a(self) -> torch.Tensor:  # (N, 2) — v1/|v1|²
        return self.fields[ROW_AX : ROW_AY + 1].T

    @property
    def axis_b(self) -> torch.Tensor:  # (N, 2) — v2/|v2|²
        return self.fields[ROW_BX : ROW_BY + 1].T

    @property
    def rgb(self) -> torch.Tensor:  # (N, 3)
        return self.fields[ROW_R : ROW_B + 1].T

    @property
    def opacity(self) -> torch.Tensor:
        return self.fields[ROW_OP]

    @property
    def depth_sq(self) -> torch.Tensor:
        return self.fields[ROW_DEPTH]

    @property
    def valid(self) -> torch.Tensor:
        return self.fields[ROW_VALID] > 0.5


def _rotation_scale_rows(orient: torch.Tensor, scale: torch.Tensor):
    """M = S·R entries as 9 (N,) expressions."""
    # unbind, not row indexing: one stack in the backward instead of a
    # full-size zero tensor and an accumulation per row
    qx, qy, qz, qw = orient.unbind(0)
    sx, sy, sz = scale.unbind(0)
    one = 1.0
    m00 = sx * (one - 2.0 * (qy * qy + qz * qz))
    m01 = sx * (2.0 * (qx * qy + qw * qz))
    m02 = sx * (2.0 * (qx * qz - qw * qy))
    m10 = sy * (2.0 * (qx * qy - qw * qz))
    m11 = sy * (one - 2.0 * (qx * qx + qz * qz))
    m12 = sy * (2.0 * (qy * qz + qw * qx))
    m20 = sz * (2.0 * (qx * qz + qw * qy))
    m21 = sz * (2.0 * (qy * qz - qw * qx))
    m22 = sz * (one - 2.0 * (qx * qx + qy * qy))
    return ((m00, m01, m02), (m10, m11, m12), (m20, m21, m22))


def _sigma_components(orient: torch.Tensor, scale: torch.Tensor):
    """Σ = MᵀM upper triangle as 6 (N,) expressions."""
    m = _rotation_scale_rows(orient, scale)

    def s(i, j):
        return m[0][i] * m[0][j] + m[1][i] * m[1][j] + m[2][i] * m[2][j]

    return s(0, 0), s(0, 1), s(0, 2), s(1, 1), s(1, 2), s(2, 2)


def project_splats(
    splats: GaussianSplats,
    camera: Camera,
    sh_order: int = 3,
    tight_footprint: bool = False,
    only_sh: bool = False,
) -> ProjectedSplats:
    """Project all splats for one camera (on the splats' device).

    ``only_sh``: the DC base color is replaced with 0.5 grey so only the
    directional SH bands show.

    ``tight_footprint``: shrink the binning bbox (rows 12-13) to the
    opacity-dependent discard radius ``√ln(opacity/ALPHA_CUTOFF)`` instead of
    the full ±QUAD_EXTENT quad.  Every pixel outside that radius fails the
    fragment discard ``α ≥ 1/255``, so with the hard cutoff the image is
    unchanged while low-opacity splats touch far fewer tiles.  Keep False for
    ``soft_cutoff`` rendering, where faint tails still contribute.
    """
    f32 = torch.float32
    view = camera.view.to(f32)
    proj = camera.proj.to(f32)
    pos = splats.pos.to(f32)
    px_, py_, pz_ = pos.unbind(0)

    # --- center projection + viewport ---
    def xform3(m, x, y, z):
        out = []
        for i in range(3):
            e = m[i, 0] * x + m[i, 1] * y + m[i, 2] * z
            e = e + m[i, 3]
            out.append(e)
        return out

    vx_, vy_, vz_ = xform3(view, px_, py_, pz_)
    cx_, cy_, _cz = xform3(proj, vx_, vy_, vz_)
    cw_ = proj[3, 0] * vx_ + proj[3, 1] * vy_ + proj[3, 2] * vz_ + proj[3, 3]
    valid = cw_ > 0.0
    safe_w = torch.where(valid, cw_, 1.0)
    ndc_x = cx_ / safe_w
    ndc_y = cy_ / safe_w
    mean_x = (ndc_x + 1.0) * (0.5 * camera.width)
    mean_y = (1.0 - ndc_y) * (0.5 * camera.height)

    # --- EWA covariance projection ---
    s00, s01, s02, s11, s12, s22 = _sigma_components(
        splats.orient.to(f32), splats.scale.to(f32)
    )
    p00 = proj[0, 0]
    p11 = proj[1, 1]
    aspect = p00 / p11
    lim_x = FOV_CLAMP / p00
    lim_y = FOV_CLAMP / (p11 * aspect)
    # clamp vz away from 0 so behind-camera splats stay finite (masked later)
    vzc = torch.clamp(vz_, max=-1e-6)
    vxc = torch.clamp(vx_ / vzc, min=-lim_x, max=lim_x) * vzc
    vyc = torch.clamp(vy_ / vzc, min=-lim_y, max=lim_y) * vzc
    focal = camera.width * p00 / 2.0

    # C = Rv Σ Rvᵀ, entries as scalar-coefficient combinations of the 6 σ.
    rv = view[:3, :3]
    sig = {
        (0, 0): s00, (0, 1): s01, (0, 2): s02,
        (1, 0): s01, (1, 1): s11, (1, 2): s12,
        (2, 0): s02, (2, 1): s12, (2, 2): s22,
    }

    def c_entry(i, j):
        acc = None
        for k in range(3):
            for l in range(3):
                term = (rv[i, k] * rv[j, l]) * sig[(k, l)]
                acc = term if acc is None else acc + term
        return acc

    c00 = c_entry(0, 0)
    c01 = c_entry(0, 1)
    c02 = c_entry(0, 2)
    c11 = c_entry(1, 1)
    c12 = c_entry(1, 2)
    c22 = c_entry(2, 2)

    inv_z = 1.0 / vzc
    a_ = focal * inv_z
    gx_ = -focal * vxc * inv_z * inv_z
    gy_ = -focal * vyc * inv_z * inv_z
    # u0 = (a, 0, gx), u1 = (0, a, gy):  cov2d_mn = u_m · C · u_n
    cu0_0 = a_ * c00 + gx_ * c02
    cu0_2 = a_ * c02 + gx_ * c22
    cu1_1 = a_ * c11 + gy_ * c12
    cu1_0 = a_ * c01 + gy_ * c02
    cu1_2 = a_ * c12 + gy_ * c22
    cov_a = a_ * cu0_0 + gx_ * cu0_2 + COV2D_DILATION
    cov_b = a_ * cu1_0 + gx_ * cu1_2
    cov_c = a_ * cu1_1 + gy_ * cu1_2 + COV2D_DILATION

    # --- 2×2 eigen decomposition → quad axes ---
    mid = 0.5 * (cov_a + cov_c)
    radius = torch.sqrt(
        torch.clamp(torch.square((cov_a - cov_c) / 2.0) + torch.square(cov_b), min=1e-18)
    )
    lambda1 = mid + radius
    lambda2 = torch.clamp(mid - radius, min=LAMBDA2_MIN)
    ex = cov_b
    ey = lambda1 - cov_a
    norm_sq = ex * ex + ey * ey
    safe = norm_sq > 1e-24
    inv_norm = torch.where(safe, torch.rsqrt(torch.where(safe, norm_sq, 1.0)), 0.0)
    dx_ = torch.where(safe, ex * inv_norm, 1.0)
    dy_ = -torch.where(safe, ey * inv_norm, 0.0)  # image-space y-flip
    len1 = torch.clamp(torch.sqrt(2.0 * lambda1), max=AXIS_MAX_PX)
    len2 = torch.clamp(torch.sqrt(2.0 * lambda2), max=AXIS_MAX_PX)
    v1x = len1 * dx_
    v1y = len1 * dy_
    v2x = len2 * dy_
    v2y = -len2 * dx_
    inv_l1 = 1.0 / (len1 * len1)
    inv_l2 = 1.0 / (len2 * len2)
    ax_ = v1x * inv_l1
    ay_ = v1y * inv_l1
    bx_ = v2x * inv_l2
    by_ = v2y * inv_l2
    if tight_footprint:
        # A pixel survives the hard fragment discard only if
        # α = exp(−(qx²+qy²))·op ≥ ALPHA_CUTOFF  AND  |qx|,|qy| ≤ QUAD_EXTENT,
        # i.e. the live region in quad space is square(QUAD_EXTENT) ∩ disc(ρ)
        # with ρ = √ln(op/cutoff).  Screen-space AABB of the square is the L1
        # combination of the quad axes; of the disc, the L2 combination.
        # min() of the two bounds the intersection, so the bbox never clips a
        # live pixel.  Detached: the footprint is binning-only, and √x at x=0
        # would otherwise inject inf·0 = NaN into the gradient.
        opac = splats.opacity.to(f32)
        rho = torch.sqrt(
            torch.clamp(torch.log(torch.clamp(opac, min=1e-20) / ALPHA_CUTOFF), min=0.0)
        ).detach()
        half_x = torch.minimum(
            QUAD_EXTENT * (torch.abs(v1x) + torch.abs(v2x)),
            rho * torch.sqrt(v1x * v1x + v2x * v2x),
        )
        half_y = torch.minimum(
            QUAD_EXTENT * (torch.abs(v1y) + torch.abs(v2y)),
            rho * torch.sqrt(v1y * v1y + v2y * v2y),
        )
    else:
        half_x = QUAD_EXTENT * (torch.abs(v1x) + torch.abs(v2x))
        half_y = QUAD_EXTENT * (torch.abs(v1y) + torch.abs(v2y))

    # --- depth key + SH color ---
    cam_pos = camera.position.to(f32)
    tx = px_ - cam_pos[0]
    ty = py_ - cam_pos[1]
    tz = pz_ - cam_pos[2]
    depth_sq = tx * tx + ty * ty + tz * tz
    color = splats.color.to(f32)
    if only_sh:
        grey = torch.full_like(color[0], 0.5)
        r_, g_, b_ = grey, grey, grey
    else:
        r_, g_, b_ = color.unbind(0)
    if sh_order > 0:
        inv_n = torch.rsqrt(torch.clamp(depth_sq, min=1e-24))
        dxn, dyn, dzn = tx * inv_n, ty * inv_n, tz * inv_n
        # (45, N) → 45 rows by one unbind: indexing row by row would cost the
        # backward a (45, N) zero tensor and a (45, N) add for every row used
        sh = splats.sh.to(f32).unbind(0)

        terms = [(-SH_C1 * dyn, 0), (SH_C1 * dzn, 1), (-SH_C1 * dxn, 2)]
        if sh_order >= 2:
            xx, yy, zz = dxn * dxn, dyn * dyn, dzn * dzn
            xy, yz, xz = dxn * dyn, dyn * dzn, dxn * dzn
            terms += [
                (SH_C2[0] * xy, 3),
                (SH_C2[1] * yz, 4),
                (SH_C2[2] * (2.0 * zz - xx - yy), 5),
                (SH_C2[3] * xz, 6),
                (SH_C2[4] * (xx - yy), 7),
            ]
            if sh_order >= 3:
                terms += [
                    (SH_C3[0] * dyn * (3.0 * xx - yy), 8),
                    (SH_C3[1] * xy * dzn, 9),
                    (SH_C3[2] * dyn * (4.0 * zz - xx - yy), 10),
                    (SH_C3[3] * dzn * (2.0 * zz - 3.0 * xx - 3.0 * yy), 11),
                    (SH_C3[4] * dxn * (4.0 * zz - xx - yy), 12),
                    (SH_C3[5] * dzn * (xx - yy), 13),
                    (SH_C3[6] * dxn * (xx - 3.0 * yy), 14),
                ]

        for basis, j in terms:
            r_ = r_ + basis * sh[3 * j + 0]
            g_ = g_ + basis * sh[3 * j + 1]
            b_ = b_ + basis * sh[3 * j + 2]
        r_ = max0(r_)
        g_ = max0(g_)
        b_ = max0(b_)

    opacity = splats.opacity.to(f32)
    zeros = torch.zeros_like(opacity)
    fields = torch.stack(
        [
            mean_x, mean_y,
            ax_, ay_, bx_, by_,
            r_, g_, b_,
            opacity,
            depth_sq,
            valid.to(f32),
            half_x, half_y,
            -vz_, zeros,
        ],
        dim=0,
    )
    return ProjectedSplats(fields=fields)
