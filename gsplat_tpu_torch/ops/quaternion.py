"""Quaternion → rotation/scale matrix ops (counterpart of
``gsplat_tpu.ops.quaternion``).

Conventions, as in the JAX package:

* Public API takes quaternions in **xyzw** component order.
* The produced matrix is ``M = S · R`` with ``S = diag(scale)``; ``R`` is the
  *transpose* of the textbook rotation matrix for quat (w,x,y,z), and since
  the 3D covariance is ``Σ = MᵀM = Rᵀ S² R`` this yields the standard 3DGS
  covariance.  The element layout is transcribed exactly.

All functions are vectorised over leading batch dimensions.
"""

from __future__ import annotations

import torch


def quat_to_rotmat_wxyz(qw, qx, qy, qz):
    """Rotation matrix from scalar-first parts, shape ``(..., 3, 3)``."""
    one = torch.ones_like(qw)
    r00 = one - 2.0 * (qy * qy + qz * qz)
    r10 = 2.0 * (qx * qy - qw * qz)
    r20 = 2.0 * (qx * qz + qw * qy)
    r01 = 2.0 * (qx * qy + qw * qz)
    r11 = one - 2.0 * (qx * qx + qz * qz)
    r21 = 2.0 * (qy * qz - qw * qx)
    r02 = 2.0 * (qx * qz - qw * qy)
    r12 = 2.0 * (qy * qz + qw * qx)
    r22 = one - 2.0 * (qx * qx + qy * qy)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rotation_scale_matrix(orient_xyzw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``M = S · R``: ``(..., 4)`` xyzw quaternion and ``(..., 3)`` scales →
    ``(..., 3, 3)`` such that ``Σ = MᵀM`` is the splat's 3D covariance."""
    qx, qy, qz, qw = (orient_xyzw[..., i] for i in range(4))
    r = quat_to_rotmat_wxyz(qw, qx, qy, qz)
    return r * scale[..., :, None]


def covariance_3d(orient_xyzw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """3D covariance ``Σ = MᵀM``, expanded elementwise (no matmul) in the JAX
    package's summation order."""
    m = rotation_scale_matrix(orient_xyzw, scale)
    rows = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            acc = m[..., 0, i] * m[..., 0, j]
            for k in (1, 2):
                acc = acc + m[..., k, i] * m[..., k, j]
            rows[i][j] = acc
            rows[j][i] = acc
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
