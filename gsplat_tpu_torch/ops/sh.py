"""Spherical-harmonics color evaluation, degrees 0–3 (counterpart of
``gsplat_tpu.ops.sh``).

The degree-0 (DC) term is **pre-baked into the base color** upstream —
``color = sh0·SH_C0 + 0.5`` — so ``sh`` here holds only bands 1..3 (15
coefficients of 3 channels each, in ``sh1..sh15`` order).
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814  # DC constant used when baking `color` from sh0
SH_C1 = 0.4886025
SH_C2 = (1.0925484, -1.0925484, 0.3153916, -1.0925484, 0.5462742)
SH_C3 = (-0.5900436, 2.8906114, -0.4570458, 0.3731763, -0.4570458, 1.4453057, -0.5900436)


def max0(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` whose gradient at a tie (``x == 0`` exactly) is split in
    half, as ``jnp.maximum``'s is in the JAX package; ``torch.clamp`` would
    pass it whole.  The tie is a real input: a black splat with zero SH
    coefficients evaluates to exactly 0."""
    return torch.where(x == 0.0, 0.5 * x, torch.clamp(x, min=0.0))


def shade_sh(
    base_color: torch.Tensor,
    sh: torch.Tensor,
    direction: torch.Tensor,
    sh_order: int,
    only_sh: bool = False,
) -> torch.Tensor:
    """Evaluate view-dependent color.

    Args:
      base_color: ``(..., 3)`` DC color.
      sh: ``(..., 15, 3)`` band 1-3 coefficients.
      direction: ``(..., 3)`` **normalized** view direction (splat − camera).
      sh_order: int in [0, 3] — how many bands to evaluate.
      only_sh: replace the base color with 0.5 grey.

    Returns:
      ``(..., 3)`` color, clamped to ≥ 0.
    """
    if not 0 <= sh_order <= 3:
        raise ValueError(f"sh_order must be in [0, 3], got {sh_order}")
    res = torch.full_like(base_color, 0.5) if only_sh else base_color
    if sh_order >= 1:
        x = direction[..., 0:1]
        y = direction[..., 1:2]
        z = direction[..., 2:3]
        res = res + SH_C1 * (-sh[..., 0, :] * y + sh[..., 1, :] * z - sh[..., 2, :] * x)
        if sh_order >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            res = res + (
                (SH_C2[0] * xy) * sh[..., 3, :]
                + (SH_C2[1] * yz) * sh[..., 4, :]
                + (SH_C2[2] * (2.0 * zz - xx - yy)) * sh[..., 5, :]
                + (SH_C2[3] * xz) * sh[..., 6, :]
                + (SH_C2[4] * (xx - yy)) * sh[..., 7, :]
            )
            if sh_order >= 3:
                res = res + (
                    (SH_C3[0] * y * (3.0 * xx - yy)) * sh[..., 8, :]
                    + (SH_C3[1] * xy * z) * sh[..., 9, :]
                    + (SH_C3[2] * y * (4.0 * zz - xx - yy)) * sh[..., 10, :]
                    + (SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)) * sh[..., 11, :]
                    + (SH_C3[4] * x * (4.0 * zz - xx - yy)) * sh[..., 12, :]
                    + (SH_C3[5] * z * (xx - yy)) * sh[..., 13, :]
                    + (SH_C3[6] * x * (xx - 3.0 * yy)) * sh[..., 14, :]
                )
    return max0(res)
