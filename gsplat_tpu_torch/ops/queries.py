"""Geometric queries on splat clusters (counterpart of ``gsplat_tpu.ops.queries``).

* :meth:`GaussianSplats.bbox` and :meth:`GaussianSplats.barycenter`;
* :func:`intersect_ray_bbox` — a slab test of one ray against the cluster's
  axis-aligned point bounding box, returning the hit distance and position;
* :func:`intersect_rays_bbox` — the same for many rays at once (picking).

As in the JAX package, the box covers the splat *centers* only.  The tests
run on the splats' device with torch ops.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.splats import GaussianSplats


class RayHit(NamedTuple):
    """Result of a ray/bbox query (tensors on the splats' device)."""

    hit: torch.Tensor       # () or (R,) bool
    distance: torch.Tensor  # () or (R,) f32 — entry distance along the ray (≥0)
    pos: torch.Tensor       # (3,) or (R, 3) f32 — org + distance·dir


def _slab_test(bb_lo, bb_hi, org, dir_, tmax):
    """Vectorized slab test.  org/dir (…, 3); returns (hit, t_entry)."""
    parallel = torch.abs(dir_) <= 1e-30
    inv = 1.0 / torch.where(parallel, torch.ones_like(dir_), dir_)
    t0 = (bb_lo - org) * inv
    t1 = (bb_hi - org) * inv
    lo_t = torch.minimum(t0, t1)
    hi_t = torch.maximum(t0, t1)
    # A parallel axis passes iff the origin lies inside its slab: the slab
    # then constrains t not at all (−inf, +inf); otherwise it can never be
    # entered (+inf, −inf).
    inside = (org >= bb_lo) & (org <= bb_hi)
    inf = torch.full_like(lo_t, math.inf)
    lo_t = torch.where(parallel, torch.where(inside, -inf, inf), lo_t)
    hi_t = torch.where(parallel, torch.where(inside, inf, -inf), hi_t)
    t_near = torch.amax(lo_t, dim=-1)
    t_far = torch.amin(hi_t, dim=-1)
    t_entry = torch.clamp(t_near, min=0.0)  # ray origin inside the box → 0
    hit = (t_far >= t_near) & (t_far >= 0.0) & (t_entry <= tmax)
    return hit, t_entry


def intersect_ray_bbox(splats: GaussianSplats, org, dir, tmax: float = math.inf) -> RayHit:
    """Intersect one ray with the cluster's point bounding box: the
    primitive-level hit proxy a host application uses for selection, not a
    per-splat intersection."""
    lo, hi = splats.bbox()
    org = torch.as_tensor(org, dtype=torch.float32, device=splats.device)
    dir_ = torch.as_tensor(dir, dtype=torch.float32, device=splats.device)
    hit, t = _slab_test(lo, hi, org, dir_, tmax)
    return RayHit(hit=hit, distance=t, pos=org + t[..., None] * dir_)


def intersect_rays_bbox(splats: GaussianSplats, orgs, dirs, tmax: float = math.inf) -> RayHit:
    """Batched ray/bbox picking: ``orgs``/``dirs`` are (R, 3)."""
    return intersect_ray_bbox(splats, orgs, dirs, tmax)
