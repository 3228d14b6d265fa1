"""Scenes of trained-3DGS statistics: log-normal anisotropic scales, a
near-transparent opacity tail, splats clustered on ``clusters`` Gaussian
blobs.  The draws of the program's ``trained_like_splats``, in its order."""

import math

import torch

from harness.scenes import normal, uniform, unit_quats


def geometry(spec, g):
    """``pos`` (3, N), ``orient`` (4, N) xyzw, ``scale`` (3, N), ``opacity`` (N,)."""
    n, extent, k = int(spec["splats"]), float(spec["extent"]), int(spec["clusters"])
    centers = uniform(g, (3, k), -0.7 * extent, 0.7 * extent)
    widths = torch.exp(uniform(g, (3, k), math.log(0.05 * extent), math.log(0.45 * extent)))
    cid = torch.randint(0, k, (n,), generator=g, device=g.device)
    pos = centers[:, cid] + widths[:, cid] * normal(g, (3, n))
    orient = unit_quats(g, n)
    base = torch.exp(math.log(0.004 * extent) + 0.9 * normal(g, (1, n)))
    scale = torch.clamp(base * torch.exp(0.8 * normal(g, (3, n))), 1e-5, 0.3 * extent)
    opacity = torch.sigmoid(1.2 * normal(g, (n,)) - 0.3)
    return {"pos": pos, "orient": orient, "scale": scale, "opacity": opacity}


def appearance(spec, g):
    """``color`` (3, N) and ``sh`` (45, N): they move no splat's footprint or
    opacity, so no frame's work."""
    n = int(spec["splats"])
    color = torch.clamp(0.5 + 0.25 * normal(g, (3, n)), 0.0, 1.0)
    sh = float(spec["sh_scale"]) * normal(g, (45, n))
    return {"color": color, "sh": sh}
