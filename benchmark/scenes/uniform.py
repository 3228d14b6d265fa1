"""Uniform scenes: positions, scales and opacities uniform in their ranges,
as the JAX package's benchmark draws them.  The draws of the program's
``random_splats``, in its order."""

import torch

from harness.scenes import normal, uniform, unit_quats


def geometry(spec, g):
    """``pos`` (3, N), ``orient`` (4, N) xyzw, ``scale`` (3, N), ``opacity`` (N,)."""
    n, extent = int(spec["splats"]), float(spec["extent"])
    lo, hi = spec["scale_range"]
    pos = uniform(g, (3, n), -extent, extent)
    orient = unit_quats(g, n)
    scale = uniform(g, (3, n), float(lo), float(hi))
    opacity = uniform(g, (n,), 0.3, 1.0)
    return {"pos": pos, "orient": orient, "scale": scale, "opacity": opacity}


def appearance(spec, g):
    """``color`` (3, N) and ``sh`` (45, N): they move no splat's footprint or
    opacity, so no frame's work."""
    n = int(spec["splats"])
    color = uniform(g, (3, n), 0.0, 1.0)
    sh = float(spec["sh_scale"]) * normal(g, (45, n))
    return {"color": color, "sh": sh}
