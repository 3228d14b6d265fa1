"""Houdini-convention attribute-dict ingest (counterpart of
``gsplat_tpu.io.attributes``).

Takes a dict of point-attribute arrays (as a Houdini exporter or ``hou``
session would produce) and resolves it into a :class:`GaussianSplats` by
the JAX package's rules:

* ``P`` required; everything else optional with the defaults (color
  (0,0,0), opacity 1, unit scale, identity orient, zero SH), each missing
  attribute logged once as an error.
* Opacity precedence: ``opacity`` first, else ``Alpha``.
* SH resolved from any of 3 conventions, in priority order:
    1. ``sh_coefficients`` — (N, K≤15, 3) array attribute;
    2. ``sh1`` .. ``sh15`` — per-coefficient vec3 attributes;
    3. ``f_rest_0`` .. ``f_rest_44`` — planar scalars (x=j, y=j+15, z=j+30).
  A one-time warning if none is found.
* Detail-attribute config: ``gsplat__explicit_camera_pos`` (vec3) and
  ``gsplat__sh_order`` (int 0-3, clamped to 0 with an error) are returned
  separately for the render config and camera.

Resolution is numpy on the host; :func:`splats_from_attributes` moves the
result to ``device`` (``None``: the card).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..models.splats import SH_REST_COEFFS, GaussianSplats, make_splats
from ..utils.logging import get_logger

log = get_logger("io.attributes")


def _as2d(a, n, width, name) -> np.ndarray:
    arr = np.asarray(a, dtype=np.float32)
    if arr.shape != (n, width):
        raise ValueError(f"attribute {name!r}: expected shape {(n, width)}, got {arr.shape}")
    return arr


def resolve_sh(attrs: Dict[str, Any], n: int) -> Optional[np.ndarray]:
    """Resolve SH band-1..3 coefficients from any of the 3 conventions."""
    if "sh_coefficients" in attrs:
        arr = np.asarray(attrs["sh_coefficients"], dtype=np.float32)
        if arr.ndim != 3 or arr.shape[0] != n or arr.shape[2] != 3 or arr.shape[1] > 15:
            raise ValueError(
                f"sh_coefficients: expected (N, K<=15, 3), got {arr.shape}"
            )
        sh = np.zeros((n, SH_REST_COEFFS, 3), dtype=np.float32)
        sh[:, : arr.shape[1], :] = arr
        return sh
    if "sh1" in attrs:
        sh = np.zeros((n, SH_REST_COEFFS, 3), dtype=np.float32)
        for j in range(SH_REST_COEFFS):
            key = f"sh{j + 1}"
            if key in attrs:
                sh[:, j, :] = _as2d(attrs[key], n, 3, key)
        return sh
    if "f_rest_0" in attrs:
        n_rest = sum(1 for k in attrs if k.startswith("f_rest_"))
        k = n_rest // 3
        sh = np.zeros((n, SH_REST_COEFFS, 3), dtype=np.float32)
        for j in range(min(k, SH_REST_COEFFS)):
            sh[:, j, 0] = np.asarray(attrs[f"f_rest_{j}"], dtype=np.float32).reshape(n)
            sh[:, j, 1] = np.asarray(attrs[f"f_rest_{j + k}"], dtype=np.float32).reshape(n)
            sh[:, j, 2] = np.asarray(attrs[f"f_rest_{j + 2 * k}"], dtype=np.float32).reshape(n)
        return sh
    log.warning_once("no SH attributes found (sh_coefficients | sh1..sh15 | f_rest_*)")
    return None


def splats_from_attributes(attrs: Dict[str, Any], device=None) -> GaussianSplats:
    """Build splats from a Houdini-convention point-attribute dict, on
    ``device`` (``None``: the card)."""
    if "P" not in attrs:
        raise ValueError("required point attribute 'P' missing")
    pos = np.asarray(attrs["P"], dtype=np.float32)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"P: expected (N, 3), got {pos.shape}")
    n = pos.shape[0]

    orient = None
    if "orient" in attrs:
        orient = _as2d(attrs["orient"], n, 4, "orient")
    else:
        log.error_once("missing 'orient' point attribute — using identity orientation")

    scale = None
    if "scale" in attrs:
        scale = _as2d(attrs["scale"], n, 3, "scale")
    else:
        log.error_once("missing 'scale' point attribute — using unit scale")

    # opacity first, else Alpha
    opacity = None
    if "opacity" in attrs:
        opacity = np.asarray(attrs["opacity"], dtype=np.float32).reshape(n)
    elif "Alpha" in attrs:
        opacity = np.asarray(attrs["Alpha"], dtype=np.float32).reshape(n)
    else:
        log.error_once("missing 'opacity'/'Alpha' point attribute — using 1.0")

    color = None
    if "Cd" in attrs:
        color = _as2d(attrs["Cd"], n, 3, "Cd")
    else:
        log.error_once("missing 'Cd' point attribute — using (0, 0, 0)")

    sh = resolve_sh(attrs, n)
    return make_splats(pos, orient, scale, opacity, color, sh, device=device)


def detail_config(attrs: Dict[str, Any]) -> Tuple[Optional[np.ndarray], int]:
    """Extract the detail-attribute runtime config.

    Returns (explicit_camera_pos | None, sh_order).  An out-of-range
    sh_order is clamped to 0 with an error.
    """
    cam = None
    if "gsplat__explicit_camera_pos" in attrs:
        cam = np.asarray(attrs["gsplat__explicit_camera_pos"], dtype=np.float32).reshape(3)
    sh_order = int(attrs.get("gsplat__sh_order", 3))
    if not 0 <= sh_order <= 3:
        log.error_once(f"gsplat__sh_order {sh_order} out of range [0,3] — disabling SH")
        sh_order = 0
    return cam, sh_order
