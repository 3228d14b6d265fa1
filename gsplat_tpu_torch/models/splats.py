"""Gaussian-splat scene data model (counterpart of ``gsplat_tpu.models.splats``).

A splat cluster is a frozen dataclass of plain tensors in the JAX package's
**transposed structure-of-arrays** layout — components on the first axis,
splats on the last — kept at the port's public functions so the two packages
compare like with like, and so a per-splat column read touches one element
of each contiguous row:

* ``pos``      (3, N)  float32 — world positions.
* ``orient``   (4, N)  — quaternion in **xyzw** component order.
* ``scale``    (3, N)  — per-axis standard deviations.
* ``opacity``  (N,)    — post-sigmoid opacity.
* ``color``    (3, N)  — DC base color, ``sh0·SH_C0 + 0.5`` pre-baked.
* ``sh``       (45, N) — band 1-3 SH coefficients; row ``3·j + c`` is
  coefficient ``sh{j+1}`` channel ``c``.

Constructors accept the user-facing per-splat conventions ((N, 3) arrays,
(N, 15, 3) SH) and transpose on the host.  Missing attributes get the same
defaults as in the JAX package: color (0,0,0), opacity 1, unit scale, identity
orientation, zero SH.

``device=None`` means the card.  :func:`splats_from_numpy` carries a scene
across from the JAX package (it takes what ``gsplat_tpu.to_numpy_dict`` gives).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from .camera import camera_from_numpy, resolve_device  # noqa: F401  (camera_from_numpy: re-export)

SH_REST_COEFFS = 15  # bands 1..3 (3DGS degree-3)


@dataclasses.dataclass(frozen=True)
class GaussianSplats:
    """A cluster of N Gaussian splats."""

    pos: torch.Tensor       # (3, N)
    orient: torch.Tensor    # (4, N) xyzw
    scale: torch.Tensor     # (3, N)
    opacity: torch.Tensor   # (N,)
    color: torch.Tensor     # (3, N)
    sh: torch.Tensor        # (45, N)

    @property
    def count(self) -> int:
        return self.pos.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def astype(self, dtype: torch.dtype) -> "GaussianSplats":
        """Cast every field but the positions, which stay float32."""
        return GaussianSplats(
            pos=self.pos,
            orient=self.orient.to(dtype),
            scale=self.scale.to(dtype),
            opacity=self.opacity.to(dtype),
            color=self.color.to(dtype),
            sh=self.sh.to(dtype),
        )

    def concat(self, other: "GaussianSplats") -> "GaussianSplats":
        """The two clusters' splats, ``self``'s first, on ``self``'s device."""
        return GaussianSplats(**{
            f.name: torch.cat([getattr(self, f.name), getattr(other, f.name)], dim=-1)
            for f in dataclasses.fields(self)
        })

    def head(self, n: int) -> "GaussianSplats":
        """The first ``n`` splats (the registry's partial-cluster budget clamp)."""
        return GaussianSplats(**{f.name: getattr(self, f.name)[..., :n] for f in dataclasses.fields(self)})

    def barycenter(self) -> torch.Tensor:
        """Mean position, (3,), on the splats' device."""
        return torch.mean(self.pos, dim=-1)

    def bbox(self):
        """(min, max) corners of the positions, each (3,), on the splats' device."""
        return torch.amin(self.pos, dim=-1), torch.amax(self.pos, dim=-1)

    def validate(self) -> "GaussianSplats":
        """Shape validation."""
        n = self.pos.shape[-1]
        expect = {
            "pos": (3, n),
            "orient": (4, n),
            "scale": (3, n),
            "opacity": (n,),
            "color": (3, n),
            "sh": (3 * SH_REST_COEFFS, n),
        }
        for name, shape in expect.items():
            got = tuple(getattr(self, name).shape)
            if got != shape:
                raise ValueError(f"GaussianSplats.{name}: expected shape {shape}, got {got}")
        return self

    # -------- user-facing per-splat views (row layouts; test/IO convenience)
    @property
    def pos_n3(self) -> torch.Tensor:
        return self.pos.T

    @property
    def orient_n4(self) -> torch.Tensor:
        return self.orient.T

    @property
    def scale_n3(self) -> torch.Tensor:
        return self.scale.T

    @property
    def color_n3(self) -> torch.Tensor:
        return self.color.T

    @property
    def sh_n153(self) -> torch.Tensor:
        return self.sh.T.reshape(self.count, SH_REST_COEFFS, 3)


def _to_soa(a, width, name, dtype) -> np.ndarray:
    """(N, width) or (width, N) → (width, N), host-side."""
    arr = np.asarray(a, dtype=dtype)
    if arr.ndim != 2:
        raise ValueError(f"{name}: expected 2-D, got {arr.shape}")
    if arr.shape[0] == width and arr.shape[1] != width:
        return arr
    if arr.shape[1] == width:
        return np.ascontiguousarray(arr.T)
    if arr.shape[0] == width:  # ambiguous square-ish; assume already SoA
        return arr
    raise ValueError(f"{name}: expected (N, {width}) or ({width}, N), got {arr.shape}")


def make_splats(
    pos: Any,
    orient: Optional[Any] = None,
    scale: Optional[Any] = None,
    opacity: Optional[Any] = None,
    color: Optional[Any] = None,
    sh: Optional[Any] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> GaussianSplats:
    """Build a validated :class:`GaussianSplats` from per-splat (N, ·) host
    arrays (or pre-transposed SoA), filling defaults for missing attributes.
    Positions stay float32; the other fields are cast to ``dtype``."""
    dev = resolve_device(device)
    pos = _to_soa(pos, 3, "pos", np.float32)
    n = pos.shape[-1]
    if orient is None:
        orient = np.zeros((4, n), np.float32)
        orient[3] = 1.0
    else:
        orient = _to_soa(orient, 4, "orient", np.float32)
    scale = np.ones((3, n), np.float32) if scale is None else _to_soa(scale, 3, "scale", np.float32)
    if opacity is None:
        opacity = np.ones((n,), np.float32)
    else:
        opacity = np.asarray(opacity, dtype=np.float32).reshape(n)
    color = np.zeros((3, n), np.float32) if color is None else _to_soa(color, 3, "color", np.float32)
    if sh is None:
        sh = np.zeros((3 * SH_REST_COEFFS, n), np.float32)
    else:
        sh_arr = np.asarray(sh, dtype=np.float32)
        if sh_arr.shape == (n, SH_REST_COEFFS, 3):
            sh = np.ascontiguousarray(sh_arr.reshape(n, 3 * SH_REST_COEFFS).T)
        elif sh_arr.shape == (3 * SH_REST_COEFFS, n):
            sh = sh_arr
        else:
            raise ValueError(
                f"sh: expected (N, 15, 3) or (45, N), got {sh_arr.shape}"
            )

    def put(a, dt):
        return torch.from_numpy(np.array(a, order="C", copy=True)).to(device=dev, dtype=dt)

    return GaussianSplats(
        pos=put(pos, torch.float32),
        orient=put(orient, dtype),
        scale=put(scale, dtype),
        opacity=put(opacity, dtype),
        color=put(color, dtype),
        sh=put(sh, dtype),
    ).validate()


def splats_from_numpy(d: Dict[str, Any], dtype: torch.dtype = torch.float32, device=None) -> GaussianSplats:
    """Per-splat (N, ·) numpy dict → :class:`GaussianSplats`: the inverse of
    :func:`to_numpy_dict`, and the function that carries a scene across from
    the JAX package (``splats_from_numpy(gsplat_tpu.to_numpy_dict(s))``).
    Float32 values round-trip exactly."""
    return make_splats(
        d["pos"], d.get("orient"), d.get("scale"), d.get("opacity"),
        d.get("color"), d.get("sh"), dtype=dtype, device=device,
    )


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def random_splats(
    generator: torch.Generator,
    n: int,
    extent: float = 1.0,
    scale_range=(0.01, 0.08),
    sh_scale: float = 0.0,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> GaussianSplats:
    """Synthetic-scene generator for tests and benchmarks: the JAX package's
    distributions, drawn from an explicit ``torch.Generator`` (the numbers
    differ from ``jax.random``'s for the same seed).  Values are drawn on the
    generator's device and moved to ``device``."""
    dev = resolve_device(device)
    g = generator
    pos = _uniform(g, (3, n), -extent, extent)
    quat = _normal(g, (4, n))
    quat = quat / torch.linalg.norm(quat, dim=0, keepdim=True)
    scale = _uniform(g, (3, n), scale_range[0], scale_range[1])
    opacity = _uniform(g, (n,), 0.3, 1.0)
    color = _uniform(g, (3, n), 0.0, 1.0)
    sh = sh_scale * _normal(g, (3 * SH_REST_COEFFS, n))
    return GaussianSplats(
        pos=pos.to(dev, torch.float32),
        orient=quat.to(dev, dtype),
        scale=scale.to(dev, dtype),
        opacity=opacity.to(dev, dtype),
        color=color.to(dev, dtype),
        sh=sh.to(dev, dtype),
    ).validate()


def trained_like_splats(
    generator: torch.Generator,
    n: int,
    extent: float = 1.2,
    sh_scale: float = 0.1,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> GaussianSplats:
    """Synthetic scene matched to TRAINED 3DGS statistics — the heavy-tailed
    distributions ``random_splats``' uniform draws lack:

    * log-normal anisotropic scales: most splats tiny, a rare large tail,
      per-axis anisotropy up to ~10× (needle/disc splats);
    * sigmoid-of-normal opacities: a large near-transparent population plus
      a solid opaque mode;
    * Gaussian-mixture positions: splats cluster on surfaces, not uniformly
      in the volume.
    """
    dev = resolve_device(device)
    g = generator
    n_clusters = 12
    centers = _uniform(g, (3, n_clusters), -0.7 * extent, 0.7 * extent)
    widths = torch.exp(
        _uniform(g, (3, n_clusters), math.log(0.05 * extent), math.log(0.45 * extent))
    )
    cid = torch.randint(0, n_clusters, (n,), generator=g, device=g.device)
    pos = centers[:, cid] + widths[:, cid] * _normal(g, (3, n))
    quat = _normal(g, (4, n))
    quat = quat / torch.linalg.norm(quat, dim=0, keepdim=True)
    base = torch.exp(math.log(0.004 * extent) + 0.9 * _normal(g, (1, n)))
    aniso = torch.exp(0.8 * _normal(g, (3, n)))
    scale = torch.clamp(base * aniso, 1e-5, 0.3 * extent)
    opacity = torch.sigmoid(1.2 * _normal(g, (n,)) - 0.3)
    color = torch.clamp(0.5 + 0.25 * _normal(g, (3, n)), 0.0, 1.0)
    sh = sh_scale * _normal(g, (3 * SH_REST_COEFFS, n))
    return GaussianSplats(
        pos=pos.to(dev, torch.float32),
        orient=quat.to(dev, dtype),
        scale=scale.to(dev, dtype),
        opacity=opacity.to(dev, dtype),
        color=color.to(dev, dtype),
        sh=sh.to(dev, dtype),
    ).validate()


def to_numpy_dict(splats: GaussianSplats) -> Dict[str, np.ndarray]:
    """Per-splat (N, ·) numpy dict (user-facing row conventions)."""
    def host(t):
        return t.detach().to("cpu", torch.float32).contiguous().numpy()

    return {
        "pos": host(splats.pos_n3),
        "orient": host(splats.orient_n4),
        "scale": host(splats.scale_n3),
        "opacity": host(splats.opacity),
        "color": host(splats.color_n3),
        "sh": host(splats.sh_n153),
    }
