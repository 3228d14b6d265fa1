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

The arithmetic (``ops/kernels/projection.py``: ``project_fields_plain``) is
explicit per-component arithmetic in the JAX package's order (no
``matmul``/``einsum``): each PyTorch op rounds once, as each XLA op does, so
CPU results stay within a few ulp of the JAX package's (the transcendental
functions differ by an ulp between the two libraries).  On the card it runs
as two hand-written kernels, one forward and one backward
(``csrc/projection.cu``, the port's counterpart of the fusion ``jax.jit``
gives the JAX package's ``project_splats``); on the CPU as their plain
versions inside the same ``autograd.Function``.  Differentiable with respect
to every splat field.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.camera import Camera
from ..models.splats import GaussianSplats
from .kernels.projection import N_FIELDS, ProjectSplats
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


def project_splats(
    splats: GaussianSplats,
    camera: Camera,
    sh_order: int = 3,
    tight_footprint: bool = False,
    only_sh: bool = False,
    payload_dtype: str = None,
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

    ``payload_dtype`` (``RenderConfig.payload_dtype``): the fields come back
    sanitized and quantized (``sanitize_projected`` then ``quantize_payload``
    of ``ops/rasterize_ref.py``) by the same kernel launch, and the gradient
    goes back through both (the kernel path's frame takes this form).
    """
    f32 = torch.float32
    cam = (camera.view.to(f32), camera.proj.to(f32), camera.position.to(f32))
    if any(t.requires_grad for t in cam):
        raise ValueError("project_splats takes no gradient for the camera")
    return ProjectedSplats(fields=ProjectSplats.apply(
        splats.pos.to(f32), splats.orient.to(f32), splats.scale.to(f32), splats.opacity.to(f32),
        splats.color.to(f32), splats.sh.to(f32), *cam, int(camera.width), int(camera.height),
        int(sh_order), bool(tight_footprint), bool(only_sh), payload_dtype,
    ))
