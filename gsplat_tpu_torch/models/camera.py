"""Camera model (counterpart of ``gsplat_tpu.models.camera``).

Conventions (OpenGL, as in the JAX package):
  * ``view``: (4,4) world→view; camera looks down −z in view space.
  * ``proj``: (4,4) perspective projection; ``proj[0,0] = 1/tan(fovx/2)``.
  * Image coordinates: x right, y **down**, pixel centers at (i+0.5, j+0.5).
    NDC→pixel: ``px = (ndc.x+1)/2·W``, ``py = (1−ndc.y)/2·H``.

The matrices are built on the host with numpy (the same arithmetic as the JAX
package, so both packages see bit-equal cameras) and then live as float32
tensors on ``device``.  ``device=None`` means the card (``"cuda"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``None`` → the card.  There is no probe that substitutes the CPU:
    asking for the card on a machine without one raises at first use."""
    return torch.device("cuda" if device is None else device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera: two (4, 4) float32 tensors plus the static image size."""

    view: torch.Tensor                 # (4, 4) world → view
    proj: torch.Tensor                 # (4, 4) view → clip
    width: int
    height: int
    # Optional world-space camera-position override for sorting + SH.  The
    # JAX package marks "unset" with NaNs inside a traced value; here it is
    # ``None``, decided on the host when the camera is built.
    explicit_camera_pos: Optional[torch.Tensor] = None
    # ``−Rᵀ·t`` of the view matrix, computed on the host by the constructors
    # below (so it is bit-equal to the JAX package's numpy value); derived
    # with tensor ops when a Camera is built by hand without it.
    derived_pos: Optional[torch.Tensor] = None
    # ``position`` as a host array, set by the constructors below: a host loop
    # (the scene registry's re-sort test) reads it without a device read.
    host_position: Optional[np.ndarray] = None

    @property
    def position(self) -> torch.Tensor:
        """World-space camera position, (3,): the explicit override if set,
        else ``−Rᵀ·t`` from the view matrix."""
        if self.explicit_camera_pos is not None:
            return self.explicit_camera_pos
        if self.derived_pos is not None:
            return self.derived_pos
        r, t = self.view[:3, :3], self.view[:3, 3]
        return -(r[0] * t[0] + r[1] * t[1] + r[2] * t[2])



def perspective(fov_y_deg: float, width: int, height: int, near: float = 0.01, far: float = 100.0) -> np.ndarray:
    """Standard OpenGL perspective projection matrix (numpy, float32)."""
    aspect = width / height
    f = 1.0 / np.tan(np.radians(fov_y_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World→view matrix, camera at ``eye`` looking at ``target`` (GL style;
    numpy, float32)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = right
    m[1, :3] = true_up
    m[2, :3] = -fwd
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


def camera_from_numpy(
    view, proj, width: int, height: int, explicit_camera_pos=None, device=None
) -> Camera:
    """Build a Camera from host matrices — what ``gsplat_tpu.Camera.view`` /
    ``.proj`` hold.  ``explicit_camera_pos`` may be ``None`` or a (3,) array;
    an array holding any NaN means "unset", as in the JAX package."""
    dev = resolve_device(device)
    view = np.asarray(view, dtype=np.float32)
    proj = np.asarray(proj, dtype=np.float32)
    explicit = None
    derived = np.asarray(-view[:3, :3].T @ view[:3, 3], np.float32)
    host_position = derived
    if explicit_camera_pos is not None:
        e = np.asarray(explicit_camera_pos, dtype=np.float32)
        if not np.isnan(e).any():
            explicit = torch.from_numpy(e.copy()).to(dev)
            host_position = e.copy()
    return Camera(
        view=torch.from_numpy(view.copy()).to(dev),
        proj=torch.from_numpy(proj.copy()).to(dev),
        width=int(width),
        height=int(height),
        explicit_camera_pos=explicit,
        derived_pos=torch.from_numpy(derived.copy()).to(dev),
        host_position=host_position,
    )


def make_camera(
    eye,
    target,
    width: int,
    height: int,
    fov_y_deg: float = 45.0,
    up=(0.0, 1.0, 0.0),
    near: float = 0.01,
    far: float = 100.0,
    device=None,
) -> Camera:
    return camera_from_numpy(
        look_at(eye, target, up),
        perspective(fov_y_deg, width, height, near, far),
        width,
        height,
        device=device,
    )
