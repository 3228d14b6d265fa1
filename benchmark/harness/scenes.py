"""The benchmark's inputs, made from the seed on the device: splat scenes,
camera sets and training targets.

A scene follows a configuration's ``scene`` entry, whose ``kind`` names its
module ``scenes/<kind>.py``: ``geometry`` (positions, orientations, scales,
opacities) and ``appearance`` (colours, SH).  The geometry is the
configuration's dataset, drawn from its ``scene_seed``: the heavy tail of a
trained scene's scales moves a frame's work by some percent from one draw
to the next, so a geometry drawn from the run's seed would change the work
from seed to seed.  The run's seed draws what moves no work: the order of
the splats in memory and their appearance; it also places the camera set
on its orbit (the phase), draws the training targets, the order of the
training views and the frames the check compares.  Everything is drawn
with ``torch.Generator``s on the device, a few large calls, in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from harness.spec import module
from reference.render import camera_position, look_at, perspective

GOLDEN_ANGLE = math.pi * (3.0 - math.sqrt(5.0))


def derive(seed: int, stream: int) -> int:
    """A 63-bit seed of the run's seed for one use (``stream``)."""
    s = int(seed) % (1 << 64)
    a, b = np.random.SeedSequence([s & 0xFFFFFFFF, s >> 32, int(stream)]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator of the seed, one ``stream`` for each use."""
    s = int(seed) % (1 << 64)
    return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, int(stream)])


def uniform(g, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def normal(g, shape):
    return torch.randn(shape, generator=g, device=g.device)


def unit_quats(g, n):
    q = normal(g, (4, n))
    return q / torch.linalg.norm(q, dim=0, keepdim=True)


def scene(spec: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The splat fields of a configuration's ``scene`` entry for the run's
    seed, as (3, N), (4, N) xyzw, (3, N), (N,), (3, N), (45, N) float32
    tensors: the geometry of ``scenes/<kind>.py`` drawn from the entry's
    ``scene_seed``, its splats in an order drawn from the run's seed, and the
    appearance drawn from the run's seed."""
    kind = module("scenes", spec["kind"])
    fields = kind.geometry(spec, generator(int(spec["scene_seed"]), device))
    g = generator(derive(seed, 1), device)
    order = torch.randperm(int(spec["splats"]), generator=g, device=g.device)
    for k in list(fields):
        fields[k] = fields[k][..., order].contiguous()
    del order
    fields.update(kind.appearance(spec, g))
    return {k: v.contiguous() for k, v in fields.items()}


class Pose:
    """A camera: float32 numpy ``view``, ``proj`` and ``position``, and the
    same on the device (``view_t``, ``proj_t``, ``pos_t``)."""

    def __init__(self, view, proj, device):
        self.view, self.proj = view, proj
        self.position = camera_position(view)
        self.view_t = torch.from_numpy(view.copy()).to(device)
        self.proj_t = torch.from_numpy(proj.copy()).to(device)
        self.pos_t = torch.from_numpy(self.position.copy()).to(device)


def orbit(count: int, radius: float, heights: np.ndarray, phase: float, width: int, height: int, fov_y: float,
          device) -> List[Pose]:
    """``count`` poses at evenly spaced azimuths from ``phase``, each
    looking at the origin."""
    proj = perspective(fov_y, width, height)
    poses = []
    for k in range(count):
        a = phase + 2.0 * math.pi * k / count
        eye = [radius * math.sin(a), float(heights[k]), radius * math.cos(a)]
        poses.append(Pose(look_at(eye, [0.0, 0.0, 0.0]), proj, device))
    return poses


def camera_set(traffic: Dict, seed: int, width: int, height: int, device) -> List[Pose]:
    """A traffic mix's camera set: an orbit whose phase is the mix's
    ``phase_deg`` or, without one, comes from the seed; each pose's height
    ``height`` ± ``height_jitter`` on a fixed golden-angle sequence (the
    same heights for every seed)."""
    rng = host_rng(seed, 1)
    count = int(traffic["poses"])
    phase = float(rng.uniform(0.0, 2.0 * math.pi))
    if "phase_deg" in traffic:
        phase = math.radians(float(traffic["phase_deg"]))
    jitter = float(traffic.get("height_jitter", 0.0))
    heights = float(traffic["height"]) + jitter * np.sin(GOLDEN_ANGLE * np.arange(count))
    return orbit(count, float(traffic["radius"]), heights, phase, width, height, float(traffic["fov_y_deg"]), device)


def targets(traffic: Dict, seed: int, count: int, width: int, height: int, device) -> torch.Tensor:
    """``count`` (H, W, 3) target images in [0, 1]: smooth random fields, a
    coarse grid of uniform values upsampled bilinearly."""
    gh, gw = traffic["target_grid"]
    g = generator(derive(seed, 2), device)
    coarse = torch.rand((count, 3, int(gh), int(gw)), generator=g, device=device)
    full = torch.nn.functional.interpolate(coarse, size=(height, width), mode="bilinear", align_corners=False)
    return full.permute(0, 2, 3, 1).contiguous()
