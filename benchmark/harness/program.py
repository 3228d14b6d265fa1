"""What the benchmark takes from the program under test, ``gsplat_tpu_torch``:
its public entry points, its launch counters and its kernels' names.

``fit_capacity`` is the set-up a user of a deep scene runs before serving
it: the smallest tile capacity, a multiple of the chunk, at which no frame
of the camera set drops a pair, found through the public ``render`` and
its ``dropped_pairs``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch import graphs
from gsplat_tpu_torch.ops import kernels as kernel_table

__all__ = ["gt", "graphs", "render_config", "splats_of", "camera_of", "live_camera", "set_camera",
           "tune", "fit_capacity", "counters", "kernel_names"]

# keys of a configuration's ``render`` entry that size the camera, not the
# program's settings
CAMERA_KEYS = ("width", "height")


def render_config(render: Dict) -> "gt.RenderConfig":
    """The program's settings of a configuration's ``render`` entry: every
    key but the camera's is a ``RenderConfig`` field, and one that is not
    raises."""
    fields = {f.name for f in dataclasses.fields(gt.RenderConfig)}
    settings = {k: v for k, v in render.items() if k not in CAMERA_KEYS}
    unknown = sorted(set(settings) - fields)
    if unknown:
        raise ValueError(f"render settings the program does not have: {unknown}")
    return gt.RenderConfig(**settings)


def splats_of(fields: Dict[str, torch.Tensor]) -> "gt.GaussianSplats":
    return gt.GaussianSplats(**fields).validate()


def camera_of(pose, width: int, height: int, device) -> "gt.Camera":
    return gt.camera_from_numpy(pose.view, pose.proj, width, height, device=device)


def live_camera(pose, width: int, height: int) -> "gt.Camera":
    """A camera whose tensors each frame's pose is copied into."""
    return gt.Camera(view=pose.view_t.clone(), proj=pose.proj_t.clone(), width=width, height=height,
                     derived_pos=pose.pos_t.clone())


def set_camera(live: "gt.Camera", pose) -> None:
    live.view.copy_(pose.view_t)
    live.proj.copy_(pose.proj_t)
    live.derived_pos.copy_(pose.pos_t)


def tune(splats, cams: List, base: "gt.RenderConfig", headroom: float):
    """The pair budget of ``tune_pair_budget`` over the cameras, and the
    index of the camera with the most pairs."""
    pairs = [gt.measure_pairs(splats, c, base) for c in cams]
    heaviest = max(range(len(cams)), key=lambda k: pairs[k])
    return gt.tune_pair_budget(splats, [cams[heaviest]], base, headroom=headroom), heaviest


def _drops(splats, cam, cfg) -> bool:
    with torch.no_grad():
        return int(gt.render(splats, cam, cfg, with_stats=True)[1].dropped_pairs) > 0


def _least_capacity(splats, cam, cfg, lo: int, hi: int) -> int:
    """The least multiple of the chunk in (lo, hi] at which the frame drops
    no pair, where it drops at ``lo`` (or ``lo`` is 0) and not at ``hi``."""
    c = cfg.chunk
    while hi - lo > c:
        mid = (lo + hi) // (2 * c) * c
        if _drops(splats, cam, dataclasses.replace(cfg, tile_capacity=mid)):
            lo = mid
        else:
            hi = mid
    return hi


def fit_capacity(splats, cams: List, cfg: "gt.RenderConfig", headroom: float = 1.0):
    """``cfg`` with the least tile capacity, a multiple of the chunk, at
    which no camera's frame drops a pair, times ``headroom`` and rounded up
    to a multiple of the chunk, or ``cfg``'s own where that is more; and
    that least capacity.  The pair budget of
    ``cfg`` has to hold every camera's pairs: a tile never holds more, so at
    the budget nothing drops.  Each camera's frame is rendered at the least
    capacity found so far, and only a camera that drops there searches
    further: the deepest camera first makes the fewest frames."""
    c = cfg.chunk
    quiet = dataclasses.replace(cfg, warn_on_drop=False)
    top = -(-cfg.pair_budget(splats.count) // c) * c
    least = c
    for cam in cams:
        if not _drops(splats, cam, dataclasses.replace(quiet, tile_capacity=least)):
            continue
        lo, step = least, c
        hi = min(lo + step, top)
        while hi < top and _drops(splats, cam, dataclasses.replace(quiet, tile_capacity=hi)):
            lo, step = hi, 2 * step
            hi = min(lo + step, top)
        least = _least_capacity(splats, cam, quiet, lo, hi)
    need = max(math.ceil(least * headroom), cfg.tile_capacity)
    return dataclasses.replace(cfg, tile_capacity=-(-need // c) * c), least


def counters() -> Dict[str, int]:
    """The program's launch counters, by name."""
    return kernel_table.counts()


def kernel_names() -> Dict[str, str]:
    """Each counter that counts one kernel, and a substring of that kernel's
    name in a profiler trace."""
    return {name: c.kernel for name, c in kernel_table.counters().items() if c.kernel}
