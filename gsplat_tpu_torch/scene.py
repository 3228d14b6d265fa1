"""Scene registry: multi-cluster aggregation and the frame lifecycle
(counterpart of ``gsplat_tpu.scene``).

A host-side session object around the render functions, with the JAX
package's semantics:

* **registry of clusters** keyed by (cluster id, version); registering a new
  version flushes the stale versions of the same id;
* **per-frame active set**: a cluster is drawn only if it was included this
  frame, and ``post_render`` ages the entries — one not included for more
  than ``max_age`` frames is evicted;
* **global budget**: at most ``config.max_splats`` splats are drawn; the
  cluster that crosses the budget contributes its leading splats, the rest
  is culled with a one-time warning (re-armed once the budget is met);
* **shared origin**: the concatenated positions are re-based to the mean of
  the cluster barycenters for float precision, with the camera translated to
  match;
* **amortized sort**: the global depth order is cached and recomputed only
  when the geometry changed or the camera has accumulated enough squared
  movement (threshold 0: re-sort on any movement);
* **runtime setters**: an explicit camera position (consumed each frame,
  cleared in ``post_render``) and the SH order (clamped with a one-time
  error).

A frame makes no host read of device values: the overflow counters of a
frame are reported at the start of the next ``render`` (by then they have
long materialized), and the re-sort test takes the camera position from the
camera's host copy (``Camera.host_position``).  Building the geometry reads
the origin back once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .models.camera import Camera
from .models.splats import GaussianSplats
from .ops.binning import report_stats
from .ops.rasterize_tiles import depth_order, render_tiles
from .render import render as _render
from .render import render_cuda
from .utils.config import RenderConfig
from .utils.logging import format_count, get_logger

log = get_logger("scene")


@dataclasses.dataclass
class _Entry:
    splats: GaussianSplats
    version: int
    active: bool = False
    age: int = 0


class SceneRegistry:
    """Aggregates splat clusters and renders them in one globally sorted pass."""

    def __init__(self, config: RenderConfig = RenderConfig(), max_age: int = 2):
        self.config = config
        self.max_age = max_age
        self._entries: Dict[str, _Entry] = {}
        self._generation = 0          # bumped on any registry change
        self._built_generation = -1   # generation of the cached concat
        self._built_active: tuple = ()
        self._cached: Optional[GaussianSplats] = None
        self._origin: Optional[torch.Tensor] = None       # (3,) on the splats' device
        self._origin_host: Optional[np.ndarray] = None    # the same, on the host
        self._order: Optional[torch.Tensor] = None
        self._last_sort_campos: Optional[np.ndarray] = None
        self._accum_delta_sq = 0.0
        self.sort_movement_threshold = 0.0  # any movement re-sorts
        self._explicit_camera_pos: Optional[np.ndarray] = None
        self._sh_order: Optional[int] = None
        self._last_stats = None  # the previous frame's RenderStats (deferred read)

    # ------------------------------------------------------------------ API
    def register_update(self, key: str, splats: GaussianSplats, version: int = 0) -> str:
        """Register (or update) a cluster.  A new version flushes the older
        versions of the same key."""
        registry_id = f"{key}__{version}"
        stale = [
            rid
            for rid, e in self._entries.items()
            if rid.startswith(f"{key}__") and e.version != version
        ]
        for rid in stale:
            del self._entries[rid]
        self._entries[registry_id] = _Entry(splats=splats.validate(), version=version)
        self._generation += 1
        return registry_id

    def flush(self, key: str) -> None:
        """Remove all versions of a cluster."""
        for rid in [r for r in self._entries if r.startswith(f"{key}__")]:
            del self._entries[rid]
        self._generation += 1

    def include_in_render_pass(self, registry_id: str) -> None:
        entry = self._entries.get(registry_id)
        if entry is not None:
            entry.active = True
            entry.age = 0

    def set_explicit_camera_pos(self, pos) -> None:
        """Override the camera position used for sorting and SH this frame."""
        self._explicit_camera_pos = None if pos is None else np.asarray(pos, np.float32)

    def set_sh_order(self, order: int) -> None:
        if not 0 <= order <= 3:
            log.error_once(
                f"sh order {order} out of range [0,3] — disabling SH", key="sh_order"
            )
            order = 0
        else:
            log.reset_once("sh_order")
        self._sh_order = order

    @property
    def total_active_splats(self) -> int:
        return sum(e.splats.count for e in self._entries.values() if e.active)

    # ------------------------------------------------------- frame pipeline
    def generate_render_geometry(self) -> bool:
        """Concat the active clusters (budget-culled) into the cached scene.

        Returns True if the geometry was (re)built, False if it was cached."""
        active = tuple(
            sorted(rid for rid, e in self._entries.items() if e.active)
        )
        if (
            self._built_generation == self._generation
            and self._built_active == active
            and self._cached is not None
        ):
            return False
        if not active:
            self._cached = None
            self._origin = None
            self._origin_host = None
            self._order = None
            self._built_generation = self._generation
            self._built_active = active
            return True

        budget = self.config.max_splats
        chosen = []
        total = 0
        culled = 0
        for rid in active:
            e = self._entries[rid]
            if total + e.splats.count <= budget:
                chosen.append(e.splats)
                total += e.splats.count
            elif total < budget:
                # the cluster that crosses the budget still draws its first
                # budget − total splats; only the excess is culled
                head = budget - total
                chosen.append(e.splats.head(head))
                total = budget
                culled += e.splats.count - head
            else:
                culled += e.splats.count
        if culled:
            log.warning_once(
                f"splat budget {format_count(budget)} exceeded — culling "
                f"{format_count(culled)} splats",
                key="budget",
            )
        else:
            log.reset_once("budget")

        scene = chosen[0]
        for other in chosen[1:]:
            scene = scene.concat(other)
        # shared origin = mean of the cluster barycenters
        origin = torch.mean(torch.stack([s.barycenter() for s in chosen]), dim=0)
        self._cached = dataclasses.replace(scene, pos=scene.pos - origin[:, None])
        self._origin = origin
        self._origin_host = origin.detach().cpu().numpy()  # the build's one host read
        self._order = None  # fresh geometry → re-sort
        self._built_generation = self._generation
        self._built_active = active
        return True

    def _origin_camera(self, camera: Camera) -> Camera:
        """The camera translated into origin-relative coordinates, with its
        position on the host beside it."""
        origin, origin_host = self._origin, self._origin_host
        view = camera.view
        new_view = view.clone()
        # R·o + t as three column products added in order (not a matmul,
        # which may fuse or reorder): the JAX package's rounding
        r = view[:3, :3]
        new_view[:3, 3] = r[:, 0] * origin[0] + r[:, 1] * origin[1] + r[:, 2] * origin[2] + view[:3, 3]
        explicit = camera.explicit_camera_pos
        if self._explicit_camera_pos is not None:
            explicit = torch.from_numpy(self._explicit_camera_pos).to(origin.device) - origin
            host = self._explicit_camera_pos - origin_host
        else:
            if explicit is not None:
                explicit = explicit - origin
            host = camera.host_position
            if host is None:  # a Camera built by hand: one device read
                host = camera.position.detach().cpu().numpy()
            host = host - origin_host
        # derived_pos=None: the position is derived from the rebased view
        return dataclasses.replace(camera, view=new_view, explicit_camera_pos=explicit,
                                   derived_pos=None, host_position=host)

    def render(self, camera: Camera, backend: str = "auto") -> Optional[torch.Tensor]:
        """Render all active clusters.  Returns (H, W, 4), or None if none is
        active.

        Backends: ``"auto"`` (and ``"cuda"``) — :func:`render_cuda` with the
        cached order: the kernels on CUDA tensors, their plain versions on
        CPU tensors; ``"tiles"`` — :func:`render_tiles` with the cached
        order; any other name goes to :func:`render` (which sorts anew).

        Overflow reporting: the frame renders with ``warn_on_drop=False`` and
        keeps its counters; the previous frame's are read and reported under
        the registry's config at the start of the next render, so a frame
        makes no device sync for them.
        """
        if self._last_stats is not None:
            report_stats(self._last_stats, self.config)
            self._last_stats = None
        self.generate_render_geometry()
        if self._cached is None:
            return None
        cfg = dataclasses.replace(self.config, warn_on_drop=False)
        if self._sh_order is not None and self._sh_order != cfg.sh_order:
            cfg = dataclasses.replace(cfg, sh_order=self._sh_order)
        cam = self._origin_camera(camera)

        # amortized re-sort: when the geometry is fresh or the camera has
        # accumulated enough squared movement since the last sort
        campos = cam.host_position
        if self._order is None or self._last_sort_campos is None:
            need_sort = True
        else:
            self._accum_delta_sq += float(
                np.sum((campos - self._last_sort_campos) ** 2)
            )
            need_sort = self._accum_delta_sq > self.sort_movement_threshold
        if need_sort:
            self._order = depth_order(self._cached, cam)
            self._last_sort_campos = campos
            self._accum_delta_sq = 0.0

        if backend in ("auto", "cuda"):
            img, self._last_stats = render_cuda(
                self._cached, cam, cfg, order=self._order, with_stats=True
            )
        elif backend == "tiles":
            img, self._last_stats = render_tiles(
                self._cached, cam, cfg, order=self._order, with_stats=True
            )
        else:
            img, self._last_stats = _render(
                self._cached, cam, cfg, backend=backend, with_stats=True
            )
        return img

    def post_render(self) -> None:
        """Age and deactivate the entries; clear the explicit camera."""
        evict = []
        for rid, e in self._entries.items():
            if not e.active:
                e.age += 1
                if e.age > self.max_age:
                    evict.append(rid)
            e.active = False
        for rid in evict:
            del self._entries[rid]
        if evict:
            self._generation += 1
        self._explicit_camera_pos = None
