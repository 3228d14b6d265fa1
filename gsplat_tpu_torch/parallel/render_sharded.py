"""Multi-process sharded rendering over ``torch.distributed`` (counterpart of
``gsplat_tpu.parallel.render_sharded``).

Every rank runs the same program on its own block of the scene
(:func:`shard_splats`):

* **splats sharded** over the ``sp`` axis: each rank projects N/d splats
  (the per-splat math and its backward stay sharded);
* **exchange** of the compact projected payload (16 rows a splat): an
  ``all_gather`` in float32, the same with the 10 payload rows travelling as
  bf16 (``payload_dtype="bfloat16"``: already bf16-representable, so exact),
  or the strip-compacted ``all_to_all`` (``strip_exchange_factor > 0``);
* a **replicated global depth sort** of the gathered keys — every rank holds
  the same stable permutation, so each tile's compositing order is the
  single-device render's;
* **image tiles sharded** over the same axis: each rank bins and composites
  its strip of 32-px tiles through the kernel path in its strided/offset
  mode (``render.render_strip``) — a 2-D cyclic interleave by default,
  contiguous strips for the strip exchange and the trainer;
* backward: gradients reach the owning rank through the transpose of the
  exchange (``parallel/collectives.py``: a fixed-order sum over ranks).

:func:`render_sharded` assembles the frame on every rank (an all-gather of
the strips, de-interleaved).  It differs from the JAX package where that
package is quietly wrong: ``config.depth_test`` raises (JAX accepts the flag
and drops the scene depth).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.camera import Camera
from ..models.splats import GaussianSplats
from ..ops.binning import RenderStats, tile_grid, warn_exchange_dropped
from ..ops.projection import ROW_CX, ROW_CY, ROW_HX, ROW_HY, ROW_VALID, ProjectedSplats, project_splats
from ..ops.rasterize_ref import _benign_column, quantize_payload, sanitize_projected
from ..ops.rasterize_tiles import sort_by_depth
from ..render import render_strip
from ..utils.config import RenderConfig
from . import collectives as C
from .mesh import SPLAT_AXIS, Mesh, pad_to_multiple


def _factor_grid(d: int, nty: int, ntx: int):
    """Factor d ranks into a (dy, dx) cyclic interleave grid: minimize the
    coarser of the two stride/extent ratios so both axes keep a few tiles
    of granularity per rank.  On a tie the first candidate — the smallest
    dy — is kept, as in the JAX package (whose docstring says the reverse)."""
    best, best_score = (d, 1), None
    for dy in range(1, d + 1):
        if d % dy:
            continue
        dx = d // dy
        score = max(dy / max(nty, 1), dx / max(ntx, 1))
        if best_score is None or score < best_score - 1e-12:
            best, best_score = (dy, dx), score
    return best


def pad_splats(splats: GaussianSplats, multiple: int) -> GaussianSplats:
    """Pad the splat cluster with zero splats (opacity 0: culled at binning)
    so N divides the mesh axis."""
    extra = pad_to_multiple(splats.count, multiple) - splats.count
    if extra == 0:
        return splats
    return GaussianSplats(**{
        f.name: F.pad(getattr(splats, f.name), (0, extra)) for f in dataclasses.fields(GaussianSplats)
    })


def shard_splats(splats: GaussianSplats, mesh: Mesh, axis: str = SPLAT_AXIS) -> GaussianSplats:
    """This rank's contiguous block of the padded scene (the splat axis is
    the last dimension of every field), on the mesh's device."""
    d = mesh.shape[axis]
    padded = pad_splats(splats, d)
    n_local = padded.count // d
    lo = mesh.index(axis) * n_local
    return GaussianSplats(**{
        f.name: getattr(padded, f.name)[..., lo : lo + n_local].contiguous().to(mesh.device)
        for f in dataclasses.fields(GaussianSplats)
    })


def _strip_overlap(fields: torch.Tensor, width: int, strip_h: int, d: int):
    """Which contiguous strips can each projected splat's footprint overlap?
    ``(alive, s0, s1)`` — the one test ``_strip_exchange`` compacts by and
    ``measure_strip_counts`` counts by."""
    y_lo = fields[ROW_CY] - fields[ROW_HY]
    y_hi = fields[ROW_CY] + fields[ROW_HY]
    x_lo = fields[ROW_CX] - fields[ROW_HX]
    x_hi = fields[ROW_CX] + fields[ROW_HX]
    alive = (
        (fields[ROW_VALID] > 0.5)
        & (x_hi >= 0.0)
        & (x_lo < width)
        & (y_hi >= 0.0)
        & (y_lo < d * strip_h)
    )
    sh_px = float(strip_h)
    s0 = torch.clamp(torch.floor(y_lo / sh_px).to(torch.int32), 0, d - 1)
    s1 = torch.clamp(torch.floor(y_hi / sh_px).to(torch.int32), 0, d - 1)
    return alive, s0, s1


def _strip_exchange(fields: torch.Tensor, width: int, strip_h: int, d: int, bucket: int, group):
    """Strip-compacted payload exchange: ``all_to_all`` in place of the
    gather.  For each destination strip s, the local splats whose footprint
    can overlap it are compacted, in local storage order, into a bucket of
    ``bucket`` columns (benign padding); bucket s goes to rank s.  Returns
    the (16, d·bucket) fields of every splat overlapping this rank's strip,
    in global storage order, and the group-wide count of columns that did
    not fit.  Overflow drops the columns compacted last (arbitrary depth):
    a nonzero count means ``strip_exchange_factor`` is too small."""
    n_local = fields.shape[1]
    dev = fields.device
    alive, s0, s1 = _strip_overlap(fields, width, strip_h, d)
    benign = _benign_column(dev)
    slots = torch.arange(bucket, dtype=torch.int32, device=dev)
    bufs = []
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    for s in range(d):
        m = alive & (s0 <= s) & (s <= s1)
        pos = torch.cumsum(m.to(torch.int32), 0, dtype=torch.int32) - 1
        count = pos[-1] + 1 if n_local > 0 else torch.zeros((), dtype=torch.int32, device=dev)
        # column of each bucket slot; slots past the count keep index 0 and
        # are replaced by the benign column
        idx = torch.zeros((bucket + 1,), dtype=torch.long, device=dev)
        idx[torch.where(m & (pos < bucket), pos, bucket).long()] = torch.arange(n_local, device=dev)
        slot_ok = slots < torch.clamp(count, max=bucket)
        bufs.append(torch.where(slot_ok[None, :], fields[:, idx[:bucket]], benign))
        dropped = dropped + torch.clamp(count - bucket, min=0)
    x = C.all_to_all(torch.stack(bufs), group)  # x[j]: what rank j compacted for this strip
    full = x.transpose(0, 1).reshape(fields.shape[0], d * bucket)
    return full, C.psum(dropped, group)


def exchange_projected(p: ProjectedSplats, width: int, strip_h: int, d: int, config: RenderConfig, group):
    """Every strip-relevant projected field column on this rank.

    ``p`` is this rank's sanitized, quantized projected block.  Returns
    ``(fields, exchange_dropped)``: the (16, ·) fields of every splat that
    can overlap the local strip, in global storage order, and the bucket
    overflow count (a 0-dim tensor; 0 for the gathers).  Three policies,
    chosen by ``config`` and shared by the sharded renderer and trainer:

    * ``strip_exchange_factor > 0`` — the strip-compacted ``all_to_all``
      (per-rank payload factor·N columns instead of N; overflow drops
      columns, warned once when ``config.warn_on_drop``);
    * ``payload_dtype == "bfloat16"`` — ``all_gather`` with the 10 payload
      rows travelling as bf16 (half their bytes; exact, the rows are
      bf16-rounded already); the gradient comes back in float32;
    * otherwise — a float32 ``all_gather`` of the field matrix.
    """
    ex_dropped = torch.zeros((), dtype=torch.int32, device=p.fields.device)
    if config.strip_exchange_factor > 0.0:
        bucket = min(max(int(math.ceil(config.strip_exchange_factor * p.count)), 1), p.count)
        full, ex_dropped = _strip_exchange(p.fields, width, strip_h, d, bucket, group)
        if config.warn_on_drop:
            warn_exchange_dropped(ex_dropped)
    elif config.payload_dtype == "bfloat16":
        pay = C.all_gather(p.fields[:10], group, dim=1, wire_dtype=torch.bfloat16)
        geo = C.all_gather(p.fields[10:], group, dim=1)
        full = torch.cat([pay, geo], dim=0)
    else:
        full = C.all_gather(p.fields, group, dim=1)
    return ProjectedSplats(fields=full), ex_dropped


def local_strip_render(
    splats_local: GaussianSplats,
    camera: Camera,
    strip_h: int,
    d: int,
    config: RenderConfig,
    backend: str,
    group,
    with_stats: bool = False,
    strip_w: int = None,
):
    """One rank's share of a sharded render: project this rank's block,
    exchange the projected payload, sort, and composite the local strip.
    The body of :func:`render_sharded` and of each camera of the sharded
    trainer.  With ``with_stats`` also the group-wide
    :class:`~gsplat_tpu_torch.ops.binning.RenderStats` (pair-budget drops
    summed over strips, exchange drops)."""
    if config.depth_test:
        raise ValueError("the sharded renderer takes no scene depth: config.depth_test is not supported")
    projected = project_splats(
        splats_local, camera, config.sh_order,
        tight_footprint=not config.soft_cutoff, only_sh=config.only_sh,
    )
    # Quantized before the exchange: rounding each block is rounding the
    # gathered matrix, so the bf16 policies stay bit-equal to one device.
    p = quantize_payload(sanitize_projected(projected), config)
    full, ex_dropped = exchange_projected(p, camera.width, strip_h, d, config, group)
    p_sorted = sort_by_depth(full)
    di = C.group_rank(group)
    col_offset = 0
    if config.row_stride > 1 or config.col_stride > 1:
        # Cyclic interleave: ranks form a (row_stride × col_stride) grid,
        # di = a·col_stride + b owns global tile rows ≡ a (mod row_stride)
        # and columns ≡ b (mod col_stride).
        row_offset = di // config.col_stride
        col_offset = di % config.col_stride
    else:
        row_offset = di * (strip_h // config.tile_h)
    strip, dropped = render_strip(
        p_sorted, strip_w if strip_w is not None else camera.width, strip_h, row_offset, config,
        backend, n_strips=d, col_offset=col_offset,
    )
    if not with_stats:
        return strip
    return strip, RenderStats(dropped_pairs=C.psum(dropped, group), exchange_dropped=ex_dropped)


def render_sharded(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    mesh: Mesh = None,
    backend: str = "auto",
    axis: str = SPLAT_AXIS,
    with_stats: bool = False,
):
    """Multi-rank render, called by every rank of the mesh's ``axis`` group
    with its own block (:func:`shard_splats`).  Returns the whole (H, W, 4)
    frame on every rank — or ``(image, RenderStats)`` with ``with_stats``
    (counters summed over the group).  Differentiable: a loss every rank
    computes alike from the frame sends each rank the gradient of its own
    block.

    Backends: ``"auto"``/``"cuda"`` (the kernel path), ``"tiles"`` (plain
    PyTorch tiled compositing; runs on the CPU).
    """
    if mesh is None:
        raise ValueError("render_sharded requires a mesh")
    if config.depth_test:
        raise ValueError("the sharded renderer takes no scene depth: config.depth_test is not supported")
    if backend == "auto":
        backend = "cuda"
    group = mesh.group(axis)
    d = mesh.shape[axis]
    # Each rank owns 1/d of the 32-px tiles.  "cyclic" (default) factors d
    # into a (dy × dx) grid and interleaves tile rows and columns — rank
    # a·dx + b owns global tiles (row ≡ a mod dy, col ≡ b mod dx), which
    # balances centre-heavy scenes; the strip exchange needs spatially
    # coherent strips, so it forces "contiguous".
    cyclic = config.row_assignment == "cyclic" and config.strip_exchange_factor == 0.0 and d > 1
    if cyclic:
        nty_full, ntx_full = tile_grid(camera.width, camera.height, config.tile_h, config.tile_w)
        dy, dx = _factor_grid(d, nty_full, ntx_full)
        h_pad = pad_to_multiple(camera.height, dy * config.tile_h)
        w_pad = pad_to_multiple(camera.width, dx * config.tile_w)
        strip_h, strip_w = h_pad // dy, w_pad // dx
        cfg_local = dataclasses.replace(config, row_stride=dy, col_stride=dx)
    else:
        h_pad = pad_to_multiple(camera.height, d * config.tile_h)
        strip_h, strip_w = h_pad // d, camera.width
        w_pad = camera.width
        cfg_local = config
    out = local_strip_render(splats, camera, strip_h, d, cfg_local, backend, group,
                             with_stats=with_stats, strip_w=strip_w)
    strip = out[0] if with_stats else out
    strips = C.gather_replicated(strip[None], group, dim=0)  # (d, strip_h, strip_w, 4)
    if cyclic:
        # rank-major strips → screen order: global tile (jy·dy + a, jx·dx + b)
        # is rank a·dx + b's local tile (jy, jx)
        th, tw = config.tile_h, config.tile_w
        x = strips.reshape(dy, dx, strip_h // th, th, strip_w // tw, tw, 4)
        image = x.permute(2, 0, 3, 4, 1, 5, 6).reshape(h_pad, w_pad, 4)
    else:
        image = strips.reshape(h_pad, w_pad, 4)
    image = image[: camera.height, : camera.width]
    return (image, out[1]) if with_stats else image


def measure_strip_counts(
    splats: GaussianSplats, camera: Camera, d: int, config: RenderConfig = RenderConfig()
) -> np.ndarray:
    """(d, d) host matrix: how many of source shard i's splats the strip
    exchange would compact for destination strip j this frame — the exact
    ``_strip_overlap`` test on the exact contiguous blocks
    :func:`shard_splats` makes.  One counting pass over the whole scene, in
    one process (no pair arrays, no mesh)."""
    strip_h = pad_to_multiple(camera.height, d * config.tile_h) // d
    with torch.no_grad():
        p = project_splats(pad_splats(splats, d), camera, config.sh_order, tight_footprint=not config.soft_cutoff)
        p = quantize_payload(sanitize_projected(p), config)
        alive, s0, s1 = _strip_overlap(p.fields, camera.width, strip_h, d)
        counts = [
            torch.sum((alive & (s0 <= s) & (s <= s1)).to(torch.int32).reshape(d, p.count // d), dim=1)
            for s in range(d)
        ]
    return torch.stack(counts, dim=1).cpu().numpy()  # (source shard, dest strip)


def tune_strip_exchange(
    splats: GaussianSplats,
    cameras,
    d: int,
    config: RenderConfig = RenderConfig(),
    headroom: float = 1.3,
) -> RenderConfig:
    """Measure the scene's worst (shard, strip) overlap and set
    ``strip_exchange_factor`` with ``headroom`` (the strip-exchange
    counterpart of ``tune_pair_budget``).  ``cameras``: one Camera or an
    iterable; the worst over them is used.  A factor at or above 1 − 1/d
    cannot beat the gather: the returned config keeps factor 0 then."""
    if isinstance(cameras, Camera):
        cameras = [cameras]
    n_local = pad_to_multiple(splats.count, d) // d
    worst = 0
    for cam in cameras:
        worst = max(worst, int(measure_strip_counts(splats, cam, d, config).max()))
    factor = min(headroom * worst / max(n_local, 1), 1.0)
    if factor >= 1.0 - 1.0 / d:
        return dataclasses.replace(config, strip_exchange_factor=0.0)
    return dataclasses.replace(config, strip_exchange_factor=factor)
