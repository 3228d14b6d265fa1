"""Tiled rasterizer in plain PyTorch (counterpart of
``gsplat_tpu.ops.rasterize_tiles``).

The algorithmic twin of the CUDA compositor (``ops/kernels/composite.py``):
project → global depth sort → tile binning → per-tile front-to-back
compositing over dense tile lists.  Runs on the CPU and on the card and
serves as the mid-level oracle between the O(N·H·W) reference rasterizer and
the kernel path.

Pipeline parity contract: identical math to
``rasterize_ref.composite_reference`` (same per-pixel alpha, same global
compositing order) — images match to fp32 tolerance whenever no pairs were
dropped by the binning budget.
"""

from __future__ import annotations

import torch

from ..models.camera import Camera
from ..models.splats import GaussianSplats
from ..utils.config import RenderConfig
from .binning import BinnedPairs, RenderStats, bin_splats, tile_grid, warn_if_dropped
from .covariance import ALPHA_CUTOFF, QUAD_EXTENT
from .permute import permute_cols
from .projection import N_FIELDS, ROW_DEPTH, ROW_VIEWZ, ProjectedSplats, project_splats
from .rasterize_ref import quantize_payload, sanitize_projected


def permute_fields(p: ProjectedSplats, order: torch.Tensor, n_rows: int) -> ProjectedSplats:
    """Permute the ``n_rows`` live rows and re-append the structural-zero
    rows, as the JAX package's ``sort_by_depth`` shapes its result."""
    live = permute_cols(p.fields[:n_rows], order, 10)
    pad = torch.zeros(
        (N_FIELDS - n_rows, live.shape[1]), dtype=live.dtype, device=live.device
    )
    return ProjectedSplats(fields=torch.cat([live, pad], dim=0))


def sort_by_depth(p: ProjectedSplats, n_rows: int = 14) -> ProjectedSplats:
    """Global ascending-distance sort; invalid splats (depth=inf after
    sanitize) go last.  The sort is stable, as ``jnp.argsort`` is: all the
    ``+inf`` depths of culled splats tie.  Only the ``n_rows`` live rows are
    permuted (14 by default; the remainder are structural zeros)."""
    order = torch.argsort(p.fields[ROW_DEPTH], stable=True)
    return permute_fields(p, order, n_rows)


def depth_order(splats: GaussianSplats, camera: Camera) -> torch.Tensor:
    """Ascending squared-camera-distance permutation over splats.  Exposed so
    an interactive host can cache the order and re-sort only when the camera
    has moved enough."""
    pos = splats.pos
    cam_pos = camera.position
    tx = pos[0] - cam_pos[0]
    ty = pos[1] - cam_pos[1]
    tz = pos[2] - cam_pos[2]
    key = tx * tx + ty * ty + tz * tz
    # behind-camera (clip_w ≤ 0) last, matching sanitize_projected's inf depth
    view = camera.view
    proj = camera.proj
    vx = view[0, 0] * pos[0] + view[0, 1] * pos[1] + view[0, 2] * pos[2] + view[0, 3]
    vy = view[1, 0] * pos[0] + view[1, 1] * pos[1] + view[1, 2] * pos[2] + view[1, 3]
    vz = view[2, 0] * pos[0] + view[2, 1] * pos[1] + view[2, 2] * pos[2] + view[2, 3]
    clip_w = proj[3, 0] * vx + proj[3, 1] * vy + proj[3, 2] * vz + proj[3, 3]
    key = torch.where(clip_w > 0.0, key, float("inf"))
    return torch.argsort(key, stable=True)


def build_tile_lists(binned: BinnedPairs, num_tiles: int, capacity: int, n: int) -> torch.Tensor:
    """Dense per-tile splat lists [T, K] (entries = depth-rank index, ``n`` =
    padded benign column).  Entries beyond a tile's capacity are dropped
    (farthest splats, consistent with the binning overflow policy)."""
    dev = binned.pair_splat.device
    tile = binned.pair_tile.long()
    pos_in_tile = (
        torch.arange(binned.pair_budget, dtype=torch.int64, device=dev)
        - binned.tile_start[torch.clamp(tile, max=num_tiles - 1)].long()
    )
    keep = (tile < num_tiles) & (pos_in_tile >= 0) & (pos_in_tile < capacity)
    # Dropped entries (sentinel tile, pos ≥ capacity) go to one extra slot.
    flat = torch.where(keep, tile * capacity + pos_in_tile, num_tiles * capacity)
    lists = torch.full((num_tiles * capacity + 1,), n, dtype=torch.int32, device=dev)
    lists[flat] = binned.pair_splat
    return lists[:-1].reshape(num_tiles, capacity)


def composite_tile_lists(
    tile_lists: torch.Tensor,
    payload: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig,
    row_offset: int = 0,
    col_offset: int = 0,
    bg_depth_tiles: torch.Tensor = None,
) -> torch.Tensor:
    """Front-to-back composite of dense tile lists.

    ``bg_depth_tiles``: optional (T, TH, TW) view-space scene depth per
    tile (:func:`pack_depth_tiles`) — splat contributions behind it are
    killed per pixel before blending (the host scene's z-tested beauty pass).

    Args:
      tile_lists: (T, K) int32 depth-rank indices, ``n`` sentinel for empty.
      payload: (16, N) field matrix (``ops/projection.py`` row layout; NOT
        padded — a benign zero column is appended here).
      width/height: screen size in pixels.

    Returns:
      (H, W, 4) premultiplied RGBA.
    """
    nty, ntx = tile_grid(width, height, config.tile_h, config.tile_w)
    num_tiles, capacity = tile_lists.shape
    assert num_tiles == nty * ntx
    th, tw = config.tile_h, config.tile_w
    dev = payload.device
    f32 = torch.float32
    n = payload.shape[1]

    # Benign padded column: opacity 0 → alpha 0 → no contribution.
    pad = torch.zeros((payload.shape[0], 1), dtype=payload.dtype, device=dev)
    payload_p = torch.cat([payload, pad], dim=1)

    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    origin_x = (((tile_ids % ntx) * config.col_stride + int(col_offset)) * tw).to(f32)
    origin_y = (
        (torch.div(tile_ids, ntx, rounding_mode="floor") * config.row_stride + int(row_offset)) * th
    ).to(f32)
    iota_y = (torch.arange(th, dtype=f32, device=dev) + 0.5)[None, :, None]
    iota_x = (torch.arange(tw, dtype=f32, device=dev) + 0.5)[None, None, :]
    px = origin_x[:, None, None] + iota_x  # (T, 1, TW)
    py = origin_y[:, None, None] + iota_y  # (T, TH, 1)

    color = torch.zeros((num_tiles, 3, th, tw), dtype=f32, device=dev)
    transmittance = torch.ones((num_tiles, th, tw), dtype=f32, device=dev)
    # List columns past the longest tile hold only the benign sentinel and
    # contribute exact zeros; stop there (one host read — this is an oracle).
    depth = int((tile_lists != n).sum(dim=1).max()) if tile_lists.numel() > 0 else 0
    for k in range(depth):
        f = payload_p[:, tile_lists[:, k].long()]  # (16, T)
        dx = px - f[0][:, None, None]
        dy = py - f[1][:, None, None]
        qx = dx * f[2][:, None, None] + dy * f[3][:, None, None]
        qy = dx * f[4][:, None, None] + dy * f[5][:, None, None]
        power = qx * qx + qy * qy
        alpha = torch.clamp(torch.exp(-power) * f[9][:, None, None], 0.0, config.max_alpha)
        if not config.soft_cutoff:
            inside = (torch.abs(qx) <= QUAD_EXTENT) & (torch.abs(qy) <= QUAD_EXTENT)
            alpha = torch.where(inside & (alpha >= ALPHA_CUTOFF), alpha, 0.0)
        if bg_depth_tiles is not None:
            alpha = torch.where(f[ROW_VIEWZ][:, None, None] <= bg_depth_tiles, alpha, 0.0)
        weight = alpha * transmittance  # (T, TH, TW)
        color = color + weight[:, None] * f[6:9, :].T[:, :, None, None]
        transmittance = transmittance * (1.0 - alpha)

    tiles = torch.cat([color, (1.0 - transmittance)[:, None]], dim=1)  # (T,4,TH,TW)
    image = (
        tiles.reshape(nty, ntx, 4, th, tw)
        .permute(0, 3, 1, 4, 2)
        .reshape(nty * th, ntx * tw, 4)
    )
    return image[:height, :width].contiguous()


def pack_depth_tiles(bg_depth: torch.Tensor, nty: int, ntx: int, th: int, tw: int) -> torch.Tensor:
    """(H, W) scene depth → (T, TH, TW) per-tile blocks, padded with +inf
    (pixels outside the image never kill anything)."""
    h, w = bg_depth.shape
    d = bg_depth.new_full((nty * th, ntx * tw), float("inf"))
    d[:h, :w] = bg_depth
    return d.reshape(nty, th, ntx, tw).permute(0, 2, 1, 3).reshape(-1, th, tw)


def render_tiles(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    order: torch.Tensor = None,
    with_stats: bool = False,
    bg_depth: torch.Tensor = None,
) -> torch.Tensor:
    """End-to-end tiled render.  Returns (H, W, 4) premultiplied RGBA — or
    ``(image, RenderStats)`` with ``with_stats=True``.

    ``bg_depth``: optional (H, W) view-space scene depth (depth-tested
    compositing into a host scene; pair with ``config.depth_test``).

    ``order``: optional precomputed depth permutation (see
    :func:`depth_order`) — the amortized-sort path; recomputed when None.
    """
    projected = project_splats(
        splats, camera, config.sh_order,
        tight_footprint=not config.soft_cutoff, only_sh=config.only_sh,
    )
    p = quantize_payload(sanitize_projected(projected), config)
    # 15 rows keep the view-z row (14) for the depth test
    n_rows = 15 if bg_depth is not None else 14
    p = sort_by_depth(p, n_rows) if order is None else permute_fields(p, order, n_rows)
    binned = bin_splats(p, camera.width, camera.height, config)
    nty, ntx = tile_grid(camera.width, camera.height, config.tile_h, config.tile_w)
    lists = build_tile_lists(binned, nty * ntx, config.tile_capacity, p.count)
    bgd_t = None
    if bg_depth is not None:
        bgd_t = pack_depth_tiles(bg_depth, nty, ntx, config.tile_h, config.tile_w)
    image = composite_tile_lists(
        lists, p.fields, camera.width, camera.height, config, bg_depth_tiles=bgd_t
    )
    warn_if_dropped(binned, config)
    if with_stats:
        return image, RenderStats(dropped_pairs=binned.dropped_pairs)
    return image
