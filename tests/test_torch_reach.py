"""The backward compositor's reach test and the live pixel count the bounds
now price.

``reach_mask_plain`` is the PyTorch twin of ``pair_reaches`` in
``csrc/composite_common.cuh`` (the same separately rounded float32
operations).  It may keep a warp that turns out dead, never drop a live one:
held here, on random and adversarial payloads, against the port's plain α
and the JAX package's ``splat_alpha_image`` on the same inputs.
``walked_pair_counts`` / ``live_pixel_updates`` are held against a
brute-force count by the plain compositor's own per-position α.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import gsplat_tpu_torch as gt
from gsplat_tpu.ops.rasterize_ref import splat_alpha_image
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.ops.kernels import composite as kcomp
from gsplat_tpu_torch.ops.projection import project_splats
from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, sanitize_projected
from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth
from gsplat_tpu_torch.utils import sol

MAX_ALPHA = 0.99
KINDS = ("random", "axis", "near_singular", "huge_tiny", "far", "edge", "nonfinite")


def _payloads(kind, n, rng, gx0, gy0):
    """(6, n) float32 geometry rows ``cx cy ax ay bx by`` and (n,) opacities
    of one adversarial kind, around the tile whose first pixel is (gx0, gy0)."""
    cx = gx0 + rng.uniform(-40, 72, n)
    cy = gy0 + rng.uniform(-40, 72, n)
    theta = rng.uniform(0, 2 * np.pi, n)
    s1 = 10.0 ** rng.uniform(-3, 1, n)  # quad units a pixel: ±2 spans 4/s pixels
    s2 = 10.0 ** rng.uniform(-3, 1, n)
    ax, ay = s1 * np.cos(theta), s1 * np.sin(theta)
    bx, by = -s2 * np.sin(theta), s2 * np.cos(theta)
    op = rng.uniform(0.004, 1.0, n)
    if kind == "axis":
        ay, bx = np.zeros(n), np.zeros(n)
    elif kind == "near_singular":
        eps = 10.0 ** rng.uniform(-9, -2, n)
        bx, by = ax * (1 + eps), ay * (1 - eps)
    elif kind == "huge_tiny":
        big = 10.0 ** rng.uniform(-7, 6, (4, n))
        ax, ay, bx, by = (big * rng.choice([-1.0, 1.0], (4, n)))
    elif kind == "far":
        cx = gx0 + rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(2, 7, n)
        cy = gy0 + rng.uniform(-1e3, 1e3, n)
        ax, ay, bx, by = ax * 1e-3, ay * 1e-3, bx * 1e-3, by * 1e-3
    elif kind == "edge":
        # q = ±2 exactly at a pixel centre of the tile: the hard threshold
        # itself, where a pixel is live and the next one is not
        px = gx0 + rng.integers(0, 32, n) + 0.5
        py = gy0 + rng.integers(0, 32, n) + 0.5
        dx, dy = px - cx, py - cy
        dx = np.where(np.abs(dx) < 0.25, 0.25, dx)
        ax = 2.0 / dx * rng.choice([-1.0, 1.0], n)
        ay = np.zeros(n)
        bx = np.zeros(n)
        by = np.where(np.abs(dy) < 0.25, 1.0, 1.5 / np.where(dy == 0, 1.0, dy))
        op = np.ones(n)
    elif kind == "nonfinite":
        rows = np.stack([cx, cy, ax, ay, bx, by])
        which = rng.integers(0, 6, n)
        rows[which, np.arange(n)] = rng.choice([np.inf, -np.inf, np.nan], n)
        cx, cy, ax, ay, bx, by = rows
    geo = np.stack([cx, cy, ax, ay, bx, by]).astype(np.float32)
    return geo, op.astype(np.float32)


def _live_pixels(geo, op, gx0, gy0):
    """(n, 32, 32) bool: α != 0 by the port's plain α or by the JAX
    package's, at the tile's pixel centres."""
    cfg = gt.RenderConfig(max_alpha=MAX_ALPHA)
    g = torch.from_numpy(geo)
    iota = torch.arange(32, dtype=torch.float32) + 0.5
    px = (float(gx0) + iota)[None, None, :].expand(geo.shape[1], 1, 32)
    py = (float(gy0) + iota)[None, :, None].expand(geo.shape[1], 32, 1)
    alpha, _, _ = kcomp._pair_alpha(g, torch.from_numpy(op), None, px, py, None, cfg, kcomp.MODE_BEAUTY,
                                    torch.tensor(MAX_ALPHA))
    col = [jnp.asarray(r)[:, None, None] for r in geo]
    ja = splat_alpha_image(*col, jnp.asarray(op)[:, None, None], jnp.asarray(px.numpy()),
                           jnp.asarray(py.numpy()), MAX_ALPHA)
    return (alpha != 0.0).numpy() | (np.asarray(ja) != 0.0)


def _warp_live(live):
    return np.stack([live[:, y0:y0 + h, x0:x0 + w].any(axis=(1, 2))
                     for x0, y0, w, h in kcomp.warp_rects()], axis=1)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(KINDS), seed=st.integers(0, 2**31 - 1),
       tile=st.tuples(st.integers(0, 200), st.integers(0, 120)))
def test_reach_test_never_drops_a_live_pixel(kind, seed, tile):
    """Random and adversarial payloads — near-singular and rotated bases,
    tiny and huge scales, centres far outside the tile, inf/NaN, q = ±2 on a
    pixel centre — on global tiles anywhere in a strided frame: every warp
    holding a pixel with α != 0 is kept."""
    rng = np.random.default_rng(seed)
    gx0, gy0 = 32 * tile[0], 32 * tile[1]
    geo, op = _payloads(kind, 64, rng, gx0, gy0)
    live = _live_pixels(geo, op, gx0, gy0)
    g = torch.from_numpy(geo)
    t_gx0 = torch.full((geo.shape[1],), gx0, dtype=torch.int32)
    t_gy0 = torch.full((geo.shape[1],), gy0, dtype=torch.int32)
    kept = kcomp.reach_mask_plain(g, t_gx0, t_gy0).numpy()
    dropped_live = _warp_live(live) & ~kept
    assert not dropped_live.any(), (kind, np.argwhere(dropped_live)[:3], geo[:, dropped_live.any(1)][:, :3])
    if kind == "nonfinite":  # a NaN or infinite entry keeps every warp
        assert kept.all()


def test_reach_test_drops_dead_warps_of_small_splats():
    """Not everything is kept: a 6-pixel splat in a tile's corner reaches
    the corner's warp of eight and at most one more."""
    geo = torch.tensor([[3.5], [2.5], [2.0 / 3.0], [0.0], [0.0], [2.0 / 3.0]])
    zero = torch.zeros((1,), dtype=torch.int32)
    kept = kcomp.reach_mask_plain(geo, zero, zero)
    assert kept[0, 0] and int(kept.sum()) <= 2, kept


def _scene(mode):
    g = torch.Generator().manual_seed(3)
    splats = gt.random_splats(g, 600, extent=0.8, scale_range=(0.02, 0.08), sh_scale=0.1, device="cpu")
    cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], 96, 64, device="cpu")
    cfg = gt.RenderConfig(payload_dtype="packed" if mode in ("beauty", "strided") else "float32",
                          soft_cutoff=mode == "soft", depth_test=mode == "depth", transmittance_eps=1e-3,
                          pairs_per_splat=12.0, warn_on_drop=False)
    offsets, (w, h) = (0, 0), (96, 64)
    if mode == "strided":
        cfg = dataclasses.replace(cfg, row_stride=2, col_stride=2)
        offsets, (w, h) = (1, 0), (64, 32)
    p = project_splats(splats, cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff)
    p = sort_by_depth(quantize_payload(sanitize_projected(p), cfg), 15 if cfg.depth_test else 14)
    if mode == "wire":
        from gsplat_tpu_torch.ops import wireframe as wire
        args, b = wire._wireframe_inputs(splats, cam, cfg, 1.5)
        return args, b, None, offsets
    b = binning.bin_splats(p, w, h, cfg, row_offset=offsets[0], col_offset=offsets[1], with_tiles=False)
    nty, ntx = binning.tile_grid(w, h, 32, 32)
    if cfg.payload_dtype == "packed":
        pay = kcomp.pack_payload(p.fields)
    elif cfg.depth_test:
        pay = torch.cat([p.fields[:10], p.fields[14:15]]).contiguous()
    else:
        pay = p.fields[:10].contiguous()
    bgd = None
    if cfg.depth_test:
        bgd = (2.0 + 1.5 * torch.linspace(0, 1, w)[None, :]) * torch.ones((h, 1))
        bgd[h // 2] = float("nan")
    return (pay, b.pair_splat, b.tile_base, b.tile_phi, b.tile_span, nty, ntx, h, w, cfg), b, bgd, offsets


@pytest.mark.parametrize("mode", ["beauty", "soft", "depth", "wire", "strided"])
def test_live_pixel_updates_equals_a_brute_force_count(mode):
    """The batched count over the walked pairs equals a walk of every
    position of every tile through the plain compositor's own α (with the
    early stop, the band test, the depth test with a NaN row, the strided
    mapping; every pixel with the soft cutoff), and so do its live warps."""
    args, b, bgd, offsets = _scene(mode)
    pay, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, h, w, cfg = args
    _, used = kcomp.composite_splats_plain(*args, bg_depth=bgd, offsets=offsets)
    got = kcomp.walked_pair_counts(pay, pair_splat, tile_base, tile_phi, used, nty, ntx, cfg, bgd, offsets,
                                   batch=37)
    tiles = kcomp._PlainTiles(pay, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, cfg,
                              cfg.payload_dtype == "packed", bgd, offsets)
    active = torch.ones((nty * ntx,), dtype=torch.bool)
    pairs = live = live_warps = 0
    for pos in range(int(tile_span.max())):
        valid, alpha, _, _, _ = tiles.pair(pos, active)
        walked = valid & (used > pos)
        pairs += int(walked.sum())
        nz = (alpha != 0.0) & walked[:, None, None]
        live += int(walked.sum()) * 1024 if (cfg.soft_cutoff and not cfg.wireframe) else int(nz.sum())
        live_warps += int(_warp_live(nz.numpy()).sum())
    assert pairs > 0 and got["pairs"] == pairs
    assert got["live_pixel_updates"] == live and got["live_warps"] == live_warps
    assert live_warps <= got["reach_warps"] <= 8 * pairs
    assert kcomp.live_pixel_updates(pay, pair_splat, tile_base, tile_phi, used, nty, ntx, cfg, bgd,
                                    offsets) == live
    if mode in ("beauty", "depth", "strided"):  # the reach test drops something
        assert got["reach_warps"] < 8 * pairs and 0 < live < 1024 * pairs
    if mode == "soft":
        assert got["reach_warps"] == 8 * pairs and live == 1024 * pairs


def test_bounds_price_the_live_updates():
    """The speed-of-light model's compositor floors scale with the live
    updates when given, and equal the all-pixel floors without them."""
    n, w, h, budget, walked = 1_000_000, 1920, 1080, 2_359_296, 850_000
    all_px = sol.speed_of_light(n, w, h, budget, False, sol.H100, walked)["stages"]
    live = sol.speed_of_light(n, w, h, budget, False, sol.H100, walked, live_updates=walked * 128)["stages"]
    same = sol.speed_of_light(n, w, h, budget, False, sol.H100, walked, live_updates=walked * 1024)["stages"]
    assert same == all_px
    for stage in ("fwd kernel", "bwd kernel"):
        assert live[stage][0] < all_px[stage][0] / 4
    assert live["segment sum"] == all_px["segment sum"]


def test_audit_instance_is_for_the_card_and_the_hard_cutoff():
    """composite_bwd_audit refuses CPU tensors (the plain version has no
    reach test to audit) and the soft cutoff (which has none either)."""
    args, b, _, _ = _scene("beauty")
    _, used, tchk = kcomp.composite_splats_plain(*args, checkpoint=True)
    grad_base = torch.zeros_like(used)
    bargs = args[:5] + (used, grad_base, torch.zeros((64, 96, 4)), tchk, 1024) + args[5:]
    with pytest.raises(ValueError, match="CUDA tensors with the hard cutoff"):
        kcomp.composite_bwd_audit(*bargs)
