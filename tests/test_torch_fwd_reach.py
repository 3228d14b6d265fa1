"""The forward compositor's warp mask.

A warp of ``csrc/composite_fwd.cu`` skips a pair when the mask
(``fwd_reach_bits``; its PyTorch twin ``fwd_mask_plain`` on top of
``reach_mask_plain``, the same separately rounded float32 operations) clears
its bit.  Skipping is exact only where the update would have added exact
zeros, so the mask may keep a warp that turns out dead but never drop one
with a pixel where α ≠ 0, nor one whose colour update would be NaN (a
non-finite colour keeps every warp).  Held here on random and adversarial
payloads in the beauty, depth and band modes against the port's plain α and
the JAX package's ``_splat_alpha`` (the Pallas kernel's own α, called as
plain jnp on the CPU), and on whole scenes by a plain forward that skips
what the mask drops, which must give the plain forward's image bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import gsplat_tpu_torch as gt
from gsplat_tpu.ops.pallas.composite import _splat_alpha
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.ops import wireframe as wire
from gsplat_tpu_torch.ops.kernels import composite as kcomp
from gsplat_tpu_torch.ops.projection import project_splats
from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, sanitize_projected
from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth

MAX_ALPHA = 0.99
N_PAIRS = 48
KINDS = ("random", "axis", "singular", "huge_tiny", "far", "edge", "band_edge", "nonfinite", "nonfinite_color")


def _payloads(kind, n, rng, gx0, gy0, line_px):
    """(6, n) geometry rows ``cx cy ax ay bx by``, (3, n) colours, (n,)
    opacities and view-z of one adversarial kind around the tile whose first
    pixel is (gx0, gy0), all float32."""
    cx = gx0 + rng.uniform(-40, 72, n)
    cy = gy0 + rng.uniform(-40, 72, n)
    theta = rng.uniform(0, 2 * np.pi, n)
    s1 = 10.0 ** rng.uniform(-3, 1, n)  # quad units a pixel
    s2 = 10.0 ** rng.uniform(-3, 1, n)
    ax, ay = s1 * np.cos(theta), s1 * np.sin(theta)
    bx, by = -s2 * np.sin(theta), s2 * np.cos(theta)
    op = rng.uniform(0.004, 1.0, n)
    color = rng.uniform(0.0, 1.0, (3, n))
    viewz = rng.uniform(1.0, 4.0, n)
    if kind == "axis":
        ay, bx = np.zeros(n), np.zeros(n)
    elif kind == "singular":  # A parallel to B, or one of them zero
        eps = np.where(rng.random(n) < 0.5, 0.0, 10.0 ** rng.uniform(-9, -3, n))
        bx, by = ax * (1 + eps), ay * (1 - eps)
        zero = rng.random(n) < 0.3
        ax, ay = np.where(zero, 0.0, ax), np.where(zero, 0.0, ay)
    elif kind == "huge_tiny":
        big = 10.0 ** rng.uniform(-7, 6, (4, n))
        ax, ay, bx, by = (big * rng.choice([-1.0, 1.0], (4, n)))
    elif kind == "far":
        cx = gx0 + rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(2, 7, n)
        cy = gy0 + rng.uniform(-1e3, 1e3, n)
        ax, ay, bx, by = ax * 1e-3, ay * 1e-3, bx * 1e-3, by * 1e-3
    elif kind in ("edge", "band_edge"):
        # |qx| on the threshold at a pixel centre of the tile: 2 (the
        # Gaussian's cutoff) or 2 + wq (the band's outer edge, wq = line_px*|A|)
        px = gx0 + rng.integers(0, 32, n) + 0.5
        py = gy0 + rng.integers(0, 32, n) + 0.5
        reach = line_px if kind == "band_edge" else 0.0
        dx = px - cx
        dx = np.where(np.abs(dx) < reach + 0.25, np.sign(dx + 0.1) * (reach + 0.25), dx)
        ax = 2.0 / (np.abs(dx) - reach) * rng.choice([-1.0, 1.0], n)
        ay, bx = np.zeros(n), np.zeros(n)
        dy = py - cy
        by = np.where(np.abs(dy) < 0.25, 1.0, 1.5 / np.where(dy == 0, 1.0, dy))
        op = np.ones(n)
    elif kind == "nonfinite":
        rows = np.stack([cx, cy, ax, ay, bx, by, viewz])
        which = rng.integers(0, 7, n)
        rows[which, np.arange(n)] = rng.choice([np.inf, -np.inf, np.nan], n)
        cx, cy, ax, ay, bx, by, viewz = rows
    elif kind == "nonfinite_color":
        color[rng.integers(0, 3, n), np.arange(n)] = rng.choice([np.inf, -np.inf, np.nan], n)
    geo = np.stack([cx, cy, ax, ay, bx, by]).astype(np.float32)
    return geo, color.astype(np.float32), op.astype(np.float32), viewz.astype(np.float32)


def _tile_depth(rng):
    """(32, 32) scene depth of one tile: values among the splats' view-z,
    one NaN row, some NaN pixels and an off-image block of +inf."""
    d = rng.uniform(0.5, 4.5, (32, 32))
    d[rng.integers(0, 32)] = np.nan
    d[rng.random((32, 32)) < 0.05] = np.nan
    if rng.random() < 0.5:
        d[:, 24:] = np.inf
    return d.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_alpha_fn(mode):
    """The JAX package's per-pair α over one tile's pixels, vmapped over
    pairs: buf (1, 11, n) rows cx cy ax ay bx by r g b op viewz."""

    def one(buf, i, px, py, bgd, line_px):
        return _splat_alpha(buf, 0, i, px, py, MAX_ALPHA, False, True, wireframe=mode == "band",
                            line_px=line_px, bgd=bgd if mode == "depth" else None)[0]

    return jax.jit(jax.vmap(one, in_axes=(None, 0, None, None, None, None)))


def _live_pixels(mode, geo, color, op, viewz, depth, gx0, gy0, line_px):
    """(n, 32, 32) bool: α != 0 by the port's plain α or by the JAX
    package's, at the tile's pixel centres."""
    n = geo.shape[1]
    cfg = gt.RenderConfig(max_alpha=MAX_ALPHA, depth_test=mode == "depth", wireframe=mode == "band",
                          line_px=line_px)
    iota = np.arange(32, dtype=np.float32) + np.float32(0.5)
    px = (np.float32(gx0) + iota)[None, :] * np.ones((32, 1), np.float32)
    py = (np.float32(gy0) + iota)[:, None] * np.ones((1, 32), np.float32)
    t_bgd = None if depth is None else torch.from_numpy(np.broadcast_to(depth, (n, 32, 32)).copy())
    alpha, _, _ = kcomp._pair_alpha(torch.from_numpy(geo), torch.from_numpy(op), torch.from_numpy(viewz),
                                    torch.from_numpy(px)[None].expand(n, 32, 32)[:, :1, :],
                                    torch.from_numpy(py)[None].expand(n, 32, 32)[:, :, :1], t_bgd, cfg,
                                    kcomp.kernel_mode(cfg), torch.tensor(MAX_ALPHA))
    buf = jnp.asarray(np.concatenate([geo, color, op[None], viewz[None]])[None])
    ja = _jax_alpha_fn(mode)(buf, jnp.arange(n), jnp.asarray(px), jnp.asarray(py),
                             jnp.asarray(np.zeros((32, 32), np.float32) if depth is None else depth),
                             jnp.float32(line_px))
    return (alpha != 0.0).numpy() | (np.asarray(ja) != 0.0)


def _warp_of_pixel():
    owner = np.empty((32, 32), np.int64)
    for k, (x0, y0, w, h) in enumerate(kcomp.warp_rects()):
        owner[y0:y0 + h, x0:x0 + w] = k
    return owner


def _warp_any(pixels):
    """(n, 32, 32) bool → (n, 8): any pixel of each warp's rectangle."""
    return np.stack([pixels[:, y0:y0 + h, x0:x0 + w].any(axis=(1, 2)) for x0, y0, w, h in kcomp.warp_rects()],
                    axis=1)


def _fwd_mask(geo, color, viewz, depth, gx0, gy0, cfg):
    n = geo.shape[1]
    zmax = None
    if depth is not None:
        zmax = kcomp.warp_zmax(torch.from_numpy(depth)[None]).expand(n, 8)
    return kcomp.fwd_mask_plain(torch.from_numpy(geo), torch.from_numpy(color), torch.from_numpy(viewz),
                                torch.full((n,), gx0, dtype=torch.int32), torch.full((n,), gy0, dtype=torch.int32),
                                cfg, zmax).numpy()


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(mode=st.sampled_from(("beauty", "depth", "band")), kind=st.sampled_from(KINDS),
       line_px=st.floats(0.0, 6.0), seed=st.integers(0, 2**31 - 1),
       tile=st.tuples(st.integers(0, 200), st.integers(0, 120)))
def test_forward_mask_never_drops_a_live_warp(mode, kind, line_px, seed, tile):
    """Random and adversarial payloads — rotated, near-singular and singular
    bases, tiny and huge scales, far centres, inf/NaN geometry and view-z,
    non-finite colours, |q| on the cutoff or on the band's outer edge at a
    pixel centre, band widths of 0 to 6 pixels, scene depths with NaN and
    +inf — on global tiles anywhere in a strided frame: every warp holding a
    pixel with α != 0 is kept, and every warp of a pair whose colour is not
    finite."""
    rng = np.random.default_rng(seed)
    gx0, gy0 = 32 * tile[0], 32 * tile[1]
    line_px = np.float32(line_px)
    geo, color, op, viewz = _payloads(kind, N_PAIRS, rng, gx0, gy0, float(line_px))
    depth = _tile_depth(rng) if mode == "depth" else None
    live = _live_pixels(mode, geo, color, op, viewz, depth, gx0, gy0, float(line_px))
    cfg = gt.RenderConfig(max_alpha=MAX_ALPHA, depth_test=mode == "depth", wireframe=mode == "band",
                          line_px=float(line_px))
    keep = _fwd_mask(geo, color, viewz, depth, gx0, gy0, cfg)
    dropped_live = _warp_any(live) & ~keep
    assert not dropped_live.any(), (mode, kind, np.argwhere(dropped_live)[:3])
    bad_color = ~np.isfinite(color).all(axis=0)
    assert keep[bad_color].all()
    if kind == "nonfinite" and mode != "depth":  # a NaN or infinite geometry entry keeps every warp
        assert keep[~np.isfinite(geo).all(axis=0)].all()


def _one_pair(cx, cy, ax, ay, bx, by):
    geo = np.array([[cx], [cy], [ax], [ay], [bx], [by]], np.float32)
    return geo, np.full((3, 1), 0.5, np.float32), np.full((1,), 2.0, np.float32)


def test_band_reach_grows_with_the_line_and_keeps_what_it_cannot_bound():
    """Band mode: a splat whose |q| <= 2 square covers 4 x 4 pixels in one
    warp reaches that warp alone with a zero-width line, more warps as the
    band widens, and every warp when the half-width is infinite or NaN (the
    band test is then all on or all off; the mask keeps what it cannot
    bound).  The beauty mode ignores line_px."""
    geo, color, viewz = _one_pair(4.5, 3.5, 1.0, 0.0, 0.0, 1.0)
    kept = {}
    for line_px in ("0", "4", "12", "inf", "nan"):
        cfg = gt.RenderConfig(wireframe=True, line_px=float(line_px))
        kept[line_px] = _fwd_mask(geo, color, viewz, None, 0, 0, cfg)[0]
    assert kept["0"].tolist() == [True] + [False] * 7
    assert kept["0"].sum() < kept["4"].sum() < kept["12"].sum() <= 8
    assert not (kept["0"] & ~kept["4"]).any() and not (kept["4"] & ~kept["12"]).any()
    assert kept["inf"].all() and kept["nan"].all()
    beauty = _fwd_mask(geo, color, viewz, None, 0, 0, gt.RenderConfig(line_px=12.0))[0]
    assert beauty.tolist() == kept["0"].tolist()


def test_depth_kill_drops_only_warps_the_scene_hides():
    """Depth mode: a warp is dropped when the splat's view-z lies behind
    every non-NaN scene depth of its rectangle; a warp whose depths are all
    NaN is dropped too (a NaN kills its pixel), one with a pixel beyond the
    image's edge (+inf) never; a NaN view-z, or a non-finite colour, keeps
    every warp the reach test keeps; with the soft cutoff the kill still
    applies."""
    rects = kcomp.warp_rects()
    depth = np.full((32, 32), 1.0, np.float32)
    x0, y0, w, h = rects[3]
    depth[y0 + 2, x0 + 5] = 5.0  # one pixel behind the splat
    x0, y0, w, h = rects[5]
    depth[y0:y0 + h, x0:x0 + w] = np.nan
    x0, y0, w, h = rects[7]
    depth[y0, x0 + w - 1] = np.inf  # beyond the image's edge
    geo, color, _ = _one_pair(16.0, 16.0, 0.05, 0.0, 0.0, 0.05)  # reaches the whole tile
    cfg = gt.RenderConfig(depth_test=True)
    for viewz, soft, want in ((2.0, False, {3, 7}), (2.0, True, {3, 7}), (0.5, False, set(range(8)) - {5}),
                              (float("nan"), False, set(range(8)))):
        keep = _fwd_mask(geo, color, np.full((1,), viewz, np.float32), depth, 0, 0,
                         dataclasses.replace(cfg, soft_cutoff=soft))[0]
        assert set(np.flatnonzero(keep)) == want, (viewz, soft, keep)
    bad = color.copy()
    bad[1, 0] = np.inf
    assert _fwd_mask(geo, bad, np.full((1,), 2.0, np.float32), depth, 0, 0, cfg)[0].all()


def _scene(case):
    g = torch.Generator().manual_seed(5)
    splats = gt.random_splats(g, 600, extent=0.8, scale_range=(0.02, 0.08), sh_scale=0.1, device="cpu")
    cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], 96, 64, device="cpu")
    cfg = gt.RenderConfig(payload_dtype="packed" if case in ("packed", "strided") else "float32",
                          soft_cutoff=case == "soft_depth", depth_test=case in ("depth", "soft_depth"),
                          transmittance_eps=1e-3, pairs_per_splat=12.0, warn_on_drop=False)
    if case == "wire":
        return wire._wireframe_inputs(splats, cam, cfg, 1.5)[0], None, (0, 0)
    offsets, (w, h) = (0, 0), (96, 64)
    if case == "strided":
        cfg = dataclasses.replace(cfg, row_stride=2, col_stride=2)
        offsets, (w, h) = (1, 0), (64, 32)
    p = project_splats(splats, cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff)
    p = sort_by_depth(quantize_payload(sanitize_projected(p), cfg), 15 if cfg.depth_test else 14)
    b = binning.bin_splats(p, w, h, cfg, row_offset=offsets[0], col_offset=offsets[1], with_tiles=False)
    nty, ntx = binning.tile_grid(w, h, 32, 32)
    bgd = None
    if cfg.payload_dtype == "packed":
        pay = kcomp.pack_payload(p.fields)
    elif cfg.depth_test:
        pay = torch.cat([p.fields[:10], p.fields[14:15]]).contiguous()
        bgd = (2.0 + 1.5 * torch.linspace(0, 1, w)[None, :]) * torch.ones((h, 1))
        bgd[h // 2] = float("nan")
        bgd[:, 40:44] = float("nan")
    else:
        pay = p.fields[:10].clone()
        pay[6:9, ::7] = torch.tensor([float("inf"), float("nan"), -float("inf")])[:, None]
    return (pay, b.pair_splat, b.tile_base, b.tile_phi, b.tile_span, nty, ntx, h, w, cfg), bgd, offsets


def _masked_forward(args, bgd, offsets):
    """The plain forward with every update the mask drops skipped, as a warp
    of the kernel skips it: (image, used, kept (pair, warp) couples)."""
    pay, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, cfg = args
    packed = cfg.payload_dtype == "packed"
    tiles = kcomp._PlainTiles(pay, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, cfg, packed, bgd,
                              offsets)
    row_stride, col_stride, row_off, col_off = kcomp.tile_mapping(cfg, offsets)
    t_ids = torch.arange(nty * ntx)
    gx0 = ((t_ids % ntx) * col_stride + col_off) * 32
    gy0 = ((t_ids // ntx) * row_stride + row_off) * 32
    zmax = None if bgd is None else kcomp.warp_zmax(tiles.bgd)
    owner = torch.from_numpy(_warp_of_pixel())
    acc = torch.zeros((nty * ntx, 3, 32, 32))
    trans = torch.ones((nty * ntx, 32, 32))
    walked = torch.zeros((nty * ntx,), dtype=torch.int32)
    alive = torch.ones((nty * ntx,), dtype=torch.bool)
    nchunks = (tile_span + cfg.chunk - 1) // cfg.chunk
    kept = 0
    for ci in range(int(nchunks.max())):
        active = alive & (nchunks > ci)
        if not bool(active.any()):
            break
        for i in range(cfg.chunk):
            pos = ci * cfg.chunk + i
            valid, alpha, _, _, color = tiles.pair(pos, active)
            f = pay[:, pair_splat[torch.clamp(tiles.base + pos, max=tiles.p_len - 1)].long()]
            geo, cr, cg, cb, _ = kcomp._payload_columns(f, packed)
            keep = kcomp.fwd_mask_plain(geo, torch.stack([cr, cg, cb]), f[10] if cfg.depth_test else None,
                                        gx0, gy0, cfg, zmax)
            kept += int(keep[valid].sum())
            on = keep[:, owner]  # (T, 32, 32)
            acc = torch.where(on[:, None], acc + (alpha * trans)[:, None] * color[:, :, None, None], acc)
            trans = torch.where(on, trans * (1.0 - alpha), trans)
        walked = torch.where(active, ci + 1, walked)
        alive = torch.where(active, trans.amax(dim=(1, 2)) > cfg.transmittance_eps, alive)
    used = torch.minimum(tile_span, walked * cfg.chunk).to(torch.int32)
    image = kcomp._from_tiles(torch.cat([acc, (1.0 - trans)[:, None]], dim=1), nty, ntx, height, width)
    return image, used, kept


@pytest.mark.parametrize("case", ["packed", "float32_nonfinite_colors", "depth", "soft_depth", "wire", "strided"])
def test_skipping_what_the_mask_drops_is_exact(case):
    """On whole scenes — packed, float32 with inf/NaN colours, the depth
    test with NaN scene rows and columns (hard and soft), the wireframe
    band, the strided/offset mapping of a strip (warp rectangles at the
    global pixel centres) — the plain forward that skips every update the
    mask drops gives the plain forward's image and stop counters bit for
    bit, and keeps walked_pair_counts' kept_warps couples, fewer than all."""
    args, bgd, offsets = _scene(case)
    image, used = kcomp.composite_splats_plain(*args, bg_depth=bgd, offsets=offsets)
    m_image, m_used, kept = _masked_forward(args, bgd, offsets)
    assert torch.equal(m_image.view(torch.int32), image.view(torch.int32)) and torch.equal(m_used, used)
    pay, pair_splat, tile_base, tile_phi, _, nty, ntx, _, _, cfg = args
    counts = kcomp.walked_pair_counts(pay, pair_splat, tile_base, tile_phi, used, nty, ntx, cfg, bgd, offsets,
                                      batch=41)
    assert counts["pairs"] > 0 and counts["kept_warps"] == kept
    assert counts["live_warps"] <= kept < 8 * counts["pairs"]
    if case == "float32_nonfinite_colors":
        assert not bool(torch.isfinite(image).all())  # the NaNs the mask must keep
    if case in ("depth", "soft_depth"):  # the scene hides warps the reach test keeps
        assert kept < counts["reach_warps"]


def test_audit_instance_is_for_the_card():
    """composite_splats_audit refuses CPU tensors: the plain version skips
    nothing, so there is nothing to audit."""
    args, _, _ = _scene("packed")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kcomp.composite_splats_audit(*args)
