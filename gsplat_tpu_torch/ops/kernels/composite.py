"""Compositing: per-tile front-to-back blend of depth-ordered (tile, splat)
pair segments, its backward, and the differentiable function built on both.

``composite_splats`` replaces the forward half of the TPU kernel
``gsplat_tpu/ops/pallas/composite.py`` (``_fwd_kernel``, reached through
``composite_splats_pallas``) with the hand-written CUDA kernel in
``csrc/composite_fwd.cu``: one block per 32×32 tile, 8 warps each owning an
8×16 rectangle (4 pixels a thread), the tile's segment walked in
``config.chunk`` steps with a block-wide vote for the early stop.  A warp
skips every pair whose update would add exact zeros to its rectangle (the
forward's mask: the reach test, the band's reach in wireframe mode, the
scene in front in depth mode; never a pair with a non-finite colour;
:func:`reach_mask_plain` its plain twin), so the image does not change;
:func:`composite_splats_audit` runs the instance that checks that on the
card.  The payload gather is part of the function — the kernel and the plain
version read ``fields[:, pair_splat[j]]`` themselves — so the ``(rows,
P_pad)`` pair payload the TPU path materialises never exists here.  With
``checkpoint=True`` the kernel also writes every pixel's transmittance at the
top of each chunk it walks (``fwd_chk_call`` of the JAX package).

``composite_bwd`` replaces ``_bwd_kernel`` with ``csrc/composite_bwd.cu``: per
tile a reverse walk of the chunks the forward walked, α recomputed by the
forward's own operations, T replayed from the checkpoints, and per pair the
nine raw moment sums over the tile's 1024 pixels written into the tile's own
region of the gradient address space (``binning.grad_base``).  With the hard
cutoff a warp skips every pair whose |q| ≤ 2 region cannot reach its
rectangle of 128 pixels (the reach test, :func:`reach_mask_plain` its plain
twin); the skipped warps add exact zeros, so the sums do not change.
:func:`composite_bwd_audit` runs the instance that checks that on the card.

``CompositeSplats`` (``composite_splats_diff``) is the counterpart of the
custom VJP ``composite_splats_pallas``: checkpointed forward; backward kernel
→ segment sum (``ops/kernels/segsum.py``) → the per-splat quad-basis combine.

What bounds the two kernels: operations.  A walked pair costs up to 1024
pixel updates of about 30 float operations and one ``expf`` (twice that in
the backward, which replays a chunk before it walks it back, plus nine sums
reduced over the tile) against 32–40 bytes of payload; the inputs need only
the updates with α ≠ 0 (:func:`live_pixel_updates`, what ``utils/sol.py``
prices).  Both sources are compiled without FMA contraction so that α agrees
with the plain versions — and between the two kernels — across the two hard
thresholds (see the source notes); the backward's walk back contracts with
explicit ``__fmaf_rn``.

Modes, as in the TPU kernel: ``config.depth_test`` (an 11th payload row, the
splat's view-z, tested per pixel against the caller's (H, W) scene depth
``bg_depth``; forward and backward) and ``config.wireframe`` (an opaque band
on the quad's edge in place of the Gaussian; forward only).  And the
strided/offset tile mapping of the sharded renderer: ``config.row_stride`` /
``config.col_stride`` and ``offsets=(row_offset, col_offset)``, in tiles —
local tile (ty, tx) of the strip image is global tile (row_offset +
ty·row_stride, col_offset + tx·col_stride), pixel centres come from the
global tile and everything written stays local (kernels and plain versions
alike).  The depth test takes only the full-frame mapping (the sharded
renderer passes no scene depth, as in the JAX package).

Also here, as torch ops: ``pack2`` / ``unpack2`` and ``pack_payload`` (the
8-row int32 payload of ``payload_dtype="packed"``).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.config import RenderConfig
from ..covariance import ALPHA_CUTOFF, QUAD_EXTENT
from ..rasterize_ref import round_bf16
from . import _build

TILE = 32          # the kernel's pixel tile is TILE×TILE
P_ROWS = 10        # payload rows: cx cy ax ay bx by r g b op
P_ROWS_DEPTH = 11  # the same and the view-z row of the depth test
P_ROWS_PACKED = 8  # packed payload rows: [cx cy ax ay bx by (r,g) (b,op)]
N_SUMS = 9         # gradient-space rows, the raw moment sums of one pair over
                   # its tile's pixels: Σdp2·dx, Σdp2·dy, Σdp2·dx², Σdp2·dxdy,
                   # Σdp2·dy², Σdc_r·w, Σdc_g·w, Σdc_b·w, Σdp2
G_ROWS_PACKED = 8  # packed gradient-space rows (int32): the first six sums
                   # bit-cast, (Σdc_g·w, Σdc_b·w) as two bf16 halves, Σdp2

# Wrapper calls that launched the forward kernel (any variant), those of them
# that wrote checkpoints, that ran the depth test, that ran the wireframe band
# test and that took a strided/offset tile mapping; calls that launched the
# backward kernel, and those of them with the depth test and with a
# strided/offset mapping.
launches = 0
launches_checkpoint = 0
launches_depth = 0
launches_wire = 0
launches_strided = 0
launches_bwd = 0
launches_bwd_depth = 0
launches_bwd_strided = 0

# The forward kernel's modes (csrc/composite_fwd.cu).
MODE_BEAUTY, MODE_DEPTH, MODE_WIRE = 0, 1, 2

_lib_fwd = None
_lib_bwd = None


def _library():
    global _lib_fwd
    if _lib_fwd is None:
        lib = _build.load("composite_fwd")
        p = ctypes.c_void_p
        lib.gsplat_composite_fwd.argtypes = [
            p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, p, ctypes.c_float,
            p, p, p, p, p, p, p, p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p,
        ]
        lib.gsplat_composite_fwd.restype = ctypes.c_int
        _lib_fwd = lib
    return _lib_fwd


def _library_bwd():
    global _lib_bwd
    if _lib_bwd is None:
        lib = _build.load("composite_bwd")
        p = ctypes.c_void_p
        lib.gsplat_composite_bwd.argtypes = [
            p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, p,
            p, p, p, p, p, p, p, p, p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            p, p, p,
        ]
        lib.gsplat_composite_bwd.restype = ctypes.c_int
        _lib_bwd = lib
    return _lib_bwd


def pack2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Bit-pack two f32 tensors, bf16-ROUNDING each (idempotent on already
    rounded values): ``hi``'s top 16 bits (its bf16 encoding) in the high
    half, ``lo``'s in the low half.  Returns int32; exact round-trip with
    :func:`unpack2`."""
    hb = round_bf16(hi).contiguous().view(torch.int32)
    lb = round_bf16(lo).contiguous().view(torch.int32)
    return hb | ((lb >> 16) & 0xFFFF)


def unpack2(bits: torch.Tensor):
    """Inverse of :func:`pack2`: one int32 tensor → (hi, lo) f32 tensors."""
    hi = (bits & -65536).view(torch.float32)
    lo = (bits << 16).view(torch.float32)
    return hi, lo


def pack_payload(fields: torch.Tensor) -> torch.Tensor:
    """(≥10, N) f32 projected fields → (8, N) int32 packed payload: rows 0..5
    (center, quad basis) bit-cast, rows 6..9 packed pairwise as (r,g), (b,op).
    Built once per frame."""
    return torch.cat(
        [
            fields[0:6].contiguous().view(torch.int32),
            pack2(fields[6:7], fields[7:8]),
            pack2(fields[8:9], fields[9:10]),
        ],
        dim=0,
    )


def max_chunks(config: RenderConfig) -> int:
    """Chunks a tile can walk: φ can push a capacity-capped tile's span into
    one extra chunk.  Sizes the checkpoint tensor statically."""
    return config.tile_capacity // config.chunk + 1


def kernel_mode(config: RenderConfig) -> int:
    """The forward kernel's mode for ``config``: the wireframe band test wins
    over the depth test, as in the TPU kernel (whose band test skips it)."""
    if config.wireframe:
        return MODE_WIRE
    return MODE_DEPTH if config.depth_test else MODE_BEAUTY


def tile_mapping(config: RenderConfig, offsets) -> tuple:
    """``(row_stride, col_stride, row_offset, col_offset)`` of the strided
    tile mapping, checked.  ``offsets`` is ``(row_offset, col_offset)`` in
    tiles."""
    row_off, col_off = (int(o) for o in offsets)
    if row_off < 0 or col_off < 0:
        raise ValueError(f"tile offsets must be >= 0, got {offsets}")
    mapping = (config.row_stride, config.col_stride, row_off, col_off)
    if config.depth_test and mapping != (1, 1, 0, 0):
        raise ValueError(
            "the depth test takes the full-frame tile mapping only (strides 1, offsets 0): "
            "its scene depth is the local image's"
        )
    return mapping


def _check(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config,
           bg_depth=None, offsets=(0, 0)):
    if config.tile_h != TILE or config.tile_w != TILE:
        raise ValueError("the compositing kernel requires tile_h == tile_w == 32")
    tile_mapping(config, offsets)
    packed = config.payload_dtype == "packed"
    if config.depth_test:
        if bg_depth is None:
            raise ValueError("config.depth_test requires bg_depth, the (H, W) scene depth")
        if bg_depth.dtype != torch.float32 or tuple(bg_depth.shape) != (height, width):
            raise TypeError(
                f"bg_depth: expected ({height}, {width}) float32, got {tuple(bg_depth.shape)} {bg_depth.dtype}"
            )
        if bg_depth.device != fields.device:
            raise ValueError("all compositor inputs must live on one device")
    elif bg_depth is not None:
        raise ValueError("bg_depth given without config.depth_test")
    if packed:
        rows, dt = P_ROWS_PACKED, torch.int32
    else:
        rows, dt = (P_ROWS_DEPTH if config.depth_test else P_ROWS), torch.float32
    if fields.dim() != 2 or fields.shape[0] != rows or fields.dtype != dt:
        raise TypeError(
            f"payload_dtype={config.payload_dtype!r} takes a ({rows}, N) {dt} matrix, "
            f"got {tuple(fields.shape)} {fields.dtype}"
        )
    num_tiles = nty * ntx
    if nty != -(-height // TILE) or ntx != -(-width // TILE):
        raise ValueError(f"tile grid ({nty}, {ntx}) does not cover a {height}x{width} image")
    for name, a in (("tile_base", tile_base), ("tile_phi", tile_phi), ("tile_span", tile_span)):
        if a.dtype != torch.int32 or tuple(a.shape) != (num_tiles,):
            raise TypeError(f"{name}: expected ({num_tiles},) int32, got {tuple(a.shape)} {a.dtype}")
    if pair_splat.dtype != torch.int32 or pair_splat.dim() != 1:
        raise TypeError("pair_splat: expected a 1-D int32 tensor")
    for a in (pair_splat, tile_base, tile_phi, tile_span):
        if a.device != fields.device:
            raise ValueError("all compositor inputs must live on one device")
    return packed


def _check_forward_only(config, backward):
    if config.wireframe and backward:
        raise ValueError("wireframe mode is forward-only (the band test has no useful gradient)")


def _check_columns(fields, pair_splat):
    """CPU path only: padding entries are in range by construction (binning
    spreads them over real columns); checked where it costs no device
    synchronisation."""
    if pair_splat.numel() > 0 and fields.shape[1] > 0:
        if int(pair_splat.min()) < 0 or int(pair_splat.max()) >= fields.shape[1]:
            raise ValueError("pair_splat holds an out-of-range column")


def _require_contiguous(**tensors):
    for name, a in tensors.items():
        if a is not None and not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class _PlainTiles:
    """What the plain forward and backward share: pixel centres of every
    tile and one pair position's α over them, by the same separately rounded
    operations in the same order."""

    def __init__(self, fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, config, packed,
                 bg_depth=None, offsets=(0, 0)):
        dev = fields.device
        f32 = torch.float32
        self.fields, self.pair_splat, self.packed, self.config = fields, pair_splat, packed, config
        self.phi, self.span = tile_phi, tile_span
        self.base = tile_base.long()
        self.p_len = pair_splat.shape[0]
        row_stride, col_stride, row_off, col_off = tile_mapping(config, offsets)
        tile_ids = torch.arange(nty * ntx, dtype=torch.int32, device=dev)
        # the global tile's first pixel, an integer first (rasterize_tiles.py)
        origin_x = (((tile_ids % ntx) * col_stride + col_off) * TILE).to(f32)
        origin_y = ((torch.div(tile_ids, ntx, rounding_mode="floor") * row_stride + row_off) * TILE).to(f32)
        iota = torch.arange(TILE, dtype=f32, device=dev) + 0.5
        self.px = origin_x[:, None, None] + iota[None, None, :]  # (T, 1, 32)
        self.py = origin_y[:, None, None] + iota[None, :, None]  # (T, 32, 1)
        self.max_alpha = torch.full((), config.max_alpha, dtype=f32, device=dev)
        self.mode = kernel_mode(config)
        # (T, 32, 32) scene depth, +inf beyond the image's edge
        self.bgd = None if bg_depth is None else _depth_tiles(bg_depth, nty, ntx)

    def pair(self, pos, active):
        """Position ``pos`` of every tile's segment: ``(valid, alpha, dx, dy,
        color)`` — (T,) bool, (T, 32, 32) f32 ×3 (dx, dy broadcastable) and
        the (T, 3) colours."""
        valid = active & (self.phi <= pos) & (self.span > pos)
        idx = self.pair_splat[torch.clamp(self.base + pos, max=self.p_len - 1)].long()
        f = self.fields[:, idx]  # (rows, T)
        geo, cr, cg, cb, op_raw = _payload_columns(f, self.packed)
        op = torch.where(valid, op_raw, 0.0)
        viewz = f[10] if self.mode == MODE_DEPTH else None
        alpha, dx, dy = _pair_alpha(geo, op, viewz, self.px, self.py, self.bgd, self.config, self.mode,
                                    self.max_alpha)
        return valid, alpha, dx, dy, torch.stack([cr, cg, cb], dim=1)


def _payload_columns(f, packed):
    """(rows, B) payload columns → the (6, B) float32 geometry rows and the
    colour and opacity rows (B,) each."""
    if packed:
        cr, cg = unpack2(f[6])
        cb, op = unpack2(f[7])
        return f[0:6].view(torch.float32), cr, cg, cb, op
    return f[0:6], f[6], f[7], f[8], f[9]


def _pair_alpha(geo, op, viewz, px, py, bgd, config, mode, max_alpha):
    """α of B pairs over the pixel centres ``px`` (B, 1, 32) × ``py`` (B, 32,
    1) by the kernels' separately rounded operations, and dx, dy; ``bgd``
    the (B, 32, 32) scene depth in depth mode.  In wireframe mode the band
    test's 0/1 coverage."""
    col = _col
    dx = px - col(geo[0])
    dy = py - col(geo[1])
    qx = dx * col(geo[2]) + dy * col(geo[3])
    qy = dx * col(geo[4]) + dy * col(geo[5])
    if mode == MODE_WIRE:
        wq1, wq2 = _band_half_widths(geo, config.line_px)
        aqx, aqy = torch.abs(qx), torch.abs(qy)
        m = torch.maximum(aqx, aqy)
        wq = torch.where(aqx > aqy, col(wq1), col(wq2))
        on_edge = (torch.abs(m - QUAD_EXTENT) <= wq) & (col(op) > 0.0)
        return on_edge.to(torch.float32), dx, dy
    qx2 = qx * qx
    qy2 = qy * qy
    power = qx2 + qy2
    alpha = torch.minimum(torch.exp(-power) * col(op), max_alpha)
    if not config.soft_cutoff:
        inside = torch.maximum(qx2, qy2) <= QUAD_EXTENT * QUAD_EXTENT
        alpha = torch.where(inside & (alpha >= ALPHA_CUTOFF), alpha, 0.0)
    if mode == MODE_DEPTH:
        alpha = torch.where(col(viewz) <= bgd, alpha, 0.0)
    return alpha, dx, dy


# The compositing kernels' warps, each a rectangle of WARP_W x WARP_H pixels
# of the tile, numbered row by row (csrc/composite_common.cuh).
WARPS, WARP_W, WARP_H = 8, 16, 8
# The reach test's limit on |q| outside band mode: 2 and 1e-4 (QUAD_REACH).
QUAD_REACH = 2.0001


def warp_rects():
    """The compositing kernels' warp rectangles: ``(x0, y0, w, h)`` in the
    tile for warps 0..7."""
    per_row = TILE // WARP_W
    return [((k % per_row) * WARP_W, (k // per_row) * WARP_H, WARP_W, WARP_H) for k in range(WARPS)]


def reach_mask_plain(geo: torch.Tensor, gx0: torch.Tensor, gy0: torch.Tensor, line_px=None) -> torch.Tensor:
    """Plain version of the kernels' reach test (``csrc/composite_common.cuh``
    ``reach_bits``), by the same separately rounded float32 operations: for B
    pairs with (6, B) geometry rows ``cx cy ax ay bx by`` in tiles whose first
    pixel is at global (``gx0``, ``gy0``) (B,), the (B, 8) mask of the warps
    whose pixel rectangle the pair can reach with the hard cutoff.  A warp
    left out holds no pixel with α ≠ 0; a pair with an infinite or NaN entry
    keeps every warp.  This is the backward's mask.  ``line_px``, the band
    test's half-width in pixels, widens the limit on |q| from 2 to 2 +
    max(wq1, wq2) (wireframe mode, forward only: its α = 1 needs
    |max(|qx|, |qy|) − 2| ≤ wq).  :func:`fwd_mask_plain` adds the forward's
    other rules."""
    f32 = torch.float32
    cx, cy, ax, ay, bx, by = (r[:, None] for r in geo)
    rects = warp_rects()
    x0 = torch.tensor([r[0] for r in rects], dtype=torch.int32, device=geo.device)
    y0 = torch.tensor([r[1] for r in rects], dtype=torch.int32, device=geo.device)
    w, h = float(rects[0][2]), float(rects[0][3])
    xc = (gx0[:, None] + x0[None, :]).to(f32) + 0.5 * w
    yc = (gy0[:, None] + y0[None, :]).to(f32) + 0.5 * h
    hw, hh = 0.5 * (w - 1.0), 0.5 * (h - 1.0)
    dxc = xc - cx
    dyc = yc - cy
    qx = dxc * ax + dyc * ay
    qy = dxc * bx + dyc * by
    aax, aay, abx, aby = ax.abs(), ay.abs(), bx.abs(), by.abs()
    hx = aax * hw + aay * hh
    hy = abx * hw + aby * hh
    sx = aax * (dxc.abs() + hw) + aay * (dyc.abs() + hh)
    sy = abx * (dxc.abs() + hw) + aby * (dyc.abs() + hh)
    extent = QUAD_REACH
    if line_px is not None:
        wq1, wq2 = _band_half_widths(geo, line_px)
        extent = (QUAD_REACH + torch.fmax(wq1, wq2))[:, None]
    lx = extent + hx + 1e-5 * (sx + hx)
    ly = extent + hy + 1e-5 * (sy + hy)
    finite = torch.isfinite(geo).all(dim=0)[:, None]
    return finite.logical_not() | ~((qx.abs() > lx) | (qy.abs() > ly))


def _band_half_widths(geo, line_px):
    """The band test's half-widths in quad units, (B,) each: line_px·|A| and
    line_px·|B| by the kernels' operations."""
    return (line_px * torch.sqrt(geo[2] * geo[2] + geo[3] * geo[3]),
            line_px * torch.sqrt(geo[4] * geo[4] + geo[5] * geo[5]))


def warp_zmax(bgd_tiles: torch.Tensor) -> torch.Tensor:
    """(T, 32, 32) scene depth → (T, 8): each warp rectangle's largest
    non-NaN depth (−inf where all are NaN), as the forward computes it."""
    d = torch.where(torch.isnan(bgd_tiles), float("-inf"), bgd_tiles)
    return torch.stack([d[:, y0:y0 + h, x0:x0 + w].amax(dim=(1, 2)) for x0, y0, w, h in warp_rects()], dim=1)


def fwd_mask_plain(geo, color, viewz, gx0, gy0, config, zmax=None) -> torch.Tensor:
    """The forward kernel's (B, 8) warp mask (``fwd_reach_bits`` in
    ``csrc/composite_fwd.cu``) for B pairs with (6, B) geometry rows, (3, B)
    colour rows and (B,) view-z: the reach test with the mode's limit (every
    warp with the soft cutoff), in depth mode less the warps whose largest
    scene depth ``zmax`` (B, 8, :func:`warp_zmax`) lies in front of the
    splat's view-z; every warp for a pair with a non-finite colour, whose
    skipped update would add 0·inf = NaN."""
    mode = kernel_mode(config)
    if config.soft_cutoff and mode != MODE_WIRE:
        keep = torch.ones((geo.shape[1], WARPS), dtype=torch.bool, device=geo.device)
    else:
        keep = reach_mask_plain(geo, gx0, gy0, config.line_px if mode == MODE_WIRE else None)
    if mode == MODE_DEPTH:
        keep = keep & ~(viewz[:, None] > zmax)
    return keep | ~torch.isfinite(color).all(dim=0)[:, None]


def walked_pair_counts(fields, pair_splat, tile_base, tile_phi, used, nty, ntx, config, bg_depth=None,
                       offsets=(0, 0), batch=16384) -> dict:
    """What the compositors' inputs need, counted over the walked pairs of a
    frame (positions ``[phi, used)`` of every tile), by the plain α:
    ``pairs``; ``live_pixel_updates``, the (pair, pixel) updates with α ≠ 0
    (the band test in wireframe mode, the depth test with
    ``config.depth_test``, every pixel with the soft cutoff, which has no
    hard zero); ``live_warps``, the (pair, warp) couples with a pixel α ≠ 0
    in the warp's rectangle; ``reach_warps``, those the reach test keeps
    (:func:`reach_mask_plain`: the backward's mask; in wireframe mode the
    band's wider limit, which only the forward runs; all eight with the soft
    cutoff, which has none); ``kept_warps``, those the forward's mask keeps
    (:func:`fwd_mask_plain`: in depth mode also less the warps the scene
    hides).  Runs in batches of ``batch`` pairs on the inputs' device."""
    packed = config.payload_dtype == "packed"
    mode = kernel_mode(config)
    dev = fields.device
    row_stride, col_stride, row_off, col_off = tile_mapping(config, offsets)
    counts = torch.clamp(used - tile_phi, min=0).long()
    total = int(counts.sum())
    out = {"pairs": total, "live_pixel_updates": 0, "live_warps": 0, "reach_warps": 0, "kept_warps": 0}
    if total == 0:
        return out
    tile_of = torch.repeat_interleave(torch.arange(nty * ntx, device=dev), counts)
    start = torch.cumsum(counts, 0) - counts
    pos = tile_phi.long()[tile_of] + torch.arange(total, device=dev) - start[tile_of]
    cols = pair_splat[tile_base.long()[tile_of] + pos].long()
    bgd = None if bg_depth is None else _depth_tiles(bg_depth, nty, ntx)
    zmax = None if bgd is None else warp_zmax(bgd)
    max_alpha = torch.full((), config.max_alpha, dtype=torch.float32, device=dev)
    iota = torch.arange(TILE, dtype=torch.float32, device=dev) + 0.5
    # (8, 32, 32): the warp each pixel of a tile lies in
    owner = torch.empty((TILE, TILE), dtype=torch.long, device=dev)
    for k, (x0, y0, w, h) in enumerate(warp_rects()):
        owner[y0:y0 + h, x0:x0 + w] = k
    in_warp = owner[None] == torch.arange(WARPS, device=dev)[:, None, None]
    for b0 in range(0, total, batch):
        t = tile_of[b0:b0 + batch]
        f = fields[:, cols[b0:b0 + batch]]
        geo, cr, cg, cb, op = _payload_columns(f, packed)
        gx0 = ((t % ntx) * col_stride + col_off) * TILE
        gy0 = (torch.div(t, ntx, rounding_mode="floor") * row_stride + row_off) * TILE
        px = gx0.to(torch.float32)[:, None, None] + iota[None, None, :]
        py = gy0.to(torch.float32)[:, None, None] + iota[None, :, None]
        viewz = f[10] if mode == MODE_DEPTH else None
        alpha, _, _ = _pair_alpha(geo, op, viewz, px, py, None if bgd is None else bgd[t], config, mode, max_alpha)
        live = alpha != 0.0
        if config.soft_cutoff and mode != MODE_WIRE:
            out["live_pixel_updates"] += live.shape[0] * TILE * TILE
        else:
            out["live_pixel_updates"] += int(live.sum())
        if config.soft_cutoff and mode != MODE_WIRE:  # no reach test: every warp
            out["reach_warps"] += live.shape[0] * WARPS
        else:
            out["reach_warps"] += int(reach_mask_plain(
                geo, gx0, gy0, config.line_px if mode == MODE_WIRE else None).sum())
        out["kept_warps"] += int(fwd_mask_plain(geo, torch.stack([cr, cg, cb]), viewz, gx0, gy0, config,
                                                None if zmax is None else zmax[t]).sum())
        out["live_warps"] += int((live[:, None] & in_warp[None]).any(dim=(2, 3)).sum())
    return out


def live_pixel_updates(fields, pair_splat, tile_base, tile_phi, used, nty, ntx, config, bg_depth=None,
                       offsets=(0, 0)) -> int:
    """The (pair, pixel) updates with α ≠ 0 over the walked pairs of a frame
    (:func:`walked_pair_counts`): the work a compositor's inputs need, which
    the bounds of ``utils/sol.py`` price."""
    return walked_pair_counts(fields, pair_splat, tile_base, tile_phi, used, nty, ntx, config, bg_depth,
                              offsets)["live_pixel_updates"]


def _col(v):
    return v[:, None, None]


def _to_tiles(image, nty, ntx):
    """(H, W, C) → (T, C, 32, 32), zero beyond the image's edge."""
    h, w, c = image.shape
    full = image.new_zeros((nty * TILE, ntx * TILE, c))
    full[:h, :w] = image
    return full.reshape(nty, TILE, ntx, TILE, c).permute(0, 2, 4, 1, 3).reshape(nty * ntx, c, TILE, TILE)


def _depth_tiles(bg_depth, nty, ntx):
    """(H, W) scene depth → (T, 32, 32), +inf beyond the image's edge."""
    h, w = bg_depth.shape
    full = bg_depth.new_full((nty * TILE, ntx * TILE), float("inf"))
    full[:h, :w] = bg_depth
    return full.reshape(nty, TILE, ntx, TILE).permute(0, 2, 1, 3).reshape(nty * ntx, TILE, TILE)


def _from_tiles(tiles, nty, ntx, height, width):
    """(T, C, 32, 32) → (H, W, C)."""
    c = tiles.shape[1]
    image = tiles.reshape(nty, ntx, c, TILE, TILE).permute(0, 3, 1, 4, 2).reshape(nty * TILE, ntx * TILE, c)
    return image[:height, :width].contiguous()


def composite_splats_plain(
    fields: torch.Tensor,
    pair_splat: torch.Tensor,
    tile_base: torch.Tensor,
    tile_phi: torch.Tensor,
    tile_span: torch.Tensor,
    nty: int,
    ntx: int,
    height: int,
    width: int,
    config: RenderConfig,
    checkpoint: bool = False,
    bg_depth: torch.Tensor = None,
    offsets=(0, 0),
):
    """Plain PyTorch version of the compositing forward: a loop over chunk
    steps and, inside, over pair positions, vectorised over tiles and pixels,
    with the same base-aligned stop rule and the same modes.  Returns
    ``(image, used)``: (H, W, 4) float32 premultiplied RGBA and the (T,) int32
    stop counter; with
    ``checkpoint=True`` also the ``(T, max_chunks, 1024)`` transmittance at
    the top of every chunk a tile walked (zeros elsewhere), pixels row-major
    within the tile.

    The loop bounds are read to the host (one read for the chunk count, one
    per chunk for "any tile still walking")."""
    packed = _check(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config,
                    bg_depth, offsets)
    _check_forward_only(config, checkpoint)
    dev = fields.device
    f32 = torch.float32
    num_tiles = nty * ntx
    chunk = config.chunk
    tiles = _PlainTiles(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, config, packed,
                        bg_depth, offsets)

    acc = torch.zeros((num_tiles, 3, TILE, TILE), dtype=f32, device=dev)
    trans = torch.ones((num_tiles, TILE, TILE), dtype=f32, device=dev)
    walked = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
    alive = torch.ones((num_tiles,), dtype=torch.bool, device=dev)
    nchunks = torch.div(tile_span + (chunk - 1), chunk, rounding_mode="floor")
    n_steps = int(nchunks.max()) if num_tiles > 0 else 0
    tchk = None
    if checkpoint:
        tchk = torch.zeros((num_tiles, max_chunks(config), TILE * TILE), dtype=f32, device=dev)

    for ci in range(n_steps):
        active = alive & (nchunks > ci)
        if not bool(active.any()):
            break
        if checkpoint:
            tchk[:, ci] = torch.where(active[:, None], trans.reshape(num_tiles, -1), 0.0)
        for i in range(chunk):
            _, alpha, _, _, color = tiles.pair(ci * chunk + i, active)
            w = alpha * trans
            acc = acc + w[:, None] * color[:, :, None, None]
            trans = trans * (1.0 - alpha)
        walked = torch.where(active, ci + 1, walked)
        still = trans.amax(dim=(1, 2)) > config.transmittance_eps
        alive = torch.where(active, still, alive)

    used = torch.minimum(tile_span, walked * chunk).to(torch.int32)
    image = _from_tiles(torch.cat([acc, (1.0 - trans)[:, None]], dim=1), nty, ntx, height, width)
    if checkpoint:
        return image, used, tchk
    return image, used


def composite_splats(
    fields: torch.Tensor,
    pair_splat: torch.Tensor,
    tile_base: torch.Tensor,
    tile_phi: torch.Tensor,
    tile_span: torch.Tensor,
    nty: int,
    ntx: int,
    height: int,
    width: int,
    config: RenderConfig,
    checkpoint: bool = False,
    bg_depth: torch.Tensor = None,
    offsets=(0, 0),
):
    """Composite every tile's pair segment front to back.

    Args:
      fields: per-splat payload matrix in the order ``pair_splat`` indexes —
        ``(10, N)`` float32 rows ``cx cy ax ay bx by r g b op``, or for
        ``payload_dtype="packed"`` the ``(8, N)`` int32 matrix of
        :func:`pack_payload`; with ``config.depth_test`` ``(11, N)`` float32,
        row 10 the splats' view-z.
      pair_splat: ``(P_pad,)`` int32 — tile-sorted pair → payload column.
      tile_base / tile_phi / tile_span: ``(T,)`` int32 segment descriptors
        (``ops/binning.py``): positions ``[phi, span)`` counted from ``base``
        are the tile's own pairs.
      nty, ntx, height, width: tile grid and image size.
      config: ``chunk``, ``max_alpha``, ``transmittance_eps``, ``soft_cutoff``
        (not read by the wireframe band test), ``payload_dtype``,
        ``depth_test``, ``wireframe`` and ``line_px``.
      checkpoint: also return the transmittance checkpoints the backward
        replays from (not in wireframe mode, which is forward-only).
      bg_depth: with ``config.depth_test``, the (H, W) float32 view-space
        scene depth; a splat's contribution to a pixel is killed unless its
        view-z is ``<=`` the pixel's depth.  Ignored by the wireframe band
        test.
      offsets: ``(row_offset, col_offset)`` in tiles; with
        ``config.row_stride`` / ``col_stride`` the strided tile mapping of a
        strip: the (height, width) image is the strip's, local tile (ty, tx)
        the frame's tile (row_offset + ty·row_stride, col_offset +
        tx·col_stride), whose pixel centres every α is taken at.

    Returns:
      ``(image, used)``: (H, W, 4) float32 premultiplied RGBA (alpha = 1 − T)
      and the (T,) int32 stop counter ``min(span, chunks_walked·chunk)``; with
      ``checkpoint=True`` also ``tchk``, ``(T, max_chunks, 1024)`` float32 —
      every pixel's T at the top of chunk ``ci`` for ``ci < ceil(used/chunk)``
      (pixels row-major within the tile; entries of chunks never walked are
      unspecified).  Image and ``used`` do not depend on ``checkpoint``.

    On CUDA tensors this launches the kernel (or raises); on CPU tensors it
    takes :func:`composite_splats_plain`.
    """
    packed = _check(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config,
                    bg_depth, offsets)
    _check_forward_only(config, checkpoint)
    if not fields.is_cuda:
        _check_columns(fields, pair_splat)
        return composite_splats_plain(
            fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config,
            checkpoint=checkpoint, bg_depth=bg_depth, offsets=offsets,
        )
    image, used, tchk, _ = _composite_fwd_cuda(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx,
                                               height, width, config, checkpoint, bg_depth, offsets, packed)
    if checkpoint:
        return image, used, tchk
    return image, used


def composite_splats_audit(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config,
                           bg_depth=None, offsets=(0, 0)):
    """The forward kernel's audit instance, for the checks (CUDA tensors):
    :func:`composite_splats`'s ``(image, used)``, the number of pixels with
    α ≠ 0 in the warps its mask skipped, which must be 0, and the number of
    (pair, warp) couples the mask kept over the pairs walked
    (:func:`walked_pair_counts`' ``kept_warps``).  Counts as a launch of the
    forward like any other."""
    packed = _check(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config,
                    bg_depth, offsets)
    if not fields.is_cuda:
        raise ValueError("the audit instance runs on CUDA tensors only")
    image, used, _, counts = _composite_fwd_cuda(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx,
                                                 height, width, config, False, bg_depth, offsets, packed,
                                                 audit=True)
    skipped, kept = counts.tolist()
    return image, used, skipped, kept


def _composite_fwd_cuda(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config,
                        checkpoint, bg_depth, offsets, packed, audit=False):
    global launches, launches_checkpoint, launches_depth, launches_wire, launches_strided
    mapping = tile_mapping(config, offsets)
    mode = kernel_mode(config)
    depth = bg_depth if mode == MODE_DEPTH else None
    _require_contiguous(fields=fields, pair_splat=pair_splat, tile_base=tile_base,
                        tile_phi=tile_phi, tile_span=tile_span, bg_depth=depth)
    if (P_ROWS_DEPTH + 2) * config.chunk * 4 > 48 * 1024:
        raise ValueError(f"chunk={config.chunk} exceeds the kernel's shared memory")
    dev = fields.device
    num_tiles = nty * ntx
    image = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    used = torch.empty((num_tiles,), dtype=torch.int32, device=dev)
    n_chk = max_chunks(config)
    tchk = None
    if checkpoint:
        tchk = torch.empty((num_tiles, n_chk, TILE * TILE), dtype=torch.float32, device=dev)
    counts = torch.zeros((2,), dtype=torch.int32, device=dev) if audit else None
    # the band test takes no cutoff, hard or soft (JAX's _splat_alpha returns
    # before it reads soft_cutoff), and the kernel has no soft band variant
    soft = config.soft_cutoff and mode != MODE_WIRE
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.gsplat_composite_fwd(
            fields.data_ptr(), fields.shape[1], int(packed), int(soft),
            mode, None if depth is None else depth.data_ptr(), config.line_px,
            pair_splat.data_ptr(), tile_base.data_ptr(), tile_phi.data_ptr(),
            tile_span.data_ptr(), image.data_ptr(), used.data_ptr(),
            tchk.data_ptr() if checkpoint else None, None if counts is None else counts.data_ptr(),
            nty, ntx, height, width, config.chunk, n_chk,
            config.max_alpha, config.transmittance_eps, *mapping,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gsplat_composite_fwd launch failed: CUDA error {err}")
    launches += 1
    launches_strided += int(mapping != (1, 1, 0, 0))
    launches_depth += int(mode == MODE_DEPTH)
    launches_wire += int(mode == MODE_WIRE)
    launches_checkpoint += int(checkpoint)
    return image, used, tchk, counts


def _check_bwd(used, grad_base, d_out, tchk, g_pad, num_tiles, height, width, config, device):
    for name, a in (("used", used), ("grad_base", grad_base)):
        if a.dtype != torch.int32 or tuple(a.shape) != (num_tiles,):
            raise TypeError(f"{name}: expected ({num_tiles},) int32, got {tuple(a.shape)} {a.dtype}")
    if d_out.dtype != torch.float32 or tuple(d_out.shape) != (height, width, 4):
        raise TypeError(f"d_out: expected ({height}, {width}, 4) float32, got {tuple(d_out.shape)} {d_out.dtype}")
    want = (num_tiles, max_chunks(config), TILE * TILE)
    if tchk.dtype != torch.float32 or tuple(tchk.shape) != want:
        raise TypeError(f"tchk: expected {want} float32, got {tuple(tchk.shape)} {tchk.dtype}")
    if g_pad % config.chunk != 0 or g_pad <= 0:
        raise ValueError(f"g_pad={g_pad} must be a positive multiple of chunk")
    for a in (used, grad_base, d_out, tchk):
        if a.device != device:
            raise ValueError("all compositor inputs must live on one device")


def composite_bwd_plain(
    fields: torch.Tensor,
    pair_splat: torch.Tensor,
    tile_base: torch.Tensor,
    tile_phi: torch.Tensor,
    tile_span: torch.Tensor,
    used: torch.Tensor,
    grad_base: torch.Tensor,
    d_out: torch.Tensor,
    tchk: torch.Tensor,
    g_pad: int,
    nty: int,
    ntx: int,
    height: int,
    width: int,
    config: RenderConfig,
    bg_depth: torch.Tensor = None,
    offsets=(0, 0),
) -> torch.Tensor:
    """Plain PyTorch version of the compositing backward, vectorised over
    tiles and pixels: chunks in reverse, each replayed forward from its
    checkpoint (α and T of every position kept for the walk back), then walked
    back with the suffix accumulator ``u``.  Returns the gradient space (see
    :func:`composite_bwd`)."""
    packed = _check(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config,
                    bg_depth, offsets)
    _check_forward_only(config, True)
    num_tiles = nty * ntx
    _check_bwd(used, grad_base, d_out, tchk, g_pad, num_tiles, height, width, config, fields.device)
    dev = fields.device
    f32 = torch.float32
    chunk = config.chunk
    tiles = _PlainTiles(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, config, packed,
                        bg_depth, offsets)

    gspace = torch.zeros((N_SUMS, g_pad), dtype=f32, device=dev)
    d_tiles = _to_tiles(d_out, nty, ntx)  # off-image pixels: exact zeros
    dc_r, dc_g, dc_b = d_tiles[:, 0], d_tiles[:, 1], d_tiles[:, 2]
    u = -d_tiles[:, 3]
    nused = torch.div(used + (chunk - 1), chunk, rounding_mode="floor")
    n_steps = int(nused.max()) if num_tiles > 0 else 0
    gbase = grad_base.long()

    for ci in reversed(range(n_steps)):
        active = nused > ci
        # Forward replay of the chunk, by the forward's own operations.
        t_cur = torch.where(active[:, None], tchk[:, ci], 1.0).reshape(num_tiles, TILE, TILE)
        memo = []
        for i in range(chunk):
            valid, alpha, dx, dy, color = tiles.pair(ci * chunk + i, active)
            memo.append((valid, alpha, t_cur, dx, dy, color))
            t_cur = t_cur * (1.0 - alpha)
        any_valid = torch.stack([m[0].any() for m in memo]).tolist()
        for i in reversed(range(chunk)):
            if not any_valid[i]:
                continue
            valid, alpha, t_i, dx, dy, color = memo[i]
            w_i = alpha * t_i
            k_i = _col(color[:, 0]) * dc_r + _col(color[:, 1]) * dc_g + _col(color[:, 2]) * dc_b
            ku = k_i - u
            d_alpha = t_i * ku
            # The max_alpha clamp and (hard mode) the inside/cutoff mask stop
            # the flow from dα to (power, opacity).
            live = alpha < config.max_alpha
            if not config.soft_cutoff:
                live = live & (alpha > 0.0)
            ga = torch.where(live, d_alpha, 0.0)
            dp2 = -2.0 * ga * alpha
            dp2dx = dp2 * dx
            dp2dy = dp2 * dy
            sums = torch.stack(
                [
                    dp2dx.sum(dim=(1, 2)), dp2dy.sum(dim=(1, 2)),
                    (dp2dx * dx).sum(dim=(1, 2)), (dp2dx * dy).sum(dim=(1, 2)),
                    (dp2dy * dy).sum(dim=(1, 2)),
                    (dc_r * w_i).sum(dim=(1, 2)), (dc_g * w_i).sum(dim=(1, 2)),
                    (dc_b * w_i).sum(dim=(1, 2)),
                    dp2.sum(dim=(1, 2)),
                ]
            )  # (9, T)
            u = u + alpha * ku
            cols = (gbase + (ci * chunk + i))[valid]
            gspace[:, cols] = sums[:, valid]

    if packed:
        return torch.cat(
            [
                gspace[0:6].view(torch.int32),
                pack2(gspace[6:7], gspace[7:8]),
                gspace[8:9].view(torch.int32),
            ],
            dim=0,
        )
    return gspace


def composite_bwd(
    fields: torch.Tensor,
    pair_splat: torch.Tensor,
    tile_base: torch.Tensor,
    tile_phi: torch.Tensor,
    tile_span: torch.Tensor,
    used: torch.Tensor,
    grad_base: torch.Tensor,
    d_out: torch.Tensor,
    tchk: torch.Tensor,
    g_pad: int,
    nty: int,
    ntx: int,
    height: int,
    width: int,
    config: RenderConfig,
    bg_depth: torch.Tensor = None,
    offsets=(0, 0),
) -> torch.Tensor:
    """Backward of :func:`composite_splats` up to the per-pair moment sums.

    Args beyond the forward's: ``used`` and ``tchk`` as the checkpointed
    forward returned them, ``grad_base`` (``ops/binning.py``), the cotangent
    ``d_out`` (H, W, 4) float32 and ``g_pad`` (``binning.grad_pad_size``).
    With ``config.depth_test`` the same ``bg_depth`` as the forward's: killed
    pixels have α = 0 and add exact zeros; with a strided config the same
    ``offsets``.  Wireframe mode has no backward.

    Returns the gradient address space: ``(9, g_pad)`` float32 whose column
    ``grad_base[t] + pos`` holds, for position ``pos`` of tile ``t``'s
    segment, the sums over the tile's 1024 pixels in the row order of
    ``N_SUMS``; for ``payload_dtype="packed"`` the ``(8, g_pad)`` int32 rows
    ``[Σdp2·dx Σdp2·dy Σdp2·dx² Σdp2·dxdy Σdp2·dy² Σdc_r·w (Σdc_g·w, Σdc_b·w)
    Σdp2]`` with the pair in row 6 rounded to bf16 (nearest even) and the rest
    bit-cast.  Positions before ``phi``, from ``used`` on, and every column no
    tile owns hold exact zeros.

    On CUDA tensors this launches the kernel (or raises); on CPU tensors it
    takes :func:`composite_bwd_plain`.
    """
    packed = _check(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config,
                    bg_depth, offsets)
    _check_forward_only(config, True)
    num_tiles = nty * ntx
    _check_bwd(used, grad_base, d_out, tchk, g_pad, num_tiles, height, width, config, fields.device)
    if not fields.is_cuda:
        _check_columns(fields, pair_splat)
        return composite_bwd_plain(
            fields, pair_splat, tile_base, tile_phi, tile_span, used, grad_base, d_out, tchk,
            g_pad, nty, ntx, height, width, config, bg_depth=bg_depth, offsets=offsets,
        )
    return _composite_bwd_cuda(fields, pair_splat, tile_base, tile_phi, tile_span, used, grad_base, d_out,
                               tchk, g_pad, nty, ntx, height, width, config, bg_depth, offsets, packed)[0]


def composite_bwd_audit(fields, pair_splat, tile_base, tile_phi, tile_span, used, grad_base, d_out, tchk,
                        g_pad, nty, ntx, height, width, config, bg_depth=None, offsets=(0, 0)):
    """The backward kernel's audit instance, for the checks (CUDA tensors,
    hard cutoff): :func:`composite_bwd`'s gradient space, and the number of
    pixels with α ≠ 0 in the warps the reach test skipped, which must be 0.
    Counts as a launch of the backward like any other."""
    packed = _check(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config,
                    bg_depth, offsets)
    _check_forward_only(config, True)
    _check_bwd(used, grad_base, d_out, tchk, g_pad, nty * ntx, height, width, config, fields.device)
    if not fields.is_cuda or config.soft_cutoff:
        raise ValueError("the audit instance runs on CUDA tensors with the hard cutoff only")
    gspace, skipped = _composite_bwd_cuda(fields, pair_splat, tile_base, tile_phi, tile_span, used, grad_base,
                                          d_out, tchk, g_pad, nty, ntx, height, width, config, bg_depth, offsets,
                                          packed, audit=True)
    return gspace, int(skipped)


def _composite_bwd_cuda(fields, pair_splat, tile_base, tile_phi, tile_span, used, grad_base, d_out, tchk, g_pad,
                        nty, ntx, height, width, config, bg_depth, offsets, packed, audit=False):
    global launches_bwd, launches_bwd_depth, launches_bwd_strided
    mapping = tile_mapping(config, offsets)
    depth = config.depth_test
    _require_contiguous(fields=fields, pair_splat=pair_splat, tile_base=tile_base, tile_phi=tile_phi,
                        tile_span=tile_span, used=used, grad_base=grad_base, d_out=d_out, tchk=tchk,
                        bg_depth=bg_depth)
    if config.chunk % 8 != 0:
        raise ValueError("the backward kernel walks a chunk in sub-blocks of 8 pairs")
    dev = fields.device
    # Zero-filled once: chunks the forward never walked are never touched.
    rows, dt = (G_ROWS_PACKED, torch.int32) if packed else (N_SUMS, torch.float32)
    gspace = torch.zeros((rows, g_pad), dtype=dt, device=dev)
    # Longest walk first: one sort of the (T,) stop counters.
    order = torch.argsort(used, descending=True).to(torch.int32)
    skipped = torch.zeros((1,), dtype=torch.int32, device=dev) if audit else None
    lib = _library_bwd()
    with torch.cuda.device(dev):
        err = lib.gsplat_composite_bwd(
            fields.data_ptr(), fields.shape[1], int(packed), int(config.soft_cutoff),
            int(depth), bg_depth.data_ptr() if depth else None,
            pair_splat.data_ptr(), tile_base.data_ptr(), tile_phi.data_ptr(), tile_span.data_ptr(),
            used.data_ptr(), grad_base.data_ptr(), d_out.data_ptr(), tchk.data_ptr(),
            gspace.data_ptr(), g_pad,
            nty, ntx, height, width, config.chunk, max_chunks(config),
            config.max_alpha, *mapping, order.data_ptr(), None if skipped is None else skipped.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gsplat_composite_bwd launch failed: CUDA error {err}")
    launches_bwd += 1
    launches_bwd_depth += int(depth)
    launches_bwd_strided += int(mapping != (1, 1, 0, 0))
    return gspace, skipped


class CompositeSplats(torch.autograd.Function):
    """Differentiable payload read + compositing (the counterpart of the JAX
    package's custom VJP ``composite_splats_pallas``).  Gradients flow to
    ``fields`` only: with ``config.depth_test`` its view-z row (row 10) gets
    a zero gradient and ``bg_depth`` a zero cotangent, the test being a hard
    mask.  On CPU tensors the same graph runs through the plain versions of
    the three kernels."""

    @staticmethod
    def forward(ctx, fields, pair_splat, tile_base, tile_phi, tile_span, grad_base,
                dest_of_exp, exp_offsets, exp_counts, order, nty, ntx, height, width, config,
                bg_depth=None, offsets=(0, 0)):
        _check_forward_only(config, True)
        # Packing to int32 happens here, inside the function: an int32 tensor
        # carries no gradient.
        if config.payload_dtype == "packed":
            payload = pack_payload(fields)
        else:
            payload = fields[:P_ROWS_DEPTH if config.depth_test else P_ROWS].contiguous()
        bgd = bg_depth.detach() if bg_depth is not None else None
        image, used, tchk = composite_splats(
            payload, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config,
            checkpoint=True, bg_depth=bgd, offsets=offsets,
        )
        ctx.save_for_backward(fields, payload, pair_splat, tile_base, tile_phi, tile_span, used,
                              grad_base, dest_of_exp, exp_offsets, exp_counts, tchk, bgd)
        ctx.order = order
        ctx.geometry = (nty, ntx, height, width, config, offsets)
        return image

    @staticmethod
    def backward(ctx, g):
        from ..binning import grad_pad_size
        from .segsum import segsum_by_splat

        (fields, payload, pair_splat, tile_base, tile_phi, tile_span, used,
         grad_base, dest_of_exp, exp_offsets, exp_counts, tchk, bgd) = ctx.saved_tensors
        nty, ntx, height, width, config, offsets = ctx.geometry
        packed = config.payload_dtype == "packed"
        g_pad = grad_pad_size(dest_of_exp.shape[0], nty * ntx, config.chunk)
        gspace = composite_bwd(
            payload, pair_splat, tile_base, tile_phi, tile_span, used, grad_base,
            g.to(torch.float32).contiguous(), tchk, g_pad, nty, ntx, height, width, config,
            bg_depth=bgd, offsets=offsets,
        )
        # Per-splat raw-moment sums (9, N), in the order of ``fields``.
        m = segsum_by_splat(gspace, dest_of_exp, exp_offsets, exp_counts, order=ctx.order, packed=packed)
        # Quad-basis combine, once per splat (linear in the moments with
        # per-splat coefficients, so it commutes with the pair summation the
        # segment sum just performed).
        u_x, u_y = m[0], m[1]
        t_xx, t_xy, t_yy = m[2], m[3], m[4]
        s_dp2 = m[8]
        ax, ay = fields[2], fields[3]
        bx, by = fields[4], fields[5]
        op = fields[9]
        s_dqx = ax * u_x + ay * u_y
        s_dqy = bx * u_x + by * u_y
        # dop = Σ ga·α / op, and Σga·α = −Σdp2/2.  Binning culls opacity below
        # 1/255, so the divide is safe for real pairs.
        d_fields = torch.stack(
            [
                -(ax * s_dqx + bx * s_dqy),
                -(ay * s_dqx + by * s_dqy),
                ax * t_xx + ay * t_xy,
                ax * t_xy + ay * t_yy,
                bx * t_xx + by * t_xy,
                bx * t_xy + by * t_yy,
                m[5],
                m[6],
                m[7],
                (-0.5) * s_dp2 * (1.0 / torch.clamp(op, min=1e-20)),
            ],
            dim=0,
        )
        if fields.shape[0] > P_ROWS:
            # the view-z row of the depth test (and any row beyond the
            # payload's): the test is a hard mask, no gradient flows to it
            d_fields = torch.cat(
                [d_fields, d_fields.new_zeros((fields.shape[0] - P_ROWS, d_fields.shape[1]))], dim=0
            )
        d_bgd = torch.zeros_like(bgd) if ctx.needs_input_grad[15] else None
        return (d_fields,) + (None,) * 14 + (d_bgd, None)


def composite_splats_diff(fields, binned, nty, ntx, height, width, config, order=None, bg_depth=None,
                          offsets=(0, 0)):
    """Differentiable compositing of float ``(≥10, N)`` field rows over the
    pairs of ``binned`` (``bin_splats(..., with_grad_map=True)``).  Returns
    the (H, W, 4) image.  ``order``: the depth permutation when ``fields`` is
    in storage order (``bin_splats(..., order=...)``).  With
    ``config.depth_test`` ``fields`` holds 11 rows (row 10 the view-z) and
    ``bg_depth`` is the (H, W) scene depth.  ``offsets``: the strip's tile
    offsets under a strided config (:func:`composite_splats`)."""
    if binned.dest_of_exp is None:
        raise ValueError("composite_splats_diff needs bin_splats(..., with_grad_map=True)")
    return CompositeSplats.apply(
        fields, binned.pair_splat, binned.tile_base, binned.tile_phi, binned.tile_span,
        binned.grad_base, binned.dest_of_exp, binned.exp_offsets, binned.exp_counts,
        order, nty, ntx, height, width, config, bg_depth, tuple(int(o) for o in offsets),
    )
