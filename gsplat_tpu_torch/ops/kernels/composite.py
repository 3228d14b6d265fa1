"""Compositing forward: per-tile front-to-back blend of depth-ordered
(tile, splat) pair segments.

``composite_splats`` replaces the forward half of the TPU kernel
``gsplat_tpu/ops/pallas/composite.py`` (``_fwd_kernel``, reached through
``composite_splats_pallas``) with the hand-written CUDA kernel in
``csrc/composite_fwd.cu``: one block per 32×32 tile, 256 threads × 4 pixels,
the tile's segment walked in ``config.chunk`` steps with a block-wide vote for
the early stop.  The payload gather is part of the function — the kernel and
the plain version read ``fields[:, pair_splat[j]]`` themselves — so the
``(rows, P_pad)`` pair payload the TPU path materialises never exists here.

What bounds it: operations — every live pair costs 1024 pixel updates of
about 30 float instructions and one ``expf``, against 32–40 bytes of payload;
the per-pair shared-memory broadcast comes next.  The kernel is compiled
without FMA contraction so that it agrees with the plain version across the
two hard thresholds (see the source note).

Also here, as torch ops: ``pack2`` / ``unpack2`` and ``pack_payload`` (the
8-row int32 payload of ``payload_dtype="packed"``).  The backward half, the
transmittance checkpoints, wireframe, depth test and strided tiles belong to
later slices.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.config import RenderConfig
from ..covariance import ALPHA_CUTOFF, QUAD_EXTENT
from . import _build

TILE = 32          # the kernel's pixel tile is TILE×TILE
P_ROWS = 10        # payload rows: cx cy ax ay bx by r g b op
P_ROWS_PACKED = 8  # packed payload rows: [cx cy ax ay bx by (r,g) (b,op)]

# Wrapper calls that launched the kernel.
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("composite_fwd")
        p = ctypes.c_void_p
        lib.gsplat_composite_fwd.argtypes = [
            p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            p, p, p, p, p, p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, p,
        ]
        lib.gsplat_composite_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def pack2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Bit-pack two f32 tensors, bf16-ROUNDING each (idempotent on already
    rounded values): ``hi``'s top 16 bits (its bf16 encoding) in the high
    half, ``lo``'s in the low half.  Returns int32; exact round-trip with
    :func:`unpack2`."""
    hb = _round_bf16(hi).contiguous().view(torch.int32)
    lb = _round_bf16(lo).contiguous().view(torch.int32)
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


def _check(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config):
    if config.tile_h != TILE or config.tile_w != TILE:
        raise ValueError("the compositing kernel requires tile_h == tile_w == 32")
    if config.wireframe:
        raise NotImplementedError("wireframe compositing is a later slice of the port")
    if config.depth_test:
        raise NotImplementedError("depth-tested compositing is a later slice of the port")
    if config.row_stride != 1 or config.col_stride != 1:
        raise NotImplementedError("strided tile mapping (sharded render) is a later slice of the port")
    packed = config.payload_dtype == "packed"
    rows, dt = (P_ROWS_PACKED, torch.int32) if packed else (P_ROWS, torch.float32)
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
):
    """Plain PyTorch version of the compositing forward: a loop over chunk
    steps and, inside, over pair positions, vectorised over tiles and pixels,
    with the same base-aligned stop rule.  Returns ``(image, used)``:
    (H, W, 4) float32 premultiplied RGBA and the (T,) int32 stop counter.

    The loop bounds are read to the host (one read for the chunk count, one
    per chunk for "any tile still walking")."""
    packed = _check(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config)
    dev = fields.device
    f32 = torch.float32
    num_tiles = nty * ntx
    chunk = config.chunk
    n = fields.shape[1]
    p_len = pair_splat.shape[0]

    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    origin_x = ((tile_ids % ntx) * TILE).to(f32)
    origin_y = (torch.div(tile_ids, ntx, rounding_mode="floor") * TILE).to(f32)
    iota = torch.arange(TILE, dtype=f32, device=dev) + 0.5
    px = origin_x[:, None, None] + iota[None, None, :]  # (T, 1, 32)
    py = origin_y[:, None, None] + iota[None, :, None]  # (T, 32, 1)

    acc = torch.zeros((num_tiles, 3, TILE, TILE), dtype=f32, device=dev)
    trans = torch.ones((num_tiles, TILE, TILE), dtype=f32, device=dev)
    walked = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
    alive = torch.ones((num_tiles,), dtype=torch.bool, device=dev)
    nchunks = torch.div(tile_span + (chunk - 1), chunk, rounding_mode="floor")
    max_chunks = int(nchunks.max()) if num_tiles > 0 else 0
    base = tile_base.long()
    max_alpha = torch.full((), config.max_alpha, dtype=f32, device=dev)

    def col(v):
        return v[:, None, None]

    for ci in range(max_chunks):
        active = alive & (nchunks > ci)
        if not bool(active.any()):
            break
        for i in range(chunk):
            pos = ci * chunk + i
            valid = active & (tile_phi <= pos) & (tile_span > pos)
            idx = pair_splat[torch.clamp(base + pos, max=p_len - 1)].long()
            f = fields[:, idx]  # (rows, T)
            if packed:
                geo = f[0:6].view(f32)
                cr, cg = unpack2(f[6])
                cb, op_raw = unpack2(f[7])
            else:
                geo = f[0:6]
                cr, cg, cb, op_raw = f[6], f[7], f[8], f[9]
            op = torch.where(valid, op_raw, 0.0)
            dx = px - col(geo[0])
            dy = py - col(geo[1])
            qx = dx * col(geo[2]) + dy * col(geo[3])
            qy = dx * col(geo[4]) + dy * col(geo[5])
            qx2 = qx * qx
            qy2 = qy * qy
            power = qx2 + qy2
            alpha = torch.minimum(torch.exp(-power) * col(op), max_alpha)
            if not config.soft_cutoff:
                inside = torch.maximum(qx2, qy2) <= QUAD_EXTENT * QUAD_EXTENT
                alpha = torch.where(inside & (alpha >= ALPHA_CUTOFF), alpha, 0.0)
            w = alpha * trans
            color = torch.stack([cr, cg, cb], dim=1)  # (T, 3)
            acc = acc + w[:, None] * color[:, :, None, None]
            trans = trans * (1.0 - alpha)
        walked = torch.where(active, ci + 1, walked)
        still = trans.amax(dim=(1, 2)) > config.transmittance_eps
        alive = torch.where(active, still, alive)

    used = torch.minimum(tile_span, walked * chunk).to(torch.int32)
    tiles = torch.cat([acc, (1.0 - trans)[:, None]], dim=1)  # (T, 4, 32, 32)
    image = (
        tiles.reshape(nty, ntx, 4, TILE, TILE)
        .permute(0, 3, 1, 4, 2)
        .reshape(nty * TILE, ntx * TILE, 4)
    )
    return image[:height, :width].contiguous(), used


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
):
    """Composite every tile's pair segment front to back.

    Args:
      fields: per-splat payload matrix in the order ``pair_splat`` indexes —
        ``(10, N)`` float32 rows ``cx cy ax ay bx by r g b op``, or for
        ``payload_dtype="packed"`` the ``(8, N)`` int32 matrix of
        :func:`pack_payload`.
      pair_splat: ``(P_pad,)`` int32 — tile-sorted pair → payload column.
      tile_base / tile_phi / tile_span: ``(T,)`` int32 segment descriptors
        (``ops/binning.py``): positions ``[phi, span)`` counted from ``base``
        are the tile's own pairs.
      nty, ntx, height, width: tile grid and image size.
      config: ``chunk``, ``max_alpha``, ``transmittance_eps``, ``soft_cutoff``,
        ``payload_dtype``.

    Returns:
      ``(image, used)``: (H, W, 4) float32 premultiplied RGBA (alpha = 1 − T)
      and the (T,) int32 stop counter ``min(span, chunks_walked·chunk)``.

    On CUDA tensors this launches the kernel (or raises); on CPU tensors it
    takes :func:`composite_splats_plain`.
    """
    global launches
    packed = _check(fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config)
    if not fields.is_cuda:
        if pair_splat.numel() > 0 and fields.shape[1] > 0:
            # Padding entries are in range by construction (binning spreads
            # them over real columns); checked here, where it costs no
            # device synchronisation.
            if int(pair_splat.min()) < 0 or int(pair_splat.max()) >= fields.shape[1]:
                raise ValueError("pair_splat holds an out-of-range column")
        return composite_splats_plain(
            fields, pair_splat, tile_base, tile_phi, tile_span, nty, ntx, height, width, config
        )
    for name, a in (("fields", fields), ("pair_splat", pair_splat), ("tile_base", tile_base),
                    ("tile_phi", tile_phi), ("tile_span", tile_span)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (P_ROWS + 1) * config.chunk * 4 > 48 * 1024:
        raise ValueError(f"chunk={config.chunk} exceeds the kernel's shared memory")
    dev = fields.device
    num_tiles = nty * ntx
    image = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    used = torch.empty((num_tiles,), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.gsplat_composite_fwd(
            fields.data_ptr(), fields.shape[1], int(packed), int(config.soft_cutoff),
            pair_splat.data_ptr(), tile_base.data_ptr(), tile_phi.data_ptr(),
            tile_span.data_ptr(), image.data_ptr(), used.data_ptr(),
            nty, ntx, height, width, config.chunk,
            config.max_alpha, config.transmittance_eps,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gsplat_composite_fwd launch failed: CUDA error {err}")
    launches += 1
    return image, used
