"""The kernel path's frame glue between the port's kernels, as hand-written
kernels: the depth-order gather of the payload and the binning operands
(``gather_payload``) and its gradient (``scatter_payload``), the marks of
each rank's first pair slot (``mark_owners``), and the per-pair expansion of
the binning (``expand_pairs``).

They replace no TPU kernel.  Under ``jax.jit`` XLA fuses the JAX package's
element-wise and gather glue between its Pallas kernels into a few loops
(``gsplat_tpu/render.py:41-126``: the payload permutation of
``sort_by_depth``, ``ops/pallas/composite.py:976-984``'s packing, and
``ops/binning.py:340-539``'s extents, marks, expansion, SAT cull and key).
Run eagerly, PyTorch launches each of those operations as a kernel of its
own, each a pass over (N,) or (pairs,) words.  The kernels of
``csrc/frame_glue.cu`` are the port's counterpart of those fusions:

  * ``gather_payload`` — one thread a depth rank ``r`` reads ``order[r]``
    and that storage column of the sanitized, quantized ``(16, N)`` field
    matrix (``project_fields(..., payload_dtype=...)``, splat-major on the
    card: the column is one 64-byte record) and writes, in depth
    order, the compositor's payload (8 int32 rows when packed; 10 float32
    rows, 11 with the depth test's view-z row, otherwise, and always on
    the differentiable frame) and the binning's per-rank operands: the
    tiles a splat covers, its tile bbox width, its first tile and, where
    the cull is tightened to the opacity's discard radius, the 8-bit ρ
    threshold.  The cull's quad rows are the payload's rows 0..5, read from
    there.  It stands for ``permute_fields``, ``pack_payload``,
    ``_tile_extents`` and the ρ threshold of the frame.
  * ``scatter_payload`` — the gather's gradient on the differentiable
    frame (:class:`GatherPayload`): the inverse gather of the payload
    rows' cotangent into a ``(16, N)`` one in storage order, written
    splat-major (whole 64-byte records at random positions, the rank-order
    reads coalesced).  It stands for
    the backward of ``permute_cols`` (``ops/permute.py``) and its padding.
  * ``mark_owners`` — after a kernel that zeroes the marks, one thread a
    rank writes its first pair slot (its offset, ``cum − counts``) and
    raises the mark at that slot to its rank + 1 with an atomic max, which the prefix max (``scan_i32(marks,
    "max")``) turns into each slot's owner.  It stands for the offsets and
    the scatter-max of ``bin_splats``.
  * ``expand_pairs`` — one thread a pair slot ``k < budget`` reads the
    owning rank the prefix max found, that rank's operands and offset, and
    writes the pair's sort key ``(tile << bits) | rank`` (or the tile and
    the rank apart where the key does not fit 31 bits), after the
    exact-coverage (SAT) cull of the tile, and with the gradient map the
    pair's depth rank.  It stands for the expansion, SAT cull, spread rank
    and key of ``bin_splats``.

All four are integer bookkeeping, data movement and element-wise float math
held bit for bit against their plain versions (:func:`gather_payload_plain`,
:func:`scatter_payload_plain`, :func:`mark_owners_plain`,
:func:`expand_pairs_plain`: the ATen code these kernels replaced): the
source is compiled with ``-fmad=false`` and repeats ATen's operations one
rounding at a time (``x / 32.0`` is ``x * (float)(1 / 32.0)``, a Python
float scalar is cast to float, ``torch.log`` is ``logf``, ``torch.clamp``
keeps NaN, a float's conversion to int32 truncates as a C cast does on the
card); the atomic max is the same in any order.

What bounds them: bytes.  ``gather_payload`` reads the 8-byte order entry
and 52 bytes of its storage column (rows 0..9, 11, 12, 13; 56 with the depth
test's row 14) and writes 32 bytes of packed payload (40, 44 in float32) and
12 or 16 bytes of operands: 108 bytes a splat when packed, 0.032 ms at 1M
splats at 3.35 TB/s.  ``scatter_payload`` reads 48 bytes a splat and writes
64: 0.033 ms at 1M.  ``mark_owners`` moves 12 bytes a rank and at most one
atomic (none where the next rank marks the same slot, so a run of ranks
without pairs queues nothing on one address), beside the marks' zeroing
(4 bytes a pair slot): about 0.0064 ms at 1M ranks and 2,359,297 slots.  ``expand_pairs`` reads the pair's prefix-max word and
writes its key (8 B a pair) and reads each owning rank's offset, operands
and quad rows once (40 B a rank): about 0.018 ms at 2,359,296 pairs and 1M
ranks.

None of them allocates or synchronises: all may be captured in a CUDA graph
(``graphs.py``).  Each wrapper launches its kernel on a CUDA tensor (or
raises) and takes its plain version only on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from ...utils.config import RenderConfig
from ..covariance import ALPHA_CUTOFF, QUAD_EXTENT
from . import _build, register
from .composite import P_ROWS, P_ROWS_DEPTH, P_ROWS_PACKED, pack_payload

N_FIELDS = 16
# field-matrix rows (ops/projection.py)
ROW_CX, ROW_CY, ROW_OP, ROW_VALID, ROW_HX, ROW_HY, ROW_VIEWZ = 0, 1, 9, 11, 12, 13, 14

# Wrapper calls that launched each kernel.
launches_gather = 0
launches_scatter = 0
launches_marks = 0
launches_expand = 0
register("gather_payload", __name__, "launches_gather", kernel="gather_payload_kernel")
register("scatter_payload", __name__, "launches_scatter", kernel="scatter_payload_kernel")
register("mark_owners", __name__, "launches_marks", kernel="mark_owners_kernel")
register("expand_pairs", __name__, "launches_expand", kernel="expand_pairs_kernel")

# The payload layouts of gather_payload (csrc/frame_glue.cu).
LAYOUT_PACKED, LAYOUT_F32, LAYOUT_F32_DEPTH = 0, 1, 2

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("frame_glue")
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.gsplat_gather_payload.argtypes = [p, p, ll, i, p, p, p, p, p, i, i, f, f, i, i, i, i, p]
        lib.gsplat_gather_payload.restype = i
        lib.gsplat_scatter_payload.argtypes = [p, p, ll, p, p]
        lib.gsplat_scatter_payload.restype = i
        lib.gsplat_expand_pairs.argtypes = [p, p, p, p, p, p, p, ll, ll, i, i, i, i, i, f, f, i, i, i, i,
                                            p, p, p, p, p]
        lib.gsplat_expand_pairs.restype = i
        lib.gsplat_mark_owners.argtypes = [p, p, ll, ll, p, p, p]
        lib.gsplat_mark_owners.restype = i
        _lib = lib
    return _lib


class BinOperands(NamedTuple):
    """The binning's per-splat operands in depth-rank order (all ``(N,)``
    int32 but ``quad``)."""

    counts: torch.Tensor            # tiles the splat covers (0: culled)
    nx: torch.Tensor                # its tile bbox width, at least 1
    tile0: torch.Tensor             # its first (top-left) tile
    thr_q: Optional[torch.Tensor]   # CEIL-quantized 8-bit ρ threshold (rho_ok only)
    quad: torch.Tensor              # (6, N) float32 cx cy ax ay bx by, rows n apart


class FrameGlue(NamedTuple):
    """What :func:`gather_payload` writes: the compositor's payload in depth
    order and the binning's operands (``quad`` is a view of the payload's
    rows 0..5)."""

    payload: torch.Tensor
    operands: BinOperands


class PairKeys(NamedTuple):
    """What :func:`expand_pairs` writes: the sort key of each pair slot, or
    (where it does not fit) its tile and rank; with the gradient map the
    slot's depth rank (−1 past the real pairs)."""

    key: Optional[torch.Tensor]
    tile: Optional[torch.Tensor]
    rank: Optional[torch.Tensor]
    exp_rank: Optional[torch.Tensor]


# ----------------------------------------------------------------- plain versions

_I32_SAFE = float(1 << 30)


def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    """floor → int32, saturating far outside any tile grid (a float beyond
    the int32 range converts to an unspecified value otherwise)."""
    return torch.clamp(torch.floor(x), -_I32_SAFE, _I32_SAFE).to(torch.int32)


def _axis_tiles(p_lo, p_hi, tile_px, off, stride, nt):
    """Pixel range → local tile range on one axis under the strided mapping
    (global tile g = off + ℓ·stride).  Returns (ℓ0, ℓ1, empty): clipped
    local bounds plus the empty-range cull flag."""
    g0 = _floor_i32(p_lo / tile_px) - off
    g1 = _floor_i32(p_hi / tile_px) - off
    if stride == 1:
        l0, l1 = g0, g1
    else:
        l0 = torch.div(g0 + (stride - 1), stride, rounding_mode="floor")
        l1 = torch.div(g1, stride, rounding_mode="floor")
    empty = (l1 < l0) | (l1 < 0) | (l0 > nt - 1)
    return torch.clamp(l0, 0, nt - 1), torch.clamp(l1, 0, nt - 1), empty


def tile_grid(width: int, height: int, tile_h: int, tile_w: int):
    """Number of tiles (rows, cols) covering the screen."""
    return -(-height // tile_h), -(-width // tile_w)


def _tile_extents(f, width: int, height: int, config: RenderConfig, row_offset, col_offset):
    """Per-splat tile-coverage counts + bbox operands (shared by binning and
    the budget-tuning count pass so both cull/extent rules stay identical).

    Local tile (ℓy, ℓx) covers GLOBAL tile
    (``row_offset + ℓy·row_stride``, ``col_offset + ℓx·col_stride``)."""
    nty, ntx = tile_grid(width, height, config.tile_h, config.tile_w)

    x_lo = f[ROW_CX] - f[ROW_HX]
    x_hi = f[ROW_CX] + f[ROW_HX]
    y_lo = f[ROW_CY] - f[ROW_HY]
    y_hi = f[ROW_CY] + f[ROW_HY]

    # Cull: behind camera or opacity below the discard threshold; off-screen
    # coverage culls through the empty-range flags below.
    cull = (f[ROW_VALID] < 0.5) | (f[ROW_OP] < ALPHA_CUTOFF)

    tw = float(config.tile_w)
    th = float(config.tile_h)
    tx0, tx1, ex = _axis_tiles(x_lo, x_hi, tw, col_offset, config.col_stride, ntx)
    ty0, ty1, ey = _axis_tiles(y_lo, y_hi, th, row_offset, config.row_stride, nty)
    cull = cull | ex | ey
    nx = torch.where(cull, 0, tx1 - tx0 + 1)
    ny = torch.where(cull, 0, ty1 - ty0 + 1)
    counts = nx * ny
    return counts, nx, tx0, ty0


def tile_operands(f, width: int, height: int, config: RenderConfig, row_offset, col_offset, rho_ok: bool,
                  quad: torch.Tensor) -> BinOperands:
    """The binning operands of the field matrix ``f``'s columns, in ``f``'s
    column order (plain PyTorch; ``quad`` is passed through)."""
    nty, ntx = tile_grid(width, height, config.tile_h, config.tile_w)
    counts, nx, tx0, ty0 = _tile_extents(f, width, height, config, row_offset, col_offset)
    thr_q = None
    if rho_ok:
        # Opacity-aware SAT threshold: the compositor also discards α < 1/255,
        # so a splat's support is bounded by the quad AND the disc power ≤
        # ln(255·op) — per-axis |q| ≤ min(QUAD_EXTENT, ρ), ρ = √ln(255·op).  ρ
        # is CEIL-quantized to 8 bits, exactly as the JAX package packs it, so
        # the dequantized threshold can only be looser (the cull stays exact).
        rho = torch.sqrt(
            torch.log(torch.clamp(f[ROW_OP], min=ALPHA_CUTOFF) / ALPHA_CUTOFF)
        )
        thr_q = torch.clamp(
            torch.ceil(
                torch.clamp(rho, max=QUAD_EXTENT) * (255.0 / QUAD_EXTENT)
            ).to(torch.int32),
            max=255,
        )
    return BinOperands(counts=counts, nx=torch.clamp(nx, min=1), tile0=ty0 * ntx + tx0, thr_q=thr_q, quad=quad)


def payload_layout(config: RenderConfig, float_rows: bool = False) -> int:
    """The payload ``gather_payload`` writes: packed where ``config`` packs
    it, unless ``float_rows`` (the differentiable compositor's float32
    rows), else the float32 rows, with the view-z row under the depth test."""
    if config.payload_dtype == "packed" and not float_rows:
        return LAYOUT_PACKED
    return LAYOUT_F32_DEPTH if config.depth_test else LAYOUT_F32


def _quad_of(payload: torch.Tensor) -> torch.Tensor:
    q = payload[0:6]
    return q.view(torch.float32) if q.dtype == torch.int32 else q


def gather_payload_plain(fields, order, width, height, config, rho_ok, row_offset=0, col_offset=0,
                         float_rows=False) -> FrameGlue:
    """Plain PyTorch version of :func:`gather_payload`: the depth
    permutation of the live rows (``permute_fields``), the payload
    (``pack_payload`` or the float32 rows) and the binning operands of the
    permuted columns."""
    n_rows = 15 if config.depth_test else 14
    f = fields[:n_rows][:, order]
    layout = payload_layout(config, float_rows)
    if layout == LAYOUT_PACKED:
        payload = pack_payload(f)
    elif layout == LAYOUT_F32_DEPTH:
        payload = torch.cat([f[:10], f[ROW_VIEWZ:ROW_VIEWZ + 1]], dim=0)
    else:
        payload = f[:10].contiguous()
    ops = tile_operands(f, width, height, config, int(row_offset), int(col_offset), rho_ok, _quad_of(payload))
    return FrameGlue(payload=payload, operands=ops)


def scatter_payload_plain(d_payload, order):
    """Plain PyTorch version of :func:`scatter_payload`: the backward of
    ``permute_cols(fields[:n_rows], order, 10)`` (``ops/permute.py``) with
    the structural-zero rows of ``permute_fields`` re-appended."""
    n = order.shape[0]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, dtype=order.dtype, device=order.device)
    return torch.cat([d_payload[:10][:, inv], d_payload.new_zeros((N_FIELDS - 10, n))], dim=0)


def mark_owners_plain(cum, counts, budget):
    """Plain PyTorch version of :func:`mark_owners`."""
    n = counts.shape[0]
    offsets = cum - counts
    splat_ids = torch.arange(n, dtype=torch.int32, device=cum.device)
    # Offsets ≥ budget are dropped: they land in one extra slot that is cut
    # off again (a scatter may not see an out-of-range index).
    marks = torch.zeros((budget + 1,), dtype=torch.int32, device=cum.device)
    marks.scatter_reduce_(
        0, torch.clamp(offsets, max=budget).long(), splat_ids + 1, "amax", include_self=True
    )
    return offsets, marks


def expand_pairs_plain(smax, cum, offsets, ops: BinOperands, budget, num_tiles, ntx, config, row_offset,
                       col_offset, sat_cull, rho_ok, with_exp_rank) -> PairKeys:
    """Plain PyTorch version of :func:`expand_pairs` (the ATen code of the
    binning's expansion, SAT cull and key)."""
    dev = smax.device
    i32 = torch.int32
    n = offsets.shape[0]
    s_safe = torch.clamp(smax - 1, max=n - 1)
    s_safe = torch.clamp(s_safe, min=0).long()
    total = torch.clamp(cum[-1], max=budget)
    pair_idx = torch.arange(budget, dtype=i32, device=dev)

    # Per-pair expansion operands.  (The JAX package bit-packs them into one
    # gathered row; here they are plain per-row gathers of the same values.)
    nx_s = ops.nx[s_safe]
    tile0_s = ops.tile0[s_safe]
    r = pair_idx - offsets[s_safe]
    # r // nx as an integer floor division (the JAX package takes a float
    # quotient only because its target has no integer divide; the values
    # are equal: 0 ≤ r < 2^24 and nx ≥ 1).
    dty = torch.div(r, nx_s, rounding_mode="floor")
    dtx = r - dty * nx_s
    tile = tile0_s + dty * ntx + dtx
    pair_valid = pair_idx < total
    live = pair_valid
    if sat_cull:
        g = ops.quad[:, s_safe]
        cx_s, cy_s, ax_s, ay_s, bx_s, by_s = g[0], g[1], g[2], g[3], g[4], g[5]
        # Tile's pixel-center rect: center (pcx, pcy), half-extent
        # (tw−1)/2 px (pixel centers sit 0.5 px inside the tile edges).
        ty0_s = torch.div(tile0_s, ntx, rounding_mode="floor")
        tx_t = (tile0_s - ty0_s * ntx + dtx).to(torch.float32) * float(
            config.col_stride
        ) + float(col_offset)
        ty_t = (ty0_s.to(torch.float32) + dty.to(torch.float32)) * float(
            config.row_stride
        ) + float(row_offset)
        tw = float(config.tile_w)
        th = float(config.tile_h)
        pcx = tx_t * tw + (tw * 0.5) - cx_s
        pcy = ty_t * th + (th * 0.5) - cy_s
        hx_r = (tw - 1.0) * 0.5
        hy_r = (th - 1.0) * 0.5
        # Quad-axis intervals of the rect: |q·c| ± h·(|a|+|b|); separated on
        # an axis ⇒ every pixel center fails the compositor's |q|∞ ≤ 2 mask.
        qxc = ax_s * pcx + ay_s * pcy
        qyc = bx_s * pcx + by_s * pcy
        e1 = hx_r * torch.abs(ax_s) + hy_r * torch.abs(ay_s)
        e2 = hx_r * torch.abs(bx_s) + hy_r * torch.abs(by_s)
        # Per-splat separation threshold: the quad extent, tightened to the
        # opacity discard radius ρ (CEIL-quantized, so only ever looser than
        # the true ρ).  Separation at ρ on either quad axis means
        # power > ρ² = ln(op/cutoff) at every pixel center, i.e. α < 1/255.
        if rho_ok:
            thr1 = ops.thr_q[s_safe].to(torch.float32) * (QUAD_EXTENT / 255.0)
        else:
            thr1 = QUAD_EXTENT
        # Margin: 1e-3 quad units absolute (association-order rounding vs the
        # compositor's own qx/qy evaluation) plus a magnitude-relative term
        # for needle splats, where the two products nearly cancel.
        err1 = 1e-3 + 1e-6 * (torch.abs(ax_s * pcx) + torch.abs(ay_s * pcy))
        err2 = 1e-3 + 1e-6 * (torch.abs(bx_s * pcx) + torch.abs(by_s * pcy))
        separated = (torch.abs(qxc) > thr1 + err1 + e1) | (
            torch.abs(qyc) > thr1 + err2 + e2
        )
        live = live & torch.logical_not(separated)
    tile = torch.where(live, tile, num_tiles)
    # Invalid pairs point at *spread* real ranks instead of one shared
    # sentinel (kept from the JAX package so the arrays compare equal).  Safe
    # because an invalid pair's payload is never read: it sorts past every
    # tile's span and ``build_tile_lists`` drops it by its sentinel TILE id.
    spread = torch.clamp(pair_idx & spread_mask(n), max=n - 1)
    rank_of_pair = torch.where(pair_valid, s_safe.to(i32), spread)
    exp_rank = torch.where(pair_valid, s_safe.to(i32), -1) if with_exp_rank else None
    bits_r = rank_bits(n)
    if key_fits(num_tiles, n):
        return PairKeys(key=(tile << bits_r) | rank_of_pair, tile=None, rank=None, exp_rank=exp_rank)
    return PairKeys(key=None, tile=tile, rank=rank_of_pair, exp_rank=exp_rank)


def spread_mask(n: int) -> int:
    """The mask that spreads invalid pairs over real ranks."""
    return (1 << max(int(n).bit_length() - 1, 0)) - 1


def rank_bits(n: int) -> int:
    """Bits of a rank in the packed (tile, rank) key."""
    return max((n - 1).bit_length(), 1)


def key_fits(num_tiles: int, n: int) -> bool:
    """Whether (tile, rank) packs into one non-negative int32 key (the
    sentinel tile ``num_tiles`` included)."""
    return ((num_tiles + 1) << rank_bits(n)) <= 2**31 - 1


# ----------------------------------------------------------------- kernels

def _stream(dev):
    """The device's current stream as a raw handle (``ops/kernels/scan.py``)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def gather_payload(fields: torch.Tensor, order: torch.Tensor, width: int, height: int, config: RenderConfig,
                   rho_ok: bool, row_offset: int = 0, col_offset: int = 0, float_rows: bool = False) -> FrameGlue:
    """The depth-ordered payload and binning operands of a sanitized,
    quantized ``(16, N)`` float32 field matrix in storage order, for the
    depth permutation ``order`` (``(N,)``, int64 or int32).  ``rho_ok``: also
    write the ρ threshold (``bin_splats``' flag).  ``float_rows``: write the
    float32 rows even where ``config`` packs the payload (the
    differentiable compositor reads those).  On the card the matrix is
    splat-major, as ``project_fields(..., payload_dtype=...)`` writes it:
    the transposed view of a contiguous, 16-byte aligned ``(N, 16)`` matrix.

    On CUDA tensors this launches ``gather_payload`` (or raises); on CPU
    tensors it takes :func:`gather_payload_plain`."""
    global launches_gather
    n = fields.shape[-1] if fields.dim() == 2 else -1
    if fields.dtype != torch.float32 or fields.dim() != 2 or fields.shape[0] != N_FIELDS:
        raise TypeError(f"fields: expected ({N_FIELDS}, N) float32, got {tuple(fields.shape)} {fields.dtype}")
    if order.dim() != 1 or order.shape[0] != n or order.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"order: expected ({n},) int64 or int32, got {tuple(order.shape)} {order.dtype}")
    if order.device != fields.device:
        raise ValueError("fields and order must live on one device")
    if config.tile_h != 32 or config.tile_w != 32:
        raise ValueError("the cuda backend requires tile_h == tile_w == 32")
    if not fields.is_cuda:
        return gather_payload_plain(fields, order, width, height, config, rho_ok, row_offset, col_offset,
                                    float_rows)
    if fields.stride() != (1, N_FIELDS) or fields.data_ptr() % 16:
        raise ValueError("fields must be splat-major (the transposed view of a contiguous (N, 16) matrix, "
                         "16-byte aligned), as project_fields(..., payload_dtype=...) writes them")
    dev = fields.device
    order = order.contiguous() if order.dtype == torch.int64 else order.to(torch.int64)
    layout = payload_layout(config, float_rows)
    rows = {LAYOUT_PACKED: P_ROWS_PACKED, LAYOUT_F32: P_ROWS, LAYOUT_F32_DEPTH: P_ROWS_DEPTH}[layout]
    payload = torch.empty((rows, n), dtype=torch.int32 if layout == LAYOUT_PACKED else torch.float32, device=dev)
    counts, nx, tile0 = (torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(3))
    thr_q = torch.empty((n,), dtype=torch.int32, device=dev) if rho_ok else None
    if n > 0:
        nty, ntx = tile_grid(width, height, config.tile_h, config.tile_w)
        with torch.cuda.device(dev):
            err = _library().gsplat_gather_payload(
                fields.data_ptr(), order.data_ptr(), n, layout, payload.data_ptr(), counts.data_ptr(),
                nx.data_ptr(), tile0.data_ptr(), thr_q.data_ptr() if rho_ok else None, nty, ntx,
                1.0 / config.tile_w, 1.0 / config.tile_h, config.row_stride, config.col_stride,
                int(row_offset), int(col_offset), _stream(dev),
            )
        if err != 0:
            raise RuntimeError(f"gsplat_gather_payload launch failed: CUDA error {err}")
        launches_gather += 1
    return FrameGlue(payload=payload, operands=BinOperands(counts, nx, tile0, thr_q, _quad_of(payload)))


def scatter_payload(d_payload: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`gather_payload`'s float32 payload: the
    ``(16, N)`` float32 cotangent of the field matrix in storage order,
    whose column ``order[r]`` holds rows 0..9 of ``d_payload``'s column
    ``r`` and whose other rows are zero (the depth key, the validity, the
    footprint and the view-z row take no gradient).  ``d_payload``: ``(≥10,
    N)`` float32; ``order``: the permutation the gather read through.  On
    the card the cotangent comes back splat-major (the transposed view of an
    ``(N, 16)`` matrix), which ``project_bwd``'s masked form reads as it is.

    On CUDA tensors this launches ``scatter_payload`` (or raises); on CPU
    tensors it takes :func:`scatter_payload_plain`."""
    global launches_scatter
    n = order.shape[0]
    if d_payload.dtype != torch.float32 or d_payload.dim() != 2 or d_payload.shape[0] < 10 \
            or d_payload.shape[1] != n:
        raise TypeError(f"d_payload: expected (>=10, {n}) float32, got {tuple(d_payload.shape)} {d_payload.dtype}")
    if order.dim() != 1 or order.dtype not in (torch.int64, torch.int32) or order.device != d_payload.device:
        raise TypeError(f"order: expected ({n},) int64 or int32 on {d_payload.device}")
    if not d_payload.is_cuda:
        return scatter_payload_plain(d_payload, order)
    dev = d_payload.device
    d_payload = d_payload.contiguous()
    order = order.contiguous() if order.dtype == torch.int64 else order.to(torch.int64)
    # splat-major: a column is one 64-byte record (project_bwd reads it so)
    d_fields = torch.empty((n, N_FIELDS), dtype=torch.float32, device=dev).T
    if n > 0:
        with torch.cuda.device(dev):
            err = _library().gsplat_scatter_payload(d_payload.data_ptr(), order.data_ptr(), n, d_fields.data_ptr(),
                                                    _stream(dev))
        if err != 0:
            raise RuntimeError(f"gsplat_scatter_payload launch failed: CUDA error {err}")
        launches_scatter += 1
    return d_fields


class GatherPayload(torch.autograd.Function):
    """:func:`gather_payload`'s float32 rows, differentiable in ``fields``:
    the backward is :func:`scatter_payload`, the permutation's VJP (the
    binning operands take no gradient).  Returns the payload and the four
    operand tensors (``thr_q`` None without ``rho_ok``)."""

    @staticmethod
    def forward(ctx, fields, order, width, height, config, rho_ok, row_offset, col_offset):
        glue = gather_payload(fields, order, width, height, config, rho_ok, row_offset, col_offset,
                              float_rows=True)
        ops = glue.operands
        ctx.save_for_backward(order)
        ctx.set_materialize_grads(False)
        ints = [t for t in (ops.counts, ops.nx, ops.tile0, ops.thr_q) if t is not None]
        ctx.mark_non_differentiable(*ints)
        return glue.payload, ops.counts, ops.nx, ops.tile0, ops.thr_q

    @staticmethod
    @once_differentiable
    def backward(ctx, d_payload, *_):
        if d_payload is None:
            return (None,) * 8
        (order,) = ctx.saved_tensors
        return (scatter_payload(d_payload.to(torch.float32), order),) + (None,) * 7


def gather_payload_diff(fields, order, width, height, config, rho_ok, row_offset=0, col_offset=0) -> FrameGlue:
    """:func:`gather_payload` of the differentiable frame: the float32 rows
    (whatever ``config.payload_dtype``), through :class:`GatherPayload`."""
    payload, counts, nx, tile0, thr_q = GatherPayload.apply(fields, order, width, height, config, rho_ok,
                                                            int(row_offset), int(col_offset))
    return FrameGlue(payload=payload, operands=BinOperands(counts, nx, tile0, thr_q, _quad_of(payload.detach())))


def mark_owners(cum: torch.Tensor, counts: torch.Tensor, budget: int):
    """Each rank's first pair slot and the marks the prefix max turns into
    each slot's owner: ``offsets = cum − counts`` and ``marks`` (``(budget +
    1,)`` int32, zeroed) with ``marks[min(offsets[r], budget)] = max(…, r +
    1)`` over the ranks ``r`` (a rank with no pairs shares its offset with
    the next rank that has some, whose larger id wins; offsets past the
    budget land in the extra last slot).  ``cum`` is the inclusive prefix sum
    of ``counts`` (both ``(N,)`` int32).  The max is the same in any order of
    the atomic updates.

    On CUDA tensors this launches ``mark_owners`` (or raises; two kernels:
    the marks' zeroing, then the marks); on CPU tensors it takes
    :func:`mark_owners_plain`."""
    global launches_marks
    n = counts.shape[0]
    for name, t in (("cum", cum), ("counts", counts)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise TypeError(f"{name}: expected ({n},) int32, got {tuple(t.shape)} {t.dtype}")
    if cum.device != counts.device:
        raise ValueError("cum and counts must live on one device")
    if budget < 1:
        raise ValueError("mark_owners needs at least one pair slot")
    if not cum.is_cuda:
        return mark_owners_plain(cum, counts, budget)
    if not (cum.is_contiguous() and counts.is_contiguous()):
        raise ValueError("cum and counts must be contiguous")
    dev = cum.device
    offsets = torch.empty((n,), dtype=torch.int32, device=dev)
    marks = torch.empty((budget + 1,), dtype=torch.int32, device=dev) if n > 0 else \
        torch.zeros((budget + 1,), dtype=torch.int32, device=dev)
    if n > 0:
        with torch.cuda.device(dev):
            err = _library().gsplat_mark_owners(cum.data_ptr(), counts.data_ptr(), n, budget, offsets.data_ptr(),
                                                marks.data_ptr(), _stream(dev))
        if err != 0:
            raise RuntimeError(f"gsplat_mark_owners launch failed: CUDA error {err}")
        launches_marks += 1
    return offsets, marks


def expand_pairs(smax, cum, offsets, ops: BinOperands, budget: int, num_tiles: int, ntx: int,
                 config: RenderConfig, row_offset: int, col_offset: int, sat_cull: bool, rho_ok: bool,
                 with_exp_rank: bool) -> PairKeys:
    """Expand the binning's pair slots ``k < budget`` (``bin_splats``' steps
    after the prefix max).

    ``smax``: ``(budget,)`` int32, the prefix max of the marks (rank + 1 of
    each slot's owner); ``cum``: ``(N,)`` the inclusive prefix sum of
    ``ops.counts``; ``offsets``: ``cum − counts``; ``ops``: the per-rank
    operands (``thr_q`` read only with ``rho_ok``, ``quad`` only with
    ``sat_cull``).  Returns the sort key of each slot when (tile, rank) fits
    one int32 (:func:`key_fits`), else the tile and the rank; with
    ``with_exp_rank`` also the slot's depth rank.

    On CUDA tensors this launches ``expand_pairs`` (or raises); on CPU
    tensors it takes :func:`expand_pairs_plain`."""
    global launches_expand
    n = offsets.shape[0]
    if n < 1 or budget < 1:
        raise ValueError("expand_pairs needs at least one splat and one pair slot")
    named = [("smax", smax, (budget,)), ("cum", cum, (n,)), ("offsets", offsets, (n,)),
             ("nx", ops.nx, (n,)), ("tile0", ops.tile0, (n,))]
    if rho_ok:
        named.append(("thr_q", ops.thr_q, (n,)))
    for name, t, shape in named:
        if t is None or t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise TypeError(f"{name}: expected {shape} int32, got "
                            f"{None if t is None else (tuple(t.shape), t.dtype)}")
        if t.device != smax.device:
            raise ValueError("all expand_pairs inputs must live on one device")
    if sat_cull and (ops.quad.dtype != torch.float32 or tuple(ops.quad.shape) != (6, n)):
        raise TypeError(f"quad: expected (6, {n}) float32, got {tuple(ops.quad.shape)} {ops.quad.dtype}")
    if not smax.is_cuda:
        return expand_pairs_plain(smax, cum, offsets, ops, budget, num_tiles, ntx, config, row_offset,
                                  col_offset, sat_cull, rho_ok, with_exp_rank)
    for name, t, _ in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    quad = ops.quad
    if sat_cull and (quad.stride(1) != 1 or quad.stride(0) != n):
        quad = quad.contiguous()
    dev = smax.device
    fits = key_fits(num_tiles, n)

    def new():
        return torch.empty((budget,), dtype=torch.int32, device=dev)

    key = new() if fits else None
    tile, rank = (None, None) if fits else (new(), new())
    exp_rank = new() if with_exp_rank else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = _library().gsplat_expand_pairs(
            smax.data_ptr(), cum.data_ptr(), offsets.data_ptr(), ops.nx.data_ptr(), ops.tile0.data_ptr(),
            ops.thr_q.data_ptr() if rho_ok else None, quad.data_ptr() if sat_cull else None,
            n, budget, num_tiles, ntx, rank_bits(n), spread_mask(n), int(bool(fits)),
            float(config.tile_w), float(config.tile_h), config.row_stride, config.col_stride,
            int(row_offset), int(col_offset), ptr(key), ptr(tile), ptr(rank),
            ptr(exp_rank), _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"gsplat_expand_pairs launch failed: CUDA error {err}")
    launches_expand += 1
    return PairKeys(key=key, tile=tile, rank=rank, exp_rank=exp_rank)
