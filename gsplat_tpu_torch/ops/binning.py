"""Tile binning: (tile, splat) pair expansion with static shapes
(counterpart of ``gsplat_tpu.ops.binning``).

The screen is cut into tiles and each splat is expanded into one
(tile, splat) pair per overlapped tile:

  1. per-splat tile-bbox from the precomputed quad footprint half-extents
     (``ops/projection.py`` rows 12-13);
  2. pair offsets by a prefix sum; pair→splat lookup by a scatter-max of the
     rank at each offset followed by a prefix max, over a fixed pair budget
     (ragged→static) — the two prefix scans are the scan kernel
     (``ops/kernels/scan.py``);
  3. one sort by tile id — splats are already in global depth order, so the
     packed (tile, rank) key yields per-tile front-to-back order;
  4. **no re-layout**: the sorted pair order IS the final layout.  Each
     tile's segment ``[start, start+count)`` is described to the compositor
     by its chunk-aligned base ``base = start − φ`` and lead phase
     ``φ = start mod chunk``; the early-stop test of the compositor sits on
     that chunk grid, so the descriptors are part of the image contract.

     ``grad_base`` lays out the separate gradient address space of the
     backward pass (one chunk-aligned region per tile, sized from the *raw*
     per-tile counts).  ``with_grad_map=True`` adds the expansion-order
     gradient map: ``dest_of_exp[j]`` is the gradient-space column of
     expansion pair ``j`` (the bitwise-not of ``j`` for a dropped pair),
     ``exp_rank[j]`` its depth rank, and ``exp_offsets`` / ``exp_counts`` each
     rank's contiguous window of expansion pairs.  The two per-pair segment
     descriptors it needs are a scatter-max at the segment starts followed
     by a prefix max — two more launches of the scan kernel.

Overflow policy: pairs beyond the budget and per-tile entries beyond
``tile_capacity`` drop the *farthest* splats; the dropped count is reported
so callers can warn.

All integer arrays are int32 and equal the JAX package's bit for bit on the
same sorted, sanitized fields (``tests/test_torch_binning.py``).  Nothing
here reads a value back to the host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from ..utils.config import RenderConfig
from ..utils.logging import format_count, get_logger
from .kernels import frame_glue as kglue
from .kernels.frame_glue import BinOperands, FrameGlue, _tile_extents, tile_grid
from .kernels.scan import scan_i32
from .projection import ProjectedSplats


@dataclasses.dataclass(frozen=True)
class BinnedPairs:
    """Static-shape binning result (pairs stay in tile-sorted order).

    ``pair_splat[k]``: payload-column index of the k-th pair — a *storage*
    index when ``bin_splats`` was given ``order``, a depth-rank index
    otherwise (fields pre-sorted); pairs are grouped by tile (ascending tile
    id) and front-to-back within each tile.  Invalid/padding pairs hold
    *spread* in-range dummy indices (their payload is never read unmasked).
    Use ``pair_tile == num_tiles`` to identify them, not ``pair_splat``.

    Per-tile segment descriptors (all ``(T,) int32``):
      * ``tile_start`` — raw (unaligned) first pair of the tile's segment;
      * ``tile_count`` — segment length, capped at ``tile_capacity``;
      * ``tile_base``  — chunk-aligned base, ``tile_start − tile_phi``;
      * ``tile_phi``   — lead phase, ``tile_start mod chunk``;
      * ``tile_span``  — ``phi + count`` (0 for empty tiles): the number of
        pair positions a compositor walks from ``tile_base``, positions
        ``< phi`` and ``≥ span`` belonging to the neighbouring tiles;
      * ``grad_base``  — chunk-aligned base of the tile's exclusive region
        in the gradient address space (size ``grad_pad_size(...)``).
    """

    pair_splat: torch.Tensor     # (P_pad,) int32 — tile-sorted order
    pair_tile: Optional[torch.Tensor]  # (P_pad,) int32 (num_tiles = sentinel); None unless with_tiles
    tile_start: torch.Tensor     # (T,) int32 — raw segment starts
    tile_count: torch.Tensor     # (T,) int32 — capped per-tile count
    tile_base: torch.Tensor      # (T,) int32 — chunk-aligned base
    tile_phi: torch.Tensor       # (T,) int32 — start mod chunk
    tile_span: torch.Tensor      # (T,) int32 — phi + count (0 if empty)
    grad_base: torch.Tensor      # (T,) int32 — gradient-space region base
    dropped_pairs: torch.Tensor  # () int32 — budget + capacity overflow
    # Gradient map (``with_grad_map=True`` only):
    dest_of_exp: Optional[torch.Tensor] = None   # (budget,) int32 — exp pair → gradient slot, ~j if dropped
    exp_offsets: Optional[torch.Tensor] = None   # (N,) int32 — rank r's pairs at [off, off+cnt)
    exp_counts: Optional[torch.Tensor] = None    # (N,) int32 — indexed by depth rank
    exp_rank: Optional[torch.Tensor] = None      # (budget,) int32 — depth rank of exp pair j, −1 past the total

    @property
    def pair_budget(self) -> int:
        return self.pair_splat.shape[0]


_log = get_logger("binning")

# Test hook: the SAT cull claims image-exactness, so a test may render with
# it force-disabled and assert equality.  It only removes exact-zero pairs.
_SAT_CULL_ENABLED = True

# Above this many splats the SAT cull is skipped.  Read from the same
# environment variable, with the same default, as the JAX package reads it,
# so both packages bin the same pairs at every size and setting.
_SAT_CULL_MAX_N = int(os.environ.get("GSPLAT_SAT_MAX_N", 4_194_304))


def _warn_dropped(dropped) -> None:
    d = int(dropped)
    if d > 0:
        _log.warning_once(
            f"pair budget/tile capacity exceeded — dropped {format_count(d)} "
            "farthest (tile, splat) pairs; raise RenderConfig.pairs_per_splat "
            "or tile_capacity",
            key="dropped_pairs",
        )
    else:
        _log.reset_once("dropped_pairs")


def warn_exchange_dropped(dropped) -> None:
    """Warn once while the sharded renderer's strip exchange drops splat
    columns (a host read); re-arm when it clears."""
    d = int(dropped)
    if d > 0:
        _log.warning_once(
            f"strip-exchange bucket overflow — dropped {format_count(d)} "
            "splat columns; raise RenderConfig.strip_exchange_factor",
            key="strip_exchange_dropped",
        )
    else:
        _log.reset_once("strip_exchange_dropped")


@dataclasses.dataclass(frozen=True)
class RenderStats:
    """Overflow counters carried out of a render as device tensors; reading
    them (``int(...)``, :func:`report_stats`) is the host synchronisation.

    * ``dropped_pairs`` — (tile, splat) pairs truncated by the pair budget
      or a tile's capacity (farthest-first).
    * ``exchange_dropped`` — splat columns dropped by strip-exchange bucket
      overflow in the sharded renderer (``parallel/render_sharded.py``;
      ``None`` for a single-device render).
    """

    dropped_pairs: torch.Tensor                       # () int32
    exchange_dropped: Optional[torch.Tensor] = None   # () int32 or None

    def any_dropped_host(self) -> bool:
        """Host-side: True if any counter is nonzero (blocks on the value)."""
        d = int(self.dropped_pairs)
        e = int(self.exchange_dropped) if self.exchange_dropped is not None else 0
        return d > 0 or e > 0


def report_stats(stats: "RenderStats", config: RenderConfig = None) -> None:
    """Host-side overflow reporting: warn once per condition while it holds,
    re-arm when it clears.  Reads the counters to the host."""
    if config is not None and not config.warn_on_drop:
        return
    _warn_dropped(stats.dropped_pairs)
    if stats.exchange_dropped is not None:
        warn_exchange_dropped(stats.exchange_dropped)


def warn_if_dropped(binned: "BinnedPairs", config: RenderConfig) -> None:
    """Surface ``dropped_pairs`` of a render (a host read); no-op when
    ``config.warn_on_drop`` is False, and while the stream is captured into a
    CUDA graph, where a host read is illegal (the JAX package's counterpart
    is an asynchronous callback that never blocks).  A captured render
    reports its counter through ``with_stats=True``: the caller reads it
    after a replay, or defers the read to its next call as
    ``SceneRegistry`` and the captured training step do."""
    if not config.warn_on_drop:
        return
    d = binned.dropped_pairs
    if d.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    _warn_dropped(d)


def pair_pad_size(budget: int, chunk: int) -> int:
    """Static padded pair-array length: the last tile's final chunk may read
    past ``budget`` (``base + ceil(span/chunk)·chunk ≤ budget + chunk``)."""
    return -(-budget // chunk) * chunk + chunk


def grad_pad_size(budget: int, num_tiles: int, chunk: int) -> int:
    """Static size of the gradient address space: per tile the region wastes
    at most ``φ + (chunk−1)`` slots beyond its raw count, and Σ raw ≤ budget."""
    return -(-(budget + num_tiles * 2 * (chunk - 1)) // chunk) * chunk + chunk


def sat_flags(n: int, width: int, height: int, config: RenderConfig) -> Tuple[bool, bool]:
    """``(sat_cull, rho_ok)`` of a binning of ``n`` splats.

    Exact-coverage pair cull (hard-cutoff beauty pass only): the AABB
    expansion overcounts tiles at a *rotated* quad's corners.  A
    separating-axis test of the tile's pixel-center rect against the
    ±QUAD_EXTENT parallelogram (the compositor's ``inside`` mask support)
    culls pairs that cannot contain a nonzero pixel — image-exact.  Skipped
    in wireframe mode and soft mode (no inside mask), and above
    ``GSPLAT_SAT_MAX_N`` splats.  ``rho_ok``: the cull is tightened to the
    opacity's discard radius where the JAX package's packed operand row has
    room for its 8-bit threshold."""
    nty, ntx = tile_grid(width, height, config.tile_h, config.tile_w)
    num_tiles = nty * ntx
    sat_cull = (
        _SAT_CULL_ENABLED
        and (not config.soft_cutoff)
        and (not config.wireframe)
        and n <= _SAT_CULL_MAX_N
    )
    bits_nx = ntx.bit_length()
    packed_ok = (num_tiles << bits_nx) < 2**31
    rho_ok = packed_ok and ((num_tiles << (bits_nx + 8)) < 2**31) and sat_cull
    return sat_cull, rho_ok


def gather_frame(fields: torch.Tensor, order: torch.Tensor, width: int, height: int,
                 config: RenderConfig, differentiable: bool = False) -> FrameGlue:
    """The compositor's payload and the binning's operands of a frame, in
    depth order (``kernels.frame_glue.gather_payload``): ``fields`` is the
    sanitized, quantized ``(16, N)`` matrix in storage order, ``order`` the
    depth permutation.  ``differentiable``: the float32 rows that
    ``composite_splats_diff`` reads, with the gradient going back to
    ``fields`` (``kernels.frame_glue.GatherPayload``).  Bin with
    ``bin_splats(None, ..., operands=...)``."""
    _, rho_ok = sat_flags(fields.shape[-1], width, height, config)
    if differentiable:
        return kglue.gather_payload_diff(fields, order, width, height, config, rho_ok)
    return kglue.gather_payload(fields, order, width, height, config, rho_ok)


def count_pairs(
    sorted_projected: ProjectedSplats,
    width: int,
    height: int,
    config: RenderConfig,
    row_offset: int = 0,
    col_offset: int = 0,
) -> torch.Tensor:
    """Exact (tile, splat) pair count for one frame — the cheap counting pass
    behind ``tune_pair_budget`` (bbox math + one reduction; no expansion,
    sort, or pair arrays).  A 0-dim int32 tensor on the fields' device."""
    counts, _, _, _ = _tile_extents(
        sorted_projected.fields, width, height, config, int(row_offset), int(col_offset)
    )
    return torch.sum(counts, dtype=torch.int32)


def bin_splats(
    sorted_projected: ProjectedSplats,
    width: int,
    height: int,
    config: RenderConfig,
    row_offset: int = 0,
    with_tiles: bool = True,
    with_grad_map: bool = False,
    order: torch.Tensor = None,
    budget: int = None,
    col_offset: int = 0,
    operands: BinOperands = None,
) -> BinnedPairs:
    """Bin sanitized projected splats into tiles.

    Depth ordering comes in one of two forms:
      * ``order=None`` — the splats MUST already be in ascending
        camera-distance order (the compositing order contract);
      * ``order`` = the depth permutation — the fields stay in **storage
        order**, only the small per-splat binning operands are reordered
        through it, and ``pair_splat`` then holds *storage* indices.  The
        pair sequence is identical either way.

    ``row_offset`` / ``col_offset``: first tile row / column of this screen
    region, in tiles (sharded rendering; 0 for a full frame).

    ``budget``: overrides ``config.pair_budget(n)``.

    ``operands``: the per-rank binning operands of the frame, as
    :func:`gather_frame` wrote them beside the payload (``render_cuda``'s
    frame, with a gradient or without); then ``sorted_projected`` is not
    read and may be None, and ``order`` only maps ``pair_splat`` to storage
    indices.
    """
    i32 = torch.int32
    if operands is None:
        f = sorted_projected.fields
        dev = f.device
        n = sorted_projected.count
    else:
        dev = operands.counts.device
        n = operands.counts.shape[0]
    nty, ntx = tile_grid(width, height, config.tile_h, config.tile_w)
    num_tiles = nty * ntx
    if budget is None:
        budget = config.pair_budget(n)
    chunk = config.chunk
    p_pad = pair_pad_size(budget, chunk)
    if n == 0:
        zt = torch.zeros((num_tiles,), dtype=i32, device=dev)
        return BinnedPairs(
            pair_splat=torch.zeros((p_pad,), dtype=i32, device=dev),
            pair_tile=torch.full((p_pad,), num_tiles, dtype=i32, device=dev) if with_tiles else None,
            tile_start=torch.full((num_tiles,), budget, dtype=i32, device=dev),
            tile_count=zt, tile_base=zt.clone(), tile_phi=zt.clone(), tile_span=zt.clone(),
            grad_base=zt.clone(),
            dropped_pairs=torch.zeros((), dtype=i32, device=dev),
            # every expansion pair is a dropped one: ~j, rank −1
            dest_of_exp=~torch.arange(budget, dtype=i32, device=dev) if with_grad_map else None,
            exp_offsets=torch.zeros((0,), dtype=i32, device=dev) if with_grad_map else None,
            exp_counts=torch.zeros((0,), dtype=i32, device=dev) if with_grad_map else None,
            exp_rank=torch.full((budget,), -1, dtype=i32, device=dev) if with_grad_map else None,
        )
    row_offset = int(row_offset)
    col_offset = int(col_offset)
    sat_cull, rho_ok = sat_flags(n, width, height, config)
    if operands is None:
        ops = kglue.tile_operands(f, width, height, config, row_offset, col_offset, rho_ok, f[0:6])
        if order is not None:
            # only the small per-splat operands go through the permutation
            ops = BinOperands(
                counts=ops.counts[order], nx=ops.nx[order], tile0=ops.tile0[order],
                thr_q=ops.thr_q[order] if rho_ok else None,
                quad=ops.quad[:, order] if sat_cull else ops.quad,
            )
    else:
        ops = operands
    counts_d = ops.counts

    # Ragged → static: pair k belongs to the (depth-ranked) splat whose
    # inclusive prefix sum first exceeds k.  Ranks ascend with distance, so
    # truncation at the budget drops only the farthest splats' pairs.
    # Computed via scatter-max of (rank+1) at each rank's offset followed by
    # a prefix max — two linear passes.  Zero-count ranks share their offset
    # with the next non-empty rank, whose larger id wins the max.
    cum = scan_i32(counts_d.contiguous(), "add")
    cum_last = cum[-1]
    offsets, marks = kglue.mark_owners(cum, counts_d, budget)
    smax = scan_i32(marks[:budget], "max")

    # Per-pair expansion, exact-coverage cull and sort key (one kernel).
    # One sort by tile then groups pairs per tile while preserving the global
    # front-to-back order within each tile.  (tile, rank) is packed into a
    # single int32 key when the bit budget allows.  Keys of valid pairs are
    # unique (a splat touches a tile at most once), so stability is moot for
    # them; ranks ascend with depth so ascending key order IS front-to-back.
    # Invalid pairs share keys (sentinel tile × spread rank), and with the
    # gradient map the expansion index rides through the sort as its
    # permutation: the sort is then stable, so that ``dest_of_exp`` of
    # dropped pairs equals the JAX package's (whose sort is stable).
    pk = kglue.expand_pairs(smax, cum, offsets, ops, budget, num_tiles, ntx, config, row_offset, col_offset,
                            sat_cull, rho_ok, with_grad_map)
    spread_mask = kglue.spread_mask(n)
    tile_ids = torch.arange(num_tiles + 1, dtype=i32, device=dev)
    bits_r = kglue.rank_bits(n)
    eidx_sorted = None
    if pk.key is not None:
        if with_grad_map:
            key_sorted, eidx_sorted = torch.sort(pk.key, stable=True)
        else:
            key_sorted = torch.sort(pk.key).values
        tile_sorted = key_sorted >> bits_r
        rank_sorted = key_sorted & ((1 << bits_r) - 1)
        starts = torch.searchsorted(
            key_sorted, tile_ids << bits_r, right=False, out_int32=True
        )
    else:  # 2^23-scale scenes on huge tile grids: stable two-array sort
        tile_sorted, eidx_sorted = torch.sort(pk.tile, stable=True)
        rank_sorted = pk.rank[eidx_sorted]
        starts = torch.searchsorted(tile_sorted, tile_ids, right=False, out_int32=True)
    # pair → payload column: storage index (through ``order``) so the
    # compositor reads the unsorted field matrix directly.
    if order is not None:
        splat_sorted = order[rank_sorted.long()].to(i32)
    else:
        splat_sorted = rank_sorted
    sb = starts[:-1]
    raw_count = starts[1:] - sb
    tile_count = torch.clamp(raw_count, max=config.tile_capacity)

    # Unaligned-segment descriptors — O(T) math, no pair re-layout.
    phi = sb % chunk
    base = sb - phi
    span = torch.where(tile_count > 0, phi + tile_count, 0)

    tail = torch.arange(p_pad - budget, dtype=i32, device=dev) & spread_mask
    pair_splat = torch.cat([splat_sorted, torch.clamp(tail, max=n - 1)])
    pair_tile = None
    if with_tiles:
        pair_tile = torch.cat(
            [tile_sorted, torch.full((p_pad - budget,), num_tiles, dtype=i32, device=dev)]
        )

    # Gradient address space: tile t's exclusive region starts at
    # grad_base[t], sized ceil((φ + raw)/chunk)·chunk from the RAW count, so
    # the per-tile shift grad_base[t] + φ[t] − start[t] stays monotone
    # non-decreasing (the backward's per-pair broadcast relies on it).
    gpad_t = torch.where(
        raw_count > 0,
        torch.div(phi + raw_count + (chunk - 1), chunk, rounding_mode="floor") * chunk,
        0,
    )
    grad_base = torch.cat(
        [torch.zeros((1,), dtype=i32, device=dev), torch.cumsum(gpad_t, 0, dtype=i32)]
    )[:-1]

    dest_of_exp = None
    exp_rank = None
    if with_grad_map:
        # Per-sorted-pair segment descriptors without per-pair gathers:
        # scatter each tile's descriptor at its segment start and take the
        # prefix max.  Both scattered value sequences are monotone
        # non-decreasing in tile id (the shift: see above; capped ends:
        # starts[t+1] ≥ starts[t] + tile_count[t]), so ties at shared start
        # positions (empty tiles) resolve to the owning (largest) tile and
        # the running max reproduces the piecewise-constant per-pair
        # descriptor exactly.  Starts equal to ``budget`` (tiles past the
        # last pair) land in one extra slot that is cut off again.
        sb_long = sb.long()
        pair_idx = torch.arange(budget, dtype=i32, device=dev)

        def seg_desc(values):
            m = torch.zeros((budget + 1,), dtype=i32, device=dev)
            m.scatter_reduce_(0, sb_long, values, "amax", include_self=True)
            return scan_i32(m[:budget].contiguous(), "max")

        delta = seg_desc(grad_base + phi - sb)  # sorted position → gradient slot
        cap_end = seg_desc(sb + tile_count)     # capped segment end
        keep = pair_idx < cap_end               # capacity + sentinel pairs
        # A dropped pair carries the bitwise-not of its own expansion index
        # (negative, so told apart by its sign).
        dest = torch.where(keep, pair_idx + delta, ~eidx_sorted.to(i32))
        # ``eidx_sorted`` is a permutation of arange(budget): one scatter
        # inverts it (the JAX package sorts it back, scatters being slow on
        # its target).
        dest_of_exp = torch.empty((budget,), dtype=i32, device=dev)
        dest_of_exp[eidx_sorted] = dest
        # Depth rank of each expansion pair (−1 beyond the real pair count).
        exp_rank = pk.exp_rank

    dropped = torch.clamp(cum_last - budget, min=0) + torch.sum(
        raw_count - tile_count, dtype=i32
    )
    return BinnedPairs(
        pair_splat=pair_splat,
        pair_tile=pair_tile,
        tile_start=sb,
        tile_count=tile_count,
        tile_base=base,
        tile_phi=phi,
        tile_span=span,
        grad_base=grad_base,
        dropped_pairs=dropped.to(i32),
        dest_of_exp=dest_of_exp,
        exp_rank=exp_rank,
        exp_offsets=offsets if with_grad_map else None,
        exp_counts=counts_d if with_grad_map else None,
    )
