"""Render configuration.

The port's own copy of ``gsplat_tpu.utils.config.RenderConfig``: same fields,
same defaults, same validation (``tests/test_torch_config_models.py`` compares
the two dataclasses field by field), so a config travels unchanged between
the two packages.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (frozen and hashable)."""

    # SH evaluation order 0..3.
    sh_order: int = 3

    # Debug mode: replace the DC base color with 0.5 grey so only the
    # directional SH bands show.
    only_sh: bool = False

    # Warn (once, via the scene logger) when the pair budget or a tile's
    # capacity truncates pairs.  Reading the counter is a host
    # synchronisation at the end of the frame; set False to keep ``render``
    # free of host reads.
    warn_on_drop: bool = True

    # Tile size of the binned rasterizers.  The CUDA compositor takes 32×32
    # only (one block per tile, 256 threads × 4 pixels).
    tile_h: int = 32
    tile_w: int = 32

    # Average (tile, splat) pairs budgeted per splat: the pair arrays have
    # pairs_per_splat·N entries and every binning pass scales with them.
    # Overflow drops the *farthest* splats' pairs with a reported count.
    pairs_per_splat: float = 3.0

    # Per-tile cap on composited splats (front to back; overflow drops the
    # farthest).  Must be a multiple of the compositing chunk size.
    tile_capacity: int = 4096

    # Compositing chunk: a tile's pair segment is walked in steps of this
    # many pairs, and the tile-level early stop is tested once per step.
    chunk: int = 128

    # Upper clamp on per-fragment alpha (values < 1 keep the backward pass's
    # transmittance rewind finite; 3DGS uses 0.99).
    max_alpha: float = 0.99

    # Stop compositing a tile once every pixel's transmittance is at or
    # below this (0.0 for exact-parity tests).
    transmittance_eps: float = 1e-4

    # Global splat budget.
    max_splats: int = 1 << 23

    # Hard semantics discard fragments below α = 1/255 and outside the ±2
    # quad extent.  soft_cutoff=True drops both masks (fully differentiable).
    soft_cutoff: bool = False

    # Rasterization payload precision.  "bfloat16" rounds the 10 compositor
    # payload rows to bf16 in every backend; "packed" keeps the geometry rows
    # (center, quad basis) f32, rounds only color+opacity to bf16 and lets
    # the kernel path bit-pack them pairwise ((r,g), (b,op)) into an 8-row
    # int32 payload.  The rounding is shared by all backends, so their images
    # agree under quantization.
    payload_dtype: str = "float32"

    # Wireframe debug mode: an opaque band on each splat's quad edge.
    wireframe: bool = False

    # Wireframe line half-width in pixels.
    line_px: float = 1.0

    # Per-strip pair-budget headroom for the sharded renderer.
    strip_budget_factor: float = 2.0

    # Strip-compacted payload exchange for the sharded renderer (0 = off):
    # each rank ships per strip at most factor·N_local splat columns.
    strip_exchange_factor: float = 0.0

    # Sharded-render tile assignment: "cyclic" (a 2-D interleave of tile rows
    # and columns) or "contiguous" strips of tile rows.
    row_assignment: str = "cyclic"

    # INTERNAL (set by the sharded renderer): global tile row of local tile
    # row ℓ is ``row_offset + ℓ·row_stride`` (likewise columns).
    row_stride: int = 1
    col_stride: int = 1

    # Depth-test compositing into a host scene.  Needs the
    # per-splat view-z payload row, which the 8-row packed payload has no
    # slot for.
    depth_test: bool = False

    # Exact pair budget override (0 = derive from pairs_per_splat·N).  Set by
    # ``tune_pair_budget`` after measuring the scene's real pair count.
    pair_budget_override: int = 0

    def pair_budget(self, n: int) -> int:
        if self.pair_budget_override > 0:
            return max(self.pair_budget_override, 8)
        return max(int(round(self.pairs_per_splat * n)), 8)

    def strip_pair_budget(self, n: int, n_strips: int) -> int:
        """Static per-strip budget for 1/``n_strips`` of the tile rows."""
        full = self.pair_budget(n)
        scaled = int(round(full * self.strip_budget_factor / max(n_strips, 1)))
        return max(min(full, scaled), 4 * self.chunk)

    def __post_init__(self):
        if not 0 <= self.sh_order <= 3:
            raise ValueError(f"sh_order must be in [0,3], got {self.sh_order}")
        if self.chunk % 8 != 0:
            raise ValueError("chunk must be a multiple of 8")
        if self.row_assignment not in ("cyclic", "contiguous"):
            raise ValueError(
                f"row_assignment must be 'cyclic' or 'contiguous', got "
                f"{self.row_assignment!r}"
            )
        if self.row_stride < 1 or self.col_stride < 1:
            raise ValueError("row/col_stride must be >= 1")
        if self.depth_test and self.payload_dtype == "packed":
            raise ValueError(
                "depth_test needs the view-z payload row; the 8-row packed "
                "payload has no slot for it — use payload_dtype='float32' "
                "or 'bfloat16'"
            )
        if self.payload_dtype == "packed" and self.chunk % 128 != 0:
            # Kept from the JAX package so a config valid in one package is
            # valid in the other.
            raise ValueError("packed payload requires chunk % 128 == 0")
        if self.tile_capacity % self.chunk != 0:
            raise ValueError("tile_capacity must be a multiple of chunk")
        if self.payload_dtype not in ("float32", "bfloat16", "packed"):
            raise ValueError(
                f"payload_dtype must be 'float32', 'bfloat16' or 'packed', "
                f"got {self.payload_dtype!r}"
            )
