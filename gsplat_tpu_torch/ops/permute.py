"""Column permutation with a gather-only backward (counterpart of
``gsplat_tpu.ops.permute``).

``x[:, perm]`` under plain autograd goes back as an ``index_put`` with
accumulation (a scatter-add).  For a *permutation* the adjoint is itself a
permutation, ``dx = g[:, inv_perm]``: one small scatter builds the inverse
index and one multi-row gather moves the gradient.  Used for the global depth
sort (``ops/rasterize_tiles.sort_by_depth``).

``diff_rows`` declares that only rows ``< diff_rows`` of the output ever
receive non-zero cotangents (for the splat pipeline: rows 0..9 feed the
differentiable compositor; the depth key, validity and footprint rows feed
only the sort and the binning).  The backward gather then touches only those
rows and pads the rest with zeros.
"""

from __future__ import annotations

import torch


class _PermuteCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, diff_rows):
        ctx.save_for_backward(perm)
        ctx.diff_rows = diff_rows
        return x[:, perm]

    @staticmethod
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        n = perm.shape[0]
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)
        rows = g.shape[0]
        diff_rows = ctx.diff_rows
        if diff_rows is not None and diff_rows < rows:
            d = torch.cat(
                [g[:diff_rows][:, inv], g.new_zeros((rows - diff_rows, n))], dim=0
            )
        else:
            d = g[:, inv]
        return d, None, None


def permute_cols(x: torch.Tensor, perm: torch.Tensor, diff_rows: int = None) -> torch.Tensor:
    """``x[:, perm]`` where ``perm`` is a permutation of ``arange(x.shape[1])``."""
    return _PermuteCols.apply(x, perm, diff_rows)
