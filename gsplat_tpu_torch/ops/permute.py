"""Column permutation (counterpart of ``gsplat_tpu.ops.permute``).

The forward is plain indexing.  The JAX package pairs it with a gather-only
backward (the adjoint of a permutation is the inverse permutation); that
backward belongs to the training slice of the port.
"""

from __future__ import annotations

import torch


def permute_cols(x: torch.Tensor, perm: torch.Tensor, diff_rows: int = None) -> torch.Tensor:
    """``x[:, perm]`` where ``perm`` is a permutation of ``arange(x.shape[1])``.
    ``diff_rows`` is accepted for signature parity (it only shapes the
    backward)."""
    return x[:, perm]
