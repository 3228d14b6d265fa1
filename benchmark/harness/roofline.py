"""Peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense, at the
700 W power limit) and a kernel's share of its roofline."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # outside the tensor cores, an FMA counted as two


def share(nbytes: float, flops: float, seconds: float):
    """The least time the card could take for ``nbytes`` moved and ``flops``
    done, as a percentage of ``seconds``; None when nothing was timed."""
    if not seconds or seconds <= 0.0:
        return None
    return 100.0 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) / seconds
