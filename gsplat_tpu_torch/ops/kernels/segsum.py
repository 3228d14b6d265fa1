"""Segmented row sum: per-pair gradient sums → per-splat sums.

``segsum_by_splat`` replaces the TPU kernel ``gsplat_tpu/ops/pallas/segsum.py``
(``_segsum_kernel``, entry ``segsum_by_splat``) with the hand-written CUDA
kernel in ``csrc/segsum.cu``.  What it computes is the same: every depth
rank's pairs are a contiguous window ``[exp_offsets[r], +exp_counts[r])`` of
the expansion order, and the nine moment sums of those pairs are summed into
column ``r`` (or ``order[r]``) of a ``(9, N)`` matrix.

What differs.  The TPU path first gathered the gradient address space into
two expansion-order matrices through ``dest_of_exp`` and then reduced them
with a one-hot matrix product (with the operand split in three bf16 terms and
the rank carried as a float row).  Here the readback is part of the function:
the kernel reads ``dest_of_exp[j]`` itself, skips dropped pairs (negative
entries: exact zero), fetches that row of the gradient space and, in packed
mode, unpacks word 6 — the expansion-order matrices never exist in device
memory, and the reduction is a plain segmented sum over the window.

The gradient space is pair-major: ``(G, 8)`` int32 packed, ``(G, 9)`` float32
otherwise, one row a pair slot.  What bounds the kernel: bytes — one
scattered 32-byte sector a kept pair in packed mode (two 16-byte loads), two
sectors for the 36-byte float32 row, against one add per value; beside them
``dest_of_exp``, the windows and the ``(9, N)`` output.  (Before the
pair-major layout every pair cost eight or nine sectors, one a row.)

The summation order within a splat is fixed (a group of four lanes strides the
window, each lane adding in ascending pair order, then a fixed two-step
butterfly), so two runs give bit-equal sums.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, register
from .composite import G_ROWS_PACKED, N_SUMS, unpack2

# Wrapper calls that launched the kernel.
launches = 0
register("segsum", __name__, "launches", kernel="segsum_kernel")

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("segsum")
        p = ctypes.c_void_p
        lib.gsplat_segsum.argtypes = [
            p, ctypes.c_int, p, ctypes.c_int, p, p, p, p, ctypes.c_int, p,
        ]
        lib.gsplat_segsum.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(grad_space, dest_of_exp, exp_offsets, exp_counts, order, packed):
    words, dt = (G_ROWS_PACKED, torch.int32) if packed else (N_SUMS, torch.float32)
    if grad_space.dim() != 2 or grad_space.shape[1] != words or grad_space.dtype != dt:
        raise TypeError(
            f"grad_space: expected a pair-major (G, {words}) {dt} matrix, "
            f"got {tuple(grad_space.shape)} {grad_space.dtype}"
        )
    if not grad_space.is_contiguous():
        raise ValueError("grad_space must be contiguous (one row a pair slot)")
    n = exp_offsets.shape[0]
    named = [("dest_of_exp", dest_of_exp, None), ("exp_offsets", exp_offsets, n), ("exp_counts", exp_counts, n)]
    if order is not None:
        named.append(("order", order, n))
    for name, a, length in named:
        if a.dim() != 1 or (length is not None and a.shape[0] != length):
            raise TypeError(f"{name}: expected a 1-D tensor of length {length}, got {tuple(a.shape)}")
        if a.device != grad_space.device:
            raise ValueError("all segment-sum inputs must live on one device")
    for name, a, _ in named[:3]:
        if a.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {a.dtype}")


def segsum_by_splat_plain(
    grad_space: torch.Tensor,
    dest_of_exp: torch.Tensor,
    exp_offsets: torch.Tensor,
    exp_counts: torch.Tensor,
    order: torch.Tensor = None,
    packed: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version: gather the kept pairs' rows, find each
    expansion pair's rank from the windows' ends, and ``index_add_`` by rank."""
    _check(grad_space, dest_of_exp, exp_offsets, exp_counts, order, packed)
    dev = grad_space.device
    n = exp_offsets.shape[0]
    budget = dest_of_exp.shape[0]
    out = torch.zeros((N_SUMS, n), dtype=torch.float32, device=dev)
    if n == 0 or budget == 0:
        return out
    keep = dest_of_exp >= 0
    rows = grad_space[torch.where(keep, dest_of_exp, 0).long()]
    if packed:
        cg, cb = unpack2(rows[:, 6:7])
        rows = torch.cat([rows[:, 0:6].view(torch.float32), cg, cb, rows[:, 7:8].view(torch.float32)], dim=1)
    # Rank of expansion pair j: the number of windows that end at or before j
    # (the ends are the inclusive prefix sum of the counts).
    ends = exp_offsets + exp_counts
    j = torch.arange(budget, dtype=torch.int32, device=dev)
    rank = torch.searchsorted(ends, j, right=True)
    live = keep & (rank < n)
    out.index_add_(1, rank[live], rows[live].t())
    if order is not None:
        storage = torch.empty_like(out)
        storage[:, order.long()] = out
        return storage
    return out


def segsum_by_splat(
    grad_space: torch.Tensor,
    dest_of_exp: torch.Tensor,
    exp_offsets: torch.Tensor,
    exp_counts: torch.Tensor,
    order: torch.Tensor = None,
    packed: bool = False,
) -> torch.Tensor:
    """Sum the gradient-space rows of every splat's pairs.

    Args:
      grad_space: what :func:`composite_bwd` returned — pair-major ``(G, 9)``
        float32, or with ``packed`` ``(G, 8)`` int32; contiguous.
      dest_of_exp: ``(budget,)`` int32 — gradient-space row of expansion
        pair ``j``; negative for a dropped pair, which adds nothing.
      exp_offsets / exp_counts: ``(N,)`` int32, indexed by depth rank — rank
        ``r`` owns expansion pairs ``[off, off + cnt)``, cut at ``budget``.
      order: ``(N,)`` integer depth permutation (storage index of rank ``r``)
        or None.

    Returns ``(9, N)`` float32 — rows 0..7 the moment sums, row 8 Σdp2 —
    indexed by depth rank, or by storage index when ``order`` is given.  A
    rank without pairs gets exact zeros.

    On CUDA tensors this launches the kernel (or raises); on CPU tensors it
    takes :func:`segsum_by_splat_plain`.
    """
    global launches
    _check(grad_space, dest_of_exp, exp_offsets, exp_counts, order, packed)
    if not grad_space.is_cuda:
        return segsum_by_splat_plain(grad_space, dest_of_exp, exp_offsets, exp_counts, order, packed)
    n = exp_offsets.shape[0]
    out = torch.empty((N_SUMS, n), dtype=torch.float32, device=grad_space.device)
    if n == 0:
        return out
    if order is not None:
        order = order.to(torch.int32)
    for name, a in (("dest_of_exp", dest_of_exp), ("exp_offsets", exp_offsets),
                    ("exp_counts", exp_counts), ("order", order)):
        if a is not None and not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # A packed row is one 32-byte sector only from a 32-byte aligned base (the
    # caching allocator aligns to 512 bytes).
    if packed and grad_space.data_ptr() % 32:
        raise ValueError("a packed grad_space must start on a 32-byte boundary")
    lib = _library()
    with torch.cuda.device(grad_space.device):
        err = lib.gsplat_segsum(
            grad_space.data_ptr(), int(packed),
            dest_of_exp.data_ptr(), dest_of_exp.shape[0],
            exp_offsets.data_ptr(), exp_counts.data_ptr(),
            order.data_ptr() if order is not None else None,
            out.data_ptr(), n, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gsplat_segsum launch failed: CUDA error {err}")
    launches += 1
    return out
