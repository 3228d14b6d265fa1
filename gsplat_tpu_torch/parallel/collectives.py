"""The collectives of the sharded renderer and trainer over one mesh axis,
each a ``torch.distributed`` call (the JAX package writes them inline as
``jax.lax`` collectives inside ``shard_map``).

``group`` is a mesh axis's process group (``Mesh.group(axis)``); ``None``
means an axis of size 1, where every collective is the identity.

Differentiable where a gradient crosses the exchange, each with its own
transpose written out:

* :func:`all_gather` — blocks of every rank concatenated along a dimension;
  the backward is the gather's transpose: an all-to-all of the cotangent's
  blocks, then a **fixed-order sum over ranks** (rank 0 first), so
  gradients are deterministic and independent of the backend (no
  ``reduce_scatter``, which gloo may lack);
* :func:`gather_replicated` — the same gather for a result that every rank
  then consumes identically (the assembled frame): the backward keeps this
  rank's own block of the cotangent, since every rank holds the same one;
* :func:`all_to_all` — its own transpose;
* :func:`ppermute` — point-to-point sends (``batch_isend_irecv``) with zero
  fill where a rank receives nothing, as ``jax.lax.ppermute``; the transpose
  sends the cotangent back along the inverse pairs.

:func:`psum` / :func:`pmean` (``all_reduce``) carry counters, losses and the
batch-axis gradient mean; they take no part in autograd.

Gloo moves host tensors only: on a gloo group a CUDA tensor is staged through
host memory explicitly, chosen by the group's backend (never by catching an
error); on NCCL tensors go as they are.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the group's backend takes it: host memory on gloo."""
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return x.cpu()
    return x


def _gather_blocks(x: torch.Tensor, group) -> list:
    w = _wire(x, group)
    bufs = [torch.empty_like(w) for _ in range(group_size(group))]
    dist.all_gather(bufs, w, group=group)
    return [b.to(x.device) for b in bufs]


def _exchange_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """(d, ...) → (d, ...): block j goes to rank j; block i of the result is
    what rank i sent here."""
    w = _wire(x, group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return out.to(x.device)


def _sum_blocks(blocks: torch.Tensor) -> torch.Tensor:
    acc = blocks[0]
    for j in range(1, blocks.shape[0]):
        acc = acc + blocks[j]
    return acc


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, wire_dtype, replicated):
        ctx.group, ctx.dim, ctx.replicated = group, dim, replicated
        send = x if wire_dtype is None else x.to(wire_dtype)
        return torch.cat(_gather_blocks(send, group), dim=dim).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        parts = g.chunk(group_size(ctx.group), dim=ctx.dim)
        if ctx.replicated:
            grad = parts[group_rank(ctx.group)].contiguous()
        else:
            grad = _sum_blocks(_exchange_blocks(torch.stack(parts), ctx.group))
        return grad, None, None, None, None


def all_gather(x: torch.Tensor, group, dim: int = -1, wire_dtype: Optional[torch.dtype] = None):
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order.  ``wire_dtype``: the type the blocks travel in (``bfloat16`` for
    rows that are already bf16-representable: exact); the result and the
    cotangent are in ``x``'s type.  Backward: fixed-order sum of every
    rank's cotangent block (the rank consumers differ)."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim, wire_dtype, False)


def gather_replicated(x: torch.Tensor, group, dim: int = 0):
    """:func:`all_gather` for a result every rank consumes the same way:
    backward keeps this rank's block of the (replicated) cotangent."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim, None, True)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange_blocks(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange_blocks(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x``: (d, ...) with block j for rank j.  Returns (d, ...) whose block
    i is what rank i sent to this rank (``jax.lax.all_to_all`` with
    ``split_axis = concat_axis = 0``)."""
    if group is None:
        return x
    return _AllToAll.apply(x, group)


def _permute(x: torch.Tensor, group, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    me = group_rank(group)
    ranks = dist.get_process_group_ranks(group)
    w = _wire(x, group)
    out = torch.zeros_like(w)
    ops = []
    for src, dst in pairs:
        if src == me:
            ops.append(dist.P2POp(dist.isend, w, ranks[dst], group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs):
        ctx.group, ctx.pairs = group, pairs
        return _permute(x, group, pairs)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, [(dst, src) for src, dst in ctx.pairs]), None, None


def ppermute(x: torch.Tensor, group, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` from group rank ``src`` to ``dst`` for every ``(src, dst)``
    pair; a rank that receives nothing gets zeros (``jax.lax.ppermute``)."""
    if group is None:
        return torch.zeros_like(x)
    return _PPermute.apply(x, group, tuple(pairs))


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks (``all_reduce``); not differentiated."""
    if group is None:
        return x
    w = _wire(x.detach(), group).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(x.device)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over the group's ranks; not differentiated."""
    return psum(x, group) / group_size(group)
