"""Process mesh + multi-process initialisation on ``torch.distributed``
(counterpart of ``gsplat_tpu.parallel.mesh``).

One process a rank.  The ranks form a (dp, sp) grid, rank = a·sp + b for
batch row a and splat column b — the JAX package's
``devices.reshape(batch, splat)``: splats and image tile rows are sharded
over ``sp`` (each ``sp`` group is one render), camera batches over ``dp``.
Each rank runs on one device: the card ``cuda:(rank % device_count)`` unless
the caller names another (the CPU, for tests).

The process-group backend is the caller's choice — ``"nccl"`` (one GPU a
rank) or ``"gloo"`` (the CPU; also ranks sharing one card) — and nothing
switches to another on failure.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

SPLAT_AXIS = "sp"   # splats + image tile rows
BATCH_AXIS = "dp"   # camera batch (gradient mean)


def initialize_distributed(
    backend: str = "nccl",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> bool:
    """Join the process group (no-op when single-process).

    With ``init_method`` omitted it reads the standard environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) and does
    nothing when ``MASTER_ADDR`` is unset.  Safe to call unconditionally at
    program start.  With ``"nccl"`` the rank's card becomes the current
    device first (``cuda:(LOCAL_RANK or rank) % device_count``).
    ``timeout``: how long a collective waits for the other ranks (the
    backend's default when None).  Returns whether a process group is up.
    """
    if dist.is_initialized():
        return True
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            return False
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        # NCCL's collectives and point-to-point ops run on the current device
        torch.cuda.set_device(_default_device(int(os.environ.get("LOCAL_RANK", rank))))
    extra = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size, rank=rank, **extra)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (dp, sp) grid and its two process groups
    (``None`` for an axis of size 1: its collectives are identities)."""

    rank: int
    dp: int
    sp: int
    device: torch.device
    sp_group: Optional[object] = None
    dp_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {BATCH_AXIS: self.dp, SPLAT_AXIS: self.sp}

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    def group(self, axis: str):
        return {SPLAT_AXIS: self.sp_group, BATCH_AXIS: self.dp_group}[axis]

    def index(self, axis: str) -> int:
        return {SPLAT_AXIS: self.sp_index, BATCH_AXIS: self.dp_index}[axis]


def _default_device(rank: int) -> torch.device:
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def make_mesh(batch: int = 1, splat: Optional[int] = None, device=None) -> Mesh:
    """Build the (dp, sp) mesh over all ranks; ``splat`` defaults to the
    world size over ``batch``.  Every rank must call it (the groups are made
    collectively).  ``device=None`` means this rank's card
    (``cuda:(LOCAL_RANK or rank) % device_count``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if splat is None:
        if world % batch != 0:
            raise ValueError(f"{world} ranks not divisible by batch axis {batch}")
        splat = world // batch
    if batch * splat != world:
        raise ValueError(f"mesh {batch}x{splat} != {world} ranks")
    sp_group = dp_group = None
    # new_group is collective: every rank makes every group, in one order.
    if splat > 1:
        for a in range(batch):
            g = dist.new_group(ranks=[a * splat + b for b in range(splat)])
            if rank // splat == a:
                sp_group = g
    if batch > 1:
        for b in range(splat):
            g = dist.new_group(ranks=[a * splat + b for a in range(batch)])
            if rank % splat == b:
                dp_group = g
    if device is None:
        device = _default_device(int(os.environ.get("LOCAL_RANK", rank)))
    device = torch.device(device)
    return Mesh(rank=rank, dp=batch, sp=splat, device=device, sp_group=sp_group, dp_group=dp_group)


def splat_mesh(num: Optional[int] = None, device=None) -> Mesh:
    """1-D mesh over the splat/tile axis only (pure render scaling).
    ``num``, when given, must be the world size: a process is a rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num is not None and num != world:
        raise ValueError(f"splat_mesh({num}) over {world} ranks: start one process a rank")
    return make_mesh(batch=1, splat=world, device=device)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
