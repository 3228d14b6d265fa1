"""Exact 1-D int32 prefix scans (sum / max) for the binning glue.

``scan_i32`` replaces the TPU kernel ``gsplat_tpu/ops/pallas/scan.py``
(``_scan_kernel``; entries ``cumsum_i32`` / ``cummax_i32``) with the
hand-written CUDA kernel in ``csrc/scan.cu``: a reduce-then-scan in three
launches (per-tile totals, one block scanning the totals, per-tile scan
seeded with its predecessor's total).  The TPU kernel's single sequential
program with a carried block total is not carried over — on this card blocks
run in parallel and nothing carries between them.

What bounds it: bytes — 8 per element at the least (read once, write once);
the three-launch design reads the input twice, 12 per element.  Integer add
and max are exact in any association order, so the kernel equals
``torch.cumsum`` / ``torch.cummax`` bit for bit.

The wrapper launches the kernel for every CUDA tensor, whatever its length
(the JAX wrapper's "small arrays go to ``jnp.cumsum``" branch was a
compile-cost trick), and takes the plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KINDS = ("add", "max")

# Wrapper calls that launched the kernel (one count per scan, which is three
# kernel launches on the card).
launches = 0
# The same count, split by kind.
launches_by_kind = {"add": 0, "max": 0}

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("scan")
        lib.gsplat_scan_tile.argtypes = []
        lib.gsplat_scan_tile.restype = ctypes.c_int
        lib.gsplat_scan_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.gsplat_scan_i32.restype = ctypes.c_int
        _lib = lib
    return _lib


def scan_i32_plain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain PyTorch version: inclusive int32 prefix sum or prefix max."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "add":
        return torch.cumsum(x, 0, dtype=torch.int32)
    if x.numel() == 0:
        return x.clone()
    return torch.cummax(x, 0).values


def scan_i32(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Inclusive scan of a contiguous 1-D int32 tensor of any length ≥ 0.

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor it
    takes :func:`scan_i32_plain`."""
    global launches
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if x.dtype != torch.int32 or x.dim() != 1:
        raise TypeError(f"scan_i32 takes a 1-D int32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not x.is_cuda:
        return scan_i32_plain(x, kind)
    if not x.is_contiguous():
        raise ValueError("scan_i32 takes a contiguous tensor")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    lib = _library()
    tile = lib.gsplat_scan_tile()
    with torch.cuda.device(x.device):
        # Scratch may go out of scope before the kernels ran: the caching
        # allocator hands a freed block out again only in this stream's order.
        totals = torch.empty((-(-n // tile),), dtype=torch.int32, device=x.device)
        err = lib.gsplat_scan_i32(
            x.data_ptr(), out.data_ptr(), totals.data_ptr(), n,
            KINDS.index(kind), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gsplat_scan_i32 launch failed: CUDA error {err}")
    launches += 1
    launches_by_kind[kind] += 1
    return out
