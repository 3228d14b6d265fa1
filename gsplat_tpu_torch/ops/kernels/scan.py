"""Exact 1-D int32 prefix scans (sum / max) for the binning glue.

``scan_i32`` replaces the TPU kernel ``gsplat_tpu/ops/pallas/scan.py``
(``_scan_kernel``; entries ``cumsum_i32`` / ``cummax_i32``) with the
hand-written CUDA kernel in ``csrc/scan.cu``: a single-pass scan with
decoupled look-back, one launch a call.  Each block draws its tile from a
counter, publishes its tile's aggregate, looks back over its predecessors'
status words until it meets an inclusive prefix, and writes its tile.  The
TPU kernel's single sequential program with a carried block total is not
carried over — on this card blocks run in parallel.

What bounds it: bytes — 8 per element (read once, write once), which is
what the kernel moves.  Integer add and max are exact in any association
order, so the kernel equals ``torch.cumsum`` / ``torch.cummax`` bit for bit.

The scratch (the tile counter and one status word a tile) belongs to this
module, one int64 tensor per (device, stream), grown with ``torch.empty``:
every call passes a new epoch, and words of other epochs read as "not ready"
(see the source).  So a call enqueues one kernel and nothing else.  Two
consequences: a launch with its epoch baked in must not run twice, so a call
under CUDA graph capture raises; and when the epochs run out (after 2^31 - 2
calls) the scratch is zeroed once, with the device idle, before they start
again.

The wrapper launches the kernel for every CUDA tensor, whatever its length
(the JAX wrapper's "small arrays go to ``jnp.cumsum``" branch was a
compile-cost trick), and takes the plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KINDS = ("add", "max")
# Elements a tile of the kernel (1024 threads x 8), which sizes the scratch.
TILE = 8192

# Wrapper calls that launched the kernel (one kernel launch each).
launches = 0
# The same count, split by kind.
launches_by_kind = {"add": 0, "max": 0}

_KIND_CODE = {"add": 0, "max": 1}

_lib = None
# (device index, raw stream) -> int64 scratch: [counter, status of tile 0, ...]
_scratch = {}
_epoch = 0
_EPOCH_END = 2**31 - 1  # epochs run over [1, _EPOCH_END)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("scan")
        lib.gsplat_scan_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
        ]
        lib.gsplat_scan_i32.restype = ctypes.c_int
        lib.gsplat_scan_tile.argtypes = []
        lib.gsplat_scan_tile.restype = ctypes.c_int
        if lib.gsplat_scan_tile() != TILE:  # the scratch is sized here from TILE
            raise RuntimeError(f"csrc/scan.cu tiles {lib.gsplat_scan_tile()} elements, not {TILE}")
        _lib = lib
    return _lib


def scratch_words(n: int) -> int:
    """64-bit scratch words a scan of ``n`` elements needs: the counter and
    one status word a tile."""
    return 1 + -(-n // TILE)


def _scratch_for(device: int, stream: int, words: int) -> torch.Tensor:
    buf = _scratch.get((device, stream))
    if buf is None or buf.numel() < words:
        # Whatever the new block holds reads as "not ready" (the epoch), so
        # torch.empty is enough.  The old block may still be read by the
        # kernels queued before: the caching allocator hands it out again
        # only in this stream's order.
        buf = torch.empty((max(words, 2 * (0 if buf is None else buf.numel())),), dtype=torch.int64,
                          device=torch.device("cuda", device))
        _scratch[(device, stream)] = buf
    return buf


def _next_epoch() -> int:
    global _epoch
    if _epoch == _EPOCH_END - 1:
        # Every epoch has been used, so a word of an earlier call could carry
        # a coming call's tag.  Zeros carry epoch 0's, which no call has.
        for buf in _scratch.values():
            torch.cuda.synchronize(buf.device)
            buf.zero_()
            torch.cuda.synchronize(buf.device)
        _epoch = 0
    _epoch += 1
    return _epoch


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

    On a CUDA tensor this launches the kernel (or raises, also under CUDA
    graph capture: a replay would reuse the call's epoch); on a CPU tensor it
    takes :func:`scan_i32_plain`."""
    global launches
    code = _KIND_CODE.get(kind)
    if code is None:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if x.dtype != torch.int32 or x.dim() != 1:
        raise TypeError(f"scan_i32 takes a 1-D int32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not x.is_cuda:
        return scan_i32_plain(x, kind)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("scan_i32 cannot be captured in a CUDA graph: each launch needs an epoch of its own")
    if not x.is_contiguous():
        raise ValueError("scan_i32 takes a contiguous tensor")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    lib = _lib if _lib is not None else _library()
    dev = x.get_device()
    # The current stream as a raw handle, as inductor's generated code takes
    # it: torch.cuda.current_stream builds a Stream object first, a good part
    # of a caller's time for a scan of 1M elements.
    stream = torch._C._cuda_getCurrentRawStream(dev)
    scratch = _scratch_for(dev, stream, scratch_words(n))
    args = (x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, code, _next_epoch(), stream)
    if dev == torch.cuda.current_device():
        err = lib.gsplat_scan_i32(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.gsplat_scan_i32(*args)
    if err != 0:
        raise RuntimeError(f"gsplat_scan_i32 launch failed: CUDA error {err}")
    launches += 1
    launches_by_kind[kind] += 1
    return out
