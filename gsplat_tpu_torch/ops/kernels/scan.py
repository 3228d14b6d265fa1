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

The scratch (the epoch of the last call, the tile counter, the count of
finished blocks and one status word a tile) belongs to this module, one
int64 tensor per (device, stream).  Every launch takes a new epoch from it on
the device, and words of earlier epochs read as "not ready"; the call's last
block stores the epoch back, and when the epochs run out (after 2^31 - 2
calls on a scratch, or at the end :func:`set_epoch_end` sets) zeroes the
scratch and starts again at epoch 1, all on the device (see the source).  So a call
enqueues one kernel and nothing else, and reads nothing from the host.  That
holds only if no word already carries a tag of a coming epoch, so the
scratch is allocated and grown with ``torch.zeros`` (epoch 0's tags, which
no call has), never ``torch.empty``: the caching allocator hands back blocks
this process freed, and an int32 array of small counts or offsets read as
64-bit words carries exactly the small epochs a young scratch uses next.
One memset a growth, none a call.

CUDA graphs.  Nothing of a launch is fixed on the host but pointers and
sizes, so a call may be captured and replayed: each replay takes a fresh
epoch from the scratch it captured, exactly as an eager call does.  A
capture uses the scratch of the capture stream (the current stream while it
captures), which an eager call on that stream must already have sized: a
capture allocates nothing here and raises if the scratch is missing or too
small (``gsplat_tpu_torch.graphs.capture`` makes that warm-up call on its
capture stream).  A replay then runs on the caller's stream and touches that
capture stream's scratch, never the caller's own.  That is safe because two
launches on one scratch never overlap: eager calls on the capture stream are
ordered with the replays by the owner of the graph (its stream waits), and
graphs that captured one scratch must replay in one stream's order, never
at the same time on two streams.  A scratch a capture has read is never
freed: a growth on its stream replaces it in the table for later calls and
keeps the old tensor alive for the graphs that hold its address.

The wrapper launches the kernel for every CUDA tensor, whatever its length
(the JAX wrapper's "small arrays go to ``jnp.cumsum``" branch was a
compile-cost trick), and takes the plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, register

KINDS = ("add", "max")
# Elements a tile of the kernel (1024 threads x 8), which sizes the scratch.
TILE = 8192

# Wrapper calls that launched the kernel (one kernel launch each); a graph
# that captured the call adds its launch on each replay (``gsplat_tpu_torch/graphs.py``).
launches = 0
# The same count, split by kind.
launches_by_kind = {"add": 0, "max": 0}
register("scan_i32", __name__, "launches", kernel="scan_kernel")
register("scan_i32_add", __name__, "launches_by_kind", keys=("add",))
register("scan_i32_max", __name__, "launches_by_kind", keys=("max",))

_KIND_CODE = {"add": 0, "max": 1}

_lib = None
# (device index, raw stream) -> int64 scratch: [last epoch, tile counter,
# finished blocks, status of tile 0, ...] (csrc/scan.cu).
_scratch = {}
# data_ptr -> every scratch tensor a CUDA graph captured: kept for good.
_captured = {}
EPOCH_END = 2**31 - 1  # epochs run over [1, EPOCH_END) on a scratch
_epoch_end = EPOCH_END
_DEVICE_TYPE = "cuda"  # where the scratch lives


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("scan")
        lib.gsplat_scan_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
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
    """64-bit scratch words a scan of ``n`` elements needs: the epoch word,
    the two counters and one status word a tile."""
    return 3 + -(-n // TILE)


def set_epoch_end(end: int = None) -> None:
    """Test hook: launches from now on (and captures made from now on) take
    epochs ``1 .. end - 1`` on a scratch and then start again at 1, so that
    a test crosses the device-side wrap within a few calls.  ``None``
    restores :data:`EPOCH_END`."""
    global _epoch_end
    end = EPOCH_END if end is None else int(end)
    if not 2 <= end <= EPOCH_END:
        raise ValueError(f"the epoch end must lie in [2, {EPOCH_END}], got {end}")
    _epoch_end = end


def _scratch_for(device: int, stream: int, words: int, capturing: bool = False) -> torch.Tensor:
    buf = _scratch.get((device, stream))
    if buf is None or buf.numel() < words:
        if capturing:
            # A capture must not allocate it: the zeroing would be captured
            # and replayed, and the block would belong to the graph's pool.
            raise RuntimeError(
                "scan_i32 under CUDA graph capture: no scratch of this length on the capture stream yet; "
                "make one eager call of the captured work on that stream first "
                "(gsplat_tpu_torch.graphs.capture does)"
            )
        # Zeroed, which is required: a block the allocator hands back may
        # hold this process's earlier data, whose words can carry the tags
        # of the coming epochs (a false "ready" status, or a counter that
        # skips its restart and leaves tiles unscanned).  The old block may
        # still be read by the kernels queued before: the caching allocator
        # hands it out again only in this stream's order, and never if a
        # graph captured it.
        buf = torch.zeros((max(words, 2 * (0 if buf is None else buf.numel())),), dtype=torch.int64,
                          device=torch.device(_DEVICE_TYPE, device))
        _scratch[(device, stream)] = buf
    if capturing:
        _captured[buf.data_ptr()] = buf
    return buf


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
    takes :func:`scan_i32_plain`.  The launch may be captured in a CUDA graph
    once an eager call on the capture stream has sized its scratch (see the
    module's notes): each replay takes a fresh epoch on the device."""
    global launches
    code = _KIND_CODE.get(kind)
    if code is None:
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
    lib = _lib if _lib is not None else _library()
    dev = x.get_device()
    # The current stream as a raw handle, as inductor's generated code takes
    # it: torch.cuda.current_stream builds a Stream object first, a good part
    # of a caller's time for a scan of 1M elements.
    stream = torch._C._cuda_getCurrentRawStream(dev)
    scratch = _scratch_for(dev, stream, scratch_words(n), torch.cuda.is_current_stream_capturing())
    args = (x.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(), n, code, _epoch_end, stream)
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
