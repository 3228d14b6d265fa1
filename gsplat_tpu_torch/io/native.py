"""ctypes bindings for the native host runtime (counterpart of
``gsplat_tpu.io.native``): parallel PLY column extraction with fused 3DGS
activations, a radix argsort, and a Morton spatial reordering.

The source is the port's own, ``csrc/host_io.cpp``.  It is built with ``g++``
at first use into ``build/`` (beside the CUDA libraries, named by a hash of
the source and flags) and loaded with ``ctypes``.  A failed build raises:
nothing falls back.  The numpy versions stay beside the library versions as
the ``*_plain`` functions, the references the tests hold them to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

from ..ops.kernels._build import CSRC_DIR, build_root

SOURCE = CSRC_DIR / "host_io.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build_and_load() -> ctypes.CDLL:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    out = build_root() / f"host_io-{h.hexdigest()[:16]}"
    so = out / "libhost_io.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"libhost_io.{os.getpid()}.tmp.so"
        cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.extract_columns_f32.argtypes = [ptr, i64, i64, ctypes.POINTER(i64), ctypes.c_int, ctypes.POINTER(ptr)]
    lib.activate_splats.argtypes = [ptr] * 12 + [i64]
    lib.radix_argsort_f32.argtypes = [ptr, i64, ptr]
    lib.morton_codes.argtypes = [ptr] * 3 + [i64, ptr]
    for fn in (lib.extract_columns_f32, lib.activate_splats, lib.radix_argsort_f32, lib.morton_codes):
        fn.restype = None
    return lib


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use (raises if the build fails)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build_and_load()
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _f32_columns(arrays, n, what):
    for a in arrays:
        if a.dtype != np.float32 or a.shape != (n,) or not a.flags.c_contiguous:
            raise ValueError(f"{what}: expected contiguous float32 arrays of shape ({n},)")


def _check_records(raw: bytes, n: int, stride: int, offsets: Sequence[int]) -> None:
    if len(raw) < n * stride:
        raise ValueError(f"{len(raw)} bytes hold fewer than {n} records of {stride} bytes")
    if any(off < 0 or off + 4 > stride for off in offsets):
        raise ValueError(f"column offsets {list(offsets)} outside a {stride}-byte record")


# ----------------------------------------------------------- column extract

def extract_columns_plain(raw: bytes, n: int, stride: int, offsets: Sequence[int]) -> List[np.ndarray]:
    """Extract float32 columns from packed binary records (numpy)."""
    _check_records(raw, n, stride, offsets)
    rec = np.frombuffer(raw, np.uint8, count=n * stride).reshape(n, stride)
    return [rec[:, off: off + 4].copy().view(np.float32).reshape(n) for off in offsets]


def extract_columns(raw: bytes, n: int, stride: int, offsets: Sequence[int]) -> List[np.ndarray]:
    """Extract float32 columns from packed binary records (SoA)."""
    _check_records(raw, n, stride, offsets)
    lib = get_lib()
    outs = [np.empty(n, np.float32) for _ in offsets]
    offs = (ctypes.c_int64 * len(offsets))(*offsets)
    ptrs = (ctypes.c_void_p * len(outs))(*[o.ctypes.data for o in outs])
    base = (ctypes.c_char * len(raw)).from_buffer_copy(raw)
    lib.extract_columns_f32(ctypes.cast(base, ctypes.c_void_p), n, stride, offs, len(offsets), ptrs)
    return outs


# -------------------------------------------------------------- activations

def activate_splats_inplace_plain(opacity, scale3, rot4):
    """Sigmoid opacity, exp scale, quaternion reorder and normalize (numpy,
    in place on ``opacity`` and ``scale3``).  Returns (opacity, scale3,
    orient_xyzw)."""
    opacity[:] = 1.0 / (1.0 + np.exp(-opacity))
    for s in scale3:
        np.exp(s, out=s)
    w, x, y, z = rot4
    inv = 1.0 / np.maximum(np.sqrt(w * w + x * x + y * y + z * z), 1e-12)
    return opacity, scale3, (x * inv, y * inv, z * inv, w * inv)


def activate_splats_inplace(opacity, scale3, rot4):
    """Fused sigmoid/exp/quat-normalize.  ``scale3``: 3 arrays; ``rot4``: 4
    raw PLY rot arrays (w,x,y,z).  Returns (opacity, scale3, orient_xyzw)."""
    n = opacity.shape[0]
    _f32_columns([opacity, *scale3, *rot4], n, "activate_splats_inplace")
    lib = get_lib()
    q = [np.empty(n, np.float32) for _ in range(4)]
    lib.activate_splats(
        _ptr(opacity), _ptr(scale3[0]), _ptr(scale3[1]), _ptr(scale3[2]),
        _ptr(rot4[0]), _ptr(rot4[1]), _ptr(rot4[2]), _ptr(rot4[3]),
        _ptr(q[0]), _ptr(q[1]), _ptr(q[2]), _ptr(q[3]), n,
    )
    return opacity, scale3, tuple(q)


# -------------------------------------------------------------------- sorts

def radix_argsort_plain(keys: np.ndarray) -> np.ndarray:
    """Stable ascending argsort of float32 keys (numpy).  Unlike the radix
    sort it ranks -0.0 and +0.0 as equal."""
    return np.argsort(np.ascontiguousarray(keys, np.float32), kind="stable").astype(np.int32)


def radix_argsort(keys: np.ndarray) -> np.ndarray:
    """Ascending argsort of float32 keys (native LSD radix sort)."""
    keys = np.ascontiguousarray(keys, np.float32)
    lib = get_lib()
    out = np.empty(keys.shape[0], np.int32)
    lib.radix_argsort_f32(_ptr(keys), keys.shape[0], _ptr(out))
    return out


def _soa(pos_soa):
    return [np.ascontiguousarray(pos_soa[a], np.float32) for a in range(3)]


def morton_order_plain(pos_soa: np.ndarray) -> np.ndarray:
    """Z-order permutation of splats from (3, N) positions (numpy; codes
    quantized by its own float arithmetic, so not the library's order)."""
    x, y, z = _soa(pos_soa)

    def q(a):
        lo, hi = a.min(), a.max()
        return ((a - lo) / max(hi - lo, 1e-12) * 2097151).astype(np.uint64)

    def expand(v):
        v &= np.uint64(0x1FFFFF)
        v = (v | v << np.uint64(32)) & np.uint64(0x1F00000000FFFF)
        v = (v | v << np.uint64(16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | v << np.uint64(8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | v << np.uint64(4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | v << np.uint64(2)) & np.uint64(0x1249249249249249)
        return v

    codes = (expand(q(x)) << np.uint64(2)) | (expand(q(y)) << np.uint64(1)) | expand(q(z))
    return np.argsort(codes).astype(np.int32)


def morton_order(pos_soa: np.ndarray) -> np.ndarray:
    """Spatial (Z-order) permutation of splats from (3, N) positions.
    Reordering splats by locality improves the device's tile coherence."""
    x, y, z = _soa(pos_soa)
    lib = get_lib()
    codes = np.empty(x.shape[0], np.uint64)
    lib.morton_codes(_ptr(x), _ptr(y), _ptr(z), x.shape[0], _ptr(codes))
    return np.argsort(codes).astype(np.int32)
