"""Builds the package's CUDA sources with ``nvcc`` at first use and loads them
with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library
``build/gsplat_tpu_torch-<hash>/lib<name>.so`` (the hash covers every source,
shared header and flag, so an edited source rebuilds), all compiled in parallel — one
``nvcc`` process per source.  The sources expose plain ``extern "C"`` entry
points that take device pointers, sizes and a stream and return
``cudaGetLastError()``; nothing includes PyTorch's headers, which keeps a
build to seconds.

The build directory is ``build/`` beside the package (the repository root in
a checkout), or ``$GSPLAT_TPU_TORCH_BUILD_DIR``.  A failed build raises: no
caller falls back to a plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Per-source extra flags.  The compositor is held bit-for-bit against a
# sequence of separately rounded PyTorch ops across two hard thresholds
# (α ≥ 1/255, q² ≤ 4), so the compiler must not contract a*b+c into an FMA;
# its backward recomputes the same α and has to land on the same side.  The
# projection's forward is held bit for bit against a chain of separately
# rounded ATen ops, its backward against the same chain's analytic VJP, and
# so is the frame glue's float math (the exact-coverage cull).  The
# probes keep nvcc's defaults: their FMA chain is meant to contract, and their
# separately rounded chain is written with intrinsics that never do.  Adam
# follows the rounding of torch's capturable update, whose FMAs it writes out.
EXTRA_FLAGS = {
    "composite_fwd": ("-fmad=false",),
    "composite_bwd": ("-fmad=false",),
    "projection": ("-fmad=false",),
    "frame_glue": ("-fmad=false",),
    "segsum": (),
    "scan": (),
    "probes": (),
    "adam": ("-fmad=false",),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of gsplat_tpu_torch are built from source at first use"
    )


def build_root() -> Path:
    """``$GSPLAT_TPU_TORCH_BUILD_DIR``, else ``build/`` beside the package."""
    root = os.environ.get("GSPLAT_TPU_TORCH_BUILD_DIR")
    return Path(root) if root else Path(__file__).resolve().parents[3] / "build"


def build_dir() -> Path:
    h = hashlib.sha256()
    for name in sorted(EXTRA_FLAGS):
        h.update(name.encode())
        h.update((CSRC_DIR / f"{name}.cu").read_bytes())
        h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS[name]).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return build_root() / f"gsplat_tpu_torch-{h.hexdigest()[:16]}"


def build_all(verbose: bool = False) -> Path:
    """Compile every source that has no library yet, all ``nvcc`` processes
    started together.  Returns the build directory."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, extra in EXTRA_FLAGS.items():
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, *extra]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for name, lib, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            _libs[name] = lib
        return lib
