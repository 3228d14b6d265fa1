"""Calibration probes of the speed-of-light model: the card's float32 issue
and ``expf`` rates (``alu_probe``) and the rate of scattered against
contiguous payload reads and writes (``gather_probe``).

``alu_probe`` replaces the TPU probe ``scripts/sol_calibrate.py`` ``vpu_rate``
and ``gather_probe`` the three probe kernels of
``scripts/profile_dma_gather.py`` (``build``), with the hand-written CUDA
kernels of ``csrc/probes.cu`` (see its notes).  Both compute a value their
plain versions below recompute, so a wrong kernel is caught; what they are
for is their time, which ``utils/sol_calibrate.py`` and
``utils/profile_gather.py`` take.  The column read and the column write are
scheduled around the card's L2: a block stages ``GATHER_TILE`` of its
queries' columns in shared memory and sweeps the 16 rows over them, and the
grid is one wave of ``gather_blocks`` blocks, so the blocks in flight share
one or two rows of the matrix.

On CUDA tensors the wrappers launch the kernels (or raise); on CPU tensors
they take the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, register

ALU_VARIANTS = ("fma", "mul_add", "expf")
GATHER_ACCESSES = ("contiguous", "column", "row", "column_write")
ILP = 8          # independent chains a thread
PROBE_ROWS = 16  # rows of the probed payload matrix
THREADS = 256
GATHER_TILE = 4096  # queries a block of the column read and write stages at a time
# vpu_rate's constants: acc = acc * FMA_A + FMA_B
FMA_A = 1.0000001
FMA_B = 0.0000001

# Wrapper calls that launched a kernel, by ALU variant and gather access.
launches = {name: 0 for name in ALU_VARIANTS + GATHER_ACCESSES}
register("alu_probe", __name__, "launches", keys=ALU_VARIANTS)
register("gather_probe", __name__, "launches", keys=GATHER_ACCESSES)

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("probes")
        p = ctypes.c_void_p
        lib.gsplat_alu_probe.argtypes = [
            p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, p,
        ]
        lib.gsplat_alu_probe.restype = ctypes.c_int
        lib.gsplat_gather_probe.argtypes = [
            p, p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, p, p, ctypes.c_int, p,
        ]
        lib.gsplat_gather_sweep_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.gsplat_gather_sweep_blocks_per_sm.restype = ctypes.c_int
        lib.gsplat_gather_probe.restype = ctypes.c_int
        _lib = lib
    return _lib


def alu_ops(n: int, steps: int, variant: str) -> dict:
    """Work of one ``alu_probe`` call: links of the chains, issue slots of
    the float32 pipe they need (an FMA one, a separate mul + add two) and
    float32 operations counted the data sheet's way (an FMA two).  An
    ``expf`` link is one ``expf`` and one subtraction."""
    links = n * ILP * steps
    if variant == "expf":
        return {"links": links, "expf": links, "flops": 2 * links}
    slots = links * (1 if variant == "fma" else 2)
    return {"links": links, "issue_slots": slots, "flops": 2 * links}


def _check_alu(x, steps, variant):
    if variant not in ALU_VARIANTS:
        raise ValueError(f"variant must be one of {ALU_VARIANTS}, got {variant!r}")
    if x.dim() != 1 or x.dtype != torch.float32:
        raise TypeError(f"x: expected a 1-D float32 tensor, got {tuple(x.shape)} {x.dtype}")
    if steps < 0:
        raise ValueError("steps must be >= 0")


def alu_probe_plain(x: torch.Tensor, steps: int, variant: str) -> torch.Tensor:
    """Plain version: the same chains by torch ops.  ``"mul_add"`` is bit-equal
    (separately rounded float32); ``"fma"`` computes each link in float64,
    where ``acc·a + b`` is exact for the probe's chains (values in
    [0.25, 2): at most 49 significant bits), and rounds it once, which is
    the fused result bit for bit; ``"expf"`` is ``torch.exp(1 - acc)``, equal
    to the kernel's ``expf`` to the ulp or so a link."""
    _check_alu(x, steps, variant)
    f32 = torch.float32
    a = torch.tensor(FMA_A, dtype=f32, device=x.device)
    b = torch.tensor(FMA_B, dtype=f32, device=x.device)
    mults = torch.tensor([1.0 + 0.001 * k for k in range(ILP)], dtype=torch.float64).to(f32).to(x.device)
    acc = x[None, :] * mults[:, None]  # (ILP, n)
    a64, b64 = a.double(), b.double()
    for _ in range(steps):
        if variant == "fma":
            acc = (acc.double() * a64 + b64).to(f32)
        elif variant == "mul_add":
            acc = acc * a + b
        else:
            acc = torch.exp(1.0 - acc)
    out = acc[0]
    for k in range(1, ILP):
        out = out + acc[k]
    return out


def alu_probe(x: torch.Tensor, steps: int, variant: str = "fma") -> torch.Tensor:
    """Runs ``steps`` links of 8 independent chains per element of ``x``
    (n,) float32 and returns the (n,) sums of the chains' ends."""
    _check_alu(x, steps, variant)
    if not x.is_cuda:
        return alu_probe_plain(x, steps, variant)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.gsplat_alu_probe(
            x.data_ptr(), out.data_ptr(), x.numel(), steps, ALU_VARIANTS.index(variant),
            FMA_A, FMA_B, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gsplat_alu_probe launch failed: CUDA error {err}")
    launches[variant] += 1
    return out


def _check_gather(mat, idx, access):
    if access not in GATHER_ACCESSES:
        raise ValueError(f"access must be one of {GATHER_ACCESSES}, got {access!r}")
    if mat.dim() != 2 or mat.dtype != torch.float32:
        raise TypeError(f"mat: expected a 2-D float32 matrix, got {tuple(mat.shape)} {mat.dtype}")
    if access == "row":
        if mat.shape[1] != PROBE_ROWS:
            raise TypeError(f"row access takes an (N, {PROBE_ROWS}) matrix, got {tuple(mat.shape)}")
    elif mat.shape[0] != PROBE_ROWS:
        raise TypeError(f"{access} access takes a ({PROBE_ROWS}, N) matrix, got {tuple(mat.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or idx.device != mat.device:
        raise TypeError("idx: expected a 1-D int32 tensor on the matrix's device")


def _n_cols(mat, access):
    return mat.shape[0] if access == "row" else mat.shape[1]


def gather_probe_plain(mat: torch.Tensor, idx: torch.Tensor, access: str):
    """Plain version: the float64 sum of every value the queries read, or for
    ``"column_write"`` the matrix with the queries' columns written (in
    place)."""
    _check_gather(mat, idx, access)
    n = _n_cols(mat, access)
    if access == "contiguous":
        cols = torch.arange(idx.numel(), device=mat.device) % n
        return mat[:, cols].double().sum()
    if access == "column":
        return mat[:, idx.long()].double().sum()
    if access == "row":
        return mat[idx.long()].double().sum()
    c = idx.long()
    r = torch.arange(PROBE_ROWS, device=mat.device)
    mat[:, c] = (c[None, :] * PROBE_ROWS + r[:, None]).to(torch.float32)
    return mat


def gather_probe(mat: torch.Tensor, idx: torch.Tensor, access: str):
    """One query per entry of ``idx`` (``"contiguous"`` takes only its
    length).  ``mat``: (16, N) float32, or (N, 16) for ``"row"``.  Returns
    the float64 sum of every value read (a 0-d tensor on the device), or for
    ``"column_write"`` ``mat`` itself, written in place."""
    _check_gather(mat, idx, access)
    if not mat.is_cuda:
        if idx.numel() and access != "contiguous":
            n = _n_cols(mat, access)
            if int(idx.min()) < 0 or int(idx.max()) >= n:
                raise ValueError("idx holds an out-of-range column")
        return gather_probe_plain(mat, idx, access)
    if not (mat.is_contiguous() and idx.is_contiguous()):
        raise ValueError("mat and idx must be contiguous")
    blocks = gather_blocks(mat.device, access)
    partial = torch.empty((blocks,), dtype=torch.float64, device=mat.device)
    steps_done = None
    if access == "column_write":
        span = -(-idx.numel() // blocks)
        steps_done = torch.zeros((-(-span // GATHER_TILE) * PROBE_ROWS,), dtype=torch.int32, device=mat.device)
    lib = _library()
    with torch.cuda.device(mat.device):
        err = lib.gsplat_gather_probe(
            mat.data_ptr(), idx.data_ptr(), _n_cols(mat, access), idx.numel(),
            GATHER_ACCESSES.index(access), None if steps_done is None else steps_done.data_ptr(),
            partial.data_ptr(), blocks, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gsplat_gather_probe launch failed: CUDA error {err}")
    launches[access] += 1
    if access == "column_write":
        return mat
    return partial.sum() if idx.numel() else partial.new_zeros(())


def gather_blocks(device, access: str) -> int:
    """Blocks of one ``gather_probe`` launch (CUDA): 8 an SM for the
    contiguous and the row access (grid stride); for the column read and
    write as many as stay resident, one wave."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if access not in ("column", "column_write"):
        return 8 * sms
    with torch.cuda.device(device):
        per_sm = _library().gsplat_gather_sweep_blocks_per_sm(int(access == "column_write"))
    if per_sm <= 0:
        raise RuntimeError(f"gather {access}: the occupancy query failed")
    return per_sm * sms


def gather_bytes(p: int, access: str) -> int:
    """Bytes one ``gather_probe`` call must move: 64 per query, and a 4-byte
    index per query but for the contiguous access."""
    return p * PROBE_ROWS * 4 + (0 if access == "contiguous" else 4 * p)
