"""Port vs JAX package: the int32 prefix scans.  On the CPU the port's wrapper
takes the kernel's plain version; it is held bit-for-bit against the Pallas
scan kernel in interpret mode and against ``jnp.cumsum`` / ``lax.cummax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.pallas.scan import cummax_i32, cumsum_i32
from gsplat_tpu_torch.ops.kernels import scan as tscan
from gsplat_tpu_torch.ops.kernels.scan import scan_i32, scan_i32_plain
from torch_port_helpers import npy


def _data(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "add":
        return rng.integers(0, 40, size=n, dtype=np.int32)
    return rng.integers(-(2**31), 2**31 - 1, size=n, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("kind", ["add", "max"])
def test_plain_scan_equals_pallas_kernel_in_interpret_mode(kind):
    # 131,072 + a ragged tail: past the JAX wrapper's kernel threshold
    x = _data(131_072 + 77, kind, 0)
    jfn = cumsum_i32 if kind == "add" else cummax_i32
    want = np.asarray(jfn(jnp.asarray(x), interpret=True))
    got = npy(scan_i32_plain(torch.from_numpy(x), kind))
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["add", "max"])
@pytest.mark.parametrize("n", [0, 1, 2, 31, 1023, 4097])
def test_scan_small_ragged_lengths(kind, n):
    before = tscan.launches
    x = _data(n, kind, n + 1)
    if kind == "max" and n > 0:
        x[0] = -(2**31)  # the neutral element itself, and all-negative prefixes
        x[: n // 2] = np.minimum(x[: n // 2], -1)
    want = np.asarray(jnp.cumsum(jnp.asarray(x)) if kind == "add" else jax.lax.cummax(jnp.asarray(x)))
    got = scan_i32(torch.from_numpy(x), kind)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert np.array_equal(npy(got), want.astype(np.int32))
    assert tscan.launches == before  # a CPU tensor launches nothing


def test_scan_add_wraps_like_int32():
    x = np.full(5, 2**30, np.int32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x)))
    assert np.array_equal(npy(scan_i32(torch.from_numpy(x), "add")), want)


def test_scan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        scan_i32(torch.zeros(4, dtype=torch.int64), "add")
    with pytest.raises(TypeError):
        scan_i32(torch.zeros((2, 2), dtype=torch.int32), "add")
    with pytest.raises(ValueError):
        scan_i32(torch.zeros(4, dtype=torch.int32), "mul")


def test_scan_scratch_sizing_and_epochs(monkeypatch):
    """The kernel's scratch: the counter and one status word a tile of 8192,
    and a new epoch every call that never leaves [1, 2^31 - 1) (0 and the
    top would alias the tags of another epoch); when the epochs run out,
    every scratch is zeroed before they start again."""
    assert tscan.scratch_words(1) == 2
    assert tscan.scratch_words(8192) == 2 and tscan.scratch_words(8193) == 3
    assert tscan.scratch_words((1 << 24) + 3) == 1 + 2049
    bufs = {(0, 1): torch.full((3,), -5, dtype=torch.int64), (0, 2): torch.full((9,), 7, dtype=torch.int64)}
    monkeypatch.setattr(tscan, "_scratch", bufs)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(tscan, "_epoch", 2**31 - 4)
    seen = []
    for _ in range(4):
        seen.append(tscan._next_epoch())
        assert all(bool((buf == 0).all()) == (seen[-1] < seen[0]) for buf in bufs.values()), seen
    assert seen == [2**31 - 3, 2**31 - 2, 1, 2]
