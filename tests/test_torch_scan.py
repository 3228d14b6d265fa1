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
    """The kernel's scratch: the epoch word, the tile counter, the count of
    finished blocks and one status word a tile of 8192.  The epochs live on
    the device (csrc/scan.cu); the wrapper passes only where they end, which
    the test hook sets within [2, 2^31 - 1] (0 and the top would alias the
    tags of another epoch) and every launch reads anew."""
    assert tscan.scratch_words(1) == 4
    assert tscan.scratch_words(8192) == 4 and tscan.scratch_words(8193) == 5
    assert tscan.scratch_words((1 << 24) + 3) == 3 + 2049
    assert tscan.EPOCH_END == 2**31 - 1 and tscan._epoch_end == tscan.EPOCH_END
    monkeypatch.setattr(tscan, "_epoch_end", tscan._epoch_end)
    tscan.set_epoch_end(3)
    assert tscan._epoch_end == 3
    for bad in (0, 1, 2**31):
        with pytest.raises(ValueError):
            tscan.set_epoch_end(bad)
    assert tscan._epoch_end == 3
    tscan.set_epoch_end()
    assert tscan._epoch_end == 2**31 - 1


def test_grown_scratch_holds_only_zeros(monkeypatch):
    """The scratch is allocated and grown zeroed (the tags of epoch 0, which
    no call has, and an epoch word that starts the epochs at 1), whatever
    the block the allocator hands back held: here every fresh block holds
    the first epoch's counters (1 << 32) | 5 and its status words
    (2 * 1) << 32, as a block of this process's earlier data can, with the
    allocation moved onto the CPU.  A scratch sized by an eager call is
    kept for good once a capture has read it."""
    e = 1  # a fresh scratch's first call takes epoch 1
    real_empty = torch.empty

    def handed_back(*size, **kw):
        block = real_empty(*size, **kw).fill_((2 * e) << 32)
        block.view(-1)[0] = e - 1
        block.view(-1)[1:3] = (e << 32) | 5
        return block

    monkeypatch.setattr(tscan, "_DEVICE_TYPE", "cpu")
    monkeypatch.setattr(tscan, "_scratch", {})
    monkeypatch.setattr(tscan, "_captured", {})
    monkeypatch.setattr(torch, "empty", handed_back)
    first = tscan._scratch_for(0, 1, tscan.scratch_words(5 * tscan.TILE + 3))
    assert first.device.type == "cpu" and first.numel() == 9 and not bool(first.any())
    grown = tscan._scratch_for(0, 1, 10)  # grows to twice the old size
    assert grown.numel() == 18 and not bool(grown.any()) and tscan._scratch[(0, 1)] is grown
    assert tscan._scratch_for(0, 1, 18) is grown  # no growth: the same block, as the kernel left it
    # under capture: the sized scratch is used and kept; a missing or short one raises
    assert tscan._scratch_for(0, 1, 18, capturing=True) is grown and tscan._captured[grown.data_ptr()] is grown
    with pytest.raises(RuntimeError, match="capture"):
        tscan._scratch_for(0, 1, 19, capturing=True)
    with pytest.raises(RuntimeError, match="capture"):
        tscan._scratch_for(0, 2, 4, capturing=True)
    regrown = tscan._scratch_for(0, 1, 19)
    assert regrown.numel() == 36 and tscan._captured[grown.data_ptr()] is grown
