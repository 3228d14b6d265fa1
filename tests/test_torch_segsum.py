"""The port's segment sum (its plain version, which the wrapper takes on CPU
tensors) against the JAX package's Pallas kernel in interpret mode, fed the
readback the JAX package builds with its two gathers.  The JAX package keeps
the gradient space as (9, G) rows; the port's is pair-major, (G, 9) float32
or (G, 8) int32, so the port is handed the same numbers transposed."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
from gsplat_tpu.ops.binning import bin_splats as j_bin_splats
from gsplat_tpu.ops.binning import grad_pad_size, tile_grid
from gsplat_tpu.ops.pallas.segsum import pad_pairs, segsum_by_splat as j_segsum
from gsplat_tpu_torch.ops.kernels import composite as tk
from gsplat_tpu_torch.ops.kernels.segsum import segsum_by_splat, segsum_by_splat_plain
from torch_port_helpers import j_projected, jax_scene, jax_sorted_fields, npy

# A splat's few pair columns added in another order, in float32: relative to
# the row's largest sum.
TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _inputs(budget_override=0, n=400, seed=1, eye=(0.2, 0.4, 3.0)):
    jcfg = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0, pair_budget_override=budget_override)
    jsplats, jcam = jax_scene(n=n, seed=seed, eye=eye)
    fields = jax_sorted_fields(jsplats, jcam, jcfg)
    jb = j_bin_splats(j_projected(fields), jcam.width, jcam.height, jcfg, with_tiles=False,
                      with_grad_map=True)
    nty, ntx = tile_grid(jcam.width, jcam.height, 32, 32)
    g_pad = grad_pad_size(jb.dest_of_exp.shape[0], nty * ntx, jcfg.chunk)
    gspace = np.random.default_rng(7).standard_normal((9, g_pad)).astype(np.float32)
    return jb, gspace


def _jax_sum(jb, gspace, order=None):
    """The JAX package's readback (``_csp_bwd``) and its kernel, interpret mode."""
    dest = jb.dest_of_exp
    budget = dest.shape[0]
    keep = dest >= 0
    q = jnp.where(keep, dest, ~dest)
    rank_f = jb.exp_rank.astype(jnp.float32)
    pad = pad_pairs(budget) - budget
    q = jnp.concatenate([q, jnp.zeros((pad,), jnp.int32)])
    keep = jnp.concatenate([keep, jnp.zeros((pad,), bool)])
    rank_f = jnp.concatenate([rank_f, jnp.full((pad,), -1.0, jnp.float32)])
    g = jnp.asarray(gspace)
    d8 = jnp.where(keep[None, :], g[0:8][:, q], 0.0)
    aux = jnp.concatenate([jnp.where(keep[None, :], g[8:9][:, q], 0.0), rank_f[None, :]], axis=0)
    return np.asarray(j_segsum(d8, aux, jb.exp_offsets, jb.exp_counts, True, order=order))


def _port_sum(jb, gspace, order=None, packed=False, fn=segsum_by_splat):
    """The port on the (R, G) space ``gspace`` handed over pair-major."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return npy(fn(t(np.ascontiguousarray(np.asarray(gspace).T)), t(jb.dest_of_exp), t(jb.exp_offsets), t(jb.exp_counts),
                  order=None if order is None else t(order), packed=packed))


def _assert_rows_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    for r in range(9):
        scale = np.abs(want[r]).max()
        assert np.abs(got[r] - want[r]).max() <= TOL * scale, (r, np.abs(got[r] - want[r]).max(), scale)


@pytest.mark.parametrize("budget_override", [0, 300], ids=["all_kept", "dropped_pairs"])
def test_rank_order_matches_pallas_interpret(budget_override):
    jb, gspace = _inputs(budget_override)
    if budget_override:
        assert int((np.asarray(jb.dest_of_exp) < 0).sum()) > 0
    _assert_rows_close(_port_sum(jb, gspace), _jax_sum(jb, gspace))


def test_storage_order_matches_pallas_interpret():
    jb, gspace = _inputs()
    order = np.random.default_rng(2).permutation(jb.exp_counts.shape[0]).astype(np.int32)
    got = _port_sum(jb, gspace, order=order)
    _assert_rows_close(got, _jax_sum(jb, gspace, order=jnp.asarray(order)))
    np.testing.assert_array_equal(got[:, order], _port_sum(jb, gspace))


def test_ranks_without_pairs_get_exact_zeros_and_two_runs_are_bit_equal():
    jb, gspace = _inputs(eye=(0.2, 0.4, 1.0))  # a close camera: part of the scene is off screen
    got = _port_sum(jb, gspace)
    empty = np.asarray(jb.exp_counts) == 0
    assert empty.any() and not empty.all()
    assert np.abs(got[:, empty]).max() == 0.0
    # (a rank with pairs may still sum to zero: the exact-coverage cull drops
    # pairs after they were counted)
    assert (np.abs(got[:, ~empty]).max(axis=0) > 0).mean() > 0.5
    np.testing.assert_array_equal(got, _port_sum(jb, gspace))


def test_sums_equal_a_per_rank_loop():
    """Independent of both kernels: a Python loop over the ranks' windows."""
    jb, gspace = _inputs(300)
    dest, off, cnt = (np.asarray(a) for a in (jb.dest_of_exp, jb.exp_offsets, jb.exp_counts))
    want = np.zeros((9, len(off)), np.float64)
    for r in range(len(off)):
        for j in range(off[r], min(off[r] + cnt[r], len(dest))):
            if dest[j] >= 0:
                want[:, r] += gspace[:, dest[j]]
    got = _port_sum(jb, gspace)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())


def test_packed_gradient_space_is_unpacked_on_the_way():
    jb, gspace = _inputs()
    g = torch.from_numpy(gspace)
    packed = torch.cat([g[0:6].view(torch.int32), tk.pack2(g[6:7], g[7:8]), g[8:9].view(torch.int32)])
    cg, cb = tk.unpack2(packed[6:7])
    rounded = torch.cat([g[0:6], cg, cb, g[8:9]]).numpy()
    got = _port_sum(jb, npy(packed), packed=True)
    np.testing.assert_array_equal(got, _port_sum(jb, rounded))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    jb, gspace = _inputs()
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    space = t(np.ascontiguousarray(gspace.T))  # pair-major (G, 9)
    args = (t(jb.dest_of_exp), t(jb.exp_offsets), t(jb.exp_counts))
    with pytest.raises(TypeError):
        segsum_by_splat(space[:, :8].contiguous(), *args)          # 8 float words: not a gradient space
    with pytest.raises(TypeError):
        segsum_by_splat(space, *args, packed=True)                 # packed takes int32
    with pytest.raises(TypeError):
        segsum_by_splat(space, args[0].long(), args[1], args[2])
    with pytest.raises(TypeError):
        segsum_by_splat(space, args[0], args[1], args[2][:-1])
    assert segsum_by_splat_plain(space, args[0], args[1][:0], args[2][:0]).shape == (9, 0)


def _small_windows():
    """Three ranks over five pairs of a 12-slot space (one dropped pair)."""
    dest = torch.tensor([3, 0, -1, 7, 11], dtype=torch.int32)
    return dest, torch.tensor([0, 2, 3], dtype=torch.int32), torch.tensor([2, 1, 2], dtype=torch.int32)


@pytest.mark.parametrize("packed", [False, True], ids=["float32", "packed"])
def test_wrapper_rejects_the_row_major_orientation_and_strided_spaces(packed):
    words, dt = (8, torch.int32) if packed else (9, torch.float32)
    space = torch.arange(12 * words, dtype=torch.int32).reshape(12, words).to(dt)
    args = _small_windows()
    want = segsum_by_splat(space, *args, packed=packed)
    assert want.shape == (9, 3) and float(want.abs().max()) > 0
    with pytest.raises(TypeError, match="pair-major"):
        segsum_by_splat(space.t().contiguous(), *args, packed=packed)    # the (R, G) orientation
    with pytest.raises(ValueError, match="contiguous"):
        segsum_by_splat(space.t().contiguous().t(), *args, packed=packed)  # (G, R), but rows strided
    wide = torch.zeros((12, 2 * words), dtype=dt)
    wide[:, ::2] = space
    with pytest.raises(ValueError, match="contiguous"):
        segsum_by_splat(wide[:, ::2], *args, packed=packed)
