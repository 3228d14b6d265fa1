"""Port vs JAX package: tile binning.  Both packages bin the JAX package's
sorted, sanitized fields; every integer array must be exactly equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops.rasterize_tiles import build_tile_lists
from gsplat_tpu.ops.rasterize_tiles import build_tile_lists as j_build_tile_lists
from torch_port_helpers import j_projected, jax_scene, jax_sorted_fields, npy, t_projected, to_config

INT_ARRAYS = (
    "pair_splat", "pair_tile", "tile_start", "tile_count", "tile_base",
    "tile_phi", "tile_span", "grad_base", "dropped_pairs",
)

BASE = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0)

CASES = {
    "default": (dict(), dict(n=400, seed=1)),
    "soft_cutoff": (dict(soft_cutoff=True), dict(n=400, seed=0)),
    "packed": (dict(payload_dtype="packed"), dict(n=400, seed=1)),
    "ragged_image": (dict(), dict(n=400, seed=2, w=70, h=45)),
    # 400 splats bin ~570 pairs at 64x64: a 300-pair budget drops the farthest
    "budget_drops": (dict(pair_budget_override=300), dict(n=400, seed=1)),
    # big splats, tiny capacity: tiles truncate at tile_capacity
    "capacity_truncates": (dict(tile_capacity=128), dict(n=400, seed=3, sh=0.0)),
    "one_splat": (dict(), dict(n=1, seed=5)),
    "chunk_256": (dict(chunk=256, tile_capacity=512), dict(n=400, seed=6)),
}


def _bin_both(cfg_kw, scene_kw, with_tiles=True):
    jcfg = dataclasses.replace(BASE, **cfg_kw)
    js, jc = jax_scene(**scene_kw)
    if cfg_kw.get("tile_capacity") == 128:  # big splats: tiles overflow
        js = dataclasses.replace(js, scale=js.scale * 6.0)
    f = jax_sorted_fields(js, jc, jcfg)
    jb = jbin.bin_splats(j_projected(f), jc.width, jc.height, jcfg, with_tiles=with_tiles)
    tb = tbin.bin_splats(t_projected(f), jc.width, jc.height, to_config(jcfg), with_tiles=with_tiles)
    return f, jc, jcfg, jb, tb


@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_splats_integer_arrays_exactly_equal(case, monkeypatch):
    cfg_kw, scene_kw = CASES[case]
    f, jc, jcfg, jb, tb = _bin_both(cfg_kw, scene_kw)
    if case == "default":
        # GSPLAT_SAT_MAX_N = 0 in both packages: no SAT cull, and still the
        # same pairs in both (the port reads the variable as the JAX
        # package does)
        assert tbin._SAT_CULL_MAX_N == jbin._SAT_CULL_MAX_N
        monkeypatch.setattr(jbin, "_SAT_CULL_MAX_N", 0)
        monkeypatch.setattr(tbin, "_SAT_CULL_MAX_N", 0)
        _, _, _, jb0, tb0 = _bin_both(cfg_kw, scene_kw)
        for name in ("pair_splat", "pair_tile", "tile_count"):
            assert np.array_equal(npy(getattr(tb0, name)), np.asarray(getattr(jb0, name))), name
        assert not np.array_equal(npy(tb0.pair_splat), npy(tb.pair_splat))  # the cull was off
        monkeypatch.undo()
    for name in INT_ARRAYS:
        j, t = np.asarray(getattr(jb, name)), npy(getattr(tb, name))
        assert t.dtype == np.int32, name
        assert t.shape == j.shape, name
        assert np.array_equal(t, j), f"{case}: {name} differs at {np.flatnonzero(t != j)[:8]}"
    assert tb.pair_budget == jb.pair_budget
    if case == "budget_drops" or case == "capacity_truncates":
        assert int(tb.dropped_pairs) > 0
    else:
        assert int(tb.dropped_pairs) == 0
    # the counting pass agrees with the JAX one and with the binned total
    jn = int(jbin.count_pairs(j_projected(f), jc.width, jc.height, jcfg))
    tn = int(tbin.count_pairs(t_projected(f), jc.width, jc.height, to_config(jcfg)))
    assert tn == jn


def test_bin_splats_without_tiles_and_with_order():
    cfg_kw, scene_kw = CASES["default"]
    _, _, _, jb, tb = _bin_both(cfg_kw, scene_kw, with_tiles=False)
    assert tb.pair_tile is None and jb.pair_tile is None
    assert np.array_equal(npy(tb.pair_splat), np.asarray(jb.pair_splat))
    # storage-order fields + the depth permutation give the same pair sequence
    jcfg = BASE
    js, jc = jax_scene(**scene_kw)
    from gsplat_tpu.ops.rasterize_ref import sanitize_projected as j_sanitize

    p = j_sanitize(gj.project_splats(js, jc, 3, tight_footprint=True))
    f = np.asarray(p.fields)
    order = np.argsort(f[10], kind="stable").astype(np.int32)
    jo = jbin.bin_splats(j_projected(f), jc.width, jc.height, jcfg, order=jnp.asarray(order))
    to = tbin.bin_splats(
        t_projected(f), jc.width, jc.height, to_config(jcfg), order=torch.from_numpy(order).long()
    )
    for name in INT_ARRAYS:
        assert np.array_equal(npy(getattr(to, name)), np.asarray(getattr(jo, name))), name


def test_empty_scene_bins_nothing():
    cfg = gt.RenderConfig(tile_capacity=512)
    f = np.zeros((16, 0), np.float32)
    tb = tbin.bin_splats(t_projected(f), 64, 64, cfg)
    assert int(tb.tile_span.max()) == 0 and int(tb.dropped_pairs) == 0
    assert tb.pair_splat.shape[0] == tbin.pair_pad_size(cfg.pair_budget(0), cfg.chunk)


def test_with_grad_map_is_the_training_slice():
    """The gradient map is built only when asked for (training), and asking
    for it changes none of the forward arrays."""
    f = jax_sorted_fields(*jax_scene(n=400, seed=1), BASE)
    plain = tbin.bin_splats(t_projected(f), 64, 64, to_config(BASE))
    mapped = tbin.bin_splats(t_projected(f), 64, 64, to_config(BASE), with_grad_map=True)
    budget = to_config(BASE).pair_budget(400)
    for name, length in (("dest_of_exp", budget), ("exp_rank", budget), ("exp_offsets", 400), ("exp_counts", 400)):
        assert getattr(plain, name) is None
        got = getattr(mapped, name)
        assert got.dtype == torch.int32 and tuple(got.shape) == (length,), name
    for name in ("pair_splat", "pair_tile", "tile_start", "tile_count", "tile_base", "tile_phi", "tile_span",
                 "grad_base", "dropped_pairs"):
        assert torch.equal(getattr(plain, name), getattr(mapped, name)), name


@pytest.mark.parametrize("w,h,th,tw", [(64, 64, 32, 32), (70, 45, 32, 32), (1920, 1080, 32, 32), (100, 30, 16, 8)])
def test_static_sizes_equal(w, h, th, tw):
    assert tbin.tile_grid(w, h, th, tw) == jbin.tile_grid(w, h, th, tw)
    for budget in (8, 300, 131072, 2_490_368):
        assert tbin.pair_pad_size(budget, 128) == jbin.pair_pad_size(budget, 128)
        assert tbin.grad_pad_size(budget, 2040, 128) == jbin.grad_pad_size(budget, 2040, 128)


def test_tile_extents_with_strides_and_offsets():
    # plain arithmetic of the sharded mapping: kept equal although no path of
    # this slice sets strides
    f = jax_sorted_fields(*jax_scene(n=400, seed=2, w=128, h=128), BASE)
    jcfg = dataclasses.replace(BASE, row_stride=2, col_stride=2)
    jn = int(jbin.count_pairs(j_projected(f), 128, 128, jcfg, row_offset=1, col_offset=0))
    tn = int(tbin.count_pairs(t_projected(f), 128, 128, to_config(jcfg), row_offset=1, col_offset=0))
    assert tn == jn and tn > 0


def test_build_tile_lists_equal():
    cfg_kw, scene_kw = CASES["capacity_truncates"]
    f, jc, jcfg, jb, tb = _bin_both(cfg_kw, scene_kw)
    nty, ntx = jbin.tile_grid(jc.width, jc.height, 32, 32)
    jl = np.asarray(j_build_tile_lists(jb, nty * ntx, jcfg.tile_capacity, f.shape[1]))
    tl = npy(build_tile_lists(tb, nty * ntx, jcfg.tile_capacity, f.shape[1]))
    assert np.array_equal(tl, jl)


def test_report_stats_warns_once_and_rearms(caplog):
    stats = tbin.RenderStats(dropped_pairs=torch.tensor(1234, dtype=torch.int32))
    assert stats.any_dropped_host()
    with caplog.at_level("WARNING", logger="gsplat_tpu_torch"):
        tbin.report_stats(stats)
        tbin.report_stats(stats)
        assert sum("dropped 1,234" in r.message for r in caplog.records) == 1
        tbin.report_stats(tbin.RenderStats(dropped_pairs=torch.tensor(0, dtype=torch.int32)))
        tbin.report_stats(stats)
        assert sum("dropped 1,234" in r.message for r in caplog.records) == 2
        tbin.report_stats(stats, gt.RenderConfig(warn_on_drop=False))
