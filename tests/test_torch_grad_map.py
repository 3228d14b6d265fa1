"""The gradient map of the port's binning (``bin_splats(with_grad_map=True)``)
against the JAX package's, on the JAX package's own sorted field matrix: every
integer array exactly equal, dropped pairs included."""

import jax
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.ops.binning import bin_splats as j_bin_splats
from gsplat_tpu_torch.ops import binning as t_binning
from torch_port_helpers import (
    CPU, camera_to_torch, j_projected, jax_scene, jax_sorted_fields, npy, splats_to_torch,
    t_projected, to_config,
)

MAP_ARRAYS = ("dest_of_exp", "exp_rank", "exp_offsets", "exp_counts")
FORWARD_ARRAYS = ("pair_splat", "tile_start", "tile_count", "tile_base", "tile_phi", "tile_span",
                  "grad_base", "dropped_pairs")

CASES = {
    "basic": dict(),
    "budget_drops": dict(pair_budget_override=300),
    "tile_over_capacity": dict(tile_capacity=128),
    "soft_cutoff": dict(soft_cutoff=True),
}


def _both(jcfg, n=400, seed=1, order=False):
    jsplats, jcam = jax_scene(n=n, seed=seed)
    if order:
        # storage-order fields, depth permutation handed to the binning
        p = gj.project_splats(jsplats, jcam, jcfg.sh_order, tight_footprint=not jcfg.soft_cutoff)
        from gsplat_tpu.ops.rasterize_ref import sanitize_projected

        fields = np.asarray(sanitize_projected(p).fields)
        perm = np.argsort(fields[10], kind="stable").astype(np.int32)
        jb = j_bin_splats(j_projected(fields), jcam.width, jcam.height, jcfg, with_grad_map=True,
                          order=jax.numpy.asarray(perm))
        tb = t_binning.bin_splats(t_projected(fields), jcam.width, jcam.height, to_config(jcfg),
                                  with_grad_map=True, order=torch.from_numpy(perm).long())
    else:
        fields = jax_sorted_fields(jsplats, jcam, jcfg)
        jb = j_bin_splats(j_projected(fields), jcam.width, jcam.height, jcfg, with_grad_map=True)
        tb = t_binning.bin_splats(t_projected(fields), jcam.width, jcam.height, to_config(jcfg),
                                  with_grad_map=True)
    return jb, tb


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_map_arrays_equal_jax(case):
    kw = dict(tile_capacity=512, transmittance_eps=0.0)
    kw.update(CASES[case])
    jb, tb = _both(gj.RenderConfig(**kw))
    if case == "budget_drops" or case == "tile_over_capacity":
        assert int(jb.dropped_pairs) > 0  # the case is what its name says
    for name in MAP_ARRAYS + FORWARD_ARRAYS:
        a, b = np.asarray(getattr(jb, name)), npy(getattr(tb, name))
        assert b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    # a dropped pair carries the bitwise-not of its own expansion index
    dest = npy(tb.dest_of_exp)
    neg = np.nonzero(dest < 0)[0]
    np.testing.assert_array_equal(~dest[neg], neg)


def test_grad_map_with_order_equals_jax():
    jb, tb = _both(gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0), order=True)
    for name in MAP_ARRAYS + ("pair_splat", "grad_base"):
        np.testing.assert_array_equal(npy(getattr(tb, name)), np.asarray(getattr(jb, name)), err_msg=name)


def test_kept_pairs_land_in_their_tiles_region():
    """Every kept expansion pair's slot lies inside its tile's own region of
    the gradient address space, and no two pairs share a slot."""
    jcfg = gj.RenderConfig(tile_capacity=128, transmittance_eps=0.0)
    _, tb = _both(jcfg)
    dest = npy(tb.dest_of_exp)
    kept = dest[dest >= 0]
    assert len(np.unique(kept)) == len(kept)
    gbase, phi, span = npy(tb.grad_base), npy(tb.tile_phi), npy(tb.tile_span)
    lo = gbase + phi
    hi = gbase + span
    tile = np.searchsorted(gbase, kept, side="right") - 1
    # empty tiles share their base with the next tile; step back to the owner
    assert ((kept >= lo[tile]) & (kept < hi[tile]) | (span[tile] == 0)).all()
    assert int((span - phi).clip(min=0).sum()) == len(kept)
    assert kept.max() < t_binning.grad_pad_size(dest.shape[0], len(gbase), jcfg.chunk)


def test_zero_splats_returns_map_arrays_of_the_right_shapes():
    cfg = gt.RenderConfig(pair_budget_override=64)
    empty = t_projected(np.zeros((16, 0), np.float32))
    b = t_binning.bin_splats(empty, 64, 64, cfg, with_grad_map=True)
    assert tuple(b.dest_of_exp.shape) == (64,) and tuple(b.exp_rank.shape) == (64,)
    assert tuple(b.exp_offsets.shape) == (0,) and tuple(b.exp_counts.shape) == (0,)
    assert bool((b.dest_of_exp < 0).all()) and bool((b.exp_rank == -1).all())
    assert t_binning.bin_splats(empty, 64, 64, cfg).dest_of_exp is None


def test_render_without_gradient_bins_without_the_map(monkeypatch):
    """Serving pays for no training: no gradient map unless a splat tensor
    requires a gradient and gradients are enabled."""
    import dataclasses
    import importlib

    # the package's attribute ``render`` is the function; this is the module
    t_render = importlib.import_module("gsplat_tpu_torch.render")

    seen = []
    real = t_render.bin_splats

    def spy(*args, **kw):
        seen.append(bool(kw.get("with_grad_map", False)))
        return real(*args, **kw)

    monkeypatch.setattr(t_render, "bin_splats", spy)
    jsplats, jcam = jax_scene(n=60)
    splats, cam = splats_to_torch(jsplats), camera_to_torch(jcam)
    cfg = gt.RenderConfig(tile_capacity=256)
    gt.render(splats, cam, cfg)
    wants = dataclasses.replace(splats, pos=splats.pos.clone().requires_grad_(True))
    with torch.no_grad():
        gt.render(wants, cam, cfg)
    gt.render(wants, cam, cfg)
    assert seen == [False, False, True]
