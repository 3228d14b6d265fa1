"""The port against the JAX package in what only the large configurations
reach (the trained-statistics scene, the 2^23 envelope's tile capacity 16384
and chunk 256): a chunk of 256 with a tile deeper than the default capacity,
the binning's wide (tile, rank) key, the exact-coverage cull switched off by
its threshold, and a trained-statistics scene that loads a tile to its
capacity.  Inputs are made with numpy or the JAX package from a seed and
carried across with ``splats_from_numpy``; the JAX side runs as its own tests
run it on the CPU (``render_tiles`` under ``jax.grad``, ``bin_splats`` with
its scans' interpreter).

Tolerances: the image within 1e-5; each field's gradient within 2e-4 of the
field's max and in the 2-norm (the sums over pairs and pixels run in another
order); every integer array of the binning equal."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops.kernels import frame_glue as kglue
from torch_port_helpers import camera_to_torch, j_projected, jax_sorted_fields, npy, splats_to_torch, t_projected
from torch_port_helpers import to_config

FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")
IMAGE_TOL = 1e-5
GRAD_TOL = 2e-4
BIN_ARRAYS = ("pair_splat", "pair_tile", "tile_start", "tile_count", "tile_base", "tile_phi", "tile_span",
              "grad_base", "dropped_pairs")
GRAD_MAP_ARRAYS = ("dest_of_exp", "exp_offsets", "exp_counts", "exp_rank")


def _deepest_tile(jsplats, jcam, jcfg):
    """The most pairs a tile of the frame holds, under no capacity."""
    wide = dataclasses.replace(jcfg, tile_capacity=-(-jcfg.pair_budget(jsplats.count) // jcfg.chunk) * jcfg.chunk)
    f = jax_sorted_fields(jsplats, jcam, wide)
    b = tbin.bin_splats(t_projected(f), jcam.width, jcam.height, to_config(wide), with_tiles=False)
    return int(b.tile_count.max())


def _hold_render_and_gradient(jsplats, jcam, jcfg, seed):
    """The port's kernel path (plain versions on the CPU) against the JAX
    package's render_tiles: the image, and the gradient of a seeded weighted
    sum of it over the six fields.  Returns the port's dropped_pairs."""
    w = np.random.default_rng(seed).standard_normal((jcam.height, jcam.width, 4)).astype(np.float32)
    want_img = np.asarray(gj.render_tiles(jsplats, jcam, jcfg))
    want = jax.grad(lambda s: jnp.sum(gj.render_tiles(s, jcam, jcfg) * w))(jsplats)
    splats, cam = splats_to_torch(jsplats), camera_to_torch(jcam)
    leaves = {f: getattr(splats, f).clone().requires_grad_(True) for f in FIELDS}
    image, stats = gt.render(dataclasses.replace(splats, **leaves), cam, to_config(jcfg), with_stats=True)
    assert np.abs(npy(image) - want_img).max() < IMAGE_TOL
    (image * torch.from_numpy(w)).sum().backward()
    for f in FIELDS:
        a, b = np.asarray(getattr(want, f)), npy(leaves[f].grad)
        assert np.isfinite(b).all(), f
        assert np.abs(b - a).max() <= GRAD_TOL * np.abs(a).max(), (f, np.abs(b - a).max(), np.abs(a).max())
        assert np.linalg.norm(b - a) <= GRAD_TOL * np.linalg.norm(a), (f, np.linalg.norm(b - a))
    return int(stats.dropped_pairs)


def test_chunk_256_with_a_tile_deeper_than_4096():
    """chunk 256 and tile_capacity 4608: 4,500 splats in a cluster at the
    corner of four tiles, each of which holds more than 4096 pairs."""
    js = gj.random_splats(jax.random.PRNGKey(3), 4500, extent=0.05, sh_scale=0.2)
    js = dataclasses.replace(js, opacity=js.opacity * 0.05)
    jc = gj.make_camera(eye=[0.0, 0.0, 3.0], target=[0, 0, 0], width=64, height=64)
    jcfg = gj.RenderConfig(chunk=256, tile_capacity=4608, pairs_per_splat=4.0, transmittance_eps=0.0)
    assert 4096 < _deepest_tile(js, jc, jcfg) <= 4608
    assert _hold_render_and_gradient(js, jc, jcfg, seed=5) == 0


def _wide_key_fields(n, w, h, seed=21):
    """Depth-sorted synthetic fields of small splats spread over a (w, h)
    frame: about 1.5 pairs a splat."""
    rng = np.random.default_rng(seed)
    f = np.zeros((16, n), np.float32)
    f[0], f[1] = rng.uniform(0, w, n), rng.uniform(0, h, n)
    f[2], f[5] = rng.uniform(0.2, 0.5, n), rng.uniform(0.2, 0.5, n)
    f[3], f[4] = rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n)
    f[9] = rng.uniform(0.001, 1.0, n)
    f[10] = np.sort(rng.uniform(1.0, 10.0, n))
    f[11] = 1.0
    f[12], f[13] = rng.uniform(1.0, 6.0, n), rng.uniform(1.0, 6.0, n)
    return f


@pytest.mark.parametrize("with_grad_map", [False, True], ids=["frame", "grad_map"])
def test_wide_key_binning_equal_to_jax(with_grad_map):
    """The smallest case where (tile, rank) does not fit one int32 key:
    65,537 splats (17 rank bits) over 4096x4096 (16,384 tiles), chunk 256,
    capacity 16384, a budget of 2 pairs a splat.  Both the sorted-fields form
    and the frame's operands form (gather_payload's, render_cuda's) bin
    exactly the JAX package's arrays."""
    n, w, h = 65_537, 4096, 4096
    f = _wide_key_fields(n, w, h)
    jcfg = gj.RenderConfig(chunk=256, tile_capacity=16384, pairs_per_splat=2.0, transmittance_eps=0.0)
    cfg = to_config(jcfg)
    nty, ntx = tbin.tile_grid(w, h, 32, 32)
    assert not kglue.key_fits(nty * ntx, n) and kglue.key_fits(nty * ntx, n - 1)
    jb = jbin.bin_splats(j_projected(f), w, h, jcfg, with_grad_map=with_grad_map)
    tb = tbin.bin_splats(t_projected(f), w, h, cfg, with_grad_map=with_grad_map)
    _, rho_ok = tbin.sat_flags(n, w, h, cfg)
    ops = kglue.gather_payload(torch.from_numpy(f), torch.arange(n), w, h, cfg, rho_ok).operands
    tb_ops = tbin.bin_splats(None, w, h, cfg, with_grad_map=with_grad_map, operands=ops)
    assert int(tb.dropped_pairs) == 0
    names = BIN_ARRAYS + (GRAD_MAP_ARRAYS if with_grad_map else ())
    for name in names:
        j = np.asarray(getattr(jb, name))
        for t in (tb, tb_ops):
            assert np.array_equal(npy(getattr(t, name)), j), name


def test_sat_cull_switched_off_by_its_threshold(monkeypatch):
    """GSPLAT_SAT_MAX_N below N in both packages (as above 4,194,304 splats
    by default): the image and the gradient still equal the JAX package's."""
    js, jc = gj.random_splats(jax.random.PRNGKey(1), 400, extent=0.8, sh_scale=0.2), None
    jc = gj.make_camera(eye=[0.2, 0.4, 3.0], target=[0, 0, 0], width=70, height=45)
    monkeypatch.setattr(jbin, "_SAT_CULL_MAX_N", 399)
    monkeypatch.setattr(tbin, "_SAT_CULL_MAX_N", 399)
    jcfg = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0)
    assert tbin.sat_flags(400, 70, 45, to_config(jcfg)) == (False, False)
    assert _hold_render_and_gradient(js, jc, jcfg, seed=7) == 0


def test_trained_statistics_scene_loads_a_tile_to_capacity(monkeypatch):
    """The JAX package's trained_like_splats (needle splats, a
    near-transparent tail, clustered positions), carried across; the
    capacity is the smallest multiple of the chunk that drops no pair, so
    the deepest tile fills it to within one chunk.

    Its many sub-pixel splats are isotropic on screen after the low-pass
    dilation, where the quad basis' eigen direction is undefined and the
    projection's VJP of both packages amplifies an ulp of its cotangent by
    orders of magnitude (ROADMAP.md, queue 3: the JAX package's own gradient
    moves by 2e-3 of the scale's max under a 1e-6 relative change of the
    image cotangent here).  So the gradient is held in its two
    well-conditioned halves: the cotangent of the projected fields (the
    compositing chain's gradient) against the JAX chain's, and the six
    fields' gradient against the JAX projection's VJP of the port's own
    field cotangent, each within 2e-4 of each row's or field's max and in
    the 2-norm."""
    from gsplat_tpu.ops.projection import ProjectedSplats as JProjected
    from gsplat_tpu.ops.rasterize_ref import quantize_payload, sanitize_projected
    from gsplat_tpu.ops.rasterize_tiles import build_tile_lists, composite_tile_lists, sort_by_depth
    render_mod = importlib.import_module("gsplat_tpu_torch.render")

    js = gj.trained_like_splats(jax.random.PRNGKey(4), 3000, extent=1.2, sh_scale=0.1)
    jc = gj.make_camera(eye=[0.0, 0.4, 3.0], target=[0, 0, 0], width=96, height=64)
    jcfg = gj.RenderConfig(chunk=16, pairs_per_splat=8.0, transmittance_eps=0.0)
    deepest = _deepest_tile(js, jc, jcfg)
    jcfg = dataclasses.replace(jcfg, tile_capacity=-(-deepest // 16) * 16)
    assert jcfg.tile_capacity - 16 < deepest <= jcfg.tile_capacity
    w = np.random.default_rng(9).standard_normal((jc.height, jc.width, 4)).astype(np.float32)

    def jfields(s):
        return quantize_payload(sanitize_projected(gj.project_splats(s, jc, 3, tight_footprint=True)), jcfg).fields

    def jloss(fields):
        p = sort_by_depth(JProjected(fields=fields))
        lists = build_tile_lists(jbin.bin_splats(p, jc.width, jc.height, jcfg), 6, jcfg.tile_capacity, p.count)
        return jnp.sum(composite_tile_lists(lists, p.fields, jc.width, jc.height, jcfg) * w)

    # the port's kernel path, with the cotangent of its projected fields kept
    seen = {}
    project = render_mod.project_splats

    def spy(*args, **kwargs):
        projected = project(*args, **kwargs)
        projected.fields.register_hook(lambda g: seen.setdefault("d_fields", g))
        return projected

    monkeypatch.setattr(render_mod, "project_splats", spy)
    splats, cam = splats_to_torch(js), camera_to_torch(jc)
    leaves = {f: getattr(splats, f).clone().requires_grad_(True) for f in FIELDS}
    image, stats = gt.render(dataclasses.replace(splats, **leaves), cam, to_config(jcfg), with_stats=True)
    assert int(stats.dropped_pairs) == 0
    assert np.abs(npy(image) - np.asarray(gj.render_tiles(js, jc, jcfg))).max() < IMAGE_TOL
    (image * torch.from_numpy(w)).sum().backward()

    d_fields = npy(seen["d_fields"])
    want = np.asarray(jax.grad(jloss)(jfields(js)))
    for r in range(want.shape[0]):
        a, b = want[r], d_fields[r]
        assert np.abs(b - a).max() <= GRAD_TOL * np.abs(a).max(), (r, np.abs(b - a).max(), np.abs(a).max())
        assert np.linalg.norm(b - a) <= GRAD_TOL * np.linalg.norm(a), (r, np.linalg.norm(b - a))
    _, vjp = jax.vjp(jfields, js)
    want = vjp(jnp.asarray(d_fields))[0]
    for f in FIELDS:
        a, b = np.asarray(getattr(want, f)), npy(leaves[f].grad)
        assert np.isfinite(b).all(), f
        assert np.abs(b - a).max() <= GRAD_TOL * np.abs(a).max(), (f, np.abs(b - a).max(), np.abs(a).max())
        assert np.linalg.norm(b - a) <= GRAD_TOL * np.linalg.norm(a), (f, np.linalg.norm(b - a))
