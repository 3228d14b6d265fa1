"""Port vs JAX package: the slice as a whole — ``render`` through its
backends on CPU tensors (the main path then runs the plain versions of both
kernels) against ``gsplat_tpu.render_tiles``, ``render_pallas`` in interpret
mode, ``render_reference`` and the golden images.

Tolerance: image max|Δ| < 1e-5 (the goldens' own gate).  The two packages
run the same float32 ops in the same order; ``rsqrt``/``log``/``exp`` differ
by an ulp between XLA-CPU and PyTorch-CPU, which moves a pixel by ~1e-7.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.render import render_pallas
from gsplat_tpu_torch.ops.kernels import composite as tcomp
from gsplat_tpu_torch.ops.kernels import scan as tscan
from torch_port_helpers import CPU, camera_to_torch, jax_scene, npy, splats_to_torch, to_config

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
EXACT = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0)


@pytest.mark.parametrize("payload", ["float32", "packed"])
def test_render_matches_jax_tiles_and_pallas(payload):
    jcfg = dataclasses.replace(EXACT, payload_dtype=payload)
    js, jc = jax_scene(n=400, seed=1)
    ts, tc, tcfg = splats_to_torch(js), camera_to_torch(jc), to_config(jcfg)
    j_tiles = np.asarray(gj.render_tiles(js, jc, jcfg))
    j_pallas = np.asarray(render_pallas(js, jc, jcfg, interpret=True))
    scans, comps = tscan.launches, tcomp.launches
    t_tiles = npy(gt.render(ts, tc, tcfg, backend="tiles"))
    t_auto = npy(gt.render(ts, tc, tcfg, backend="auto"))
    t_cuda = npy(gt.render_cuda(ts, tc, tcfg))
    assert (tscan.launches, tcomp.launches) == (scans, comps)  # CPU: plain versions
    assert t_auto.shape == (64, 64, 4) and t_auto.dtype == np.float32
    assert np.array_equal(t_auto, t_cuda)
    for name, t in (("tiles", t_tiles), ("auto", t_auto)):
        assert np.abs(t - j_tiles).max() < 1e-5, name
        assert np.abs(t - j_pallas).max() < 1e-5, name


def test_render_reference_matches_jax():
    js, jc = jax_scene(n=100, seed=2, w=32, h=32)
    ts, tc = splats_to_torch(js), camera_to_torch(jc)
    for cfg_kw in (dict(), dict(soft_cutoff=True, sh_order=1)):
        jcfg = dataclasses.replace(EXACT, **cfg_kw)
        j = np.asarray(gj.render_reference(js, jc, jcfg))
        t = npy(gt.render(ts, tc, to_config(jcfg), backend="reference"))
        assert np.abs(t - j).max() < 1e-5


def _golden_scenes():
    # the two scenes of tests/test_goldens.py, rebuilt with the JAX generator
    return {
        "basic_400": (
            gj.random_splats(jax.random.PRNGKey(0), 400, extent=0.8, sh_scale=0.2),
            gj.make_camera(eye=[0.2, 0.4, 3.0], target=[0, 0, 0], width=96, height=64),
            EXACT,
        ),
        "soft_sh1": (
            gj.random_splats(jax.random.PRNGKey(3), 250, extent=0.7, sh_scale=0.3),
            gj.make_camera(eye=[-0.4, 0.2, 2.5], target=[0, 0.1, 0], width=64, height=96),
            gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0, soft_cutoff=True, sh_order=1),
        ),
    }


@pytest.mark.parametrize("name", ["basic_400", "soft_sh1"])
def test_goldens_hold(name):
    js, jc, jcfg = _golden_scenes()[name]
    ts, tc, tcfg = splats_to_torch(js), camera_to_torch(jc), to_config(jcfg)
    oracle = np.load(os.path.join(GOLDEN_DIR, f"{name}.oracle.npz"))["image"]
    binned = np.load(os.path.join(GOLDEN_DIR, f"{name}.binned.npz"))["image"]
    assert np.abs(npy(gt.render(ts, tc, tcfg, backend="reference")) - oracle).max() < 1e-5
    assert np.abs(npy(gt.render(ts, tc, tcfg, backend="tiles")) - binned).max() < 1e-5
    assert np.abs(npy(gt.render(ts, tc, tcfg, backend="auto")) - binned).max() < 1e-5


@pytest.mark.parametrize("backend", ["auto", "tiles", "reference"])
def test_empty_scenes_render_zeros(backend):
    js, _ = jax_scene(n=20)
    ts = splats_to_torch(js)
    away = gt.make_camera([0, 0, -5], [0, 0, -10], 64, 64, device=CPU)  # looking away
    img = gt.render(ts, away, to_config(EXACT), backend=backend)
    assert img.shape == (64, 64, 4) and float(img.abs().max()) == 0.0
    none = gt.make_splats(np.zeros((0, 3), np.float32), device=CPU)
    img, stats = gt.render(none, away, to_config(EXACT), backend=backend, with_stats=True)
    assert img.shape == (64, 64, 4) and float(img.abs().max()) == 0.0
    assert int(stats.dropped_pairs) == 0
    # held to the JAX package's oracle on the same scene of zero splats (its
    # tiled and Pallas backends raise on it, a quirk the port does not mirror)
    j_away = gj.make_camera(eye=[0, 0, -5], target=[0, 0, -10], width=64, height=64)
    want = np.asarray(gj.render_reference(gj.make_splats(np.zeros((0, 3), np.float32)), j_away, EXACT))
    assert want.shape == tuple(img.shape) and np.array_equal(npy(img), want)


def test_stats_and_tuned_budget_equal_jax():
    js, jc = jax_scene(n=400, seed=1)
    ts, tc = splats_to_torch(js), camera_to_torch(jc)
    jcfg = dataclasses.replace(EXACT, warn_on_drop=False)
    assert gt.measure_pairs(ts, tc, to_config(jcfg)) == gj.measure_pairs(js, jc, jcfg)
    jt = gj.tune_pair_budget(js, jc, jcfg, headroom=1.02, bucket=64)
    tt = gt.tune_pair_budget(ts, tc, to_config(jcfg), headroom=1.02, bucket=64)
    assert tt.pair_budget_override == jt.pair_budget_override > 0
    assert tt == to_config(jt)
    _, jstats = gj.render_tiles(js, jc, jt, with_stats=True)
    _, tstats = gt.render(ts, tc, tt, with_stats=True)
    assert int(tstats.dropped_pairs) == int(jstats.dropped_pairs) == 0
    # a budget that is too small drops pairs, and says how many (the count is
    # held against the JAX package's in tests/test_torch_binning.py)
    small = dataclasses.replace(to_config(jcfg), pair_budget_override=256)
    timg, tstats = gt.render(ts, tc, small, with_stats=True)
    assert int(tstats.dropped_pairs) == gt.measure_pairs(ts, tc, small) - 256
    assert torch.isfinite(timg).all()


def test_dropped_pairs_warn_once(caplog):
    js, jc = jax_scene(n=400, seed=1)
    ts, tc = splats_to_torch(js), camera_to_torch(jc)
    cfg = to_config(dataclasses.replace(EXACT, pair_budget_override=256))
    with caplog.at_level("WARNING", logger="gsplat_tpu_torch"):
        gt.render(ts, tc, cfg)
        gt.render(ts, tc, cfg)
    assert sum("dropped" in r.message for r in caplog.records) == 1


def test_background_and_composite_over():
    js, jc = jax_scene(n=400, seed=1)
    ts, tc, tcfg = splats_to_torch(js), camera_to_torch(jc), to_config(EXACT)
    bg = np.random.default_rng(0).uniform(size=(64, 64, 4)).astype(np.float32)
    j = np.asarray(gj.render(js, jc, EXACT, backend="tiles", background_rgba=bg))
    t = npy(gt.render(ts, tc, tcfg, background_rgba=torch.from_numpy(bg)))
    assert np.abs(t - j).max() < 1e-5


def test_later_slices_raise_not_implemented():
    js, jc = jax_scene(n=20)
    ts, tc, tcfg = splats_to_torch(js), camera_to_torch(jc), to_config(EXACT)
    # the strided tile mapping belongs to the sharded renderer's strips
    # (render_strip, render_sharded: tests/test_torch_sharded_render.py); a
    # full frame refuses it
    with pytest.raises(ValueError, match="stride"):
        gt.render(ts, tc, dataclasses.replace(tcfg, row_stride=2))
    with pytest.raises(ValueError, match="stride"):
        gt.render(ts, tc, dataclasses.replace(tcfg, col_stride=3), background_depth=torch.ones(64, 64))
    # the host-scene and wireframe modes render now (tests/test_torch_depth_composite.py,
    # tests/test_torch_wireframe.py); the depth test without a depth still raises, as in JAX
    assert gt.render(ts, tc, tcfg, background_depth=torch.ones(64, 64)).shape == (64, 64, 4)
    assert gt.render(ts, tc, dataclasses.replace(tcfg, wireframe=True)).shape == (64, 64, 4)
    with pytest.raises(ValueError, match="background_depth"):
        gt.render(ts, tc, dataclasses.replace(tcfg, depth_test=True))
    with pytest.raises(ValueError, match="unknown backend"):
        gt.render(ts, tc, tcfg, backend="pallas")
    with pytest.raises(ValueError, match="32"):
        gt.render(ts, tc, dataclasses.replace(tcfg, tile_h=16, tile_w=16))


def test_sat_cull_is_image_exact(monkeypatch):
    # the separating-axis cull only removes pairs that contribute exact zeros
    from gsplat_tpu_torch.ops import binning as tbin

    js, jc = jax_scene(n=400, seed=1)
    ts, tc, tcfg = splats_to_torch(js), camera_to_torch(jc), to_config(EXACT)
    with_cull = gt.render(ts, tc, tcfg)
    culled_pairs = int(tbin.bin_splats(_sorted(ts, tc, tcfg), 64, 64, tcfg).tile_count.sum())
    monkeypatch.setattr(tbin, "_SAT_CULL_ENABLED", False)
    all_pairs = int(tbin.bin_splats(_sorted(ts, tc, tcfg), 64, 64, tcfg).tile_count.sum())
    assert torch.equal(gt.render(ts, tc, tcfg), with_cull)
    assert culled_pairs < all_pairs == gt.measure_pairs(ts, tc, tcfg)


def _sorted(ts, tc, tcfg):
    from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, sanitize_projected
    from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth

    p = gt.project_splats(ts, tc, tcfg.sh_order, tight_footprint=True)
    return sort_by_depth(quantize_payload(sanitize_projected(p), tcfg))


def test_depth_order_matches_jax():
    js, jc = jax_scene(n=400, seed=1)
    j = np.asarray(gj.depth_order(js, jc))
    t = npy(gt.depth_order(splats_to_torch(js), camera_to_torch(jc)))
    assert np.array_equal(t, j)
    ts, tc, tcfg = splats_to_torch(js), camera_to_torch(jc), to_config(EXACT)
    a = gt.render_cuda(ts, tc, tcfg, order=torch.from_numpy(t))
    assert torch.equal(a, gt.render_cuda(ts, tc, tcfg))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, gsplat_tpu_torch, gsplat_tpu_torch.render, "
        "gsplat_tpu_torch.ops.kernels.scan, gsplat_tpu_torch.ops.kernels.composite, "
        "gsplat_tpu_torch.ops.kernels._build, gsplat_tpu_torch.scene, gsplat_tpu_torch.io.ply, "
        "gsplat_tpu_torch.io.attributes, gsplat_tpu_torch.io.json_io, gsplat_tpu_torch.io.native, "
        "gsplat_tpu_torch.ops.queries, gsplat_tpu_torch.graphs\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'jaxlib' or m == 'gsplat_tpu' or m.startswith('gsplat_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
