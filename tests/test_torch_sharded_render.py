"""Port vs JAX package: the sharded renderer (``parallel/render_sharded.py``,
``render.render_strip``) and the strided/offset tile mapping of the
compositors, on the CPU.

* ``_factor_grid`` and ``measure_strip_counts`` equal the JAX package's;
* one strip of a strided grid through the port's kernel path (the plain
  compositor in its strided mode) and its tiled path agree with the JAX
  package's ``_render_strip(backend="tiles")`` within 1e-5, and its gradient
  with ``jax.grad`` through that call within 2e-4 of the field's own
  max|g| (no floor);
* ``render_sharded`` over 2 and 4 spawned gloo ranks (``torch_dist_worker``),
  under the three exchange policies, is bit-equal to the port's
  single-device render of the padded scene (``transmittance_eps = 0``: the
  same pairs in the same order) and within 1e-5 of ``gsplat_tpu.render_tiles``;
  the gradient over 2 ranks within 2e-4 of the single-device one (of each
  field's own max|g|; every rank's block is large enough that a gradient
  that did not arrive would fail).

The JAX package's own sharded paths with gradients or in interpret mode are
not called here: they take minutes on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
import torch_dist_worker
from gsplat_tpu.parallel import render_sharded as jrs
from gsplat_tpu.ops.rasterize_ref import quantize_payload as jq, sanitize_projected as jsan
from gsplat_tpu.ops.rasterize_tiles import sort_by_depth as jsort
from gsplat_tpu_torch.ops.kernels import composite as tcomp
from gsplat_tpu_torch.ops.projection import project_splats as t_project
from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload as tq, sanitize_projected as tsan
from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth as tsort
from gsplat_tpu_torch.parallel import render_sharded as trs
from gsplat_tpu_torch.render import render_strip
from torch_port_helpers import camera_to_torch, jax_scene, npy, splats_to_torch, to_config

FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")
EXACT = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0)
W, H = 96, 80  # 3 × 3 tiles, the bottom row cut: the padded frame is cropped


def test_factor_grid_matches_jax():
    # tile grids with ties (square grids, d a square) and lopsided ones
    for nty, ntx in ((3, 3), (2, 3), (8, 8), (34, 60), (1, 7), (5, 1), (4, 16)):
        for d in range(1, 33):
            assert trs._factor_grid(d, nty, ntx) == jrs._factor_grid(d, nty, ntx), (d, nty, ntx)
    # the first candidate wins a tie: dy = 1 over dy = 2 for d = 2 on a square grid
    assert trs._factor_grid(2, 3, 3) == (1, 2)
    assert trs._factor_grid(4, 34, 60) == (2, 2)


@pytest.mark.parametrize("d", [2, 4])
def test_measure_strip_counts_matches_jax(d):
    js, jc = jax_scene(n=203, seed=3, w=W, h=H)  # 203: the last shard is padded
    want = jrs.measure_strip_counts(js, jc, d, EXACT)
    got = gt.measure_strip_counts(splats_to_torch(js), camera_to_torch(jc), d, to_config(EXACT))
    assert got.shape == (d, d) and got.sum() > 0
    assert np.array_equal(got, want)


def _sorted_fields(splats, cam, cfg):
    p = t_project(splats, cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff)
    return tsort(tq(tsan(p), cfg))


def _j_sorted_fields(splats, cam, cfg):
    p = gj.project_splats(splats, cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff)
    return jsort(jq(jsan(p), cfg))


# (strides, offsets, strip size, strips, payload): a 2 × 2 cyclic cell, a
# column-strided cell, a contiguous strip at a row offset
STRIP_CASES = [
    ((2, 2), (1, 1), (64, 64), 4, "float32"),
    ((1, 2), (0, 1), (96, 64), 2, "packed"),
    ((1, 1), (1, 0), (32, 96), 3, "bfloat16"),
]


@pytest.mark.parametrize("strides,offsets,size,n_strips,payload", STRIP_CASES,
                         ids=["cyclic-2x2", "cols-1x2", "row-offset"])
def test_strided_strip_matches_jax(strides, offsets, size, n_strips, payload):
    jcfg = dataclasses.replace(EXACT, row_stride=strides[0], col_stride=strides[1], payload_dtype=payload)
    js, jc = jax_scene(n=300, seed=4, w=W, h=H)
    (strip_h, strip_w), (row_off, col_off) = size, offsets
    # the JAX side's projection eagerly (op by op, as the port runs), its
    # strip render under jit
    want, j_drop = jax.jit(lambda p: jrs._render_strip(p, strip_w, strip_h, row_off, jcfg, "tiles",
                                                       n_strips=n_strips, col_offset=col_off))(
        _j_sorted_fields(js, jc, jcfg))
    want = np.asarray(want)
    assert int(j_drop) == 0 and want[..., 3].max() > 0.5
    tcfg = to_config(jcfg)
    p = _sorted_fields(splats_to_torch(js), camera_to_torch(jc), tcfg)
    for backend in ("cuda", "tiles"):  # the plain strided compositor; the plain tiled one
        got, dropped = render_strip(p, strip_w, strip_h, row_off, tcfg, backend, n_strips=n_strips,
                                    col_offset=col_off)
        assert int(dropped) == 0
        assert got.shape == (strip_h, strip_w, 4)
        assert np.abs(npy(got) - want).max() < 1e-5, backend


def test_strided_backward_matches_jax_grad():
    jcfg = dataclasses.replace(EXACT, row_stride=2, col_stride=2)
    js, jc = jax_scene(n=200, seed=5, w=W, h=H)
    weights = np.array(jax.random.normal(jax.random.PRNGKey(8), (64, 64, 4)))

    def j_loss(s):
        img, _ = jrs._render_strip(_j_sorted_fields(s, jc, jcfg), 64, 64, 1, jcfg, "tiles", n_strips=4,
                                   col_offset=0)
        return jnp.sum(img * weights)

    want = jax.jit(jax.grad(j_loss))(js)
    splats, cam, tcfg = splats_to_torch(js), camera_to_torch(jc), to_config(jcfg)
    leaves = {f: getattr(splats, f).clone().requires_grad_(True) for f in FIELDS}
    p = _sorted_fields(dataclasses.replace(splats, **leaves), cam, tcfg)
    img, _ = render_strip(p, 64, 64, 1, tcfg, "cuda", n_strips=4, col_offset=0)
    (img * torch.from_numpy(weights)).sum().backward()
    for f in FIELDS:
        a = np.asarray(getattr(want, f))
        err = np.abs(npy(leaves[f].grad) - a).max()
        assert err <= 2e-4 * np.abs(a).max(), (f, err)
    assert max(np.abs(np.asarray(getattr(want, f))).max() for f in FIELDS) > 0


def _policies(js, jc, d):
    """The three exchange policies: f32 gather, bf16 gather (both cyclic),
    the strip exchange (contiguous) with the tuned factor.  Where the tuner
    keeps the gather (a factor ≥ 1 − 1/d saves nothing, as on this small
    frame), the measured worst share itself: the tightest bucket that cannot
    overflow."""
    tuned = jrs.tune_strip_exchange(js, jc, d, EXACT).strip_exchange_factor
    port = gt.tune_strip_exchange(splats_to_torch(js), camera_to_torch(jc), d, to_config(EXACT))
    assert port.strip_exchange_factor == tuned
    if tuned == 0.0:
        n_local = -(-js.count // d)
        tuned = int(jrs.measure_strip_counts(js, jc, d, EXACT).max()) / n_local
    return [EXACT, dataclasses.replace(EXACT, payload_dtype="bfloat16"),
            dataclasses.replace(EXACT, payload_dtype="packed", strip_exchange_factor=tuned)]


@pytest.mark.parametrize("d", [2, 4])
def test_render_sharded_gloo_matches_single_device(d, tmp_path):
    js, jc = jax_scene(n=198, seed=6, w=W, h=H)  # 198: padded to 200 over 4 ranks
    configs = _policies(js, jc, d)
    job = {"splats": gj.to_numpy_dict(js), "camera": (np.asarray(jc.view), np.asarray(jc.proj), W, H),
           "configs": [dataclasses.asdict(c) for c in configs], "backend": "auto",
           "weights": np.array(jax.random.normal(jax.random.PRNGKey(d), (H, W, 4))) if d == 2 else None}
    results = torch_dist_worker.run("render", d, tmp_path, job)

    padded = jrs.pad_splats(js, d)
    t_padded = splats_to_torch(padded)
    tcam = camera_to_torch(jc)
    for k, jcfg in enumerate(configs):
        single_cfg = dataclasses.replace(to_config(jcfg), strip_exchange_factor=0.0)
        single = npy(gt.render(t_padded, tcam, single_cfg, backend="auto"))
        want = np.asarray(gj.render_tiles(padded, jc, dataclasses.replace(jcfg, strip_exchange_factor=0.0)))
        for r in results:
            img = r["images"][k]
            assert img.shape == (H, W, 4)
            assert np.array_equal(img, single), (k, np.abs(img - single).max())
            assert np.abs(img - want).max() < 1e-5
            assert r["dropped"][k] == 0 and r["exchange_dropped"][k] == 0
    assert single[..., 3].max() > 0.5
    if d == 2:
        leaves = {f: getattr(t_padded, f).clone().requires_grad_(True) for f in FIELDS}
        img = gt.render(dataclasses.replace(t_padded, **leaves), tcam, to_config(configs[0]), backend="auto")
        (img * torch.from_numpy(job["weights"])).sum().backward()
        blocks = sorted(results, key=lambda r: r["block"])
        for f in FIELDS:
            want = npy(leaves[f].grad)
            got = np.concatenate([r["grads"][f] for r in blocks], axis=-1)
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 2e-4 * scale, f
            # a rank whose gradient did not arrive fails the gate
            for r in blocks:
                cols = slice(r["block"] * r["grads"][f].shape[-1], (r["block"] + 1) * r["grads"][f].shape[-1])
                assert np.abs(want[..., cols]).max() > 2e-4 * scale, (f, r["block"])
        assert np.abs(npy(leaves["pos"].grad)).max() > 0


def test_depth_test_and_missing_mesh_raise():
    js, jc = jax_scene(n=20, w=64, h=64)
    splats, cam = splats_to_torch(js), camera_to_torch(jc)
    mesh = gt.splat_mesh(device="cpu")  # one process: a 1-rank mesh
    with pytest.raises(ValueError, match="depth"):
        gt.render_sharded(splats, cam, gt.RenderConfig(depth_test=True), mesh)
    with pytest.raises(ValueError, match="mesh"):
        gt.render_sharded(splats, cam, gt.RenderConfig())
    # so do a strip render and the compositors' strided mapping: the scene
    # depth is the local image's
    with pytest.raises(ValueError, match="depth"):
        render_strip(_sorted_fields(splats, cam, gt.RenderConfig()), 64, 32, 1,
                     gt.RenderConfig(depth_test=True), "cuda", n_strips=2)
    with pytest.raises(ValueError, match="depth"):
        tcomp.tile_mapping(gt.RenderConfig(depth_test=True, row_stride=2), (0, 0))
    assert tcomp.tile_mapping(gt.RenderConfig(depth_test=True), (0, 0)) == (1, 1, 0, 0)
