"""Port vs JAX package: compositing into a host scene — the depth test
against a scene depth buffer (forward and backward) and the under-composite
over the scene colour.

``render(backend="cuda")`` on CPU tensors runs the kernel path with the
compositor's plain versions (what the CUDA kernels are held against on the
card); ``"tiles"`` and ``"reference"`` are the port's plain renderers.  The
occluder is the JAX package's own (``tests/test_depth_composite.py``): a
slanted plane of view depth 2.0 → 3.5 across the image.

Tolerances: image max|Δ| < 1e-5; whole-render gradients 2e-4·max(1, |g|max)
per field (the gate of the JAX package's on-chip check); the cotangents of
the view-z row and of the scene depth are exact zeros (the test is a hard
mask).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops.pallas import composite as jcomp
from gsplat_tpu_torch.ops.kernels import composite as tcomp
from torch_port_helpers import (
    camera_to_torch,
    j_projected,
    jax_scene,
    npy,
    splats_to_torch,
    to_config,
)

JCFG = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0)
FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")


def occluder(w, h):
    xs = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    bgd = ((2.0 + 1.5 * xs) * np.ones((h, 1), np.float32)).astype(np.float32)
    bg_rgba = np.concatenate([np.full((h, w, 3), 0.3, np.float32), np.ones((h, w, 1), np.float32)], axis=-1)
    return bgd, bg_rgba


def _scene(n=300, w=96, h=64, seed=0):
    js, jc = jax_scene(n=n, seed=seed, w=w, h=h, extent=0.9, eye=(0.0, 0.5, 3.0))
    return js, jc, splats_to_torch(js), camera_to_torch(jc)


@pytest.mark.parametrize("backend", ["cuda", "tiles", "reference"])
def test_depth_tested_image_matches_jax(backend):
    js, jc, ts, tc = _scene()
    bgd, bg_rgba = occluder(96, 64)
    jbe = "reference" if backend == "reference" else "tiles"
    want = np.asarray(gj.render(js, jc, JCFG, backend=jbe, background_rgba=bg_rgba, background_depth=bgd))
    got = npy(gt.render(ts, tc, to_config(JCFG), backend=backend, background_rgba=torch.from_numpy(bg_rgba),
                        background_depth=torch.from_numpy(bgd)))
    assert got.shape == (64, 96, 4)
    assert np.abs(got - want).max() < 1e-5
    # the plane is load-bearing: the same frame without it differs
    free = npy(gt.render(ts, tc, to_config(JCFG), backend=backend, background_rgba=torch.from_numpy(bg_rgba)))
    assert np.abs(got - free).max() > 1e-3


def test_depth_tested_kernel_path_matches_pallas_interpret():
    js, jc, ts, tc = _scene(n=200, w=64, h=64, seed=1)
    bgd, _ = occluder(64, 64)
    want = np.asarray(gj.render(js, jc, JCFG, backend="pallas_interpret", background_depth=bgd))
    got = npy(gt.render(ts, tc, to_config(JCFG), backend="cuda", background_depth=torch.from_numpy(bgd)))
    assert np.abs(got - want).max() < 1e-5
    assert want[..., 3].max() > 0.5


def test_plain_compositor_depth_mode_matches_pallas_forward_on_the_same_inputs():
    """Compositor level, the JAX binning's arrays as the input of both: the
    11-row payload (row 10 = view-z), a NaN row in the scene depth (a NaN
    kills), the early stop on, the stop counters equal."""
    from torch_port_helpers import jax_sorted_fields

    js, jc = jax_scene(n=400, seed=1, w=70, h=45, eye=(0.2, 0.4, 2.2))
    jcfg = dataclasses.replace(JCFG, depth_test=True, transmittance_eps=1e-3)
    f = jax_sorted_fields(js, jc, jcfg, n_rows=15)
    jb = jbin.bin_splats(j_projected(f), 70, 45, jcfg, with_tiles=False)
    nty, ntx = jbin.tile_grid(70, 45, 32, 32)
    bgd, _ = occluder(70, 45)
    bgd[20] = np.nan
    rows = np.concatenate([f[:10], f[14:15]], axis=0)
    payload = jcomp._gather_payload(jnp.asarray(rows), jb.pair_splat, jcfg)
    fwd = jcomp._build_kernels(nty, ntx, payload.shape[1], 0, jcfg, True)[0]
    out, jused = fwd(jb.tile_base, jb.tile_phi, jb.tile_span, jnp.zeros((2,), jnp.int32), payload,
                     jcomp.pack_depth_packed(jnp.asarray(bgd), nty, ntx))
    jimg = np.asarray(jcomp.unpack_image(out, 45, 70))
    ti = lambda a: torch.from_numpy(np.array(a, copy=True))
    timg, tused = tcomp.composite_splats(
        ti(rows), ti(jb.pair_splat), ti(jb.tile_base), ti(jb.tile_phi), ti(jb.tile_span),
        nty, ntx, 45, 70, to_config(jcfg), bg_depth=ti(bgd),
    )
    assert np.abs(npy(timg) - jimg).max() < 1e-5
    assert np.array_equal(npy(tused), np.asarray(jused))
    assert np.abs(npy(timg)[20]).max() == 0.0  # the NaN row is killed everywhere


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_depth_tested_gradients_match_jax(soft):
    jcfg = dataclasses.replace(JCFG, soft_cutoff=soft)
    js, jc, ts, tc = _scene(n=150, w=64, h=64, seed=2)
    bgd, _ = occluder(64, 64)
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (64, 64, 4)))
    want = jax.grad(
        lambda s: jnp.sum(gj.render(s, jc, jcfg, backend="tiles", background_depth=bgd) * w)
    )(js)
    leaves = {f: getattr(ts, f).clone().requires_grad_(True) for f in FIELDS}
    image = gt.render(dataclasses.replace(ts, **leaves), tc, to_config(jcfg), backend="cuda",
                      background_depth=torch.from_numpy(bgd))
    (image * torch.from_numpy(np.array(w))).sum().backward()
    for f in FIELDS:
        a, b = np.asarray(getattr(want, f)), npy(leaves[f].grad)
        assert np.isfinite(b).all(), f
        assert np.abs(b - a).max() <= 2e-4 * max(1.0, np.abs(a).max()), (f, np.abs(b - a).max())


def test_view_z_row_and_scene_depth_get_exact_zero_cotangents():
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.projection import ProjectedSplats
    from torch_port_helpers import jax_sorted_fields

    js, jc = jax_scene(n=150, seed=3)
    cfg = to_config(dataclasses.replace(JCFG, depth_test=True))
    fields = torch.from_numpy(np.array(jax_sorted_fields(js, jc, JCFG, n_rows=15)))
    b = binning.bin_splats(ProjectedSplats(fields=fields), 64, 64, cfg, with_tiles=False, with_grad_map=True)
    rows = torch.cat([fields[:10], fields[14:15]]).clone().requires_grad_(True)
    bgd = torch.from_numpy(occluder(64, 64)[0]).requires_grad_(True)
    image = tcomp.composite_splats_diff(rows, b, 2, 2, 64, 64, cfg, bg_depth=bgd)
    image.sum().backward()
    assert float(rows.grad[10].abs().max()) == 0.0
    assert float(bgd.grad.abs().max()) == 0.0 and bgd.grad.shape == bgd.shape
    assert float(rows.grad[:10].abs().max()) > 0.0


def test_scene_depth_limits_and_what_raises():
    js, jc, ts, tc = _scene(n=200, seed=4)
    cfg = to_config(JCFG)
    _, bg_rgba = occluder(96, 64)
    bg = torch.from_numpy(bg_rgba)
    free = gt.render(ts, tc, cfg, background_rgba=bg)
    # a scene depth at +inf is no test at all; at 0 the splats vanish
    far = gt.render(ts, tc, cfg, background_rgba=bg, background_depth=torch.full((64, 96), float("inf")))
    assert torch.equal(far, free)
    near = gt.render(ts, tc, cfg, background_rgba=bg, background_depth=torch.zeros((64, 96)))
    assert torch.equal(near, bg)
    with pytest.raises(ValueError, match="background_depth"):
        gt.render(ts, tc, dataclasses.replace(cfg, depth_test=True))
    with pytest.raises(ValueError, match="packed"):
        gt.RenderConfig(payload_dtype="packed", depth_test=True)
    with pytest.raises(ValueError, match="packed"):  # as in JAX: the config refuses the pair
        gt.render(ts, tc, dataclasses.replace(cfg, payload_dtype="packed"),
                  background_depth=torch.zeros((64, 96)))
    with pytest.raises(ValueError, match="stride"):  # strides map the sharded renderer's strips
        gt.render(ts, tc, dataclasses.replace(cfg, row_stride=2), background_depth=torch.zeros((64, 96)))
