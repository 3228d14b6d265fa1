"""Port vs JAX package: the wireframe debug views (``render_wireframe``,
``render_wire_over``) and the compositor's band-test mode.

``render_wireframe(backend="cuda")`` on CPU tensors runs the kernel path
with the compositor's plain version (what the CUDA kernel is held against on
the card).  Tolerance: image max|Δ| < 1e-5 — in practice bit-equal: a band
hit is an opaque 1.  The band edge is a hard threshold, so a one-ulp
difference in the projected quad basis can flip a whole line pixel; the
scenes are those of the JAX package's own tests (``tests/
test_wireframe_profiling.py``), on which its kernel and oracle agree, and
the compositor-level case feeds both packages the JAX binning's arrays.
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
from gsplat_tpu.ops.wireframe import _wireframe_pallas, render_wire_over, render_wireframe
from gsplat_tpu_torch.ops.kernels import composite as tcomp
from torch_port_helpers import camera_to_torch, j_projected, npy, splats_to_torch, to_config


def _scene(n=60, seed=3):
    """``TestWireframePallas._scene`` of the JAX package's tests."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scale = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.1, 1.0, n).astype(np.float32)
    color = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return gj.make_splats(pos, q, scale, opacity, color)


def _both(js, jc):
    return splats_to_torch(js), camera_to_torch(jc)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_kernel_path_matches_jax_oracle_and_port_oracle(soft):
    """A soft-cutoff config draws the same outlines: the band test reads no
    cutoff."""
    js = _scene()
    jc = gj.make_camera([0, 0, 2.5], [0, 0, 0], 96, 64)
    ts, tc = _both(js, jc)
    want = np.asarray(render_wireframe(js, jc, backend="reference"))
    got = npy(gt.render_wireframe(ts, tc, gt.RenderConfig(soft_cutoff=soft)))
    assert got.shape == (64, 96, 4) and want[..., 3].sum() > 50
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(npy(gt.render_wireframe(ts, tc, backend="reference")) - want).max() < 1e-5


def test_kernel_path_matches_jax_pallas_interpret():
    js = _scene(40, seed=5)
    jc = gj.make_camera([0, 0, 2.5], [0, 0, 0], 64, 64)
    ts, tc = _both(js, jc)
    cfg = gj.RenderConfig()
    want = np.asarray(_wireframe_pallas(js, jc, cfg, 1.0, None, True))
    got = npy(gt.render_wireframe(ts, tc, to_config(cfg)))
    assert np.abs(got - want).max() < 1e-5 and want[..., 3].sum() > 20


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_background_and_line_width(backend):
    js = _scene(20)
    jc = gj.make_camera([0, 0, 2.5], [0, 0, 0], 64, 64)
    ts, tc = _both(js, jc)
    bg = [0.2, 0.3, 0.4]
    want = np.asarray(render_wireframe(js, jc, line_px=2.0, background=bg, backend="reference"))
    got = npy(gt.render_wireframe(ts, tc, line_px=2.0, background=bg, backend=backend))
    assert np.abs(got - want).max() < 1e-5
    uncovered = want[..., 3] == 0
    fill = np.broadcast_to(np.float32(bg), (int(uncovered.sum()), 3))
    assert uncovered.any() and np.array_equal(got[uncovered][:, :3], fill)
    thin = npy(gt.render_wireframe(ts, tc, line_px=1.0, background=bg, backend=backend))
    assert thin[..., 3].sum() < got[..., 3].sum()


def test_wire_over_matches_jax():
    """The JAX package's ``TestWireOver`` scene: ``wire + beauty·(1 − wire.a)``
    with the lines from the kernel path and the beauty pass from it too,
    against JAX's oracle lines over its tiled beauty pass."""
    js = gj.random_splats(jax.random.PRNGKey(2), 48, extent=0.7)
    jc = gj.make_camera(eye=[0.1, 0.3, 2.6], target=[0, 0, 0], width=64, height=64)
    cfg = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0)
    ts, tc = _both(js, jc)
    want = np.asarray(render_wire_over(js, jc, cfg, backend="tiles"))
    got = npy(gt.render_wire_over(ts, tc, to_config(cfg)))
    assert np.abs(got - want).max() < 1e-5
    wire = npy(gt.render_wireframe(ts, tc, to_config(cfg)))
    line = wire[..., 3] >= 1.0
    assert line.any() and np.array_equal(got[line], wire[line])
    tiles = npy(gt.render_wire_over(ts, tc, to_config(cfg), backend="tiles"))
    assert np.abs(tiles - want).max() < 1e-5


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_plain_compositor_band_mode_matches_pallas_forward_on_the_same_inputs(eps):
    """Compositor level: the JAX wireframe pass's fields and binning fed to
    both packages' band-test compositors, early stop on and off."""
    from gsplat_tpu.ops.projection import ROW_HX, ROW_HY, ROW_OP, ROW_VALID, project_splats
    from gsplat_tpu.ops.rasterize_ref import sanitize_projected
    from gsplat_tpu.ops.rasterize_tiles import sort_by_depth

    js = _scene(80, seed=4)
    jc = gj.make_camera([0, 0, 2.2], [0, 0, 0], 70, 45)
    line_px = 1.5
    jcfg = gj.RenderConfig(wireframe=True, line_px=line_px, transmittance_eps=eps, pairs_per_splat=12.0)
    f = sanitize_projected(project_splats(js, jc, 0)).fields
    f = f.at[ROW_OP].set(f[ROW_VALID]).at[ROW_HX].add(line_px).at[ROW_HY].add(line_px)
    f = np.asarray(sort_by_depth(j_projected(np.asarray(f))).fields)
    jb = jbin.bin_splats(j_projected(f), 70, 45, jcfg, with_tiles=False)
    nty, ntx = jbin.tile_grid(70, 45, 32, 32)
    payload = jcomp._gather_payload(jnp.asarray(f[:10]), jb.pair_splat, jcfg)
    out, jused = jcomp._build_kernels(nty, ntx, payload.shape[1], 0, jcfg, True)[0](
        jb.tile_base, jb.tile_phi, jb.tile_span, jnp.zeros((2,), jnp.int32), payload)
    jimg = np.asarray(jcomp.unpack_image(out, 45, 70))
    ti = lambda a: torch.from_numpy(np.array(a, copy=True))
    timg, tused = tcomp.composite_splats(
        ti(f[:10]), ti(jb.pair_splat), ti(jb.tile_base), ti(jb.tile_phi), ti(jb.tile_span),
        nty, ntx, 45, 70, to_config(jcfg),
    )
    assert np.abs(npy(timg) - jimg).max() < 1e-5 and jimg[..., 3].sum() > 50
    assert np.array_equal(npy(tused), np.asarray(jused))


def test_outline_nearest_wins_and_forward_only():
    cam = gt.make_camera([0, 0, 3], [0, 0, 0], 64, 64, device="cpu")
    one = gt.make_splats(pos=[[0.0, 0.0, 0.0]], scale=[[0.3, 0.3, 0.3]], opacity=[1.0],
                         color=[[1.0, 0.0, 0.0]], device="cpu")
    img = npy(gt.render_wireframe(one, cam))
    assert img[32, 32, 3] == 0.0 and img[..., 3].sum() > 10  # an outline, not filled
    covered = img[..., 3] > 0
    assert np.array_equal(img[covered][:, :3], np.broadcast_to([1.0, 0.0, 0.0], (int(covered.sum()), 3)))
    two = gt.make_splats(pos=[[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], scale=[[0.2] * 3, [0.3] * 3],
                         opacity=[1.0, 1.0], color=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device="cpu")
    img = npy(gt.render_wireframe(two, cam))
    overlap = img[..., 3] > 0
    assert ((img[overlap][:, 0] == 1.0) | (img[overlap][:, 1] == 1.0)).all() and (img[..., 0] == 1.0).any()
    # the band test has no gradient: the differentiable path refuses it, as JAX's
    pos = one.pos.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="forward-only"):
        gt.render(dataclasses.replace(one, pos=pos), cam, gt.RenderConfig(wireframe=True))
    with pytest.raises(ValueError, match="unknown wireframe backend"):
        gt.render_wireframe(one, cam, backend="pallas")
