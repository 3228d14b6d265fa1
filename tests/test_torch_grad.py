"""Whole-render gradients of the port's kernel path (``render(...,
backend="auto")`` on CPU tensors: the same autograd graph as on the card,
with the three kernels' plain versions) against ``jax.grad`` of the JAX
package's renderers, on the scenes of ``tests/test_pallas_composite.py``.

Tolerances are those of the JAX package's own gate: 2e-4·max(1, |g|max) per
field in float32 (sums over pairs and pixels in another order); with the
packed payload 2e-4 on pos/orient/scale/opacity and 2e-2 on colour/SH, whose
per-pair summands are rounded to bf16 in the gradient space."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.render import render_pallas
from torch_port_helpers import camera_to_torch, jax_scene, npy, splats_to_torch, to_config

FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")
JCFG = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0)


def _weights(seed, h=64, w=64):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (h, w, 4)))


def _port_grads(jsplats, jcam, jcfg, weights, backend="auto", mean_rgb=False):
    splats, cam = splats_to_torch(jsplats), camera_to_torch(jcam)
    leaves = {f: getattr(splats, f).clone().requires_grad_(True) for f in FIELDS}
    image = gt.render(dataclasses.replace(splats, **leaves), cam, to_config(jcfg), backend=backend)
    loss = image[..., :3].mean() if mean_rgb else (image * torch.from_numpy(np.array(weights))).sum()
    loss.backward()
    return {f: npy(leaves[f].grad) for f in FIELDS}


def _assert_close(got, want, packed=False):
    for f in FIELDS:
        a = np.asarray(getattr(want, f))
        tol = 2e-2 if (packed and f in ("color", "sh")) else 2e-4
        err = np.abs(got[f] - a).max()
        assert err <= tol * max(1.0, np.abs(a).max()), (f, err, np.abs(a).max())


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_grads_match_jax_tiled_autodiff(soft):
    jcfg = dataclasses.replace(JCFG, soft_cutoff=soft)
    jsplats, jcam = jax_scene(n=150)
    w = _weights(6 if soft else 5)
    want = jax.grad(lambda s: jnp.sum(gj.render_tiles(s, jcam, jcfg) * w))(jsplats)
    _assert_close(_port_grads(jsplats, jcam, jcfg, w), want)
    # the port's own oracle, differentiated by plain autograd, agrees too
    _assert_close(_port_grads(jsplats, jcam, jcfg, w, backend="tiles"), want)


def test_packed_grads_match_jax_tiled_autodiff():
    jcfg = dataclasses.replace(JCFG, payload_dtype="packed")
    jsplats, jcam = jax_scene(n=400, seed=1)
    w = _weights(7)
    want = jax.grad(lambda s: jnp.sum(gj.render_tiles(s, jcam, jcfg) * w))(jsplats)
    got = _port_grads(jsplats, jcam, jcfg, w)
    _assert_close(got, want, packed=True)
    # the colour rows do go through bf16 summands: not bit-equal to f32 sums
    assert np.abs(got["color"] - np.asarray(want.color)).max() > 0


def test_grads_match_jax_pallas_interpret():
    jsplats, jcam = jax_scene(n=150)
    w = _weights(5)
    want = jax.grad(lambda s: jnp.sum(render_pallas(s, jcam, JCFG, interpret=True) * w))(jsplats)
    _assert_close(_port_grads(jsplats, jcam, JCFG, w), want)


def test_grads_with_early_termination_finite_and_close():
    jsplats, jcam = jax_scene(n=300, eye=(0.2, 0.4, 1.0))
    jsplats = dataclasses.replace(jsplats, opacity=jnp.full((300,), 0.95), scale=jsplats.scale * 3.0)
    jcfg = dataclasses.replace(JCFG, transmittance_eps=1e-3)
    got = _port_grads(jsplats, jcam, jcfg, None, mean_rgb=True)
    exact = _port_grads(jsplats, jcam, JCFG, None, mean_rgb=True)
    differs = False
    for f in FIELDS:
        assert np.isfinite(got[f]).all(), f
        # the stop cuts gradient tails of the order of eps
        assert np.abs(got[f] - exact[f]).max() <= 5e-3 * max(1.0, np.abs(exact[f]).max()), f
        differs = differs or np.abs(got[f] - exact[f]).max() > 0
    assert differs  # the early stop did fire


def test_storage_order_compositing_gives_the_rank_order_gradients_permuted():
    """``CompositeSplats`` with ``order``: fields stay in storage order, the
    binning reads them through the depth permutation, and the gradient comes
    back in storage order."""
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.kernels.composite import composite_splats_diff
    from torch_port_helpers import jax_sorted_fields

    jsplats, jcam = jax_scene(n=150)
    cfg = to_config(JCFG)
    ranked = torch.from_numpy(np.array(jax_sorted_fields(jsplats, jcam, JCFG)))
    perm = torch.from_numpy(np.random.default_rng(0).permutation(150))
    order = torch.empty_like(perm)
    order[perm] = torch.arange(150)          # storage = ranked[:, perm]  ⇒  ranked = storage[:, order]
    storage = ranked[:, perm].contiguous()
    w = torch.from_numpy(np.array(_weights(5)))
    grads = []
    for fields, od in ((ranked, None), (storage, order)):
        from gsplat_tpu_torch.ops.projection import ProjectedSplats

        b = binning.bin_splats(ProjectedSplats(fields=fields), 64, 64, cfg, with_tiles=False,
                               with_grad_map=True, order=od)
        leaf = fields[:10].clone().requires_grad_(True)
        image = composite_splats_diff(leaf, b, 2, 2, 64, 64, cfg, order=od)
        (image * w).sum().backward()
        grads.append((npy(image), npy(leaf.grad)))
    np.testing.assert_array_equal(grads[1][0], grads[0][0])
    np.testing.assert_array_equal(grads[1][1], grads[0][1][:, perm.numpy()])
    assert np.abs(grads[0][1]).max() > 0


def test_camera_looking_away_gives_exactly_zero_gradients():
    jsplats, _ = jax_scene(n=20)
    jcam = gj.make_camera([0, 0, -5], [0, 0, -10], 64, 64)
    got = _port_grads(jsplats, jcam, JCFG, _weights(1))
    for f in FIELDS:
        assert got[f].shape == np.asarray(getattr(jsplats, f)).shape
        assert np.abs(got[f]).max() == 0.0, f


def test_zero_splats_still_carry_a_zero_gradient():
    cam = gt.make_camera([0, 0, 3.0], [0, 0, 0], 64, 64, device="cpu")
    empty = gt.make_splats(np.zeros((0, 3), np.float32), device="cpu")
    pos = empty.pos.clone().requires_grad_(True)
    image = gt.render(dataclasses.replace(empty, pos=pos), cam, gt.RenderConfig())
    assert image.requires_grad and float(image.detach().abs().max()) == 0.0
    image.sum().backward()
    assert tuple(pos.grad.shape) == (3, 0)


def test_projection_gradients_match_jax_and_masked_splats_leak_no_nan():
    """project → sanitize → quantize under autograd against ``jax.grad``:
    clamps, the double ``where`` around ``rsqrt``, the detached footprint
    radius, and the ``where`` of ``sanitize_projected`` on behind-camera
    splats (whose untaken branch must not leak a NaN)."""
    from gsplat_tpu.ops.rasterize_ref import quantize_payload as jq, sanitize_projected as js
    from gsplat_tpu_torch.ops.projection import project_splats as t_project
    from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload as tq, sanitize_projected as ts

    jsplats, jcam = jax_scene(n=200, seed=3, eye=(0.1, 0.2, 0.5))  # inside the cloud: some splats behind
    # ties at the clamps and a zero opacity (sqrt/log at their clamped ends)
    jsplats = dataclasses.replace(
        jsplats,
        opacity=jsplats.opacity.at[:5].set(jnp.asarray([0.0, 1.0 / 255.0, 1.0, 0.5, 1e-30])),
        sh=jsplats.sh.at[:, 5:10].set(0.0),
        color=jsplats.color.at[:, 5:10].set(0.0),
    )
    jcfg = dataclasses.replace(JCFG, payload_dtype="packed")
    w = np.random.default_rng(4).standard_normal((16, 200)).astype(np.float32)
    w[10:] = 0.0  # only the compositor's ten rows carry gradients

    def jloss(s):
        p = jq(js(gj.project_splats(s, jcam, 3, tight_footprint=True)), jcfg)
        return jnp.sum(p.fields * w)

    valid = np.asarray(gj.project_splats(jsplats, jcam, 3).fields[11]) > 0.5
    assert (~valid).any() and valid.any()
    want = jax.grad(jloss)(jsplats)
    splats, cam = splats_to_torch(jsplats), camera_to_torch(jcam)
    leaves = {f: getattr(splats, f).clone().requires_grad_(True) for f in FIELDS}
    p = tq(ts(t_project(dataclasses.replace(splats, **leaves), cam, 3, tight_footprint=True)), to_config(jcfg))
    (p.fields * torch.from_numpy(w)).sum().backward()
    for f in FIELDS:
        a, b = np.asarray(getattr(want, f)), npy(leaves[f].grad)
        assert np.isfinite(b).all(), f
        assert np.abs(b - a).max() <= 2e-4 * max(1.0, np.abs(a).max()), (f, np.abs(b - a).max(), np.abs(a).max())
        assert np.abs(b[..., ~valid]).max() == 0.0, f  # masked splats: exact zero
