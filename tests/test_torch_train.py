"""The port's trainer (``train/``, ``io/checkpoint.py``) against the JAX
package's on shared numpy inputs: loss functions, the parameterization, Adam
steps through the differentiable kernel path, checkpoints."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.train import loss as j_loss
from gsplat_tpu.train import params as j_params
from gsplat_tpu.train import trainer as j_trainer
from gsplat_tpu_torch.train.params import FIELDS
from torch_port_helpers import CPU, camera_to_torch, jax_scene, npy, splats_to_torch, to_config

JCFG = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0)


def _images(seed=0, h=40, w=50):
    rng = np.random.default_rng(seed)
    return rng.random((h, w, 3), dtype=np.float32), rng.random((h, w, 3), dtype=np.float32)


@pytest.mark.parametrize("name", ["l1_loss", "ssim", "render_loss", "psnr"])
def test_loss_functions_match_jax(name):
    a, b = _images()
    want = float(getattr(j_loss, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(gt, name)(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


def test_render_loss_gradient_matches_jax():
    a, b = _images(1)
    want = np.asarray(jax.grad(lambda p: j_loss.render_loss(p, jnp.asarray(b)))(jnp.asarray(a)))
    ta = torch.from_numpy(a).requires_grad_(True)
    gt.render_loss(ta, torch.from_numpy(b)).backward()
    # the hand-written adjoint of the separable filter; 1e-6 of the largest entry
    assert np.abs(npy(ta.grad) - want).max() <= 1e-6 * np.abs(want).max() + 1e-10


def _jax_params_to_port(jp):
    return gt.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in FIELDS}, device=CPU)


def test_params_round_trip_and_activations_match_jax():
    jsplats, _ = jax_scene(n=64)
    jp = j_params.params_from_splats(jsplats)
    tp = gt.params_from_splats(splats_to_torch(jsplats))
    for f in FIELDS:
        t = getattr(tp, f)
        assert t.is_leaf and t.requires_grad
        np.testing.assert_allclose(npy(t), np.asarray(getattr(jp, f)), rtol=1e-6, atol=1e-6, err_msg=f)
    back = gt.splats_from_params(_jax_params_to_port(jp))
    jback = j_params.splats_from_params(jp)
    for f in ("pos", "orient", "scale", "opacity", "color", "sh"):
        np.testing.assert_allclose(npy(getattr(back, f)), np.asarray(getattr(jback, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
        np.testing.assert_allclose(npy(getattr(back, f)), np.asarray(getattr(jsplats, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    assert tp.count == 64 and tuple(tp.sh.shape) == (45, 64)


def _fit_scene():
    """The scene of ``tests/test_train.py``: fit a perturbed scene back toward
    the target render."""
    target_splats = gj.random_splats(jax.random.PRNGKey(0), 32, extent=0.6, sh_scale=0.0)
    cam = gj.make_camera([0.0, 0.3, 2.5], [0, 0, 0], 64, 64)
    timg = gj.render_tiles(target_splats, cam, JCFG)
    target_rgb = timg[..., :3] + (1.0 - timg[..., 3:4])
    perturbed = dataclasses.replace(
        target_splats,
        pos=target_splats.pos + 0.05 * jax.random.normal(jax.random.PRNGKey(1), (3, 32)),
        color=jnp.clip(
            target_splats.color + 0.3 * jax.random.normal(jax.random.PRNGKey(2), (3, 32)), 0.0, 1.0
        ),
    )
    return j_params.params_from_splats(perturbed), cam, target_rgb


def test_thirty_adam_steps_halve_the_loss():
    jp, jcam, target = _fit_scene()
    params = _jax_params_to_port(jp)
    optimizer = torch.optim.Adam(list(params.as_dict().values()), lr=1e-2)
    step = gt.make_train_step(optimizer, camera_to_torch(jcam), to_config(JCFG), backend="auto",
                              lambda_dssim=0.0)
    t = torch.from_numpy(np.array(target))
    losses = [float(step(params, t)) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], losses[::10]


def test_first_steps_track_the_jax_trainer():
    """default_optimizer + make_train_step (L1 + DSSIM) through the port's
    kernel path against the JAX trainer through ``render_tiles``: the first
    five losses within 1e-3 relative (gradients agree to ~1e-5; Adam's
    normalised first steps amplify a sign flip of a near-zero gradient)."""
    jp, jcam, target = _fit_scene()
    params = _jax_params_to_port(jp)
    jopt = j_trainer.default_optimizer()
    jstate = jopt.init(jp)
    jstep = j_trainer.make_train_step(jopt, jcam, JCFG, backend="tiles", lambda_dssim=0.2)
    want = []
    for _ in range(5):
        jp, jstate, loss = jstep(jp, jstate, target)
        want.append(float(loss))
    step = gt.make_train_step(gt.default_optimizer(params), camera_to_torch(jcam), to_config(JCFG),
                              backend="auto", lambda_dssim=0.2)
    t = torch.from_numpy(np.array(target))
    got = [float(step(params, t)) for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]
    for f in FIELDS:  # and the parameters themselves stay together
        a = np.asarray(getattr(jp, f))
        assert np.abs(npy(getattr(params, f)) - a).max() <= 1e-2 * max(1.0, np.abs(a).max()), f


def test_default_optimizer_moves_every_field():
    jsplats, _ = jax_scene(n=16, extent=0.5)
    params = gt.params_from_splats(splats_to_torch(jsplats))
    before = {f: npy(getattr(params, f)).copy() for f in FIELDS}
    optimizer = gt.default_optimizer(params)
    rates = {g["name"]: g["lr"] for g in optimizer.param_groups}
    assert rates == {"pos": 1.6e-4, "quat": 1e-3, "log_scale": 5e-3, "logit_opacity": 5e-2,
                     "color": 2.5e-3, "sh": 2.5e-3 / 20.0}
    cam = gt.make_camera([0, 0, 2.5], [0, 0, 0], 32, 32, device=CPU)
    step = gt.make_train_step(optimizer, cam, to_config(JCFG), lambda_dssim=0.0)
    loss = step(params, torch.full((32, 32, 3), 0.5))
    assert np.isfinite(float(loss)) and not loss.requires_grad
    for f in FIELDS:
        assert np.abs(npy(getattr(params, f)) - before[f]).max() > 0, f


def test_checkpoint_round_trip(tmp_path):
    jsplats, _ = jax_scene(n=16, extent=0.5)
    params = gt.params_from_splats(splats_to_torch(jsplats))
    optimizer = gt.default_optimizer(params)
    cam = gt.make_camera([0, 0, 2.5], [0, 0, 0], 32, 32, device=CPU)
    step = gt.make_train_step(optimizer, cam, to_config(JCFG), lambda_dssim=0.0)
    target = torch.full((32, 32, 3), 0.5)
    step(params, target)
    for s in (1, 2, 3, 4):
        gt.save_checkpoint(str(tmp_path), s, params, optimizer)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2.pt", "step_3.pt", "step_4.pt"]
    saved = {f: npy(getattr(params, f)).copy() for f in FIELDS}
    after_saved = float(step(params, target))  # moves on past the checkpoint

    fresh = gt.params_from_splats(splats_to_torch(jsplats))
    fresh_opt = gt.default_optimizer(fresh)
    got_step, restored, restored_opt = gt.restore_checkpoint(str(tmp_path), fresh, fresh_opt)
    assert got_step == 4 and restored is fresh and restored_opt is fresh_opt
    for f in FIELDS:
        np.testing.assert_array_equal(npy(getattr(restored, f)), saved[f], err_msg=f)
    # the optimizer's moments came back too: the next step repeats exactly
    step2 = gt.make_train_step(fresh_opt, cam, to_config(JCFG), lambda_dssim=0.0)
    assert float(step2(fresh, target)) == after_saved
    for f in FIELDS:
        np.testing.assert_array_equal(npy(getattr(fresh, f)), npy(getattr(params, f)), err_msg=f)
    with pytest.raises(FileNotFoundError):
        gt.restore_checkpoint(str(tmp_path / "nothing"), fresh)
