"""Port vs JAX package: SSIM over sharded row strips (``ssim_strip`` with its
halo exchange), the parameter sharding (``shard_params``, ``shard_splats``)
and the sharded train step (``make_sharded_train_step``), on the CPU with
spawned gloo ranks (``torch_dist_worker``).

Tolerances: SSIM 1e-6 (the same filter sums, the halo rows in place of the
full image's); loss 1e-5 relative and gradients 2e-4 of the field's own
max|g| (no floor) against the single-device step (sums over pairs, pixels
and strips in another order).  The gradient gate must fail planted faults: a
zero gradient and a step without the dp mean.  ``initialize_distributed``
joins a group from the standard environment and is a no-op without one.
"""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
import torch_dist_worker
from gsplat_tpu.parallel.mesh import make_mesh as j_make_mesh
from gsplat_tpu.parallel.render_sharded import shard_splats as j_shard_splats
from gsplat_tpu.train.loss import ssim as j_ssim
from gsplat_tpu.train.params import params_from_splats as j_params_from_splats
from gsplat_tpu.train.trainer import shard_params as j_shard_params
from gsplat_tpu_torch.parallel.mesh import Mesh
from gsplat_tpu_torch.train.params import FIELDS
from torch_port_helpers import CPU, jax_scene, npy, splats_to_torch

W, H = 64, 80  # over 2 strips of 64 rows: the second holds 16 real rows
GRAD_TOL = 2e-4


def _grad_rel_err(got, want, scale):
    """max|got - want| over the field's own max|g| (no floor)."""
    return np.abs(got - want).max() / scale


def _images(h, w, seed):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    # a target that resembles the prediction, so SSIM is far from 0
    target = np.clip(pred + rng.normal(0.0, 0.1, (h, w, 3)), 0.0, 1.0).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("d", [2, 4])
def test_ssim_strip_matches_full_image(d, tmp_path):
    pred, target = _images(64, 48, seed=d)
    results = torch_dist_worker.run("ssim", d, tmp_path, {"pred": pred, "target": target})
    got = np.mean([r["ssim"] for r in results])
    p = torch.from_numpy(pred).requires_grad_(True)
    want = gt.ssim(p, torch.from_numpy(target))
    want.backward()
    assert abs(got - float(want.detach())) < 1e-6
    assert abs(got - float(j_ssim(jnp.asarray(pred), jnp.asarray(target)))) < 1e-6
    # the halo's transpose: every strip's gradient, its neighbours' windows included
    grad = np.concatenate([r["grad"] for r in results], axis=0)
    assert np.abs(grad - npy(p.grad)).max() < 1e-6 * max(1.0, np.abs(npy(p.grad)).max())


def test_shard_params_and_splats_blocks_match_jax():
    js, _ = jax_scene(n=61, seed=2)  # 61 over 4: three padding splats
    jmesh = j_make_mesh(batch=2, splat=4, devices=jax.devices()[:8])
    jp = j_shard_params(j_params_from_splats(js), jmesh)
    jsplats = j_shard_splats(js, j_make_mesh(batch=1, splat=4, devices=jax.devices()[:4]))
    tparams = gt.params_from_splats(splats_to_torch(js))
    tsplats = splats_to_torch(js)
    for b in range(4):
        mesh = Mesh(rank=b, dp=1, sp=4, device=torch.device(CPU))
        tp = gt.shard_params(tparams, mesh)
        ts = gt.shard_splats(tsplats, mesh)
        for f in FIELDS:
            want = np.asarray(getattr(jp, f))[..., 16 * b : 16 * (b + 1)]
            got = npy(getattr(tp, f))
            # params_from_splats takes log and logit in each package: an ulp apart
            assert got.shape == want.shape and np.allclose(got, want, rtol=1e-6, atol=1e-6), (f, b)
            assert getattr(tp, f).requires_grad
        for f in ("pos", "orient", "scale", "opacity", "color", "sh"):
            want = np.asarray(getattr(jsplats, f))[..., 16 * b : 16 * (b + 1)]
            assert np.array_equal(npy(getattr(ts, f)), want), (f, b)
    # the padding: logit-opacity -20 and the identity quaternion
    last = gt.shard_params(tparams, Mesh(rank=3, dp=1, sp=4, device=torch.device(CPU)))
    assert np.array_equal(npy(last.logit_opacity)[-3:], np.full(3, -20.0, np.float32))
    assert np.array_equal(npy(last.quat)[:, -3:], np.tile([[0.0], [0.0], [0.0], [1.0]], (1, 3)))


def _train_job(dp, n=96):
    js, jc = jax_scene(n=n, seed=7, w=W, h=H, extent=0.6, eye=(0.0, 0.3, 2.5))
    splats = splats_to_torch(js)
    cams = [gt.make_camera([2.5 * np.sin(a), 0.3, 2.5 * np.cos(a)], [0, 0, 0], W, H, device=CPU)
            for a in (0.0, 0.3)[:dp]]
    cfg = gt.RenderConfig(tile_capacity=512, transmittance_eps=0.0)
    targets = []
    for cam in cams:
        img = gt.render(splats, cam, cfg, backend="tiles")
        targets.append(npy(img[..., :3] + (1.0 - img[..., 3:4])))
    # start from moved positions and colours, so the loss has room to fall
    rng = np.random.default_rng(9)
    arrays = gj.to_numpy_dict(js)
    arrays["pos"] = arrays["pos"] + rng.normal(0.0, 0.04, arrays["pos"].shape).astype(np.float32)
    arrays["color"] = np.clip(arrays["color"] + rng.normal(0.0, 0.1, arrays["color"].shape), 0, 1).astype(np.float32)
    start = gt.params_from_splats(gt.splats_from_numpy(arrays, device=CPU))
    return {
        "params": {f: npy(getattr(start, f)) for f in FIELDS}, "dp": dp, "steps": 3,
        "config": dataclasses.asdict(cfg), "backend": "auto", "lambda_dssim": 0.2,
        "camera": (npy(cams[0].view), npy(cams[0].proj), W, H),
        "views": np.stack([npy(c.view) for c in cams]), "projs": np.stack([npy(c.proj) for c in cams]),
        "targets": np.stack(targets),
    }, cams, cfg


@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2)])
def test_sharded_step_matches_single_device(dp, sp, tmp_path):
    job, cams, cfg = _train_job(dp)
    results = torch_dist_worker.run("train", dp * sp, tmp_path, job)

    # single device: the mean loss and gradient over the cameras, the main path
    losses, grads = [], {f: 0.0 for f in FIELDS}
    for cam, target in zip(cams, job["targets"]):
        params = gt.params_from_numpy(job["params"], device=CPU)
        step = gt.make_train_step(torch.optim.SGD(list(params.as_dict().values()), lr=0.0), cam, cfg)
        losses.append(float(step(params, torch.from_numpy(target))))
        for f in FIELDS:
            grads[f] = grads[f] + npy(getattr(params, f).grad) / len(cams)
    want_loss = np.mean(losses)
    n_local = job["params"]["pos"].shape[-1] // sp
    for r in results:
        assert r["losses"][0] == pytest.approx(want_loss, rel=1e-5)
        assert r["losses"][2] < r["losses"][1] < r["losses"][0], r["losses"]
        cols = slice(r["block"] * n_local, (r["block"] + 1) * n_local)
        for f in FIELDS:
            want, scale = grads[f][..., cols], np.abs(grads[f]).max()
            assert scale > 0, f
            err = _grad_rel_err(r["grads"][f], want, scale)
            assert np.isfinite(r["grads"][f]).all() and err <= GRAD_TOL, (f, r["block"], err)
            # planted faults the gate must fail
            assert _grad_rel_err(np.zeros_like(want), want, scale) > GRAD_TOL, (f, r["block"])
            if dp > 1:
                err = _grad_rel_err(r["grads_without_dp_mean"][f], want, scale)
                assert err > GRAD_TOL, (f, r["block"], err)
    # every rank reports the same loss; the ranks of a dp group hold the same block
    assert len({tuple(r["losses"]) for r in results}) == 1


def test_initialize_distributed_joins_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert gt.initialize_distributed("gloo") is False  # single process: no group
    assert not torch.distributed.is_initialized()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    results = torch_dist_worker.run("env", 2, tmp_path, {}, port=port)
    assert [(r["rank"], r["world"], r["backend"], r["psum"]) for r in results] == [
        (0, 2, "gloo", 3.0), (1, 2, "gloo", 3.0)]
