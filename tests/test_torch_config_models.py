"""Port vs JAX package: RenderConfig, cameras, the splat data model, and the
function that carries a scene across (``splats_from_numpy``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu_torch.utils.logging import format_count, get_logger
from torch_port_helpers import CPU, camera_to_torch, jax_scene, npy, splats_to_torch


def test_config_fields_and_defaults_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(gj.RenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(gt.RenderConfig)]
    assert jf == tf


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(sh_order=4),
        dict(chunk=12),
        dict(row_assignment="diagonal"),
        dict(row_stride=0),
        dict(depth_test=True, payload_dtype="packed"),
        dict(payload_dtype="packed", chunk=64, tile_capacity=512),
        dict(tile_capacity=1000),
        dict(payload_dtype="float16"),
    ],
)
def test_config_validation_equal(kwargs):
    with pytest.raises(ValueError) as je:
        gj.RenderConfig(**kwargs)
    with pytest.raises(ValueError) as te:
        gt.RenderConfig(**kwargs)
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("n,override", [(1000, 0), (1, 0), (1000, 123456), (7, 3)])
def test_config_budgets_equal(n, override):
    kw = dict(pair_budget_override=override, pairs_per_splat=2.5)
    j, t = gj.RenderConfig(**kw), gt.RenderConfig(**kw)
    assert j.pair_budget(n) == t.pair_budget(n)
    assert j.strip_pair_budget(n, 4) == t.strip_pair_budget(n, 4)
    assert hash(t) == hash(gt.RenderConfig(**kw))  # frozen + hashable


@pytest.mark.parametrize(
    "eye,target,w,h,fov",
    [([0.2, 0.4, 3.0], [0, 0, 0], 64, 64, 45.0), ([-1.0, 2.0, 0.5], [0.1, 0.0, -0.3], 1920, 1080, 60.0)],
)
def test_make_camera_matrices_equal(eye, target, w, h, fov):
    j = gj.make_camera(eye, target, w, h, fov_y_deg=fov)
    t = gt.make_camera(eye, target, w, h, fov_y_deg=fov, device=CPU)
    assert np.array_equal(np.asarray(j.view), npy(t.view))
    assert np.array_equal(np.asarray(j.proj), npy(t.proj))
    assert (t.width, t.height) == (j.width, j.height)
    assert t.view.dtype == torch.float32 and t.proj.dtype == torch.float32
    # derived position: bit-equal to the JAX package's numpy value
    assert np.array_equal(np.asarray(j.position), npy(t.position))
    # ... and within an ulp when derived with tensor ops from a hand-built Camera
    bare = gt.Camera(view=t.view, proj=t.proj, width=w, height=h)
    np.testing.assert_allclose(npy(bare.position), np.asarray(j.position), rtol=1e-6, atol=1e-6)


def test_camera_explicit_position_and_nan_means_unset():
    j = gj.make_camera([0, 0, 3], [0, 0, 0], 32, 32)
    je = dataclasses.replace(j, explicit_camera_pos=np.array([1.0, 2.0, 3.0], np.float32))
    te = camera_to_torch(je)
    assert np.array_equal(npy(te.position), np.asarray(je.position))
    tn = camera_to_torch(j)  # all-NaN override = unset
    assert tn.explicit_camera_pos is None
    assert np.array_equal(npy(tn.position), np.asarray(j.position))


def test_splats_from_numpy_roundtrip_exact():
    js, _ = jax_scene(n=257, seed=3, sh=0.3)
    d = gj.to_numpy_dict(js)
    ts = gt.splats_from_numpy(d, device=CPU)
    for name in ("pos", "orient", "scale", "opacity", "color", "sh"):
        assert np.array_equal(npy(getattr(ts, name)), np.asarray(getattr(js, name))), name
    back = gt.to_numpy_dict(ts)
    for k in d:
        assert back[k].shape == d[k].shape and np.array_equal(back[k], d[k]), k
    assert ts.count == js.count == 257


def test_make_splats_defaults_and_validate():
    pos = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    j = gj.make_splats(pos)
    t = gt.make_splats(pos, device=CPU)
    for name in ("pos", "orient", "scale", "opacity", "color", "sh"):
        assert np.array_equal(npy(getattr(t, name)), np.asarray(getattr(j, name))), name
    with pytest.raises(ValueError):
        dataclasses.replace(t, opacity=torch.ones(4)).validate()
    with pytest.raises(ValueError):
        gt.make_splats(pos, sh=np.zeros((5, 14, 3), np.float32), device=CPU)


@pytest.mark.parametrize("maker", ["random", "trained"])
def test_generators_follow_the_jax_distributions(maker):
    n = 4000
    if maker == "random":
        kw = dict(extent=1.2, scale_range=(0.002, 0.01), sh_scale=0.1)
        make_t, make_j = gt.random_splats, gj.random_splats
    else:
        kw = dict(extent=1.2, sh_scale=0.1)
        make_t, make_j = gt.trained_like_splats, gj.trained_like_splats
    t = make_t(torch.Generator().manual_seed(7), n, device=CPU, **kw)
    j = make_j(jax.random.PRNGKey(7), n, **kw)
    if maker == "random":
        assert float(t.pos.abs().max()) <= 1.2
        assert 0.002 <= float(t.scale.min()) and float(t.scale.max()) <= 0.01
        assert 0.3 <= float(t.opacity.min()) and float(t.opacity.max()) <= 1.0
    else:
        assert 1e-5 <= float(t.scale.min()) and float(t.scale.max()) <= 0.3 * 1.2 + 1e-6
    t.validate()
    np.testing.assert_allclose(npy(torch.linalg.norm(t.orient, dim=0)), 1.0, atol=1e-5)
    # same distributions, other numbers: compare loose moments
    for name in ("scale", "opacity", "color", "sh"):
        a, b = npy(getattr(t, name)), np.asarray(getattr(j, name))
        assert abs(a.mean() - b.mean()) < 0.1 * (abs(b.mean()) + b.std() + 1e-3), name
        assert 0.7 < (a.std() + 1e-9) / (b.std() + 1e-9) < 1.4, name
    # the same seed gives the same scene again
    t2 = make_t(torch.Generator().manual_seed(7), n, device=CPU, **kw)
    assert torch.equal(t.pos, t2.pos) and torch.equal(t.sh, t2.sh)


def test_device_none_means_the_card_and_never_the_cpu():
    if torch.cuda.is_available():
        cam = gt.make_camera([0, 0, 3], [0, 0, 0], 32, 32)
        assert cam.view.is_cuda
        return
    # No card here: asking for it (device=None) must raise, not fall back.
    with pytest.raises((RuntimeError, AssertionError)):
        gt.make_camera([0, 0, 3], [0, 0, 0], 32, 32)
    with pytest.raises((RuntimeError, AssertionError)):
        gt.random_splats(torch.Generator().manual_seed(0), 8)
    with pytest.raises((RuntimeError, AssertionError)):
        gt.make_splats(np.zeros((4, 3), np.float32))


def test_logging_once_and_reset(caplog):
    log = get_logger("test_once")
    assert get_logger("test_once") is log
    assert format_count(1234567) == "1,234,567"
    with caplog.at_level("WARNING", logger="gsplat_tpu_torch"):
        log.warning_once("overflow", key="k")
        log.warning_once("overflow", key="k")
        assert sum("overflow" in r.message for r in caplog.records) == 1
        log.reset_once("k")
        log.warning_once("overflow", key="k")
        assert sum("overflow" in r.message for r in caplog.records) == 2
