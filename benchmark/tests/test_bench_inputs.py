"""The cells' inputs are made from the seed alone: the same seed gives the
same scene, cameras and targets.  A scene's geometry is the configuration's
(its ``scene_seed``); the run's seed draws its splats' order and their
appearance."""

import pytest
import torch

from conftest import SEED
from harness import scenes, spec

FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")
GEOMETRY = ("pos", "orient", "scale", "opacity")


def _scene(name, seed=SEED, scene_seed=None):
    cell = spec.load(name)
    cell.config["scene"]["splats"] = 5000
    if scene_seed is not None:
        cell.config["scene"]["scene_seed"] = scene_seed
    return cell.config["scene"], scenes.scene(cell.config["scene"], seed, "cpu")


def _canonical(pos):
    """The permutation that sorts splats by position, x first, then y, then z."""
    order = torch.arange(pos.shape[1])
    for row in (2, 1, 0):
        order = order[torch.argsort(pos[row, order], stable=True)]
    return order


def _sorted_columns(x):
    """The columns of a (rows, N) or (N,) tensor in a fixed order."""
    x = x.reshape(-1, x.shape[-1])
    order = torch.argsort(x[0], stable=True)
    return x[:, order]


@pytest.mark.parametrize("name", ["trained_1m.serve", "envelope_8m.serve"])
def test_scenes_repeat_from_the_seed(name):
    (_, a), (_, b) = _scene(name), _scene(name)
    assert all(torch.equal(a[k], b[k]) for k in FIELDS)
    assert a["pos"].shape == (3, 5000) and a["sh"].shape == (45, 5000) and a["opacity"].shape == (5000,)
    assert a["orient"].shape == (4, 5000) and a["color"].shape == (3, 5000)


@pytest.mark.parametrize("name", ["trained_1m.serve", "envelope_8m.serve"])
def test_the_seed_moves_order_and_appearance_not_geometry(name):
    (_, a), (_, b), (_, c) = _scene(name), _scene(name, SEED + 1), _scene(name, scene_seed=1)
    assert not torch.equal(a["pos"], b["pos"])                          # another order
    assert not torch.equal(_sorted_columns(a["color"]), _sorted_columns(b["color"]))
    # the same splats: each geometry field's columns, sorted by position
    ka, kb = _canonical(a["pos"]), _canonical(b["pos"])
    for k in GEOMETRY:
        assert torch.equal(a[k][..., ka], b[k][..., kb]), k
    assert not torch.equal(_sorted_columns(a["pos"]), _sorted_columns(c["pos"]))    # another geometry


def test_scenes_geometry_is_the_programs_generators_draws():
    """The benchmark's copies of the generators draw the geometry the
    program's own draw from the configuration's seed."""
    import gsplat_tpu_torch as gt

    spec_t, t = _scene("trained_1m.serve")
    g = torch.Generator().manual_seed(spec_t["scene_seed"])
    want = gt.trained_like_splats(g, 5000, extent=spec_t["extent"], sh_scale=spec_t["sh_scale"], device="cpu")
    spec_u, u = _scene("envelope_8m.serve")
    g = torch.Generator().manual_seed(spec_u["scene_seed"])
    want_u = gt.random_splats(g, 5000, extent=spec_u["extent"], scale_range=tuple(spec_u["scale_range"]),
                              sh_scale=spec_u["sh_scale"], device="cpu")
    for got, w in ((t, want), (u, want_u)):
        kg, kw = _canonical(got["pos"]), _canonical(w.pos)
        for k in GEOMETRY:
            assert torch.equal(got[k][..., kg], getattr(w, k)[..., kw]), k


def test_camera_sets_and_targets_repeat_from_the_seed():
    for name in ("trained_1m.serve", "trained_1m.train"):
        t = spec.load(name).traffic
        a = scenes.camera_set(t, SEED, 64, 48, "cpu")
        b = scenes.camera_set(t, SEED, 64, 48, "cpu")
        c = scenes.camera_set(t, SEED + 1, 64, 48, "cpu")
        assert len(a) == t["poses"]
        assert all((p.view == q.view).all() and (p.proj == q.proj).all() for p, q in zip(a, b))
        # the orbit's phase is the seed's unless the mix fixes it
        moved = any((p.view != q.view).any() for p, q in zip(a, c))
        assert moved == ("phase_deg" not in t)
        heights = [float(p.position[1]) for p in a]
        assert all(abs(h - t["height"]) <= t["height_jitter"] + 1e-5 for h in heights)
    t = spec.load("trained_1m.train").traffic
    x = scenes.targets(t, SEED, 2, 64, 48, "cpu")
    assert torch.equal(x, scenes.targets(t, SEED, 2, 64, 48, "cpu"))
    assert not torch.equal(x, scenes.targets(t, SEED + 1, 2, 64, 48, "cpu"))
    assert x.shape == (2, 48, 64, 3) and float(x.min()) >= 0.0 and float(x.max()) <= 1.0
