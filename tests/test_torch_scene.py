"""Port vs JAX package: ``SceneRegistry`` (``scene.py``), held call by call.

Both registries get the same clusters (made with the JAX package from a seed
and carried across as numpy) and the same calls: registration with version
flush, include / render / post_render with aging and eviction, the budget
cull with its partial head, the far-cluster rebase, the amortized re-sort,
the explicit camera position and the SH-order setter.  After every call the
entries (active flags, ages), ``_generation``, the built active set, the
depth order and the once-logged warnings and errors are equal; the frames
agree within 1e-5 (the goldens' gate), with the port on ``"tiles"`` and on
``"auto"`` (the plain kernel versions on CPU tensors) against the JAX
registry's ``"tiles"``.  The rebased frame is also held to the direct render
of the un-rebased scene within 2e-3 (the JAX package's own rebase gate).

Cluster sizes repeat (40 splats each; 48 × 48) so the JAX side compiles few
shapes.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.scene import SceneRegistry as JRegistry
from gsplat_tpu_torch.scene import SceneRegistry as TRegistry
from torch_port_helpers import LogRecords, camera_to_torch, npy, splats_to_torch, to_config

JCFG = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0)
IMAGE_TOL = 1e-5
SIZE = 48


@pytest.fixture
def logs():
    """The scene loggers' records of both packages, with their once-keys
    cleared before the test."""
    from gsplat_tpu import scene as js_mod
    from gsplat_tpu_torch import scene as ts_mod

    out = {}
    for name, mod in (("jax", js_mod), ("torch", ts_mod)):
        mod.log._seen.clear()
        handler = LogRecords()
        logging.getLogger(mod.log._log.name).addHandler(handler)
        out[name] = handler
    yield out
    for name, mod in (("jax", js_mod), ("torch", ts_mod)):
        logging.getLogger(mod.log._log.name).removeHandler(out[name])


class Pair:
    """The JAX and the port registry driven by the same calls."""

    def __init__(self, jcfg=JCFG, backend="tiles", max_age=2):
        self.j = JRegistry(jcfg, max_age=max_age)
        self.t = TRegistry(to_config(jcfg), max_age=max_age)
        self.backend = backend

    def register(self, key, jsplats, version=0):
        a = self.j.register_update(key, jsplats, version)
        b = self.t.register_update(key, splats_to_torch(jsplats), version)
        assert a == b
        self.check()
        return a

    def call(self, name, *args):
        getattr(self.j, name)(*args)
        getattr(self.t, name)(*args)
        self.check()

    def frame(self, jcam, *ids):
        for rid in ids:
            self.call("include_in_render_pass", rid)
        jimg = self.j.render(jcam, backend="tiles")
        timg = self.t.render(camera_to_torch(jcam), backend=self.backend)
        self.check()
        if jimg is None:
            assert timg is None
            return None
        jimg = np.asarray(jimg)
        assert timg.shape == jimg.shape
        err = float(np.abs(npy(timg) - jimg).max())
        assert err < IMAGE_TOL, err
        return npy(timg)

    def check(self):
        j, t = self.j, self.t
        assert list(j._entries) == list(t._entries)
        for rid, e in j._entries.items():
            f = t._entries[rid]
            assert (e.version, e.active, e.age) == (f.version, f.active, f.age), rid
        assert (j._generation, j._built_generation, j._built_active) == (
            t._generation, t._built_generation, t._built_active)
        assert j.total_active_splats == t.total_active_splats
        assert (j._order is None) == (t._order is None)
        if j._order is not None:
            assert np.array_equal(np.asarray(j._order), npy(t._order))
        assert (j._cached is None) == (t._cached is None)
        if j._cached is not None:
            assert j._cached.count == t._cached.count
            # float32 world coordinates: held to 1e-6 of their magnitude
            scale = max(1.0, float(np.abs(np.asarray(j._origin)).max()))
            np.testing.assert_allclose(npy(t._origin), np.asarray(j._origin), rtol=0, atol=1e-6 * scale)
            np.testing.assert_allclose(npy(t._cached.pos), np.asarray(j._cached.pos), rtol=0, atol=1e-6 * scale)
        assert (j._explicit_camera_pos is None) == (t._explicit_camera_pos is None)
        assert j._sh_order == t._sh_order


def clusters(*seeds, n=40, extent=0.5):
    return [gj.random_splats(jax.random.PRNGKey(s), n, extent=extent, sh_scale=0.2) for s in seeds]


def cam(eye=(0.1, 0.3, 2.5), target=(0.0, 0.0, 0.0)):
    return gj.make_camera(list(eye), list(target), SIZE, SIZE)


@pytest.mark.parametrize("backend", ["tiles", "auto"])
def test_lifecycle_call_by_call(backend, logs):
    a, b, c1, c2 = clusters(0, 1, 2, 3)
    p = Pair(backend=backend, max_age=1)
    ra = p.register("sopA", a)
    rb = p.register("sopB", b)
    rc = p.register("sopC", c1, 1)
    rc2 = p.register("sopC", c2, 2)  # flushes version 1
    assert rc not in p.t._entries and rc2 in p.t._entries
    img = p.frame(cam(), ra, rb)
    # one global sort over both clusters = the render of their concat
    direct = npy(gt.render_tiles(splats_to_torch(a.concat(b)), camera_to_torch(cam()), to_config(JCFG)))
    assert np.abs(img - direct).max() < IMAGE_TOL
    p.call("post_render")
    p.frame(cam((0.4, 0.3, 2.4)), ra)  # B inactive: not drawn
    p.call("post_render")              # C: inactive 2 frames > max_age → evicted
    assert rc2 not in p.t._entries and rb in p.t._entries
    rc2 = p.register("sopC", c2, 2)
    p.frame(cam(), ra, rc2)
    assert p.t.generate_render_geometry() is False  # cached geometry reused
    p.call("post_render")              # B evicted
    assert rb not in p.t._entries
    assert p.frame(cam()) is None      # nothing included
    p.call("post_render")
    p.call("flush", "sopA")
    p.frame(cam(), rc2)
    p.call("post_render")
    assert logs["jax"].records == logs["torch"].records == []


def test_budget_cull_partial_head_and_warning(logs):
    a, b, c = clusters(0, 1, 2)
    p = Pair(dataclasses.replace(JCFG, max_splats=50))
    ra, rb = p.register("sopA", a), p.register("sopB", b)
    for rid in (ra, rb):
        p.call("include_in_render_pass", rid)
    p.call("generate_render_geometry")
    assert p.t._cached.count == 50  # 40 + the first 10 of the crossing cluster
    np.testing.assert_allclose(npy(p.t._cached.pos[:, 40:] + p.t._origin[:, None]),
                               np.asarray(b.pos[:, :10]), rtol=0, atol=1e-6)
    rc = p.register("sopC", c)     # a third cluster over budget: dropped whole
    for rid in (ra, rb, rc):
        p.call("include_in_render_pass", rid)
    p.call("generate_render_geometry")
    assert p.t._cached.count == 50
    p.call("post_render")
    p.call("include_in_render_pass", ra)  # within budget: the warning re-arms
    p.call("generate_render_geometry")
    p.call("post_render")
    for rid in (ra, rb):
        p.call("include_in_render_pass", rid)
    p.call("generate_render_geometry")
    warned = [m for lvl, m in logs["torch"].records if lvl == "WARNING"]
    assert logs["jax"].records == logs["torch"].records
    assert warned == ["splat budget 50 exceeded — culling 30 splats",
                      "splat budget 50 exceeded — culling 30 splats"], warned


@pytest.mark.parametrize("backend", ["tiles", "auto"])
def test_far_cluster_rebase(backend):
    """Clusters far from the world origin.  (a) The JAX package's case: the
    registry's frame within 2e-3 of the direct render of the un-rebased
    scene.  (b) Held call by call against the JAX registry (frames within
    1e-5): 32 splats on a 2^-12 grid, whose float32 barycenter is exact in
    any summation order, so both packages rebase by the same origin — with
    (a)'s positions the two float32 means differ by an ulp (7.6e-6 at 100),
    and the camera's rebased translation, a sum of terms of size ~140 that
    cancel to ~2.5, carries that into the frame at ~5e-5."""
    far = jnp.array([100.0, -50.0, 80.0])
    (base,) = clusters(0)
    shifted = dataclasses.replace(base, pos=base.pos + far[:, None])
    jcam = cam(np.asarray([0.1, 0.3, 2.5]) + np.asarray(far), np.asarray(far))
    tcam = camera_to_torch(jcam)
    reg = TRegistry(to_config(JCFG))
    rid = reg.register_update("sopA", splats_to_torch(shifted))
    reg.include_in_render_pass(rid)
    img = npy(reg.render(tcam, backend=backend))
    direct = npy(gt.render(splats_to_torch(shifted), tcam, to_config(JCFG), backend=backend))
    assert np.abs(img - direct).max() < 2e-3
    assert img[..., 3].max() > 0.1

    grid = dataclasses.replace(shifted, pos=jnp.round(shifted.pos * 4096.0) / 4096.0).head(32)
    p = Pair(backend=backend)
    rid = p.register("sopA", grid)
    img = p.frame(jcam, rid)
    assert np.array_equal(npy(p.t._origin), np.asarray(p.j._origin))
    direct = npy(gt.render(splats_to_torch(grid), tcam, to_config(JCFG), backend=backend))
    assert np.abs(img - direct).max() < 2e-3
    assert img[..., 3].max() > 0.1
    p.call("post_render")
    img2 = p.frame(jcam, rid)  # the same camera: no re-sort, the same frame
    assert np.array_equal(img, img2)


def test_amortized_sort_explicit_camera_and_sh_order(logs):
    (a,) = clusters(0, extent=0.4)
    p = Pair()
    p.j.sort_movement_threshold = p.t.sort_movement_threshold = 1e9  # never re-sort
    rid = p.register("sopA", a)
    p.frame(cam((0.0, 0.0, 2.5)), rid)
    order1 = npy(p.t._order).copy()
    p.call("post_render")
    p.frame(cam((0.5, 0.0, 2.5)), rid)  # moved: the stale order is kept
    assert np.array_equal(npy(p.t._order), order1)
    assert p.t._accum_delta_sq == pytest.approx(p.j._accum_delta_sq, rel=1e-6) and p.t._accum_delta_sq > 0
    p.call("post_render")
    p.j.sort_movement_threshold = p.t.sort_movement_threshold = 0.0  # any movement re-sorts
    p.frame(cam((0.0, 0.0, 2.5)), rid)
    assert p.t._accum_delta_sq == p.j._accum_delta_sq == 0.0
    p.call("post_render")
    p.call("set_explicit_camera_pos", [5.0, 0.0, 0.0])
    p.frame(cam((0.0, 0.0, 2.5)), rid)  # sorted and shaded from the explicit position
    p.call("post_render")
    assert p.t._explicit_camera_pos is None  # consumed by one frame
    p.call("set_sh_order", 7)  # out of range: clamped to 0, one error
    p.call("set_sh_order", 9)
    assert p.t._sh_order == 0
    p.frame(cam((0.0, 0.0, 2.5)), rid)
    p.call("post_render")
    p.call("set_sh_order", 2)
    p.call("set_sh_order", 8)  # re-armed: errors again
    assert logs["jax"].records == logs["torch"].records
    assert [lvl for lvl, _ in logs["torch"].records] == ["ERROR", "ERROR"]


def test_overflow_is_reported_at_the_next_frame(caplog):
    """A frame over its pair budget warns at the start of the next render
    (its counters are read then, not inside the frame)."""
    from gsplat_tpu_torch.ops import binning

    (a,) = clusters(0, n=200, extent=0.5)
    tcfg = dataclasses.replace(to_config(JCFG), pair_budget_override=16)
    reg = TRegistry(tcfg)
    rid = reg.register_update("sopA", splats_to_torch(a))
    tcam = camera_to_torch(cam())
    binning._log._seen.clear()
    with caplog.at_level(logging.WARNING, logger="gsplat_tpu_torch"):
        reg.include_in_render_pass(rid)
        reg.render(tcam)
        assert not caplog.records and int(reg._last_stats.dropped_pairs) > 0
        reg.post_render()
        reg.include_in_render_pass(rid)
        reg.render(tcam)
    assert len(caplog.records) == 1 and "dropped" in caplog.records[0].getMessage()
