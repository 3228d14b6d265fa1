"""Port vs JAX package: the ray/bbox queries (``ops/queries.py``) and the
native host helpers (``io/native.py``).

Gates: every slab-test case of the JAX package's ``tests/test_queries_json.py``
(and the parallel-axis rule inside and outside the slab) gives the same hits
and distances and positions within 1e-6.  The native helpers — the port's own
copy of the C++ source, built into ``build/`` — are bit-equal to the JAX
module's library, and the port's ``*_plain`` numpy versions bit-equal to the
JAX module's numpy fallback, on the same inputs.  A failed build raises.
"""

import numpy as np
import pytest

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.io import native as jn
from gsplat_tpu_torch.io import native as tn
from torch_port_helpers import CPU, npy

QUERY_TOL = 1e-6
POS = np.array([[-1.0, -1.0, -1.0], [1.0, 2.0, 3.0], [0.0, 0.5, 1.0]])

# (org, dir, tmax) — bbox [-1,1]×[-1,2]×[-1,3]
RAYS = [
    ([-5.0, 0.0, 0.0], [1.0, 0.0, 0.0], np.inf),   # through the box, enters at x=-1
    ([-5.0, 10.0, 0.0], [1.0, 0.0, 0.0], np.inf),  # miss
    ([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], np.inf),    # origin inside: distance 0
    ([-5.0, 0.0, 0.0], [1.0, 0.0, 0.0], 2.0),      # culled by tmax
    ([-5.0, 0.0, 0.0], [-1.0, 0.0, 0.0], np.inf),  # box behind the origin
    ([0.5, 5.0, 0.5], [0.0, -1.0, 0.0], np.inf),   # two parallel axes, inside both slabs
    ([1.5, 5.0, 0.5], [0.0, -1.0, 0.0], np.inf),   # parallel axis outside its slab
    ([-3.0, -3.0, -3.0], [0.3, 0.4, 0.5], np.inf), # oblique
]


def _hit_equal(jh, th):
    assert np.array_equal(np.asarray(jh.hit), npy(th.hit))
    np.testing.assert_allclose(npy(th.distance), np.asarray(jh.distance), rtol=0, atol=QUERY_TOL)
    np.testing.assert_allclose(npy(th.pos), np.asarray(jh.pos), rtol=0, atol=QUERY_TOL)


def test_ray_bbox_cases_match_jax():
    js = gj.make_splats(POS, opacity=np.array([0.5, 0.8, 1.0]))
    ts = gt.make_splats(POS, opacity=np.array([0.5, 0.8, 1.0]), device=CPU)
    for org, dir_, tmax in RAYS:
        th = gt.intersect_ray_bbox(ts, org, dir_, tmax=tmax)
        assert th.hit.shape == () and th.pos.shape == (3,) and th.hit.device.type == "cpu"
        _hit_equal(gj.intersect_ray_bbox(js, org, dir_, tmax=tmax), th)
    assert [bool(gt.intersect_ray_bbox(ts, o, d, t).hit) for o, d, t in RAYS] == [
        True, False, True, False, False, True, False, True]
    assert float(gt.intersect_ray_bbox(ts, *RAYS[0][:2]).distance) == 4.0
    assert float(gt.intersect_ray_bbox(ts, *RAYS[2][:2]).distance) == 0.0


def test_batched_rays_match_jax_and_single():
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(64, 3)).astype(np.float32)
    js, ts = gj.make_splats(pos), gt.make_splats(pos, device=CPU)
    orgs = rng.normal(scale=4.0, size=(257, 3)).astype(np.float32)
    dirs = rng.normal(size=(257, 3)).astype(np.float32)
    dirs[::7, 1] = 0.0  # parallel to a slab
    th = gt.intersect_rays_bbox(ts, orgs, dirs, tmax=6.0)
    assert th.hit.shape == (257,) and th.pos.shape == (257, 3)
    _hit_equal(gj.intersect_rays_bbox(js, orgs, dirs, tmax=6.0), th)
    for i in (0, 7, 100):
        one = gt.intersect_ray_bbox(ts, orgs[i], dirs[i], tmax=6.0)
        assert bool(one.hit) == bool(th.hit[i]) and float(one.distance) == float(th.distance[i])


@pytest.fixture
def jax_fallback(monkeypatch):
    """The JAX module's numpy fallback: its library handle taken away."""
    def use():
        monkeypatch.setattr(jn, "_lib", None)
        monkeypatch.setattr(jn, "_tried", True)
    return use


def test_extract_columns_bit_equal(jax_fallback):
    n, stride = 1000, 24
    rec = np.random.default_rng(0).normal(size=(n, 6)).astype(np.float32)
    raw = rec.tobytes()
    offsets = [0, 8, 20]
    lib, plain = tn.extract_columns(raw, n, stride, offsets), tn.extract_columns_plain(raw, n, stride, offsets)
    want = jn.extract_columns(raw, n, stride, offsets)
    jax_fallback()
    want_plain = jn.extract_columns(raw, n, stride, offsets)
    for k in range(3):
        assert np.array_equal(lib[k], want[k]) and np.array_equal(plain[k], want_plain[k])
        assert np.array_equal(lib[k], rec[:, offsets[k] // 4])
    with pytest.raises(ValueError):
        tn.extract_columns(raw[:-1], n, stride, offsets)


def test_activations_bit_equal(jax_fallback):
    n = 257
    rng = np.random.default_rng(1)
    op = rng.normal(size=n).astype(np.float32)
    sc = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    rot = [rng.normal(size=n).astype(np.float32) for _ in range(4)]
    rot[0][:4] = 0.0
    for r in rot[1:]:
        r[:2] = 0.0  # two zero quaternions: the 1e-12 floor

    def run(fn):
        o, s, q = fn(op.copy(), [a.copy() for a in sc], [a.copy() for a in rot])
        return [o, *s, *q]

    lib, plain, want = run(tn.activate_splats_inplace), run(tn.activate_splats_inplace_plain), run(
        jn.activate_splats_inplace)
    jax_fallback()
    want_plain = run(jn.activate_splats_inplace)
    for a, b in zip(lib, want):
        assert np.array_equal(a, b)
    for a, b in zip(plain, want_plain):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_radix_argsort_bit_equal(jax_fallback):
    rng = np.random.default_rng(2)
    cases = [
        rng.normal(size=10000).astype(np.float32) * 100,
        np.array([0.0, -1.5, 3.0, -1.5, 0.0, 2.0], np.float32),                # negatives and ties
        np.array([0.0, -0.0, 1.0, -0.0, 0.0, -2.0, np.inf, -np.inf], np.float32),  # signed zeros
        np.array([], np.float32),
    ]
    libs = [tn.radix_argsort(k) for k in cases]
    plains = [tn.radix_argsort_plain(k) for k in cases]
    wants = [jn.radix_argsort(k) for k in cases]
    jax_fallback()
    want_plains = [jn.radix_argsort(k) for k in cases]
    for k, lib, plain, want, want_plain in zip(cases, libs, plains, wants, want_plains):
        assert lib.dtype == plain.dtype == np.int32
        assert np.array_equal(lib, want) and np.array_equal(plain, want_plain)
        assert np.array_equal(k[lib], np.sort(k))
    # the radix sort ranks -0.0 before +0.0; the stable numpy sort keeps input order
    assert list(libs[2][2:5]) == [1, 3, 0] and list(plains[2][2:6]) == [0, 1, 3, 4]


def test_morton_order_bit_equal(jax_fallback):
    n = 512
    t = np.linspace(0, 1, n).astype(np.float32)
    perm = np.random.default_rng(3).permutation(n)
    line = np.stack([t[perm], t[perm], t[perm]])
    cloud = np.random.default_rng(4).normal(size=(3, 3000)).astype(np.float32)
    libs = [tn.morton_order(p) for p in (line, cloud)]
    plains = [tn.morton_order_plain(p) for p in (line, cloud)]
    wants = [jn.morton_order(p) for p in (line, cloud)]
    jax_fallback()
    want_plains = [jn.morton_order(p) for p in (line, cloud)]
    for lib, plain, want, want_plain in zip(libs, plains, wants, want_plains):
        assert np.array_equal(lib, want) and np.array_equal(plain, want_plain)
    # points along a line: the Z-order is monotone along it
    assert np.array_equal(t[perm][libs[0]], np.sort(t)) and np.array_equal(t[perm][plains[0]], np.sort(t))


def test_failed_native_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "host_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("GSPLAT_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tn, "SOURCE", bad)
    monkeypatch.setattr(tn, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tn.radix_argsort(np.zeros(3, np.float32))
    # the library built from the real source lies under build/, not in the package
    monkeypatch.undo()
    lib_path = tn.get_lib()._name
    assert "/build/host_io-" in lib_path
