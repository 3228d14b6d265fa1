"""The projection as one forward and one backward function
(``ops/kernels/projection.py``: ``ProjectSplats``), on the CPU.

On CPU tensors ``project_splats`` runs the two kernels' plain versions inside
the same ``autograd.Function`` as on the card: the forward the JAX package's
arithmetic, the backward the analytic VJP.  Both are held against the JAX
package's ``project_splats`` and its ``jax.vjp``, and the analytic VJP against
autograd through the plain forward on the inputs where a branch rule decides
the gradient.  Gradients are compared by each field's max |g| and in the
2-norm, never entry by entry: at an axis-aligned eigenvector the VJP of both
packages is not additive in its cotangent (ROADMAP.md, queue 3).  The kernels
themselves are held against these plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu_torch.ops.kernels import projection as kproj
from torch_port_helpers import camera_to_torch, jax_scene, npy, splats_to_torch

FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")
# Fields: tests/test_torch_projection.py's tolerance (an ulp of rsqrt or log
# amplified by the focal length).  Gradients: the on-chip gate's 2e-4 of each
# field's max |g|, and the same in the 2-norm.
RTOL = ATOL = 1e-5
GRAD_TOL = 2e-4


def _assert_grads_close(got, want, tol=GRAD_TOL):
    for name, a, b in zip(FIELDS, got, want):
        if b is None:
            assert a is None or not np.any(npy(a)), name
            continue
        assert a is not None, name
        a, b = npy(a).astype(np.float64), npy(b).astype(np.float64)
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max()
        d = np.abs(a - b)
        assert d.max() <= tol * max(scale, 1e-30), (name, d.max(), scale)
        assert np.linalg.norm(d) <= tol * max(np.linalg.norm(b), 1e-30), name


def _cotangent(n, seed):
    return np.random.default_rng(seed).normal(size=(16, n)).astype(np.float32)


def _leaves(splats):
    """Leaves in the splats' dtype, and their float32 casts: gradients are
    compared in float32 (a bf16 gradient's rounding would hide nothing and
    flip whole bf16 steps)."""
    leaves = [getattr(splats, f).detach().clone().requires_grad_(True) for f in FIELDS]
    return leaves, [t.to(torch.float32) for t in leaves]


def _torch_vjp(splats, cam, cot, sh_order, tight, only_sh):
    leaves, cast = _leaves(splats)
    p = gt.project_splats(gt.GaussianSplats(*cast), cam, sh_order, tight_footprint=tight, only_sh=only_sh)
    assert type(p.fields.grad_fn).__name__ == "ProjectSplatsBackward"  # the Function, as on the card
    grads = torch.autograd.grad(p.fields, cast + leaves, grad_outputs=torch.from_numpy(cot), allow_unused=True)
    for f, leaf, g in zip(FIELDS, leaves, grads[6:]):  # cast back by autograd to the field's dtype
        assert g is None or g.dtype == leaf.dtype, f
    return p.fields, grads[:6]


def _autograd_plain(splats, cam, cot, sh_order, tight, only_sh):
    """Autograd through project_fields_plain (the projection before the
    kernels), in float32."""
    _, cast = _leaves(splats)
    f = kproj.project_fields_plain(*cast, cam.view, cam.proj, cam.position, cam.width, cam.height,
                                   sh_order, tight, only_sh)
    return f, torch.autograd.grad(f, cast, grad_outputs=torch.from_numpy(cot), allow_unused=True)


@pytest.mark.parametrize(
    "sh_order,tight,only_sh,explicit",
    [(0, False, False, False), (1, True, True, False), (2, False, False, True), (3, True, False, False)],
)
def test_function_matches_jax_project_splats_and_vjp(sh_order, tight, only_sh, explicit):
    js, jc = jax_scene(n=257, seed=7, w=64, h=64, sh=0.3)
    if explicit:
        jc = dataclasses.replace(jc, explicit_camera_pos=jnp.asarray([0.3, 0.2, 2.5], jnp.float32))
    cot = _cotangent(257, 1 + sh_order)

    def jfn(s):
        return gj.project_splats(s, jc, sh_order, tight_footprint=tight, only_sh=only_sh).fields

    jf, vjp = jax.vjp(jfn, js)
    (jg,) = vjp(jnp.asarray(cot))
    tf, tg = _torch_vjp(splats_to_torch(js), camera_to_torch(jc), cot, sh_order, tight, only_sh)
    np.testing.assert_allclose(npy(tf), np.asarray(jf), rtol=RTOL, atol=ATOL)
    assert np.array_equal(npy(tf)[11], np.asarray(jf)[11]) and not npy(tf)[15].any()
    # The JAX package's splats hold the same (components, N) arrays.
    want = [None if (f == "color" and only_sh) or (f == "sh" and sh_order == 0) else np.asarray(getattr(jg, f))
            for f in FIELDS]
    _assert_grads_close(tg, want)


def _axis_aligned_scene():
    """Isotropic splats on the optical axis of a camera whose view rotation
    is the identity: cov_b = 0 and cov_a = cov_c exactly, so the eigenvector
    falls back to (1, -0.0) and ay, bx are exactly -0.0."""
    n = 8
    z = np.linspace(-0.5, 0.5, n).astype(np.float32)
    pos = np.stack([np.zeros(n), np.zeros(n), z], axis=1).astype(np.float32)
    half = np.linspace(0.0, 1.2, n)
    orient = np.stack([np.zeros(n), np.zeros(n), np.sin(half), np.cos(half)], axis=1).astype(np.float32)
    s = np.linspace(0.02, 0.09, n).astype(np.float32)
    scale = np.stack([s, s, 1.7 * s], axis=1).astype(np.float32)
    rng = np.random.default_rng(3)
    splats = gt.make_splats(pos, orient=orient, scale=scale, opacity=np.full(n, 0.7, np.float32),
                            color=rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
                            sh=(0.2 * rng.normal(size=(n, 15, 3))).astype(np.float32), device="cpu")
    cam = gt.make_camera(eye=[0.0, 0.0, 3.0], target=[0, 0, 0], width=64, height=48, device="cpu")
    return splats, cam


def _edge_scene(case):
    if case == "axis_aligned":
        return _axis_aligned_scene()
    js, jc = jax_scene(n=300, seed=4, extent=1.5, sh=0.3)
    splats = splats_to_torch(js)
    if case == "behind":
        jc = gj.make_camera(eye=[0.0, 0.0, 0.0], target=[0, 0, -1], width=64, height=64)
    elif case == "black_zero_sh":
        color, sh = splats.color.clone(), splats.sh.clone()
        color[:, :40] = 0.0
        sh[:, :40] = 0.0
        splats = dataclasses.replace(splats, color=color, sh=sh)
    elif case == "bf16":
        splats = splats.astype(torch.bfloat16)
    return splats, camera_to_torch(jc)


@pytest.mark.parametrize("case", ["behind", "axis_aligned", "black_zero_sh", "bf16"])
def test_analytic_vjp_matches_autograd_of_the_plain_forward(case):
    splats, cam = _edge_scene(case)
    n = splats.count
    for k, (sh_order, tight) in enumerate(((3, True), (3, False), (1, True))):
        cot = _cotangent(n, 10 + k)
        tf, tg = _torch_vjp(splats, cam, cot, sh_order, tight, False)
        pf, pg = _autograd_plain(splats, cam, cot, sh_order, tight, False)
        assert torch.equal(tf, pf)
        _assert_grads_close(tg, pg)
        if case == "behind":
            assert 50 < int((tf[11] < 0.5).sum()) < 250  # about half behind the camera
        if case == "axis_aligned":  # the -0.0 basis rows
            assert torch.all(torch.signbit(tf[3])) and torch.all(tf[3] == 0)
            assert torch.all(torch.signbit(tf[4])) and torch.all(tf[4] == 0)
        if case == "black_zero_sh" and sh_order > 0:
            # the max0 tie: a black splat's colour gradient is half its cotangent
            np.testing.assert_array_equal(npy(tg[4])[:, :40], 0.5 * cot[6:9, :40])


def test_wrappers_check_inputs_and_the_function_saves_only_inputs():
    splats, cam = _edge_scene("black_zero_sh")
    args = [getattr(splats, f) for f in FIELDS] + [cam.view, cam.proj, cam.position]
    with pytest.raises(TypeError):
        kproj.project_fields(*[a.double() if i == 2 else a for i, a in enumerate(args)], 64, 64)
    with pytest.raises(ValueError):
        kproj.project_fields(*args, 64, 64, sh_order=4)
    view = cam.view.clone().requires_grad_(True)
    with pytest.raises(ValueError):
        gt.project_splats(splats, dataclasses.replace(cam, view=view))
    # zero splats: an empty (16, 0) matrix and empty gradients
    empty = splats.head(0)
    out = kproj.project_fields(*[getattr(empty, f) for f in FIELDS], cam.view, cam.proj, cam.position, 64, 64)
    assert out.shape == (16, 0)
    grads = kproj.project_fields_bwd(*[getattr(empty, f) for f in FIELDS], cam.view, cam.proj, cam.position,
                                     64, 64, 3, True, False, torch.zeros(16, 0))
    assert [tuple(g.shape) for g in grads] == [(3, 0), (4, 0), (3, 0), (0,), (3, 0), (45, 0)]
    # autograd keeps the nine inputs and nothing of the forward's intermediates
    leaves = {f: getattr(splats, f).clone().requires_grad_(True) for f in FIELDS}
    fields = gt.project_splats(dataclasses.replace(splats, **leaves), cam).fields
    assert len(fields.grad_fn.saved_tensors) == 9


def test_axes_vjp_is_autograds_own_sums():
    """From the quad basis back to the 2D covariance the analytic VJP is
    autograd's, bit for bit: near an axis-aligned eigenvector that section
    cancels terms of ~1e5·|g|, so its order of operations shows in the
    sharded renderer's gradient gate."""
    js, _ = jax_scene(n=2000, seed=11, extent=1.5, sh=0.3)
    jc = gj.make_camera(eye=[0.0, 0.0, 0.0], target=[0, 0, -1], width=640, height=360)
    splats, cam = splats_to_torch(js), camera_to_torch(jc)
    cot = torch.from_numpy(_cotangent(2000, 5))
    for tight in (False, True):
        leaves = [getattr(splats, f).clone().requires_grad_(True) for f in FIELDS]
        args = (cam.view, cam.proj, cam.position, cam.width, cam.height, 3, tight, False)
        fields, t = kproj._project(*leaves, *args)
        want = torch.autograd.grad(fields, [t.cov_a, t.cov_b, t.cov_c], cot)
        with torch.no_grad():
            _, t0 = kproj._project(*[x.detach() for x in leaves], *args)
            got = kproj._axes_vjp(t0, cot.unbind(0), tight)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
