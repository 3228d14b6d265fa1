"""Port vs JAX package: the per-splat math ops, ``project_splats``, and the
sanitize / quantize stages (the latter two bit-for-bit on JAX's fields)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.ops import covariance as jcov
from gsplat_tpu.ops import quaternion as jquat
from gsplat_tpu.ops import sh as jsh
from gsplat_tpu.ops.pallas.composite import pack2 as j_pack2
from gsplat_tpu.ops.pallas.composite import round_bf16 as j_round_bf16
from gsplat_tpu.ops.pallas.composite import unpack2 as j_unpack2
from gsplat_tpu.ops.rasterize_ref import quantize_payload as j_quantize
from gsplat_tpu.ops.rasterize_ref import sanitize_projected as j_sanitize
from gsplat_tpu_torch.ops import covariance as tcov
from gsplat_tpu_torch.ops import projection as tproj
from gsplat_tpu_torch.ops import quaternion as tquat
from gsplat_tpu_torch.ops import sh as tsh
from gsplat_tpu_torch.ops.kernels.composite import pack2, pack_payload, unpack2
from gsplat_tpu_torch.ops.permute import permute_cols
from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, round_bf16, sanitize_projected
from torch_port_helpers import (
    camera_to_torch, j_projected, jax_scene, npy, splats_to_torch, t_projected,
)

# Projection tolerance, in pixel units for the geometric rows: every op is
# one separately rounded float32 operation in both packages and in the same
# order, but rsqrt, log and exp differ by an ulp between XLA-CPU and
# PyTorch-CPU, and that ulp is amplified by the focal length.
RTOL = ATOL = 1e-5


def test_constants_equal():
    for name in ("ALPHA_CUTOFF", "QUAD_EXTENT", "FOV_CLAMP", "COV2D_DILATION", "LAMBDA2_MIN", "AXIS_MAX_PX"):
        assert getattr(tcov, name) == getattr(jcov, name), name
    for name in ("SH_C0", "SH_C1", "SH_C2", "SH_C3"):
        assert getattr(tsh, name) == getattr(jsh, name), name
    from gsplat_tpu.ops import projection as jproj

    for name in dir(jproj):
        if name.startswith("ROW_") or name == "N_FIELDS":
            assert getattr(tproj, name) == getattr(jproj, name), name


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_quaternion_ops_match():
    q = _rand((64, 4), 0)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = np.abs(_rand((64, 3), 1)) + 0.01
    jm = np.asarray(jquat.rotation_scale_matrix(jnp.asarray(q), jnp.asarray(s)))
    tm = npy(tquat.rotation_scale_matrix(torch.from_numpy(q), torch.from_numpy(s)))
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=1e-7)
    jc = np.asarray(jquat.covariance_3d(jnp.asarray(q), jnp.asarray(s)))
    tc = npy(tquat.covariance_3d(torch.from_numpy(q), torch.from_numpy(s)))
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-7)


def test_ewa_and_decompose_match():
    js, jc = jax_scene(n=100, seed=2)
    pos = np.array(js.pos_n3)
    cov3 = np.array(jquat.covariance_3d(js.orient_n4, js.scale_n3))
    jcov2 = np.array(jcov.ewa_project(jnp.asarray(pos), jnp.asarray(cov3), jc.view, jc.proj, jc.width))
    tc = camera_to_torch(jc)
    tcov2 = tcov.ewa_project(torch.from_numpy(pos), torch.from_numpy(cov3), tc.view, tc.proj, tc.width)
    np.testing.assert_allclose(npy(tcov2), jcov2, rtol=1e-5, atol=1e-5)
    jv1, jv2 = jcov.decompose_covariance(jnp.asarray(jcov2))
    tv1, tv2 = tcov.decompose_covariance(torch.from_numpy(jcov2))
    np.testing.assert_allclose(npy(tv1), np.asarray(jv1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(npy(tv2), np.asarray(jv2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("order,only_sh", [(0, False), (1, False), (2, True), (3, False)])
def test_shade_sh_matches(order, only_sh):
    base = np.abs(_rand((50, 3), 3))
    sh = 0.3 * _rand((50, 15, 3), 4)
    d = _rand((50, 3), 5)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    j = np.asarray(jsh.shade_sh(jnp.asarray(base), jnp.asarray(sh), jnp.asarray(d), order, only_sh))
    t = npy(tsh.shade_sh(torch.from_numpy(base), torch.from_numpy(sh), torch.from_numpy(d), order, only_sh))
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "sh_order,tight,only_sh",
    [(0, False, False), (0, True, False), (3, False, False), (3, True, False), (2, True, True)],
)
def test_project_splats_matches(sh_order, tight, only_sh):
    js, jc = jax_scene(n=400, seed=1, w=96, h=64, sh=0.3)
    j = np.asarray(gj.project_splats(js, jc, sh_order, tight_footprint=tight, only_sh=only_sh).fields)
    t = gt.project_splats(splats_to_torch(js), camera_to_torch(jc), sh_order, tight_footprint=tight, only_sh=only_sh)
    assert t.fields.shape == (16, 400) and t.fields.dtype == torch.float32
    np.testing.assert_allclose(npy(t.fields), j, rtol=RTOL, atol=ATOL)
    # the validity row and the zero row are exact
    assert np.array_equal(npy(t.fields)[11], j[11]) and np.array_equal(npy(t.fields)[15], j[15])


def test_project_behind_camera_scene():
    # camera in the middle of the cloud: about half the splats lie behind it
    js, _ = jax_scene(n=300, seed=4, extent=1.5)
    jc = gj.make_camera(eye=[0.0, 0.0, 0.0], target=[0, 0, -1], width=64, height=64)
    jp = gj.project_splats(js, jc, 3, tight_footprint=True)
    tp = gt.project_splats(splats_to_torch(js), camera_to_torch(jc), 3, tight_footprint=True)
    j, t = np.asarray(jp.fields), npy(tp.fields)
    assert 50 < int((j[11] < 0.5).sum()) < 250
    assert np.array_equal(t[11], j[11])
    front = j[11] > 0.5
    # Splats within a whisker of the camera plane have unbounded pixel
    # coordinates; hold those to the relative tolerance only.
    np.testing.assert_allclose(t[:, front], j[:, front], rtol=1e-4, atol=ATOL)
    assert np.isfinite(t[:10]).all()
    # after sanitize both agree everywhere, and the invalid columns are benign
    js_, ts_ = np.asarray(j_sanitize(jp).fields), npy(sanitize_projected(tp).fields)
    assert np.array_equal(ts_[:, ~front], js_[:, ~front])


def test_sanitize_bit_equal_on_jax_fields():
    js, _ = jax_scene(n=300, seed=4, extent=1.5)
    jc = gj.make_camera(eye=[0.0, 0.0, 0.0], target=[0, 0, -1], width=64, height=64)
    f = np.asarray(gj.project_splats(js, jc, 3, tight_footprint=True).fields)
    j = np.asarray(j_sanitize(j_projected(f)).fields)
    t = npy(sanitize_projected(t_projected(f)).fields)
    assert np.array_equal(t.view(np.int32), j.view(np.int32))


@pytest.mark.parametrize("payload_dtype", ["float32", "bfloat16", "packed"])
def test_quantize_payload_bit_equal_on_jax_fields(payload_dtype):
    js, jc = jax_scene(n=400, seed=1, sh=0.3)
    f = np.asarray(j_sanitize(gj.project_splats(js, jc, 3, tight_footprint=True)).fields)
    jcfg = gj.RenderConfig(payload_dtype=payload_dtype)
    tcfg = gt.RenderConfig(payload_dtype=payload_dtype)
    j = np.asarray(j_quantize(j_projected(f), jcfg).fields)
    t = npy(quantize_payload(t_projected(f), tcfg).fields)
    assert np.array_equal(t.view(np.int32), j.view(np.int32))


def test_round_bf16_and_pack2_bit_equal():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=5000).astype(np.float32),
        (rng.normal(size=5000) * 1e-3).astype(np.float32),
        np.array([0.0, -0.0, 1.0, 1.0000001, 0.1, 3.14159265, -2.7182818, 1e-4, 0.99, 255.0], np.float32),
        # ties-to-even cases: exactly halfway between two bf16 values
        np.array([0x3F808000, 0x3F818000, 0x3F800001 + 0x7FFF], np.uint32).view(np.float32),
    ])
    y = x[::-1].copy()
    jr = np.asarray(j_round_bf16(jnp.asarray(x)))
    tr = npy(round_bf16(torch.from_numpy(x)))
    assert np.array_equal(tr.view(np.int32), jr.view(np.int32))
    jp = np.asarray(j_pack2(jnp.asarray(x), jnp.asarray(y)))
    tp = pack2(torch.from_numpy(x), torch.from_numpy(y))
    assert tp.dtype == torch.int32 and np.array_equal(npy(tp), jp)
    jhi, jlo = j_unpack2(jnp.asarray(jp))
    thi, tlo = unpack2(tp)
    assert np.array_equal(npy(thi).view(np.int32), np.asarray(jhi).view(np.int32))
    assert np.array_equal(npy(tlo).view(np.int32), np.asarray(jlo).view(np.int32))
    assert np.array_equal(npy(thi), tr) and np.array_equal(npy(tlo), npy(round_bf16(torch.from_numpy(y))))


def test_pack_payload_equals_jax_gather_payload_columns():
    from gsplat_tpu.ops.pallas.composite import _gather_payload

    js, jc = jax_scene(n=200, seed=2, sh=0.3)
    cfg = gj.RenderConfig(payload_dtype="packed")
    f = np.array(j_quantize(j_sanitize(gj.project_splats(js, jc, 3, tight_footprint=True)), cfg).fields)
    idx = np.arange(200, dtype=np.int32)[::-1].copy()
    j = np.asarray(_gather_payload(jnp.asarray(f[:10]), jnp.asarray(idx), cfg))
    t = npy(pack_payload(torch.from_numpy(f)))[:, idx]
    assert t.dtype == np.int32 and np.array_equal(t, j)


def test_permute_cols_is_plain_indexing():
    x = torch.arange(40, dtype=torch.float32).reshape(4, 10)
    perm = torch.randperm(10, generator=torch.Generator().manual_seed(0))
    assert torch.equal(permute_cols(x, perm, 2), x[:, perm])
