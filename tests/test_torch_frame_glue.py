"""The serving frame's glue (``ops/kernels/frame_glue.py`` and
``project_fields(..., payload_dtype=...)``) against the JAX package's own
composition of the same steps, on the CPU.

On CPU tensors the wrappers take their plain versions: the projection's
sanitize and quantize (``payload_fields_plain``), the depth-order gather of
the payload and the binning operands (``gather_payload_plain``) and its
gradient (``scatter_payload_plain``, through ``GatherPayload``), and the
binning's expansion, cull and key (``expand_pairs_plain``, inside
``bin_splats``).  Each is fed the JAX package's own fields (numpy, made from
a seed) and held to what the JAX package computes from them: its
``sanitize_projected`` and ``quantize_payload`` and their VJP; its
``sort_by_depth`` and that sort's VJP, the payload packing of
``ops/pallas/composite.py`` and ``_tile_extents``; its ``bin_splats``.  Integers and packed words must be exactly equal; the
projection's float fields are held to the projection's 1e-5 (an ulp of rsqrt
or log amplified by the focal length).  The kernels themselves are held to
these plain versions on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops.pallas.composite import _gather_payload as j_gather_payload
from gsplat_tpu.ops.pallas.composite import round_bf16 as j_round_bf16
from gsplat_tpu.ops.rasterize_ref import quantize_payload as j_quantize
from gsplat_tpu.ops.rasterize_ref import sanitize_projected as j_sanitize
from gsplat_tpu.ops.rasterize_tiles import sort_by_depth as j_sort_by_depth
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops.kernels import frame_glue as kglue
from gsplat_tpu_torch.ops.kernels import projection as kproj
from gsplat_tpu_torch.ops.projection import project_splats
from torch_port_helpers import (
    camera_to_torch,
    j_projected,
    jax_scene,
    npy,
    splats_to_torch,
    t_projected,
    to_config,
)

INT_ARRAYS = (
    "pair_splat", "pair_tile", "tile_start", "tile_count", "tile_base",
    "tile_phi", "tile_span", "grad_base", "dropped_pairs",
)
FIELDS_TOL = 1e-5
GRAD_TOL = 2e-4  # scripts/verify_tpu.py's gate on gradients, of each field's max |g|
SPLAT_FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")
PACKED_COLOR_TOL = 2e-2  # scripts/verify_tpu.py's gate on the packed payload's colour rows
BASE = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0)
LINE_PX = 1.5

# mode -> (RenderConfig fields, tile offsets, scene)
MODES = {
    "packed": (dict(payload_dtype="packed"), (0, 0), dict(n=400, seed=1)),
    "float32": (dict(), (0, 0), dict(n=400, seed=2, w=70, h=45)),
    "bfloat16": (dict(payload_dtype="bfloat16"), (0, 0), dict(n=400, seed=3)),
    "depth_test": (dict(depth_test=True), (0, 0), dict(n=400, seed=4)),
    "wireframe": (dict(wireframe=True, line_px=LINE_PX), (0, 0), dict(n=400, seed=5)),
    "soft_cutoff": (dict(soft_cutoff=True), (0, 0), dict(n=400, seed=6)),
    # one cell of a 2 x 3 strided grid at tile (1, 2), as a sharded strip bins it
    "strided": (dict(row_stride=2, col_stride=3), (1, 2), dict(n=400, seed=7, w=128, h=96)),
}


def _storage_fields(mode, jcfg, js, jc):
    """The JAX package's sanitized, quantized fields in storage order, as the
    frame hands them to the gather (the wireframe pass's own rewrite of the
    opacity and footprint rows included)."""
    if mode == "wireframe":
        f = j_sanitize(gj.project_splats(js, jc, 0)).fields
        f = f.at[9].set(f[11]).at[12].add(LINE_PX).at[13].add(LINE_PX)
        return np.asarray(f)
    p = gj.project_splats(js, jc, jcfg.sh_order, tight_footprint=not jcfg.soft_cutoff)
    return np.asarray(j_quantize(j_sanitize(p), jcfg).fields)


def _jax_thr_q(op):
    """The JAX package's 8-bit ρ threshold (gsplat_tpu/ops/binning.py,
    bin_splats' rho_ok branch) of an opacity row."""
    ac, qe = jbin.ALPHA_CUTOFF, jbin.QUAD_EXTENT
    rho = jnp.sqrt(jnp.log(jnp.maximum(op, ac) / ac))
    return np.asarray(jnp.minimum(jnp.ceil(jnp.minimum(rho, qe) * (255.0 / qe)).astype(jnp.int32), 255))


def test_sanitize_quantize_equal_to_jax():
    """payload_fields_plain (project_fwd's payload policy) is the JAX
    package's sanitize_projected then quantize_payload, bit for bit, with the
    camera inside the cloud so that about half the columns are invalid."""
    js, jc = jax_scene(n=300, seed=11, extent=1.5, eye=(0.0, 0.1, 0.2))
    raw = np.asarray(gj.project_splats(js, jc, 3, tight_footprint=True).fields)
    assert 0 < int((raw[11] > 0.5).sum()) < raw.shape[1]
    for payload in ("float32", "packed", "bfloat16"):
        jcfg = dataclasses.replace(BASE, payload_dtype=payload)
        want = np.asarray(j_quantize(j_sanitize(j_projected(raw)), jcfg).fields)
        got = npy(kproj.payload_fields_plain(torch.from_numpy(raw.copy()), payload))
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), payload


def test_projected_payload_form_close_to_jax():
    """project_splats(..., payload_dtype=...) on CPU tensors against the JAX
    package's project, sanitize and quantize: the invalid columns and the
    rounded rows' grid exact, the rest within the projection's tolerance;
    and its gradient (the projection's backward in its masked form) against
    the VJP of the JAX package's composition, within the gradient gate, an
    invalid splat's gradient exactly zero."""
    js, jc = jax_scene(n=300, seed=12, extent=1.5, eye=(0.0, 0.1, 0.2))
    splats, cam = splats_to_torch(js), camera_to_torch(jc)
    cot = np.random.default_rng(13).standard_normal((16, 300)).astype(np.float32)
    for payload in ("float32", "packed", "bfloat16"):
        jcfg = dataclasses.replace(BASE, payload_dtype=payload)

        def jfn(s):
            p = j_sanitize(gj.project_splats(s, jc, 3, tight_footprint=True))
            if payload == "bfloat16":
                # The JAX package rounds these rows with astype, whose VJP
                # rounds the cotangent to bf16 too; the port's round_bf16
                # passes it straight through (ops/rasterize_ref.py), as the
                # JAX package's own round_bf16 does: hold it to that.
                return jnp.concatenate([j_round_bf16(p.fields[:10]), p.fields[10:]], axis=0)
            return j_quantize(p, jcfg).fields

        jf, vjp = jax.vjp(jfn, js)
        want = np.asarray(jf)
        leaves = [getattr(splats, f).detach().clone().requires_grad_(True) for f in SPLAT_FIELDS]
        fields = project_splats(type(splats)(*leaves), cam, 3, tight_footprint=True, payload_dtype=payload).fields
        grads = torch.autograd.grad(fields, leaves, grad_outputs=torch.from_numpy(cot))
        (jg,) = vjp(jnp.asarray(cot))
        invalid = want[11] < 0.5
        for f, g in zip(SPLAT_FIELDS, grads):
            a, b = npy(g).astype(np.float64), np.asarray(getattr(jg, f)).astype(np.float64)
            assert not np.any(a[..., invalid]), (payload, f)
            assert np.abs(a - b).max() <= GRAD_TOL * max(np.abs(b).max(), 1e-30), (payload, f)
        got = npy(fields.detach())
        assert np.array_equal(got[:, invalid].view(np.int32), want[:, invalid].view(np.int32)), payload
        rounded = range(6, 10) if payload == "packed" else range(10) if payload == "bfloat16" else range(0)
        v = ~invalid
        for r in range(16):
            if r in rounded:  # bf16-rounded: the low 16 bits are zero; one bf16 step of an ulp's move
                assert not np.any(got[r].view(np.int32) & 0xFFFF), (payload, r)
                np.testing.assert_allclose(got[r, v], want[r, v], rtol=PACKED_COLOR_TOL, atol=PACKED_COLOR_TOL)
            else:
                np.testing.assert_allclose(got[r, v], want[r, v], rtol=FIELDS_TOL, atol=FIELDS_TOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_gather_and_expansion_equal_to_jax(mode):
    """gather_payload_plain against the JAX package's depth sort, payload
    packing and tile extents of the same fields, word for word; then
    bin_splats on those operands (the serving frame's route, through
    expand_pairs_plain) against the JAX package's bin_splats of its sorted
    fields: every integer array exactly equal."""
    cfg_kw, offsets, scene_kw = MODES[mode]
    jcfg = dataclasses.replace(BASE, **cfg_kw)
    cfg = to_config(jcfg)
    js, jc = jax_scene(**scene_kw)
    w, h = jc.width, jc.height
    fs = _storage_fields(mode, jcfg, js, jc)
    n = fs.shape[1]
    order = torch.argsort(torch.from_numpy(fs[10].copy()), stable=True)
    assert np.array_equal(npy(order), np.argsort(fs[10], kind="stable"))
    n_rows = 15 if jcfg.depth_test else 14
    srt = np.asarray(j_sort_by_depth(j_projected(fs), n_rows=n_rows).fields)

    sat_cull, rho_ok = tbin.sat_flags(n, w, h, cfg)
    assert sat_cull == (mode not in ("wireframe", "soft_cutoff"))
    glue = kglue.gather_payload(torch.from_numpy(fs.copy()), order, w, h, cfg, rho_ok, *offsets)
    pay = npy(glue.payload)
    if jcfg.payload_dtype == "packed":
        want = np.asarray(j_gather_payload(jnp.asarray(srt), jnp.arange(n), jcfg))
        assert pay.dtype == np.int32 and np.array_equal(pay, want)
    else:
        rows = list(range(10)) + ([14] if jcfg.depth_test else [])
        assert pay.dtype == np.float32 and np.array_equal(pay.view(np.int32), srt[rows].view(np.int32))
    counts, nx, tx0, ty0 = (np.asarray(a) for a in jbin._tile_extents(jnp.asarray(srt), w, h, jcfg, *offsets))
    _, ntx = jbin.tile_grid(w, h, 32, 32)
    ops = glue.operands
    assert np.array_equal(npy(ops.counts), counts)
    assert np.array_equal(npy(ops.nx), np.maximum(nx, 1))
    assert np.array_equal(npy(ops.tile0), ty0 * ntx + tx0)
    if rho_ok:
        assert np.array_equal(npy(ops.thr_q), _jax_thr_q(jnp.asarray(srt[9])))
    else:
        assert ops.thr_q is None

    # The differentiable frame's gather (the float32 rows whatever the
    # payload dtype) and its backward (scatter_payload_plain) against the
    # JAX package's depth sort and its VJP: equal word for word.
    rows = list(range(10)) + ([14] if jcfg.depth_test else [])
    leaf = torch.from_numpy(fs.copy()).requires_grad_(True)
    dglue = kglue.gather_payload_diff(leaf, order, w, h, cfg, rho_ok, *offsets)
    assert np.array_equal(npy(dglue.payload.detach()).view(np.int32), srt[rows].view(np.int32))
    for name in ("counts", "nx", "tile0"):
        assert np.array_equal(npy(getattr(dglue.operands, name)), npy(getattr(ops, name))), name
    cot = np.random.default_rng(5).standard_normal((len(rows), n)).astype(np.float32)
    dglue.payload.backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda f: j_sort_by_depth(j_projected(f), n_rows=n_rows).fields[jnp.asarray(rows)],
                     jnp.asarray(fs))
    assert np.array_equal(npy(leaf.grad).view(np.int32), np.asarray(vjp(jnp.asarray(cot))[0]).view(np.int32))

    jb = jbin.bin_splats(j_projected(srt), w, h, jcfg, row_offset=offsets[0], col_offset=offsets[1])
    tb = tbin.bin_splats(None, w, h, cfg, row_offset=offsets[0], col_offset=offsets[1], operands=ops)
    for name in INT_ARRAYS:
        assert np.array_equal(npy(getattr(tb, name)), np.asarray(getattr(jb, name))), name
    assert int(tb.tile_count.sum()) > 0


def test_expansion_with_split_key_equal_to_jax():
    """A tile grid too large for one int32 (tile, rank) key (65,536 tiles,
    20,000 splats): expand_pairs_plain writes the tile and the rank apart and
    bin_splats sorts them stably, as the JAX package's else branch does; and
    the order= form (storage-order fields, the permutation beside them) bins
    the same pairs.  Synthetic sorted fields from a numpy seed."""
    rng = np.random.default_rng(21)
    n, w, h = 20_000, 8192, 8192
    f = np.zeros((16, n), np.float32)
    f[0], f[1] = rng.uniform(0, w, n), rng.uniform(0, h, n)
    f[2], f[5] = rng.uniform(0.02, 0.2, n), rng.uniform(0.02, 0.2, n)
    f[3], f[4] = rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n)
    f[9] = rng.uniform(0.001, 1.0, n)
    f[10] = np.sort(rng.uniform(1.0, 10.0, n))
    f[11] = 1.0
    f[12], f[13] = rng.uniform(1.0, 60.0, n), rng.uniform(1.0, 60.0, n)
    jcfg = dataclasses.replace(BASE, pair_budget_override=60_000)
    cfg = to_config(jcfg)
    nty, ntx = tbin.tile_grid(w, h, 32, 32)
    assert not kglue.key_fits(nty * ntx, n)
    jb = jbin.bin_splats(j_projected(f), w, h, jcfg)
    tb = tbin.bin_splats(t_projected(f), w, h, cfg)
    assert int(tb.dropped_pairs) > 0  # the budget truncates: the farthest pairs drop
    for name in INT_ARRAYS:
        assert np.array_equal(npy(getattr(tb, name)), np.asarray(getattr(jb, name))), name
    perm = rng.permutation(n)
    storage = f[:, perm]
    order = torch.from_numpy(np.argsort(perm))
    to = tbin.bin_splats(t_projected(storage), w, h, cfg, order=order)
    rank_to_storage = np.argsort(perm)
    budget = cfg.pair_budget(n)  # the sorted pairs; the padded tail holds spread ranks in both forms
    assert np.array_equal(npy(to.pair_splat[:budget]), rank_to_storage[npy(tb.pair_splat[:budget])])
    for name in INT_ARRAYS[1:]:
        assert np.array_equal(npy(getattr(to, name)), npy(getattr(tb, name))), name
