"""The port's checkpointed forward and backward compositor (their plain
versions, which the wrappers take on CPU tensors) against the JAX package's
Pallas kernels in interpret mode, on the JAX package's own binned pairs; and
the two repaired gradients (``round_bf16``, ``permute_cols``).  The JAX
package's gradient space is (R, g_pad) rows; the port's is pair-major,
(g_pad, R), so the JAX side is transposed to meet it."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
from gsplat_tpu.ops.binning import bin_splats as j_bin_splats
from gsplat_tpu.ops.binning import grad_pad_size, tile_grid
from gsplat_tpu.ops.pallas import composite as jk
from gsplat_tpu.ops.permute import permute_cols as j_permute_cols
from gsplat_tpu_torch.ops.kernels import composite as tk
from gsplat_tpu_torch.ops.permute import permute_cols as t_permute_cols
from gsplat_tpu_torch.ops.rasterize_ref import round_bf16 as t_round_bf16
from torch_port_helpers import j_projected, jax_scene, jax_sorted_fields, npy, to_config

# Gradient-space rows, relative to the row's largest entry.  Both sides add a
# pair's 1024 per-pixel terms in float32, in different orders: 1e-5.  The
# three second-moment rows (Σdp2·dx², Σdp2·dxdy, Σdp2·dy²) get 1e-4: the JAX
# kernel rebuilds them from tile-local sums by a centre shift
# (r_uu − cxl·(r_u + t1), a difference of large terms for a splat centred off
# its tile), while the port multiplies dx and dy at every pixel; measured
# 2e-5 to 6e-5 on these scenes.
ROW_TOL = 1e-5
SECOND_MOMENT_TOL = 1e-4


def _row_tol(r):
    return SECOND_MOMENT_TOL if r in (2, 3, 4) else ROW_TOL


def _tiles_to_row_major(x):
    """(..., 8, 128) in the JAX kernels' pixel packing (row = sublane +
    8·(lane // 32), col = lane % 32) → (..., 1024) row-major within the tile."""
    lead = x.shape[:-2]
    x = x.reshape(lead + (8, 4, 32))          # (sublane, group, col)
    x = np.moveaxis(x, -3, -2)                # (group, sublane, col): row = 8·group + sublane
    return x.reshape(lead + (1024,))


@functools.lru_cache(maxsize=None)
def _case(payload_dtype="float32", soft=False, eps=0.0, opaque=False, n=150, seed=0):
    """Binned pairs, forward with checkpoints and backward, from both packages
    (cached: the tests only read it)."""
    eye = (0.2, 0.4, 1.0) if opaque else (0.2, 0.4, 3.0)  # close: every pixel of a tile is covered
    jcfg = gj.RenderConfig(tile_capacity=512, transmittance_eps=eps, payload_dtype=payload_dtype,
                           soft_cutoff=soft)
    jsplats, jcam = jax_scene(n=n, seed=seed, eye=eye)
    if opaque:  # large opaque splats, so that tiles saturate and stop early
        jsplats = dataclasses.replace(jsplats, opacity=jnp.full((n,), 0.95), scale=jsplats.scale * 3.0)
    fields = jax_sorted_fields(jsplats, jcam, jcfg)
    h, w = jcam.height, jcam.width
    jb = j_bin_splats(j_projected(fields), w, h, jcfg, with_tiles=False, with_grad_map=True)
    nty, ntx = tile_grid(w, h, 32, 32)
    g_pad = grad_pad_size(jb.dest_of_exp.shape[0], nty * ntx, jcfg.chunk)
    d_out = np.random.default_rng(5).standard_normal((h, w, 4)).astype(np.float32)

    # JAX: the kernels' own wrappers, interpret mode
    payload = jk._gather_payload(jnp.asarray(fields[:10]), jb.pair_splat, jcfg)
    _, fwd_chk_call, bwd_call = jk._build_kernels(nty, ntx, payload.shape[1], g_pad, jcfg, True)
    zeros2 = jnp.zeros((2,), jnp.int32)
    out, used, tchk = fwd_chk_call(jb.tile_base, jb.tile_phi, jb.tile_span, zeros2, payload)
    _, pack = jax.vjp(lambda p: jk.unpack_image(p, h, w), jnp.zeros_like(out))
    g_dt = jnp.int32 if payload_dtype == "packed" else jnp.float32
    gspace = bwd_call(jb.tile_base, jb.tile_phi, jb.tile_span, used, jb.grad_base, zeros2, payload,
                      pack(jnp.asarray(d_out))[0], tchk, jnp.zeros((jk._grad_rows(jcfg), g_pad), g_dt))
    jax_side = dict(image=np.asarray(jk.unpack_image(out, h, w)), used=np.asarray(used),
                    span=np.asarray(jb.tile_span), grad_base=np.asarray(jb.grad_base),
                    phi=np.asarray(jb.tile_phi),
                    tchk=_tiles_to_row_major(np.asarray(tchk)).reshape(nty * ntx, -1, 1024),
                    gspace=np.ascontiguousarray(np.asarray(gspace)[:_words(payload_dtype == "packed")].T),
                    grad_rows=np.asarray(gspace).shape[0])

    # port: the wrappers on CPU tensors (their plain versions)
    cfg = to_config(jcfg)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tf = t(fields[:10])
    tpay = tk.pack_payload(tf) if payload_dtype == "packed" else tf
    seg = (t(jb.pair_splat), t(jb.tile_base), t(jb.tile_phi), t(jb.tile_span))
    image, t_used, t_tchk = tk.composite_splats(tpay, *seg, nty, ntx, h, w, cfg, checkpoint=True)
    t_gspace = tk.composite_bwd(tpay, *seg, t_used, t(jb.grad_base), t(d_out), t_tchk, g_pad,
                                nty, ntx, h, w, cfg)
    port_side = dict(image=npy(image), used=npy(t_used), tchk=npy(t_tchk), gspace=npy(t_gspace))
    return jax_side, port_side, jcfg


def _words(packed):
    return tk.G_ROWS_PACKED if packed else tk.N_SUMS


def _rows(gspace, packed):
    """A pair-major space as nine float32 rows (9, g_pad), one a sum."""
    if not packed:
        return gspace.T
    g = torch.from_numpy(np.ascontiguousarray(gspace))
    cg, cb = tk.unpack2(g[:, 6])
    return torch.cat([g[:, 0:6].view(torch.float32).t(), cg[None], cb[None],
                      g[:, 7:8].view(torch.float32).t()]).numpy()


def _assert_space_close(a, b, packed, name=""):
    """Nine rows of the JAX side ``a`` against the port's ``b`` (both (9, G))."""
    for r in range(9):
        scale = np.abs(a[r]).max()
        assert scale > 0, (name, r)
        if packed and r in (6, 7):  # two bf16 halves of one word: one step of an 8-bit mantissa
            tol = np.abs(a[r]) * 2.0 ** -7 + ROW_TOL * scale
            assert (np.abs(b[r] - a[r]) <= tol).all(), (name, r)
        else:
            assert np.abs(b[r] - a[r]).max() <= _row_tol(r) * scale, (name, r, np.abs(b[r] - a[r]).max(), scale)


def _written(j, p):
    """Rows of the gradient space some tile's walk owns: [grad_base + phi,
    grad_base + used) of every tile."""
    written = np.zeros(p["gspace"].shape[0], bool)
    for gb, phi, used in zip(j["grad_base"], j["phi"], p["used"]):
        written[gb + phi: gb + used] = True
    return written


def _assert_pair_major(j, p, jcfg, packed):
    """The port's space is one contiguous row a pair slot, (g_pad, 9) float32
    or (g_pad, 8) int32, holding the JAX package's column of that slot; the
    rows no walk owns are exact zeros on both sides."""
    words = _words(packed)
    space = p["gspace"]
    g_pad = space.shape[0]
    assert space.shape == (g_pad, words) == j["gspace"].shape and j["grad_rows"] >= words
    assert space.flags["C_CONTIGUOUS"] and space.strides == (4 * words, 4)
    assert space.dtype == (np.int32 if packed else np.float32)
    assert g_pad % jcfg.chunk == 0
    written = _written(j, p)
    assert written.any()
    assert not space[~written].any() and not j["gspace"][~written].any()


@pytest.mark.parametrize("name,kw", [
    ("hard", dict()),
    ("soft", dict(soft=True, n=100)),
    ("early_stop", dict(eps=1e-3, opaque=True, n=300)),
])
def test_checkpoints_and_gradient_space_match_pallas_interpret(name, kw):
    j, p, jcfg = _case(**kw)
    np.testing.assert_array_equal(p["used"], j["used"])
    np.testing.assert_allclose(p["image"], j["image"], atol=1e-6)
    # checkpoints of the chunks a tile walked, up to the pixel order
    nused = -(-j["used"] // jcfg.chunk)
    for tile, k in enumerate(nused):
        np.testing.assert_allclose(p["tchk"][tile, :k], j["tchk"][tile, :k], atol=1e-6,
                                   err_msg=f"tile {tile}")
    _assert_pair_major(j, p, jcfg, False)
    _assert_space_close(_rows(j["gspace"], False), _rows(p["gspace"], False), False, name)
    if name == "early_stop":
        assert (j["used"] < j["span"]).any()  # the stop did fire


def test_packed_gradient_space_matches_pallas_interpret():
    j, p, jcfg = _case(payload_dtype="packed", n=400, seed=1)
    _assert_pair_major(j, p, jcfg, True)
    _assert_space_close(_rows(j["gspace"], True), _rows(p["gspace"], True), True)


def test_unwalked_positions_hold_exact_zeros():
    j, p, _ = _case(eps=1e-3, opaque=True, n=300)
    assert (p["used"] < j["span"]).any()
    written = _written(j, p)
    assert np.abs(p["gspace"][~written]).max() == 0.0
    assert np.abs(p["gspace"][written]).max() > 0.0


def test_round_bf16_forward_bits_and_straight_through_gradient():
    x = np.array([1.0000001, 0.1, 3.14159265, -2.7182818, 0.0, 1e-4], np.float32)
    g = np.array([1.0000001, 0.1, 3.14159265, 7.0, -1e-9, 123456.789], np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = t_round_bf16(tx)
    np.testing.assert_array_equal(npy(ty), np.asarray(jk.round_bf16(jnp.asarray(x))))
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(npy(tx.grad), g)  # exactly g: nothing is rounded on the way back
    jg = jax.grad(lambda v: jnp.sum(jk.round_bf16(v) * jnp.asarray(g)))(jnp.asarray(x))
    np.testing.assert_array_equal(npy(tx.grad), np.asarray(jg))


def test_pack_payload_gradient_free_and_quantize_gradient_identity():
    from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload
    from torch_port_helpers import t_projected

    f = np.random.default_rng(0).random((16, 7)).astype(np.float32)
    g = np.random.default_rng(1).standard_normal((16, 7)).astype(np.float32)
    for dtype in ("packed", "bfloat16"):
        p = t_projected(f)
        p.fields.requires_grad_(True)
        q = quantize_payload(p, dataclasses.replace(to_config(gj.RenderConfig()), payload_dtype=dtype))
        (q.fields * torch.from_numpy(g)).sum().backward()
        np.testing.assert_array_equal(npy(p.fields.grad), g)


@pytest.mark.parametrize("diff_rows", [None, 10, 16])
def test_permute_cols_gather_backward_matches_jax(diff_rows):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((14, 50)).astype(np.float32)
    g = rng.standard_normal((14, 50)).astype(np.float32)
    perm = rng.permutation(50).astype(np.int32)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = t_permute_cols(tx, torch.from_numpy(perm).long(), diff_rows)
    np.testing.assert_array_equal(npy(ty), x[:, perm])
    (ty * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(j_permute_cols(v, jnp.asarray(perm), diff_rows) * jnp.asarray(g)))(
        jnp.asarray(x))
    np.testing.assert_array_equal(npy(tx.grad), np.asarray(jg))
    if diff_rows == 10:
        assert np.abs(npy(tx.grad)[10:]).max() == 0.0
