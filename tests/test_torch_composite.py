"""Port vs JAX package: the compositing forward.  The port's plain version
(what its wrapper takes for CPU tensors, and what the CUDA kernel is held
against on the card) composites the JAX package's binned arrays and is
compared with the Pallas forward kernel in interpret mode: image and the
per-tile stop counter ``used``.

Tolerance: image max|Δ| < 1e-5.  Both sides evaluate the same float32
expression tree in the same order; the only differences are ``exp`` (an ulp
between XLA-CPU and PyTorch-CPU) and multiply-add contraction inside the
compiled Pallas body.  Across the two hard thresholds (α ≥ 1/255, q² ≤ 4) an
ulp can flip a whole contribution (up to ~4e-3): if a scene ever lands a
pixel within an ulp of a cut, pick another seed rather than widen the
tolerance — the scenes below have no such pixel.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops.pallas import composite as jcomp
from gsplat_tpu_torch.ops.kernels import composite as tcomp
from torch_port_helpers import j_projected, jax_scene, jax_sorted_fields, npy, to_config

BASE = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0)


def _both(jcfg, n=400, seed=1, w=64, h=64, sh=0.2, opacity=None, scale_mul=None, eye=(0.2, 0.4, 3.0)):
    js, jc = jax_scene(n=n, seed=seed, w=w, h=h, sh=sh, eye=eye)
    if opacity is not None:
        js = dataclasses.replace(js, opacity=jnp.full((n,), opacity))
    if scale_mul is not None:
        js = dataclasses.replace(js, scale=js.scale * scale_mul)
    f = jax_sorted_fields(js, jc, jcfg)
    jb = jbin.bin_splats(j_projected(f), w, h, jcfg, with_tiles=False)
    nty, ntx = jbin.tile_grid(w, h, 32, 32)
    # JAX side: payload gather + forward kernel (interpret mode) + unpack
    payload = jcomp._gather_payload(jnp.asarray(f[:10]), jb.pair_splat, jcfg)
    fwd = jcomp._build_kernels(nty, ntx, payload.shape[1], 0, jcfg, True)[0]
    out, jused = fwd(jb.tile_base, jb.tile_phi, jb.tile_span, jnp.zeros((2,), jnp.int32), payload)
    jimg = np.asarray(jcomp.unpack_image(out, h, w))
    # port side: the same binned arrays, per-splat matrix + pair_splat
    tcfg = to_config(jcfg)
    ft = torch.from_numpy(np.array(f, copy=True))
    fields = tcomp.pack_payload(ft) if jcfg.payload_dtype == "packed" else ft[:10].contiguous()
    ti = lambda a: torch.from_numpy(np.array(a, copy=True))
    before = tcomp.launches
    timg, tused = tcomp.composite_splats(
        fields, ti(jb.pair_splat), ti(jb.tile_base), ti(jb.tile_phi), ti(jb.tile_span),
        nty, ntx, h, w, tcfg,
    )
    assert tcomp.launches == before  # CPU tensors launch nothing
    return jimg, np.asarray(jused), npy(timg), npy(tused), np.asarray(jb.tile_span)


@pytest.mark.parametrize(
    "cfg_kw",
    [dict(), dict(payload_dtype="packed"), dict(soft_cutoff=True), dict(payload_dtype="bfloat16")],
    ids=["float32", "packed", "soft_cutoff", "bfloat16"],
)
def test_plain_compositor_matches_pallas_forward_exact_mode(cfg_kw):
    jimg, jused, timg, tused, span = _both(dataclasses.replace(BASE, **cfg_kw))
    assert timg.shape == jimg.shape == (64, 64, 4) and timg.dtype == np.float32
    assert np.abs(timg - jimg).max() < 1e-5
    assert np.array_equal(tused, jused) and np.array_equal(tused, span)  # eps 0: no stop
    assert jimg[..., 3].max() > 0.5


@pytest.mark.parametrize("payload", ["float32", "packed"])
def test_early_stop_matches_pallas_forward(payload):
    # opaque, large splats seen from close by, so whole tiles saturate and the
    # chunk-granular, base-aligned stop fires after one chunk in some tiles,
    # after two in others, and not at all in one; used pins the rule down
    jcfg = dataclasses.replace(BASE, transmittance_eps=1e-3, payload_dtype=payload)
    jimg, jused, timg, tused, span = _both(
        jcfg, sh=0.0, opacity=0.95, scale_mul=3.0, eye=(0.2, 0.4, 2.0)
    )
    assert (jused < span).any() and (jused == span).any(), "scene does not exercise the early stop"
    assert len(set(jused.tolist())) >= 3
    assert np.array_equal(tused, jused)
    assert np.abs(timg - jimg).max() < 1e-5


def test_ragged_image_matches_pallas_forward():
    jimg, jused, timg, tused, _ = _both(BASE, w=70, h=45)
    assert timg.shape == (45, 70, 4)
    assert np.abs(timg - jimg).max() < 1e-5 and np.array_equal(tused, jused)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    cfg = gt.RenderConfig(tile_capacity=512)
    f = torch.zeros((10, 4))
    z = torch.zeros((4,), dtype=torch.int32)
    ps = torch.zeros((256,), dtype=torch.int32)
    args = (f, ps, z, z, z, 2, 2, 64, 64)
    with pytest.raises(ValueError, match="32"):
        tcomp.composite_splats(*args, dataclasses.replace(cfg, tile_h=16, tile_w=16))
    with pytest.raises(ValueError, match="forward-only"):  # the band test has no backward
        tcomp.composite_splats(*args, dataclasses.replace(cfg, wireframe=True), checkpoint=True)
    with pytest.raises(ValueError, match="bg_depth"):  # the depth test needs the scene depth
        tcomp.composite_splats(*args, dataclasses.replace(cfg, depth_test=True))
    with pytest.raises(TypeError):  # ... and the 11-row payload with the view-z row
        tcomp.composite_splats(*args, dataclasses.replace(cfg, depth_test=True), bg_depth=torch.zeros((64, 64)))
    with pytest.raises(ValueError, match="depth_test"):
        tcomp.composite_splats(*args, cfg, bg_depth=torch.zeros((64, 64)))
    # the strided mapping: offsets are tiles >= 0, and the depth test takes
    # only the full-frame mapping (its scene depth is the local image's)
    with pytest.raises(ValueError, match="offsets"):
        tcomp.composite_splats(*args, dataclasses.replace(cfg, row_stride=2), offsets=(-1, 0))
    with pytest.raises(ValueError, match="full-frame"):
        tcomp.composite_splats(*args, dataclasses.replace(cfg, depth_test=True, col_stride=2),
                               bg_depth=torch.zeros((64, 64)))
    img, used = tcomp.composite_splats(*args, dataclasses.replace(cfg, row_stride=2), offsets=(1, 3))
    assert float(img.abs().max()) == 0.0 and int(used.max()) == 0
    with pytest.raises(TypeError):  # packed config wants the (8, N) int32 matrix
        tcomp.composite_splats(*args, dataclasses.replace(cfg, payload_dtype="packed"))
    with pytest.raises(TypeError):
        tcomp.composite_splats(f, ps.long(), z, z, z, 2, 2, 64, 64, cfg)
    with pytest.raises(ValueError, match="grid"):
        tcomp.composite_splats(f, ps, z, z, z, 2, 2, 100, 64, cfg)
    with pytest.raises(ValueError, match="out-of-range"):
        tcomp.composite_splats(f, ps + 9, z, z, z, 2, 2, 64, 64, cfg)
    img, used = tcomp.composite_splats(*args, cfg)  # all spans 0: empty image
    assert float(img.abs().max()) == 0.0 and int(used.max()) == 0
