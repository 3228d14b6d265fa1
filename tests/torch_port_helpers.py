"""Shared helpers of the ``test_torch_*`` files: scenes are made once with the
JAX package (or numpy) from a seed and carried across to the port as numpy, so
both packages see bit-equal inputs.  Everything runs on the CPU."""

import logging

import jax
import numpy as np
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.ops.projection import ProjectedSplats as JProjected
from gsplat_tpu.ops.rasterize_ref import quantize_payload as j_quantize
from gsplat_tpu.ops.rasterize_ref import sanitize_projected as j_sanitize
from gsplat_tpu.ops.rasterize_tiles import sort_by_depth as j_sort_by_depth
from gsplat_tpu_torch.ops.projection import ProjectedSplats as TProjected

CPU = "cpu"

# The port's test tensors are tiny: one intra-op thread is as fast, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)


def jax_scene(n=150, seed=0, w=64, h=64, sh=0.2, extent=0.8, eye=(0.2, 0.4, 3.0)):
    splats = gj.random_splats(jax.random.PRNGKey(seed), n, extent=extent, sh_scale=sh)
    cam = gj.make_camera(eye=list(eye), target=[0, 0, 0], width=w, height=h)
    return splats, cam


def splats_to_torch(jsplats):
    return gt.splats_from_numpy(gj.to_numpy_dict(jsplats), device=CPU)


def camera_to_torch(jcam):
    return gt.camera_from_numpy(
        np.asarray(jcam.view), np.asarray(jcam.proj), jcam.width, jcam.height,
        explicit_camera_pos=np.asarray(jcam.explicit_camera_pos), device=CPU,
    )


def to_config(jcfg):
    """The port's RenderConfig with the JAX config's values."""
    import dataclasses

    return gt.RenderConfig(**dataclasses.asdict(jcfg))


def jax_sorted_fields(jsplats, jcam, jcfg, n_rows=14) -> np.ndarray:
    """The JAX package's projected, sanitized, quantized, depth-sorted (16, N)
    field matrix — the input of binning and compositing.  ``n_rows=15`` keeps
    the view-z row of the depth test."""
    p = gj.project_splats(
        jsplats, jcam, jcfg.sh_order,
        tight_footprint=not jcfg.soft_cutoff, only_sh=jcfg.only_sh,
    )
    p = j_sort_by_depth(j_quantize(j_sanitize(p), jcfg), n_rows=n_rows)
    return np.asarray(p.fields)


def j_projected(fields: np.ndarray) -> JProjected:
    import jax.numpy as jnp

    return JProjected(fields=jnp.asarray(fields))


def t_projected(fields: np.ndarray) -> TProjected:
    return TProjected(fields=torch.from_numpy(np.array(fields, copy=True)))


def npy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class LogRecords(logging.Handler):
    """Collects (level name, message) of the records a logger emits."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append((record.levelname, record.getMessage()))
