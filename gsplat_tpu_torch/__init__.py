"""gsplat_tpu_torch — the PyTorch/CUDA port of ``gsplat_tpu`` for one NVIDIA
H100: a differentiable 3D Gaussian-splat renderer (EWA-projected
screen-space Gaussians, SH color of degree 0-3, global depth sort, tile
binning, front-to-back alpha compositing).

The package mirrors the JAX package's layout and public names, so the
counterpart of a module is found by its path.  It imports ``torch`` and
numpy, never ``jax`` and nothing of ``gsplat_tpu``.  Plain tensor code is
PyTorch; each kernel the JAX package wrote in Pallas is a kernel written by
hand in CUDA C++ under ``csrc/`` (built with ``nvcc`` at first use), with its
plain PyTorch version beside its wrapper in ``ops/kernels/``.

Device rule: constructors and generators take ``device=None``, which means
the card (``"cuda"``); ``render`` runs where its splats live.  Nothing falls
back to the CPU when the card is missing.

Covered so far: the forward render (serving), its backward through
hand-written kernels, and the single-device trainer (``train/``,
``io/checkpoint.py``); compositing into a host scene (``background_depth``)
and the wireframe views (``ops/wireframe.py``); the calibration probes and
the H100 speed-of-light model (``utils/sol_calibrate.py``,
``utils/profile_gather.py``, ``utils/sol.py``); rendering and training
sharded over ranks of ``torch.distributed`` (``parallel/``,
``make_sharded_train_step``); the host runtime — the scene registry
(``scene.py``), PLY, attribute and JSON I/O (``io/``), the ray/bbox queries
(``ops/queries.py``) and the native host helpers (``io/native.py``, C++
built with ``g++`` at first use); the counterpart of ``jax.jit``: CUDA
graphs (``graphs.py``) — ``make_train_step`` captures its step on the card,
and ``capture`` holds a frame for replay.
"""

from .version import __version__
from .models.camera import Camera, camera_from_numpy, look_at, make_camera, perspective
from .models.splats import (
    GaussianSplats,
    make_splats,
    random_splats,
    splats_from_numpy,
    to_numpy_dict,
    trained_like_splats,
)
from .utils.config import RenderConfig
from .ops.binning import RenderStats, report_stats
from .ops.projection import ProjectedSplats, project_splats
from .ops.rasterize_ref import render_reference
from .ops.rasterize_tiles import depth_order, render_tiles
from .ops.wireframe import render_wire_over, render_wireframe
from .render import composite_over, measure_pairs, render, render_cuda, tune_pair_budget
from .train.loss import l1_loss, psnr, render_loss, ssim
from .train.params import (
    SplatParams,
    params_from_numpy,
    params_from_splats,
    splats_from_params,
)
from .train.trainer import default_optimizer, make_sharded_train_step, make_train_step, shard_params
from .train.loss import ssim_strip
from .parallel.mesh import initialize_distributed, make_mesh, splat_mesh
from .parallel.render_sharded import (
    measure_strip_counts,
    pad_splats,
    render_sharded,
    shard_splats,
    tune_strip_exchange,
)
from .io.checkpoint import restore_checkpoint, save_checkpoint
from .scene import SceneRegistry
from .io.ply import load_ply, save_ply
from .io.attributes import splats_from_attributes
from .io.json_io import load_json, save_json
from .ops.queries import RayHit, intersect_ray_bbox, intersect_rays_bbox
from .graphs import CapturedGraph, capture

__all__ = [
    "render",
    "render_cuda",
    "measure_pairs",
    "tune_pair_budget",
    "composite_over",
    "render_tiles",
    "render_reference",
    "render_wireframe",
    "render_wire_over",
    "__version__",
    "Camera",
    "make_camera",
    "camera_from_numpy",
    "look_at",
    "perspective",
    "GaussianSplats",
    "make_splats",
    "random_splats",
    "trained_like_splats",
    "splats_from_numpy",
    "to_numpy_dict",
    "RenderConfig",
    "RenderStats",
    "report_stats",
    "ProjectedSplats",
    "project_splats",
    "depth_order",
    "SplatParams",
    "params_from_splats",
    "splats_from_params",
    "params_from_numpy",
    "l1_loss",
    "ssim",
    "render_loss",
    "psnr",
    "default_optimizer",
    "make_train_step",
    "make_sharded_train_step",
    "shard_params",
    "ssim_strip",
    "initialize_distributed",
    "make_mesh",
    "splat_mesh",
    "render_sharded",
    "shard_splats",
    "pad_splats",
    "measure_strip_counts",
    "tune_strip_exchange",
    "save_checkpoint",
    "restore_checkpoint",
    "SceneRegistry",
    "load_ply",
    "save_ply",
    "splats_from_attributes",
    "load_json",
    "save_json",
    "RayHit",
    "intersect_ray_bbox",
    "intersect_rays_bbox",
    "capture",
    "CapturedGraph",
]
