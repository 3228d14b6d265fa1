"""Spawned ranks of the port's sharded tests (``test_torch_sharded_*.py``).

Imports no ``jax``: every rank is a fresh process that joins a gloo group on
the CPU through ``initialize_distributed`` (a rendezvous file under the
test's own ``tmp_path``, or the standard environment at a port the test
bound to 0; never a fixed port: several test workers run at once), runs one
task on the inputs the test made with the JAX package (numpy arrays), and
leaves its result in ``tmp_path/rank<r>.pt`` for the test to read.
"""

import dataclasses
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.train.loss import ssim_strip

CPU = "cpu"


def _camera(cam):
    view, proj, w, h = cam
    return gt.camera_from_numpy(view, proj, w, h, device=CPU)


def _leaves(splats):
    return gt.GaussianSplats(**{
        f.name: getattr(splats, f.name).detach().clone().requires_grad_(True)
        for f in dataclasses.fields(gt.GaussianSplats)
    })


def task_render(rank, world, job):
    """render_sharded under each config of ``job["configs"]``: image and
    stats; with ``job["weights"]`` also the gradient of sum(image·weights)
    for this rank's block under the first config."""
    mesh = gt.splat_mesh(world, device=CPU)
    splats = gt.splats_from_numpy(job["splats"], device=CPU)
    cam = _camera(job["camera"])
    local = gt.shard_splats(splats, mesh)
    out = {"images": [], "dropped": [], "exchange_dropped": [], "block": mesh.sp_index}
    for cfg_dict in job["configs"]:
        cfg = gt.RenderConfig(**cfg_dict)
        with torch.no_grad():
            img, stats = gt.render_sharded(local, cam, cfg, mesh, backend=job["backend"], with_stats=True)
        out["images"].append(img.numpy())
        out["dropped"].append(int(stats.dropped_pairs))
        out["exchange_dropped"].append(int(stats.exchange_dropped))
    if job.get("weights") is not None:
        leaves = _leaves(local)
        cfg = gt.RenderConfig(**job["configs"][0])
        img = gt.render_sharded(leaves, cam, cfg, mesh, backend=job["backend"])
        (img * torch.from_numpy(job["weights"])).sum().backward()
        out["grads"] = {f.name: getattr(leaves, f.name).grad.numpy() for f in dataclasses.fields(leaves)}
    return out


def task_ssim(rank, world, job):
    """ssim_strip of this rank's row strip (equal strips, rank order)."""
    pred, target = (torch.from_numpy(job[k]) for k in ("pred", "target"))
    h = pred.shape[0] // world
    rows = slice(rank * h, (rank + 1) * h)
    mesh = gt.splat_mesh(world, device=CPU)
    p = pred[rows].clone().requires_grad_(True)
    value = ssim_strip(p, target[rows], mesh.sp_group, world)
    (value / world).backward()
    return {"ssim": float(value), "grad": p.grad.numpy()}


def task_train(rank, world, job):
    """``job["steps"]`` sharded steps with ``default_optimizer`` over this
    rank's block (the first step's gradient kept) on a dp × sp mesh."""
    mesh = gt.make_mesh(batch=job["dp"], splat=world // job["dp"], device=CPU)
    params = gt.shard_params(gt.params_from_numpy(job["params"], device=CPU), mesh)
    opt = gt.default_optimizer(params)
    cfg = gt.RenderConfig(**job["config"])
    step = gt.make_sharded_train_step(opt, _camera(job["camera"]), mesh, cfg, backend=job["backend"],
                                      lambda_dssim=job["lambda_dssim"])
    views, projs, targets = (torch.from_numpy(job[k]) for k in ("views", "projs", "targets"))
    losses, grads = [], None
    for k in range(job["steps"]):
        losses.append(float(step(params, views, projs, targets)))
        if k == 0:
            grads = {name: t.grad.numpy().copy() for name, t in params.as_dict().items()}
    out = {"losses": losses, "grads": grads, "block": mesh.sp_index, "batch_row": mesh.dp_index}
    if mesh.dp > 1:
        # planted fault: one step from the same start on a mesh without its
        # dp group, so the gradient skips the mean over the batch axis
        faulty = gt.shard_params(gt.params_from_numpy(job["params"], device=CPU), mesh)
        gt.make_sharded_train_step(gt.default_optimizer(faulty), _camera(job["camera"]),
                                   dataclasses.replace(mesh, dp_group=None), cfg, backend=job["backend"],
                                   lambda_dssim=job["lambda_dssim"])(faulty, views, projs, targets)
        out["grads_without_dp_mean"] = {name: t.grad.numpy().copy() for name, t in faulty.as_dict().items()}
    return out


def task_env(rank, world, job):
    """What the group joined through the environment says of this rank."""
    total = gt.parallel.collectives.psum(torch.tensor(float(rank + 1)), dist.group.WORLD)
    return {"rank": dist.get_rank(), "world": dist.get_world_size(), "backend": str(dist.get_backend()),
            "psum": float(total)}


TASKS = {"render": task_render, "ssim": task_ssim, "train": task_train, "env": task_env}


def _rank_main(rank, world, out_dir, task, job, port):
    torch.set_num_threads(1)
    if port is None:
        up = gt.initialize_distributed("gloo", init_method=f"file://{out_dir}/rendezvous", world_size=world,
                                       rank=rank)
    else:  # the standard environment, as a launcher sets it (env://)
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world))
        up = gt.initialize_distributed("gloo")
    if not up:
        raise RuntimeError("initialize_distributed joined no group")
    try:
        result = TASKS[task](rank, world, job)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def run(task: str, world: int, tmp_path, job: dict, port: int = None) -> list:
    """Spawn ``world`` ranks of ``task`` on ``job``; their results in rank
    order.  A failing rank fails the call.  The ranks meet through a file
    under ``tmp_path``, or with ``port`` through ``MASTER_ADDR``/
    ``MASTER_PORT``/``RANK``/``WORLD_SIZE`` (env://) at that port."""
    out_dir = str(tmp_path)
    mp.spawn(_rank_main, args=(world, out_dir, task, job, port), nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]

