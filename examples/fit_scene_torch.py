"""Fit splats to posed target images with gsplat_tpu_torch (the counterpart
of examples/fit_scene.py).

Self-contained demo: renders a synthetic "ground-truth" scene from a ring of
cameras, then fits a randomly initialized splat set to those images with
Adam, checkpointing along the way.

Usage:
    python examples/fit_scene_torch.py [--splats 2000] [--steps 300] [--size 128] [--device cuda]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--splats", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--ckpt", default=None, help="checkpoint dir (optional)")
    ap.add_argument("--out", default=None, help="save fitted scene to PLY")
    ap.add_argument("--device", default="cuda", help="torch device the fit runs on")
    args = ap.parse_args()

    import torch

    import gsplat_tpu_torch as gt

    dev = args.device
    g = torch.Generator(device=dev).manual_seed(0)
    target_scene = gt.random_splats(g, args.splats, extent=0.7, sh_scale=0.1, device=dev)
    cams, targets = [], []
    cfg = gt.RenderConfig()
    with torch.no_grad():
        for v in range(args.views):
            ang = 2 * np.pi * v / args.views
            eye = [2.5 * np.sin(ang), 0.5, 2.5 * np.cos(ang)]
            cam = gt.make_camera(eye, [0, 0, 0], args.size, args.size, device=dev)
            img = gt.render(target_scene, cam, cfg)
            cams.append(cam)
            targets.append(img[..., :3] + (1.0 - img[..., 3:4]))
    print(f"rendered {args.views} target views")

    init = gt.random_splats(torch.Generator(device=dev).manual_seed(1), args.splats, extent=0.7, device=dev)
    params = gt.params_from_splats(init)
    opt = gt.default_optimizer(params, lr_pos=2e-3)
    steps = [gt.make_train_step(opt, cam, cfg, lambda_dssim=0.2) for cam in cams]

    for it in range(args.steps):
        v = it % args.views
        loss = steps[v](params, targets[v])
        if it % 50 == 0 or it == args.steps - 1:
            with torch.no_grad():
                img = gt.render(gt.splats_from_params(params), cams[0], cfg)
                rgb = img[..., :3] + (1.0 - img[..., 3:4])
                print(
                    f"step {it:4d}  loss {float(loss):.4f}  "
                    f"psnr(view0) {float(gt.psnr(rgb, targets[0])):.2f} dB"
                )
            if args.ckpt:
                gt.save_checkpoint(args.ckpt, it, params, opt)

    if args.out:
        gt.save_ply(args.out, gt.splats_from_params(params))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
