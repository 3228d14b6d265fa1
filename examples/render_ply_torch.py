"""Render a 3DGS point_cloud.ply to a PNG with gsplat_tpu_torch (the
counterpart of examples/render_ply.py).

Usage:
    python examples/render_ply_torch.py scene.ply out.png \
        --eye 0 0 3 --target 0 0 0 --width 1280 --height 720 [--wire] [--device cuda]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ply")
    ap.add_argument("out")
    ap.add_argument("--eye", nargs=3, type=float, default=[0.0, 0.0, 3.0])
    ap.add_argument("--target", nargs=3, type=float, default=[0.0, 0.0, 0.0])
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--fov", type=float, default=50.0)
    ap.add_argument("--sh-order", type=int, default=3)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--wire", action="store_true", help="wireframe debug view")
    ap.add_argument("--background", nargs=3, type=float, default=[1.0, 1.0, 1.0])
    ap.add_argument("--device", default="cuda", help="torch device the scene is loaded onto")
    args = ap.parse_args()

    import torch

    import gsplat_tpu_torch as gt

    splats = gt.load_ply(args.ply, device=args.device)
    print(f"loaded {splats.count:,} splats")
    cam = gt.make_camera(args.eye, args.target, args.width, args.height, fov_y_deg=args.fov, device=args.device)
    cfg = gt.tune_pair_budget(splats, cam, gt.RenderConfig(sh_order=args.sh_order))
    with torch.no_grad():
        if args.wire:
            img = gt.render_wireframe(splats, cam, cfg, background=args.background)
            rgb = img[..., :3].cpu().numpy()
        else:
            img = gt.render(splats, cam, cfg, backend=args.backend).cpu().numpy()
            bg = np.asarray(args.background, np.float32)
            rgb = img[..., :3] + (1.0 - img[..., 3:4]) * bg
    rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    try:
        from PIL import Image

        Image.fromarray(rgb8).save(args.out)
    except ImportError:
        with open(args.out, "wb") as f:  # PPM fallback
            f.write(f"P6\n{rgb8.shape[1]} {rgb8.shape[0]}\n255\n".encode())
            f.write(rgb8.tobytes())
    if not args.wire:
        print(f"alpha: max {float(img[..., 3].max()):.4f}, covered share {float((img[..., 3] > 0.5).mean()):.4f}")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
