#!/usr/bin/env python3
"""Does a one-ulp change of the projected-field cotangent move some splats'
scale gradient by percent because of the math, or because of the port's
projection backward?

The sharded render's gradient differs from the single-device one by the
rounding of one float32 sum of four strip gradients at the projected fields
(about an ulp); after the projection's backward that became ~1.4e-4 of the
largest scale gradient, and several percent of some splats' own.  This
script carries the same two cotangents through the port's projection
backward and through the JAX package's projection VJP, splat by splat.

    python3 scripts/scale_grad_ulp.py --dump   # on a CUDA card: the port only
    python3 scripts/scale_grad_ulp.py          # on the CPU: the port and the JAX package

--dump builds the sharded path's input of chip_smoke.py (1,000,000 splats,
1920x1080, camera 0, packed payload, transmittance_eps 0, the tuned pair
budget), takes the cotangent of sum(render * weights) at the output of
project_splats once over the whole frame and once as the float32 sum, in
rank order, of the four cells of the cyclic 2 x 2 tile grid (what
render_sharded adds), carries both back through the port's projection, and
saves the splats whose scale gradient moved most (relative to its own size,
and relative to the largest), and a random sample of splats with a
gradient, with their parameters, the camera, both cotangents and the card's
gradients, to --out (build/scale_grad_ulp.npz by default; copy it to the
CPU machine for the second step).

Without --dump it loads --out and computes, on the CPU, the scale
gradient of each saved splat from both cotangents by the port's autograd and
by jax.vjp of the JAX package's project_splats (the projection treats each
splat alone, so the saved splats form a scene of their own), and prints one
JSON line: each side's relative move per splat and how the sides agree.
"""

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import gsplat_tpu_torch as gt  # noqa: E402
from gsplat_tpu_torch.ops import binning  # noqa: E402
from gsplat_tpu_torch.ops.kernels import composite as kcomp  # noqa: E402
from gsplat_tpu_torch.ops.projection import project_splats  # noqa: E402
from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, sanitize_projected  # noqa: E402
from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth  # noqa: E402

OUT = ROOT / "build" / "scale_grad_ulp.npz"
FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")
KEEP = 2048  # splats saved by each of the three rules


def _rel_move(g1, g2):
    """Per splat: |g2 - g1| / |g1| over the three scale components, and the
    same over the largest |g1| of the set."""
    d = np.linalg.norm(g2 - g1, axis=0)
    own = np.linalg.norm(g1, axis=0)
    return d / np.where(own > 0, own, np.inf), d / np.abs(g1).max()


def dump(out, n_splats=1_000_000, width=1920, height=1080, dev="cuda"):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    splats = gt.random_splats(g, n_splats, extent=1.2, scale_range=(0.002, 0.01), sh_scale=0.1, device=dev)
    cams = []
    for k in range(5):  # chip_smoke.py's orbit
        a = 0.04 * k
        cams.append(gt.make_camera(eye=[3.0 * math.sin(a), 0.4, 3.0 * math.cos(a)], target=[0, 0, 0],
                                   width=width, height=height, device=dev))
    cfg = gt.tune_pair_budget(splats, cams, gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3),
                              headroom=1.02)
    cfg = dataclasses.replace(cfg, transmittance_eps=0.0)
    cam = cams[0]
    leaves = {f: getattr(splats, f).detach().clone().requires_grad_(True) for f in FIELDS}
    p = project_splats(dataclasses.replace(splats, **leaves), cam, cfg.sh_order,
                       tight_footprint=not cfg.soft_cutoff, only_sh=cfg.only_sh)
    ps = sort_by_depth(quantize_payload(sanitize_projected(p), cfg))
    nty, ntx = binning.tile_grid(width, height, cfg.tile_h, cfg.tile_w)
    b = binning.bin_splats(ps, width, height, cfg, with_tiles=False, with_grad_map=True)
    image = kcomp.composite_splats_diff(ps.fields[:10], b, nty, ntx, height, width, cfg)
    gw = torch.Generator(device=dev)
    gw.manual_seed(77)
    weights = torch.randn((height, width, 4), generator=gw, device=dev)
    single = torch.autograd.grad((image * weights).sum(), p.fields, retain_graph=True)[0]
    ty = (torch.arange(height, device=dev) // cfg.tile_h)[:, None]
    tx = (torch.arange(width, device=dev) // cfg.tile_w)[None, :]
    ranks = None
    for r in range(4):  # the cyclic 2 x 2 grid, in rank order
        mask = ((ty % 2 == r // 2) & (tx % 2 == r % 2))[..., None]
        part = torch.autograd.grad((image * weights * mask).sum(), p.fields, retain_graph=True)[0]
        ranks = part if ranks is None else ranks + part
    g1, g2 = (torch.autograd.grad(p.fields, leaves["scale"], grad_outputs=c, retain_graph=True)[0]
              for c in (single, ranks))
    g1n, g2n = g1.cpu().numpy(), g2.cpu().numpy()
    rel_own, rel_max = _rel_move(g1n, g2n)
    has = np.flatnonzero(np.linalg.norm(g1n, axis=0) > 0)
    pick = np.unique(np.concatenate([
        has[np.argsort(-rel_own[has])[:KEEP]],
        has[np.argsort(-rel_max[has])[:KEEP]],
        np.random.default_rng(0).choice(has, min(KEEP, has.size), replace=False),
    ]))
    host = gt.to_numpy_dict(splats)
    cot_single, cot_ranks = single.detach().cpu().numpy(), ranks.detach().cpu().numpy()
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out, index=pick, **{f: host[f][pick] for f in FIELDS},
        view=cam.view.cpu().numpy(), proj=cam.proj.cpu().numpy(), width=width, height=height,
        sh_order=cfg.sh_order, tight_footprint=not cfg.soft_cutoff, only_sh=cfg.only_sh,
        cot_single=cot_single[:, pick], cot_ranks=cot_ranks[:, pick],
        card_single=g1n[:, pick], card_ranks=g2n[:, pick], card=_device_name(dev))
    print(json.dumps({
        "saved": int(pick.size), "splats_with_gradient": int(has.size), "file": str(out),
        "card": _device_name(dev),
        "card_max_rel_own": float(rel_own[has].max()), "card_max_rel_of_max": float(rel_max.max()),
        "cotangent_entries_changed": float((cot_single != cot_ranks).mean()),
    }))


def _device_name(dev):
    return torch.cuda.get_device_name(0) if torch.device(dev).type == "cuda" else "cpu"


def compare(out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import gsplat_tpu as gj

    d = np.load(out)
    params = {f: d[f] for f in FIELDS}
    w, h = int(d["width"]), int(d["height"])
    kw = dict(tight_footprint=bool(d["tight_footprint"]), only_sh=bool(d["only_sh"]))
    order = int(d["sh_order"])
    # the port, on the CPU
    cam = gt.camera_from_numpy(d["view"], d["proj"], w, h, device="cpu")
    splats = gt.splats_from_numpy(params, device="cpu")
    leaves = {f: getattr(splats, f).detach().clone().requires_grad_(True) for f in FIELDS}
    fields = project_splats(dataclasses.replace(splats, **leaves), cam, order, **kw).fields
    port = [torch.autograd.grad(fields, leaves["scale"], grad_outputs=torch.from_numpy(d[c]), retain_graph=True)[0]
            .numpy() for c in ("cot_single", "cot_ranks")]
    # the JAX package, on the CPU
    jcam = gj.Camera(view=np.asarray(d["view"]), proj=np.asarray(d["proj"]), width=w, height=h)
    jsplats = gj.make_splats(**params)
    _, vjp = jax.vjp(lambda s: gj.project_splats(s, jcam, order, **kw).fields, jsplats)
    ref = [np.asarray(vjp(jnp.asarray(d[c]))[0].scale) for c in ("cot_single", "cot_ranks")]
    card = [d["card_single"], d["card_ranks"]]
    sides = {"card": card, "port_cpu": port, "jax_cpu": ref}
    moves = {k: _rel_move(*v) for k, v in sides.items()}
    top = np.argsort(-moves["card"][0])[:8]

    def by_row(i):
        """For splat i, on the port: its quad-basis rows ay, bx, and the
        scale gradient's move when only one changed cotangent row j takes
        its sharded value, for each such j."""
        one = gt.splats_from_numpy({f: params[f][i:i + 1] for f in FIELDS}, device="cpu")
        scale = one.scale.detach().clone().requires_grad_(True)
        rows = project_splats(dataclasses.replace(one, scale=scale), cam, order, **kw).fields
        single, ranks = d["cot_single"][:, i:i + 1], d["cot_ranks"][:, i:i + 1]

        def grad(cot):
            return torch.autograd.grad(rows, scale, grad_outputs=torch.from_numpy(cot), retain_graph=True)[0]

        base = grad(single)
        moves_j = {}
        for j in np.flatnonzero(single[:, 0] != ranks[:, 0]):
            cot = single.copy()
            cot[j] = ranks[j]
            moves_j[int(j)] = float((grad(cot) - base).norm() / base.norm())
        return {"ay_bx": [float(v) for v in rows[3:5, 0]], "move_if_only_row_changes": moves_j}

    print(json.dumps({
        "splats": int(d["index"].size), "card": str(d["card"]),
        "max_rel_own": {k: float(np.nanmax(np.where(np.isfinite(v[0]), v[0], np.nan))) for k, v in moves.items()},
        "max_rel_of_max": {k: float(v[1].max()) for k, v in moves.items()},
        "top_card_splats": [{"splat": int(d["index"][i]), **{k: float(v[0][i]) for k, v in moves.items()},
                             "grad_norm": float(np.linalg.norm(card[0][:, i])),
                             "cotangent_rel_change": float(np.linalg.norm(d["cot_ranks"][:, i] - d["cot_single"][:, i])
                                                           / np.linalg.norm(d["cot_single"][:, i])),
                             **by_row(i)} for i in top],
    }))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", action="store_true", help="on a CUDA card: build the input and save the cotangents")
    ap.add_argument("--splats", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda", help="--dump's device (cpu only to rehearse at a small size)")
    ap.add_argument("--out", type=Path, default=OUT, help="the file --dump writes and the comparison reads")
    args = ap.parse_args()
    if args.dump:
        dump(args.out, args.splats, args.width, args.height, args.device)
    else:
        compare(args.out)
