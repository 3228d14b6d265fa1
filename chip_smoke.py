#!/usr/bin/env python3
"""Smoke run of gsplat_tpu_torch on one NVIDIA GPU: the quickest proof that the
port still builds, starts and renders on the card.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, each printing one JSON line; any failure exits non-zero:

  device     torch.cuda must be there; prints the card's name and power limit.
  build      compiles csrc/*.cu with nvcc (one process per source, in
             parallel) and loads the libraries.
  checks     every kernel against its plain PyTorch version on the card at
             small and ragged shapes (scan: bit-equal; compositor: image
             max|diff| < 1e-5 and equal stop counters; its checkpoint variant:
             the same image and counters bit for bit; backward compositor:
             every gradient-space row within 1e-5 of the row's max, the packed
             bf16 halves within one bf16 step - the two sides add 1024 pixels
             in different orders; segment sum: within 1e-6 of the row's max
             and bit-equal between two runs).
  reference  a small scene rendered through the main path against the
             plain tiled renderer and the O(N*H*W) oracle, and its gradient
             through the kernels against autograd through the plain tiled
             renderer.
  main_path  1,000,000 splats at 1920x1080, packed payload, eps 1e-3, pair
             budget tuned: five frames from an orbit through render(...,
             backend="auto", with_stats=True).  Launch counters are zeroed
             just before and read just after.
  stages     the main path's stages timed one by one (where a frame's time
             goes).
  train_path the same scene and configuration under make_train_step with
             default_optimizer: steps towards a target rendered from the
             scene with perturbed colours and positions.  Launch counters
             are zeroed just before and read just after.
  train_stages  one training step taken apart (where a step's time goes).
  kernels    each kernel at the shapes (and, for the compositor, the very
             inputs) of the main path: error against the plain version, its
             time, the plain version's, a library call's where one exists,
             and the least time the card could take (bound).

The last line is {"ok": true, "device": {...}}.
"""

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False - this script needs a CUDA card\n")
    sys.exit(1)

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.ops.kernels import _build
from gsplat_tpu_torch.ops.kernels import composite as kcomp
from gsplat_tpu_torch.ops.kernels import scan as kscan
from gsplat_tpu_torch.ops.kernels import segsum as ksegsum
from gsplat_tpu_torch.ops.projection import project_splats
from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, sanitize_projected
from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth

DEV = "cuda"
IMAGE_TOL = 1e-5
WARMUP_FRAMES = 3
WARMUP_STEPS = 2
# Backward compositor against its plain version, per gradient-space row: both
# add the same 1024 per-pixel terms of a pair, in different orders.
GRAD_ROW_TOL = 1e-5
# Segment sum against its plain version, per row: a splat's few pairs added in
# another order.
SEGSUM_TOL = 1e-6
# Whole-render gradients against autograd through the plain tiled renderer
# (the thresholds of the JAX package's on-chip gate): relative to
# max(1, |g|max) of the field.
GRAD_TOL = 2e-4
GRAD_TOL_PACKED_COLOR = 2e-2
SPLAT_FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")

# Published peaks of one H100 SXM (NVIDIA data sheet): the bounds below are
# stated against them, whatever the card's power limit is set to.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations of one pixel update of the compositor, as the kernel's
# source spells them out: dy (1), qx, qy (4), squares and power (3), exp (1),
# *op (1), min (1), three tests and the select (4), alpha*T (1), three
# multiply-adds into the accumulators (6), 1 - alpha and T * (2).
FLOPS_PER_PIXEL_UPDATE = 24
# float32 operations the backward needs for one pixel of one pair: alpha once
# (15: the forward's count without its blend), T once (2), the weight and
# K (6), K - u, d_alpha, the gate and dp2 (7), the two first and three second
# moments (5), three colour products (3), the nine adds into the sums (9),
# the update of u (2).  The kernel's second alpha evaluation (its replay) is
# not counted: the bound is what the function needs, not what this design does.
FLOPS_PER_PIXEL_BWD = 49


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


def time_ms(fn, reps, warmup=2):
    """Mean milliseconds of fn(i) over `reps` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ----------------------------------------------------------------- scenes

def bench_scene(n, seed=0):
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    return gt.random_splats(g, n, extent=1.2, scale_range=(0.002, 0.01), sh_scale=0.1, device=DEV)


def orbit_cameras(width, height, frames):
    cams = []
    for k in range(frames):
        a = 0.04 * k  # radians around the y axis, starting at the bench camera
        eye = [3.0 * math.sin(a), 0.4, 3.0 * math.cos(a)]
        cams.append(gt.make_camera(eye=eye, target=[0, 0, 0], width=width, height=height, device=DEV))
    return cams


def compositor_inputs(splats, cam, cfg, with_grad_map=False):
    """The main path's own stages up to the compositor (render_cuda's)."""
    p = project_splats(splats, cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff, only_sh=cfg.only_sh)
    p = sort_by_depth(quantize_payload(sanitize_projected(p), cfg))
    b = binning.bin_splats(p, cam.width, cam.height, cfg, with_tiles=False, with_grad_map=with_grad_map)
    nty, ntx = binning.tile_grid(cam.width, cam.height, cfg.tile_h, cfg.tile_w)
    payload = kcomp.pack_payload(p.fields) if cfg.payload_dtype == "packed" else p.fields[:10].contiguous()
    args = (payload, b.pair_splat, b.tile_base, b.tile_phi, b.tile_span, nty, ntx, cam.height, cam.width, cfg)
    return args, b


def compare_compositor(args, label):
    img_k, used_k = kcomp.composite_splats(*args)
    torch.cuda.synchronize()
    img_p, used_p = kcomp.composite_splats_plain(*args)
    torch.cuda.synchronize()
    if img_k.shape != img_p.shape or not torch.isfinite(img_k).all():
        fail(f"compositor {label}: bad output {tuple(img_k.shape)}")
    err = float((img_k - img_p).abs().max())
    used_equal = bool(torch.equal(used_k, used_p))
    if not (err < IMAGE_TOL) or not used_equal:
        fail(f"compositor {label}: max|diff| {err:.3e} (tolerance {IMAGE_TOL}), used equal: {used_equal}")
    return err, used_k


def zero_counters():
    kscan.launches = 0
    kscan.launches_by_kind.update(add=0, max=0)
    kcomp.launches = 0
    kcomp.launches_checkpoint = 0
    kcomp.launches_bwd = 0
    ksegsum.launches = 0


def read_counters():
    return {
        "scan_i32_add": kscan.launches_by_kind["add"],
        "scan_i32_max": kscan.launches_by_kind["max"],
        "scan_i32": kscan.launches,
        "composite_fwd": kcomp.launches,
        "composite_fwd_checkpoint": kcomp.launches_checkpoint,
        "composite_bwd": kcomp.launches_bwd,
        "segsum": ksegsum.launches,
    }


def backward_inputs(splats, cam, cfg, seed):
    """The gradient path's own stages up to the backward kernel: binning with
    the gradient map, and a seeded cotangent."""
    fwd, b = compositor_inputs(splats, cam, cfg, with_grad_map=True)
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    d_out = torch.randn((cam.height, cam.width, 4), generator=g, device=DEV)
    g_pad = binning.grad_pad_size(b.dest_of_exp.shape[0], fwd[5] * fwd[6], cfg.chunk)
    return fwd, b, d_out, g_pad


def compare_checkpoint(fwd, label):
    """The checkpoint variant: image and stop counters bit-equal to the
    variant without, checkpoints equal to the plain version's on the chunks
    a tile walked."""
    img, used = kcomp.composite_splats(*fwd)
    img_c, used_c, tchk = kcomp.composite_splats(*fwd, checkpoint=True)
    torch.cuda.synchronize()
    if not (torch.equal(img, img_c) and torch.equal(used, used_c)):
        fail(f"checkpoint variant {label}: image or stop counters differ from the variant without")
    _, _, tchk_p = kcomp.composite_splats_plain(*fwd, checkpoint=True)
    chunk = fwd[-1].chunk
    nused = (used + chunk - 1) // chunk
    walked = torch.arange(tchk.shape[1], device=DEV)[None, :] < nused[:, None]
    # entries of chunks never walked are unspecified (possibly NaN): select, do not multiply
    diff = torch.where(walked[:, :, None], (tchk - tchk_p).abs(), 0.0)
    err = float(diff.max()) if diff.numel() else 0.0
    if not err < IMAGE_TOL:
        fail(f"checkpoint variant {label}: checkpoints differ from the plain version by {err:.3e}")
    return used_c, tchk, err


def gspace_rows(gspace, packed):
    """Gradient space as nine float32 rows, whatever its storage."""
    if not packed:
        return gspace
    cg, cb = kcomp.unpack2(gspace[6:7])
    return torch.cat([gspace[0:6].view(torch.float32), cg, cb, gspace[7:8].view(torch.float32)], dim=0)


def compare_backward(fwd, b, used, tchk, d_out, g_pad, label):
    """composite_bwd against composite_bwd_plain, row by row."""
    cfg = fwd[-1]
    packed = cfg.payload_dtype == "packed"
    args = fwd[:5] + (used, b.grad_base, d_out, tchk, g_pad) + fwd[5:]
    got = kcomp.composite_bwd(*args)
    torch.cuda.synchronize()
    want = kcomp.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"composite_bwd {label}: output {tuple(got.shape)} {got.dtype}, plain {tuple(want.shape)} {want.dtype}")
    a, w = gspace_rows(got, packed), gspace_rows(want, packed)
    if not torch.isfinite(a).all():
        fail(f"composite_bwd {label}: non-finite sums")
    worst = 0.0
    worst_abs = 0.0
    for r in range(a.shape[0]):
        scale = float(w[r].abs().max())
        err = float((a[r] - w[r]).abs().max())
        if packed and r in (6, 7):
            # bf16 halves: one step of an 8-bit mantissa at the value's own
            # size, plus the f32 tolerance before rounding
            tol_t = w[r].abs() * 2.0 ** -7 + GRAD_ROW_TOL * scale
            ok = bool(((a[r] - w[r]).abs() <= tol_t).all())
        else:
            ok = err <= GRAD_ROW_TOL * scale
        if not ok:
            fail(f"composite_bwd {label}: row {r} differs by {err:.3e} (row max {scale:.3e})")
        if not (packed and r in (6, 7)):  # the float32 rows
            worst_abs = max(worst_abs, err)
            if scale > 0:
                worst = max(worst, err / scale)
    if float(w.abs().max()) == 0.0:
        fail(f"composite_bwd {label}: the plain version's sums are all zero")
    return got, worst, worst_abs


def compare_segsum(gspace, b, packed, label):
    args = (gspace, b.dest_of_exp, b.exp_offsets, b.exp_counts)
    got = ksegsum.segsum_by_splat(*args, packed=packed)
    again = ksegsum.segsum_by_splat(*args, packed=packed)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"segsum {label}: two runs on the same input differ")
    want = ksegsum.segsum_by_splat_plain(*args, packed=packed)
    worst = 0.0
    worst_abs = 0.0
    for r in range(got.shape[0]):
        scale = float(want[r].abs().max())
        err = float((got[r] - want[r]).abs().max())
        worst_abs = max(worst_abs, err)
        if err > SEGSUM_TOL * scale:
            fail(f"segsum {label}: row {r} differs by {err:.3e} (row max {scale:.3e})")
        if scale > 0:
            worst = max(worst, err / scale)
    n = b.exp_counts.shape[0]
    order = torch.randperm(n, device=DEV)
    stored = ksegsum.segsum_by_splat(*args, order=order, packed=packed)
    if not torch.equal(stored[:, order], got):
        fail(f"segsum {label}: the storage-order result is not the rank-order one permuted")
    empty = b.exp_counts == 0
    if bool(empty.any()) and float(got[:, empty].abs().max()) != 0.0:
        fail(f"segsum {label}: a rank without pairs did not get exact zeros")
    return worst, worst_abs


def splat_grads(splats, cam, cfg, weights, backend):
    leaves = {f: getattr(splats, f).detach().clone().requires_grad_(True) for f in SPLAT_FIELDS}
    image = gt.render(dataclasses.replace(splats, **leaves), cam, cfg, backend=backend)
    (image * weights).sum().backward()
    return {f: leaves[f].grad for f in SPLAT_FIELDS}


# ----------------------------------------------------------------- phases

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return card


def phase_build(verbose):
    t0 = time.time()
    out = _build.build_all(verbose=verbose)
    kscan._library()
    kcomp._library()
    kcomp._library_bwd()
    ksegsum._library()
    emit("build", seconds=round(time.time() - t0, 2), directory=str(out),
         sources=sorted(f"gsplat_tpu_torch/csrc/{n}.cu" for n in _build.EXTRA_FLAGS))


def phase_checks():
    """Small and ragged shapes: every kernel against its plain version."""
    g = torch.Generator(device=DEV)
    g.manual_seed(1)
    scan_cases = 0
    for n in (0, 1, 1023, 4096, 4097, 1_000_000, 3_000_001):
        for kind in kscan.KINDS:
            if kind == "add":
                x = torch.randint(0, 40, (n,), generator=g, device=DEV, dtype=torch.int32)
            else:
                x = torch.randint(-(2**31), 2**31 - 1, (n,), generator=g, device=DEV, dtype=torch.int64).to(torch.int32)
            got = kscan.scan_i32(x, kind)
            torch.cuda.synchronize()
            want = kscan.scan_i32_plain(x, kind)
            if got.dtype != torch.int32 or got.shape != want.shape or not torch.equal(got, want):
                fail(f"scan_i32[{kind}] differs from its plain version at length {n}")
            # a misaligned view (data pointer not 16-byte aligned) takes the scalar path
            if n > 8:
                if not torch.equal(kscan.scan_i32(x[1:], kind), kscan.scan_i32_plain(x[1:], kind)):
                    fail(f"scan_i32[{kind}] differs on a misaligned view at length {n - 1}")
            scan_cases += 1

    splats = bench_scene(100_000, seed=2)
    worst = 0.0
    comp_cases = 0
    stops = 0
    bwd = {"cases": 0, "checkpoint_max_abs_err": 0.0, "bwd_worst_rel_err": 0.0, "segsum_worst_rel_err": 0.0}

    def check_backward(scene, cam, cfg, label):
        fwd, b, d_out, g_pad = backward_inputs(scene, cam, cfg, seed=11 + bwd["cases"])
        used, tchk, e_chk = compare_checkpoint(fwd, label)
        gspace, e_bwd, _ = compare_backward(fwd, b, used, tchk, d_out, g_pad, label)
        e_seg, _ = compare_segsum(gspace, b, cfg.payload_dtype == "packed", label)
        bwd["cases"] += 1
        bwd["checkpoint_max_abs_err"] = max(bwd["checkpoint_max_abs_err"], e_chk)
        bwd["bwd_worst_rel_err"] = max(bwd["bwd_worst_rel_err"], e_bwd)
        bwd["segsum_worst_rel_err"] = max(bwd["segsum_worst_rel_err"], e_seg)

    for (w, h) in ((640, 360), (70, 45)):
        cam = gt.make_camera(eye=[0.0, 0.4, 3.0], target=[0, 0, 0], width=w, height=h, device=DEV)
        for mode in ("float32", "packed", "soft_cutoff"):
            for eps in (0.0, 1e-3):
                cfg = gt.RenderConfig(
                    payload_dtype="packed" if mode == "packed" else "float32",
                    soft_cutoff=(mode == "soft_cutoff"),
                    transmittance_eps=eps, warn_on_drop=False,
                    pairs_per_splat=8.0 if mode == "soft_cutoff" else 3.0,
                )
                args, b = compositor_inputs(splats, cam, cfg)
                err, used = compare_compositor(args, f"{w}x{h} {mode} eps={eps}")
                worst = max(worst, err)
                stops += int((used < b.tile_span).sum())
                comp_cases += 1
                check_backward(splats, cam, cfg, f"{w}x{h} {mode} eps={eps}")
    # An opaque scene of large splats, so that the tile-level early stop
    # fires in most tiles and `used` is a real test of the stop rule.
    dense = dataclasses.replace(
        bench_scene(100_000, seed=3),
        opacity=torch.full((100_000,), 0.95, device=DEV),
    )
    dense = dataclasses.replace(dense, scale=dense.scale * 3.0)
    cam = gt.make_camera(eye=[0.0, 0.4, 3.0], target=[0, 0, 0], width=640, height=360, device=DEV)
    for payload in ("float32", "packed"):
        cfg = gt.RenderConfig(payload_dtype=payload, transmittance_eps=1e-3, warn_on_drop=False,
                              pairs_per_splat=12.0)
        args, b = compositor_inputs(dense, cam, cfg)
        err, used = compare_compositor(args, f"dense 640x360 {payload}")
        n_stop = int((used < b.tile_span).sum())
        if n_stop == 0:
            fail("the dense check scene did not trigger the early stop")
        worst = max(worst, err)
        stops += n_stop
        comp_cases += 1
        check_backward(dense, cam, cfg, f"dense 640x360 {payload}")
    # Trained-scene statistics: needle splats, a near-transparent tail and
    # clustered positions, which load single tiles up to tile_capacity.
    g = torch.Generator(device=DEV)
    g.manual_seed(4)
    trained = gt.trained_like_splats(g, 100_000, device=DEV)
    cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3, warn_on_drop=False,
                          pairs_per_splat=16.0)
    args, b = compositor_inputs(trained, cam, cfg)
    err, used = compare_compositor(args, "trained-like 640x360 packed")
    worst = max(worst, err)
    stops += int((used < b.tile_span).sum())
    comp_cases += 1
    check_backward(trained, cam, cfg, "trained-like 640x360 packed")
    # another chunk size: the backward kernel sizes its shared memory by it
    small = gt.make_camera(eye=[0.0, 0.4, 3.0], target=[0, 0, 0], width=70, height=45, device=DEV)
    cfg = gt.RenderConfig(chunk=64, tile_capacity=1024, transmittance_eps=1e-3, warn_on_drop=False,
                          pairs_per_splat=3.0)
    compare_compositor(compositor_inputs(splats, small, cfg)[0], "70x45 float32 chunk=64")
    comp_cases += 1
    check_backward(splats, small, cfg, "70x45 float32 chunk=64")
    emit("checks", scan_cases=scan_cases, scan="bit-equal", compositor_cases=comp_cases,
         compositor_max_abs_err=worst, tolerance=IMAGE_TOL, tiles_stopped_early=stops, used="equal",
         backward_cases=bwd["cases"], checkpoint_variant="image and used bit-equal",
         checkpoint_max_abs_err=bwd["checkpoint_max_abs_err"],
         composite_bwd_worst_row_rel_err=bwd["bwd_worst_rel_err"], composite_bwd_row_tolerance=GRAD_ROW_TOL,
         segsum_worst_row_rel_err=bwd["segsum_worst_rel_err"], segsum_row_tolerance=SEGSUM_TOL,
         segsum_two_runs="bit-equal")


def phase_reference():
    """The main path against the plain renderers on a small scene."""
    g = torch.Generator(device=DEV)
    g.manual_seed(5)
    splats = gt.random_splats(g, 1500, extent=0.8, sh_scale=0.2, device=DEV)
    cam = gt.make_camera(eye=[0.2, 0.4, 3.0], target=[0, 0, 0], width=200, height=120, device=DEV)
    out = {}
    for payload in ("float32", "packed"):
        cfg = gt.RenderConfig(tile_capacity=1024, transmittance_eps=0.0, payload_dtype=payload)
        main = gt.render(splats, cam, cfg, backend="auto")
        tiles = gt.render(splats, cam, cfg, backend="tiles")
        oracle = gt.render(splats, cam, cfg, backend="reference")
        e_tiles = float((main - tiles).abs().max())
        e_oracle = float((main - oracle).abs().max())
        if not (e_tiles < IMAGE_TOL and e_oracle < IMAGE_TOL):
            fail(f"reference {payload}: main path vs tiles {e_tiles:.3e}, vs oracle {e_oracle:.3e}")
        if float(main[..., 3].max()) < 0.5:
            fail("reference scene rendered (nearly) empty")
        out[payload] = {"vs_tiles": e_tiles, "vs_oracle": e_oracle}
    # The whole gradient d splats through the three kernels against autograd
    # through the plain tiled renderer.
    gw = torch.Generator(device=DEV)
    gw.manual_seed(6)
    weights = torch.randn((120, 200, 4), generator=gw, device=DEV)
    grad_err = {}
    for payload in ("float32", "packed"):
        cfg = gt.RenderConfig(tile_capacity=1024, transmittance_eps=0.0, payload_dtype=payload)
        g_main = splat_grads(splats, cam, cfg, weights, "auto")
        g_tiles = splat_grads(splats, cam, cfg, weights, "tiles")
        grad_err[payload] = {}
        for f in SPLAT_FIELDS:
            scale = max(1.0, float(g_tiles[f].abs().max()))
            err = float((g_main[f] - g_tiles[f]).abs().max())
            tol = GRAD_TOL_PACKED_COLOR if (payload == "packed" and f in ("color", "sh")) else GRAD_TOL
            if not torch.isfinite(g_main[f]).all() or not err <= tol * scale:
                fail(f"reference {payload}: gradient of {f} differs by {err:.3e} "
                     f"(tolerance {tol} x {scale:.3e})")
            grad_err[payload][f] = err / scale
        if max(float(g_tiles[f].abs().max()) for f in SPLAT_FIELDS) == 0.0:
            fail("reference scene has an all-zero gradient")
    emit("reference", splats=1500, size="200x120", tolerance=IMAGE_TOL, max_abs_err=out,
         grad_tolerance={"float32": GRAD_TOL, "packed": GRAD_TOL, "packed_color_sh": GRAD_TOL_PACKED_COLOR},
         grad_rel_err=grad_err)


def phase_main_path(n_splats, width, height, frames):
    splats = bench_scene(n_splats, seed=0)
    cams = orbit_cameras(width, height, frames)
    cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3)
    cfg = gt.tune_pair_budget(splats, cams, cfg, headroom=1.02)
    pairs = [gt.measure_pairs(splats, c, cfg) for c in cams]

    for k in range(WARMUP_FRAMES):  # the caching allocator's pool settles over a few frames
        gt.render(splats, cams[k % len(cams)], cfg, backend="auto")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counters()
    times, images, dropped = [], [], []
    for cam in cams:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        image, stats = gt.render(splats, cam, cfg, backend="auto", with_stats=True)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        images.append(image)
        dropped.append(int(stats.dropped_pairs))
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated()

    # serving pays for no training: no checkpoints, no backward, no gradient map
    want = {"scan_i32_add": frames, "scan_i32_max": frames, "scan_i32": 2 * frames, "composite_fwd": frames,
            "composite_fwd_checkpoint": 0, "composite_bwd": 0, "segsum": 0}
    if counts != want:
        fail(f"main path launch counts {counts}, expected {want}")
    if any(dropped):
        fail(f"dropped_pairs {dropped} with a budget tuned on these cameras")
    coverage = []
    for image in images:
        if tuple(image.shape) != (height, width, 4) or image.dtype != torch.float32:
            fail(f"image shape/dtype {tuple(image.shape)} {image.dtype}")
        if not torch.isfinite(image).all():
            fail("image holds non-finite values")
        a = image[..., 3]
        if float(a.min()) < 0.0 or float(a.max()) > 1.0:
            fail(f"alpha outside [0, 1]: [{float(a.min())}, {float(a.max())}]")
        cov = float((a > 0.5).float().mean())
        if cov < 0.05:
            fail(f"frame (nearly) empty: {cov:.3f} of the pixels are covered")
        coverage.append(round(cov, 4))
    nty, ntx = binning.tile_grid(width, height, cfg.tile_h, cfg.tile_w)
    emit("main_path", splats=n_splats, size=f"{width}x{height}", frames=frames,
         payload_dtype=cfg.payload_dtype, transmittance_eps=cfg.transmittance_eps,
         pair_budget=cfg.pair_budget(n_splats), pairs=pairs, tiles=nty * ntx,
         dropped_pairs=dropped, warmup_frames=WARMUP_FRAMES, frame_ms=times,
         median_frame_ms=statistics.median(times), min_frame_ms=min(times),
         peak_memory_bytes=peak, covered_share=coverage, launches=counts)
    return splats, cams, cfg, counts


def phase_stages(splats, cam, cfg, reps=7):
    """Where a frame's time goes: the stages of render_cuda, each between two
    CUDA events with a synchronise before it (so the sum exceeds the frame
    time, which overlaps host and device work)."""
    nty, ntx = binning.tile_grid(cam.width, cam.height, cfg.tile_h, cfg.tile_w)
    state = {}

    def project():
        state["p"] = project_splats(splats, cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff,
                                    only_sh=cfg.only_sh)

    def sanitize_quantize():
        state["p"] = quantize_payload(sanitize_projected(state["p"]), cfg)

    def depth_sort():
        state["p"] = sort_by_depth(state["p"])

    def bin_pairs():
        state["b"] = binning.bin_splats(state["p"], cam.width, cam.height, cfg, with_tiles=False)

    def pack():
        state["payload"] = kcomp.pack_payload(state["p"].fields)

    def composite():
        b = state["b"]
        kcomp.composite_splats(state["payload"], b.pair_splat, b.tile_base, b.tile_phi, b.tile_span,
                               nty, ntx, cam.height, cam.width, cfg)

    stages = [("project", project), ("sanitize_quantize", sanitize_quantize), ("depth_sort", depth_sort),
              ("bin_splats", bin_pairs), ("pack_payload", pack), ("composite_fwd", composite)]
    samples = {name: [] for name, _ in stages}
    for _ in range(reps):
        for name, fn in stages:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            samples[name].append(start.elapsed_time(stop))
    med = {name: statistics.median(v) for name, v in samples.items()}
    emit("stages", reps=reps, median_ms=med, sum_ms=sum(med.values()))


def perturbed_target(splats, cam, cfg, seed=21):
    """The training target: the scene rendered with perturbed colours and
    positions, over white.  Made from a seed; nothing is read from disk."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    moved = dataclasses.replace(
        splats,
        pos=splats.pos + 0.01 * torch.randn(splats.pos.shape, generator=g, device=DEV),
        color=torch.clamp(splats.color + 0.2 * torch.randn(splats.color.shape, generator=g, device=DEV), 0.0, 1.0),
    )
    with torch.no_grad():
        img = gt.render(moved, cam, gt.tune_pair_budget(moved, [cam], cfg, headroom=1.02), backend="auto")
    return (img[..., :3] + (1.0 - img[..., 3:4])).contiguous()


def phase_train_path(splats, cam, cfg, steps):
    """make_train_step with default_optimizer on the production scene."""
    n = splats.count
    target = perturbed_target(splats, cam, cfg)
    # a budget with room for the few steps the parameters move
    cfg = gt.tune_pair_budget(splats, [cam], cfg, headroom=1.05)
    params = gt.params_from_splats(splats)
    start = {k: v.detach().clone() for k, v in params.as_dict().items()}
    optimizer = gt.default_optimizer(params)
    step = gt.make_train_step(optimizer, cam, cfg, backend="auto")
    warm = [float(step(params, target)) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counters()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        loss = step(params, target)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
        losses.append(float(loss))
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated()

    want = {"scan_i32_add": steps, "scan_i32_max": 3 * steps, "scan_i32": 4 * steps,
            "composite_fwd": steps, "composite_fwd_checkpoint": steps,
            "composite_bwd": steps, "segsum": steps}
    if counts != want:
        fail(f"train path launch counts {counts}, expected {want}")
    if not all(math.isfinite(x) for x in warm + losses):
        fail(f"non-finite loss: {warm + losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall over {steps} steps: {losses}")
    with torch.no_grad():
        _, stats = gt.render(gt.splats_from_params(params), cam, cfg, backend="auto", with_stats=True)
    dropped = int(stats.dropped_pairs)
    if dropped:
        fail(f"dropped_pairs {dropped} on the trained parameters")
    moved_by = {}
    for k, v in params.as_dict().items():
        if not torch.isfinite(v).all():
            fail(f"parameter {k} holds non-finite values after training")
        moved_by[k] = float((v.detach() - start[k]).abs().max())
        if not moved_by[k] > 0.0:
            fail(f"parameter {k} did not move")
    emit("train_path", splats=n, size=f"{cam.width}x{cam.height}", steps=steps, warmup_steps=WARMUP_STEPS,
         payload_dtype=cfg.payload_dtype, transmittance_eps=cfg.transmittance_eps,
         pair_budget=cfg.pair_budget(n), optimizer="Adam, one group per field (default_optimizer)",
         lambda_dssim=0.2, warmup_losses=warm, losses=losses, step_ms=times,
         median_step_ms=statistics.median(times), min_step_ms=min(times), peak_memory_bytes=peak,
         dropped_pairs=dropped, max_abs_move=moved_by, launches=counts,
         launches_per_step={k: v / steps for k, v in counts.items()})
    return cfg, target, counts


def phase_train_stages(splats, cam, cfg, target, reps=3):
    """Where a training step's time goes: one step taken apart by cutting the
    graph at the image and at the projected field rows, each piece between two
    CUDA events with a synchronise before it."""
    from gsplat_tpu_torch.train.loss import render_loss

    nty, ntx = binning.tile_grid(cam.width, cam.height, cfg.tile_h, cfg.tile_w)
    params = gt.params_from_splats(splats)
    optimizer = gt.default_optimizer(params)
    st = {}

    def project():
        st["s"] = gt.splats_from_params(params)
        st["p0"] = project_splats(st["s"], cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff,
                                  only_sh=cfg.only_sh)

    def sanitize_quantize_sort():
        st["p"] = sort_by_depth(quantize_payload(sanitize_projected(st["p0"]), cfg))

    def bin_with_grad_map():
        st["b"] = binning.bin_splats(st["p"], cam.width, cam.height, cfg, with_tiles=False, with_grad_map=True)

    def composite_forward():
        st["f"] = st["p"].fields[:10].detach().requires_grad_(True)
        st["img"] = kcomp.composite_splats_diff(st["f"], st["b"], nty, ntx, cam.height, cam.width, cfg)

    def loss_forward():
        st["img_leaf"] = st["img"].detach().requires_grad_(True)
        rgb = st["img_leaf"][..., :3] + (1.0 - st["img_leaf"][..., 3:4])
        st["loss"] = render_loss(rgb, target, 0.2)

    def loss_backward():
        st["loss"].backward()

    def composite_backward():  # backward kernel + segment sum + per-splat combine
        st["img"].backward(st["img_leaf"].grad)

    def projection_backward():  # depth-sort permutation, quantize, sanitize, projection, activations
        optimizer.zero_grad(set_to_none=True)
        st["p"].fields[:10].backward(st["f"].grad)

    def optimizer_step():
        optimizer.step()

    stages = [("project", project), ("sanitize_quantize_sort", sanitize_quantize_sort),
              ("bin_splats_grad_map", bin_with_grad_map), ("composite_fwd_checkpoint", composite_forward),
              ("loss_forward", loss_forward), ("loss_backward", loss_backward),
              ("composite_backward_total", composite_backward), ("projection_backward", projection_backward),
              ("optimizer_step", optimizer_step)]
    samples = {name: [] for name, _ in stages}
    for rep in range(reps + 1):
        for name, fn in stages:
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize()
            if rep > 0:  # the first pass warms the allocator
                samples[name].append(t0.elapsed_time(t1))
    med = {name: statistics.median(v) for name, v in samples.items()}
    emit("train_stages", reps=reps, median_ms=med, sum_ms=sum(med.values()),
         note="composite_backward_total = backward kernel + segment sum + per-splat combine; "
              "their own times are on the kernels line")


def phase_profile(label, units):
    """Optional (--profile): torch.profiler over a few units of work (frames
    or training steps, each a callable) — the device's busy share of the
    window and the kernels that take most device time."""
    from torch.profiler import ProfilerActivity, profile

    units[0]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        units[0]()  # absorbs the tracer's start-up
        torch.cuda.synchronize()
        t0 = time.time()
        for unit in units:
            unit()
        torch.cuda.synchronize()
        t1 = time.time()
    wall_ms = (t1 - t0) * 1e3
    # Kernels (device-side events) only: an operator's event repeats the time
    # of the kernels it launched.
    kernels = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        name = e.name
        tot, cnt = kernels.get(name, (0.0, 0))
        kernels[name] = (tot + us, cnt + 1)
    total = len(units) + 1  # the traced window holds one extra unit
    top = sorted(((tot, name, cnt) for name, (tot, cnt) in kernels.items()), reverse=True)
    busy_ms = sum(t for t, _, _ in top) / 1e3 / total
    unit_ms = wall_ms / len(units)
    emit("profile", of=label, units=len(units), unit_ms_traced=unit_ms, device_busy_ms_per_unit=busy_ms,
         device_busy_share=busy_ms / unit_ms if unit_ms else None,
         kernel_launches_per_unit=sum(c for _, _, c in top) / total,
         note="unit_ms_traced is host wall time with the tracer on, longer than untraced",
         top=[{"name": name[:90], "device_ms_per_unit": tot / 1e3 / total, "calls_per_unit": cnt / total}
              for tot, name, cnt in top[:14]])


def once_ms(fn):
    """Host-clock milliseconds of one call that ends synchronised (for the
    plain versions, which take seconds)."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t0) * 1e3


def phase_train_kernels(splats, cam, cfg, counts):
    """The training path's kernels at that path's own inputs."""
    n = splats.count
    packed = cfg.payload_dtype == "packed"
    fwd, b, d_out, g_pad = backward_inputs(splats, cam, cfg, seed=31)
    payload, pair_splat = fwd[0], fwd[1]
    chunk = cfg.chunk
    rows = []

    # checkpoint variant of the forward
    used, tchk, e_chk = compare_checkpoint(fwd, "train-path frame")
    ms_chk = time_ms(lambda i: kcomp.composite_splats(*fwd, checkpoint=True), reps=10)
    ms_nochk = time_ms(lambda i: kcomp.composite_splats(*fwd), reps=10)
    _, plain_chk_ms = once_ms(lambda: kcomp.composite_splats_plain(*fwd, checkpoint=True))
    walked = int((torch.minimum(used, b.tile_span) - torch.where(b.tile_span > 0, b.tile_phi, 0)).clamp(min=0).sum())
    chunks_walked = int(((used + chunk - 1) // chunk).sum())
    in_bytes = (payload.numel() + pair_splat.numel() + 3 * b.tile_base.numel()) * 4
    img_bytes = cam.height * cam.width * 16
    chk_bytes = chunks_walked * 1024 * 4
    ops_ms = walked * 1024 * FLOPS_PER_PIXEL_UPDATE / PEAK_F32_FLOPS * 1e3
    bytes_ms = (in_bytes + img_bytes + used.numel() * 4 + chk_bytes) / PEAK_BYTES_PER_S * 1e3
    rows.append({
        "name": "composite_fwd_checkpoint", "route": "cuda", "source": "gsplat_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gsplat_tpu/ops/pallas/composite.py:852", "launches": counts["composite_fwd_checkpoint"],
        "max_abs_err": e_chk, "ms": ms_chk, "plain_ms": plain_chk_ms,
        "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None, "ms_without_checkpoints": ms_nochk, "pairs_walked": walked,
        "chunks_walked": chunks_walked, "checkpoint_bytes_written": chk_bytes,
        "checkpoint_bytes_allocated": tchk.numel() * 4, "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
    })

    # backward compositor
    gspace, e_bwd, e_bwd_abs = compare_backward(fwd, b, used, tchk, d_out, g_pad, "train-path frame")
    bargs = fwd[:5] + (used, b.grad_base, d_out, tchk, g_pad) + fwd[5:]
    ms_bwd = time_ms(lambda i: kcomp.composite_bwd(*bargs), reps=10)
    _, plain_bwd_ms = once_ms(lambda: kcomp.composite_bwd_plain(*bargs))
    ops_ms = walked * 1024 * FLOPS_PER_PIXEL_BWD / PEAK_F32_FLOPS * 1e3
    nbytes = in_bytes + 2 * used.numel() * 4 + img_bytes + chk_bytes + gspace.numel() * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    rows.append({
        "name": "composite_bwd", "route": "cuda", "source": "gsplat_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "gsplat_tpu/ops/pallas/composite.py:853", "launches": counts["composite_bwd"],
        "max_abs_err": e_bwd_abs, "max_abs_err_is": "float32 rows; the two bf16 halves are held to one bf16 step",
        "worst_row_rel_err": e_bwd, "row_tolerance": GRAD_ROW_TOL,
        "ms": ms_bwd, "plain_ms": plain_bwd_ms,
        "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None, "pairs_walked": walked, "bytes": nbytes, "grad_space_columns": g_pad,
        "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
    })

    # segment sum
    e_seg, e_seg_abs = compare_segsum(gspace, b, packed, "train-path frame")
    sargs = (gspace, b.dest_of_exp, b.exp_offsets, b.exp_counts)
    ms_seg = time_ms(lambda i: ksegsum.segsum_by_splat(*sargs, packed=packed), reps=20)
    plain_seg_ms = time_ms(lambda i: ksegsum.segsum_by_splat_plain(*sargs, packed=packed), reps=5)
    # The library yardstick: index_add_ of the already gathered expansion-order
    # columns by rank (the port never calls it on the card).
    keep = b.dest_of_exp >= 0
    cols = gspace_rows(gspace, packed)[:, torch.where(keep, b.dest_of_exp, 0).long()] * keep
    rank = torch.clamp(b.exp_rank, min=0).long()
    out = torch.zeros((9, n), device=DEV)
    lib_ms = time_ms(lambda i: out.zero_().index_add_(1, rank, cols), reps=10)
    kept = int(keep.sum())
    nbytes = kept * gspace.shape[0] * 4 + b.dest_of_exp.numel() * 4 + 2 * n * 4 + 9 * n * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = kept * 9 / PEAK_F32_FLOPS * 1e3
    rows.append({
        "name": "segsum", "route": "cuda", "source": "gsplat_tpu_torch/csrc/segsum.cu",
        "replaces": "gsplat_tpu/ops/pallas/segsum.py:148", "launches": counts["segsum"],
        "max_abs_err": e_seg_abs, "worst_row_rel_err": e_seg, "row_tolerance": SEGSUM_TOL,
        "ms": ms_seg, "plain_ms": plain_seg_ms,
        "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": lib_ms, "library": "Tensor.index_add_ on pre-gathered columns",
        "pairs_kept": kept, "pair_budget": b.dest_of_exp.numel(), "bytes": nbytes,
    })
    return rows


def phase_kernels(splats, cam, cfg, counts, train_counts):
    """Each kernel at the main path's shapes: error, times, bound."""
    n = splats.count
    budget = cfg.pair_budget(n)
    g = torch.Generator(device=DEV)
    g.manual_seed(9)
    rows = []
    for kind, length, replaces in (
        ("add", n, "gsplat_tpu/ops/pallas/scan.py:130"),
        ("max", budget, "gsplat_tpu/ops/pallas/scan.py:130"),
    ):
        # Rotating inputs larger than the 50 MB L2 together, so every call
        # reads from device memory, which is what the bound counts.
        nbuf = max(2, (96 << 20) // (4 * length) + 1)
        if kind == "add":
            xs = [torch.randint(0, 8, (length,), generator=g, device=DEV, dtype=torch.int32) for _ in range(nbuf)]
        else:
            xs = [torch.randint(-(2**31), 2**31 - 1, (length,), generator=g, device=DEV,
                                dtype=torch.int64).to(torch.int32) for _ in range(nbuf)]
        got = kscan.scan_i32(xs[0], kind)
        want = kscan.scan_i32_plain(xs[0], kind)
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            fail(f"scan_i32[{kind}] differs from its plain version at length {length}")
        lib = (lambda x: torch.cumsum(x, 0, dtype=torch.int32)) if kind == "add" else (lambda x: torch.cummax(x, 0).values)
        ms = time_ms(lambda i: kscan.scan_i32(xs[i % nbuf], kind), reps=50)
        plain_ms = time_ms(lambda i: kscan.scan_i32_plain(xs[i % nbuf], kind), reps=50)
        library_ms = time_ms(lambda i: lib(xs[i % nbuf]), reps=50)
        rows.append({
            "name": f"scan_i32_{kind}", "route": "cuda", "source": "gsplat_tpu_torch/csrc/scan.cu",
            "replaces": replaces, "launches": counts[f"scan_i32_{kind}"],
            "launches_train_path": train_counts[f"scan_i32_{kind}"], "length": length,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 8.0 * length / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms,
        })
        del xs

    args, b = compositor_inputs(splats, cam, cfg)
    err, used = compare_compositor(args, "main-path frame")
    ms = time_ms(lambda i: kcomp.composite_splats(*args), reps=10)
    torch.cuda.synchronize()
    t0 = time.time()
    kcomp.composite_splats_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    # Work this frame's data needs: the live pair positions each tile walked
    # before it stopped, times 1024 pixels, and every input and output once.
    walked = int((torch.minimum(used, b.tile_span) - torch.where(b.tile_span > 0, b.tile_phi, 0)).clamp(min=0).sum())
    total_pairs = int(b.tile_count.sum())
    payload, pair_splat = args[0], args[1]
    nbytes = (payload.numel() + pair_splat.numel() + 3 * b.tile_base.numel()) * 4 \
        + cam.height * cam.width * 16 + used.numel() * 4
    ops_ms = walked * 1024 * FLOPS_PER_PIXEL_UPDATE / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    rows.append({
        "name": "composite_fwd", "route": "cuda", "source": "gsplat_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gsplat_tpu/ops/pallas/composite.py:817", "launches": counts["composite_fwd"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "pairs_binned": total_pairs, "pairs_walked": walked, "bytes": nbytes,
        "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
        "tiles_stopped_early": int((used < b.tile_span).sum()),
    })
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splats", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--steps", type=int, default=5, help="training steps after warm-up")
    ap.add_argument("--stop-after", choices=("build", "checks", "reference"), default=None,
                    help="a short run: stop after this phase (prints no result line)")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print what ptxas reports for each kernel (registers, shared memory, spills)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace three frames and three training steps with torch.profiler "
                         "(device busy share, top kernels)")
    args = ap.parse_args()

    t0 = time.time()
    card = phase_device()
    phase_build(args.verbose_build)
    if args.stop_after == "build":
        return
    phase_checks()
    if args.stop_after == "checks":
        return
    phase_reference()
    if args.stop_after == "reference":
        return
    splats, cams, cfg, counts = phase_main_path(args.splats, args.width, args.height, args.frames)
    phase_stages(splats, cams[0], cfg)
    if args.profile:
        phase_profile("frame", [lambda cam=cam: gt.render(splats, cam, cfg, backend="auto") for cam in cams[:3]])
    train_cfg, target, train_counts = phase_train_path(splats, cams[0], cfg, args.steps)
    if args.profile:
        params = gt.params_from_splats(splats)
        step = gt.make_train_step(gt.default_optimizer(params), cams[0], train_cfg, backend="auto")
        phase_profile("training step", [lambda: step(params, target)] * 3)
    phase_train_stages(splats, cams[0], train_cfg, target)
    rows = phase_kernels(splats, cams[0], cfg, counts, train_counts)
    rows += phase_train_kernels(splats, cams[0], train_cfg, train_counts)
    emit("done", seconds=round(time.time() - t0, 1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
