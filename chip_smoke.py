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
             max|diff| < 1e-5 and equal stop counters).
  reference  a small scene rendered through the main path against the
             plain tiled renderer and the O(N*H*W) oracle.
  main_path  1,000,000 splats at 1920x1080, packed payload, eps 1e-3, pair
             budget tuned: five frames from an orbit through render(...,
             backend="auto", with_stats=True).  Launch counters are zeroed
             just before and read just after.
  stages     the main path's stages timed one by one (where a frame's time
             goes).
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
from gsplat_tpu_torch.ops.projection import project_splats
from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, sanitize_projected
from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth

DEV = "cuda"
IMAGE_TOL = 1e-5
WARMUP_FRAMES = 3

# Published peaks of one H100 SXM (NVIDIA data sheet): the bounds below are
# stated against them, whatever the card's power limit is set to.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations of one pixel update of the compositor, as the kernel's
# source spells them out: dy (1), qx, qy (4), squares and power (3), exp (1),
# *op (1), min (1), three tests and the select (4), alpha*T (1), three
# multiply-adds into the accumulators (6), 1 - alpha and T * (2).
FLOPS_PER_PIXEL_UPDATE = 24


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


def compositor_inputs(splats, cam, cfg):
    """The main path's own stages up to the compositor (render_cuda's)."""
    p = project_splats(splats, cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff, only_sh=cfg.only_sh)
    p = sort_by_depth(quantize_payload(sanitize_projected(p), cfg))
    b = binning.bin_splats(p, cam.width, cam.height, cfg, with_tiles=False)
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
    emit("checks", scan_cases=scan_cases, scan="bit-equal", compositor_cases=comp_cases,
         compositor_max_abs_err=worst, tolerance=IMAGE_TOL, tiles_stopped_early=stops, used="equal")


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
    emit("reference", splats=1500, size="200x120", tolerance=IMAGE_TOL, max_abs_err=out)


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

    kscan.launches = 0
    kscan.launches_by_kind.update(add=0, max=0)
    kcomp.launches = 0
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
    counts = {
        "scan_i32_add": kscan.launches_by_kind["add"],
        "scan_i32_max": kscan.launches_by_kind["max"],
        "scan_i32": kscan.launches,
        "composite_fwd": kcomp.launches,
    }
    peak = torch.cuda.max_memory_allocated()

    want = {"scan_i32_add": frames, "scan_i32_max": frames, "scan_i32": 2 * frames, "composite_fwd": frames}
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


def phase_profile(splats, cams, cfg):
    """Optional (--profile): torch.profiler over a few frames — the device's
    busy share of the window and the kernels that take most device time."""
    from torch.profiler import ProfilerActivity, profile

    gt.render(splats, cams[0], cfg, backend="auto")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gt.render(splats, cams[0], cfg, backend="auto")  # absorbs the tracer's start-up
        torch.cuda.synchronize()
        t0 = time.time()
        for cam in cams:
            gt.render(splats, cam, cfg, backend="auto")
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
    frames_total = len(cams) + 1  # the traced window holds one extra frame
    top = sorted(((tot, name, cnt) for name, (tot, cnt) in kernels.items()), reverse=True)
    busy_ms_per_frame = sum(t for t, _, _ in top) / 1e3 / frames_total
    frame_ms = wall_ms / len(cams)
    emit("profile", frames=len(cams), frame_ms_traced=frame_ms, device_busy_ms_per_frame=busy_ms_per_frame,
         device_busy_share=busy_ms_per_frame / frame_ms if frame_ms else None,
         kernel_launches_per_frame=sum(c for _, _, c in top) / frames_total,
         note="frame_ms_traced is host wall time with the tracer on, longer than an untraced frame",
         top=[{"name": name[:90], "device_ms_per_frame": tot / 1e3 / frames_total, "calls_per_frame": cnt / frames_total}
              for tot, name, cnt in top[:14]])


def phase_kernels(splats, cam, cfg, counts):
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
            "replaces": replaces, "launches": counts[f"scan_i32_{kind}"], "length": length,
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
    ap.add_argument("--verbose-build", action="store_true",
                    help="print what ptxas reports for each kernel (registers, shared memory, spills)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace three frames with torch.profiler (device busy share, top kernels)")
    args = ap.parse_args()

    t0 = time.time()
    card = phase_device()
    phase_build(args.verbose_build)
    phase_checks()
    phase_reference()
    splats, cams, cfg, counts = phase_main_path(args.splats, args.width, args.height, args.frames)
    phase_stages(splats, cams[0], cfg)
    if args.profile:
        phase_profile(splats, cams[:3], cfg)
    rows = phase_kernels(splats, cams[0], cfg, counts)
    emit("done", seconds=round(time.time() - t0, 1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
