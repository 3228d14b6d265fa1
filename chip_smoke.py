#!/usr/bin/env python3
"""Smoke run of gsplat_tpu_torch on one NVIDIA GPU: the quickest proof that the
port still builds, starts and renders on the card.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, each printing one JSON line; any failure exits non-zero:

  device     torch.cuda must be there; prints the card's name and power limit.
  build      compiles csrc/*.cu with nvcc (one process per source, in
             parallel) and loads the libraries.
  checks     every kernel against its plain PyTorch version on the card at
             small and ragged shapes (scan: bit-equal at every length, in
             200 back-to-back calls of alternating kind and length with its
             scratch poisoned by random words, and - in a child process
             under a timeout of its own - after two scratch growths into a
             handed-back block that holds the next epoch's tags; captured
             in a CUDA graph at 1M (add) and 2,359,296 (max) and replayed
             with new inputs, bit-equal, also across forced epoch wraps,
             one launch counted and one device operation traced a replay;
             compositor: image max|diff| < 1e-5 and equal stop counters,
             every forward call run twice (bit-equal) and through its audit
             instance (no pixel with alpha != 0 in a warp its mask skipped,
             the same image, and exactly the plain mask's kept (pair, warp)
             couples); its checkpoint variant:
             the same image and counters bit for bit; backward compositor:
             every gradient-space row within 1e-5 of the row's max, the packed
             bf16 halves within one bf16 step - the two sides add 1024 pixels
             in different orders; segment sum (on the pair-major gradient
             space): within 1e-6 of the row's max and bit-equal between two
             runs; the compositors' depth-test mode and the forward's
             wireframe mode (hard and soft configs) by the same gates; the ALU probe's float32 chains
             bit-equal to their plain versions and its expf chain within 1e-6,
             at two link counts, one link moving nearly every value and the
             values hanging on their inputs; the gather probe's float64 sums
             within 1e-9 of the summed magnitudes and bit-equal between two
             runs, its writes bit-equal, at one query and at a block span one
             past the staging tile too; both compositors in the strided/offset
             tile mapping of the sharded renderer on the grids (2, 2) at (0, 0)
             and (1, 1), (1, 4) at (0, 3), (4, 1) at (3, 0) and a contiguous
             strip at tile row 17: the forward and its checkpoint variant
             bit-equal, the backward rows as above; the projection's two
             kernels at N = 1, 255, 257 and 1M over sh_order 0-3 x
             tight_footprint x only_sh, in front of the camera, half behind
             it and with an explicit camera position, with a black splat of
             zero SH and an axis-aligned one: the forward bit-equal to its
             plain version, the backward bit-equal or within 1e-6 of each
             field's max to its plain version (the analytic VJP), and both
             backwards within 2e-4 of each field's max and in the 2-norm of
             autograd through the plain forward; with NaN inputs the
             forward NaN where the plain version is, bit-equal elsewhere;
             every forward also in the serving frame's form, sanitized and
             quantized to each payload dtype, bit-equal to its plain
             version, and every backward also in its masked form, the
             gradient of those fields).  The frame glue (gather_payload,
             its float32 rows for the differentiable frame, scatter_payload,
             mark_owners, expand_pairs) bit-equal to its plain versions in
             every mode (packed, float32 and bf16 payloads, the depth test,
             wireframe, soft cutoff, a strided cell at an offset, the SAT
             cull off through GSPLAT_SAT_MAX_N's threshold, int64 and int32
             orders, a budget
             that drops pairs, a (tile, rank) key too wide for 31 bits, the
             gradient map's ranks) at N = 1, 257 and 100k, at the main
             path's 1M splats at 1080p, and on a scene half behind the
             camera; and bin_splats through the kernels bit-equal to
             bin_splats through the plain versions in the frame's form
             (operands) and the order= form with the gradient map.
             Every backward call, here and in
             the kernels phase, also runs twice (bit-equal) and through its
             audit instance (no pixel with alpha != 0 in a warp the reach
             test skipped).  Every time below is taken by
             utils/profiling.py.
  reference  a small scene rendered through the main path against the
             plain tiled renderer and the O(N*H*W) oracle, and its gradient
             through the kernels against autograd through the plain tiled
             renderer; the same with the depth test against a slanted plane;
             a small wireframe against the O(N*H*W) wireframe oracle.  The
             plain side projects through project_fields_plain under autograd
             and bins through the frame glue's plain versions (plain_path),
             so it shares no such kernel with the main path:
             no launch of project_fwd or project_bwd is counted there.
  sharded_path  4 ranks (processes started with the spawn method, one gloo
             group) sharing the one card render the main path's scene and
             settings through render_sharded on the cyclic 2 x 2 tile grid:
             five frames (launch counters zeroed before, read after, on each
             rank) within eps * max colour of the single-device frame (the
             early stop sits on each segment's chunk grid, which moves with
             the strip); at transmittance_eps 0 bit-equal to the
             single-device frame under the f32 gather, the bf16 gather and
             the tuned strip exchange, no pair or column dropped; one
             gradient within 2e-4 of the single-device one (of each field's
             own max|g| with no floor, and in the 2-norm; a zero gradient
             must fail the gate); each rank's strided kernels against their
             plain versions and timed one rank at a time.  Times of 4
             processes on one card are no scaling number.  Then, in this
             process, the gradient taken apart: each rank's strip gradient
             bit-equal to the full-frame one masked to its tiles, and the
             ranks' gradient bit-equal to the rank-order float32 sum of those
             carried through the projection.
  sharded_train_path  4 ranks, dp 2 x sp 2: make_sharded_train_step takes
             three steps on the train path's scene and targets (orbit cameras
             0 and 1, eps 0); the first loss within 1e-5 of the mean of the
             two single-device make_train_step losses, each rank's gradient
             block within 2e-4 of the single-device mean in the 2-norm (a
             zero gradient and a step without the dp mean must fail that
             gate; the max-norm error is printed beside the single-device
             gradient's own under an ulp's nudge of the loss), losses
             falling, nothing dropped.
  nccl_group one rank a card in an NCCL group joined through the standard
             environment (env://): the collectives on CUDA tensors, no host
             staging, against the ranks' seeded inputs.
  main_path  1,000,000 splats at 1920x1080, packed payload, eps 1e-3, pair
             budget tuned: five frames from an orbit through render(...,
             backend="auto", with_stats=True).  Launch counters are zeroed
             just before and read just after.  Then the same frame captured
             in a CUDA graph (gsplat_tpu_torch.graphs.capture, as bench.py
             jits it) and replayed over the five cameras, each camera's
             matrices copied into the captured camera's tensors: each image
             bit-equal to the eager frame of its camera, dropped_pairs 0,
             the counters (zeroed, read) 2 scans + 1 projection (in its
             payload form) + 1 gather_payload + 1 mark_owners + 1
             expand_pairs + 1 forward a replay, and one replay's trace
             holding the same kernels;
             median_graph_frame_ms beside median_frame_ms.
  stages     the main path's stages timed one by one (where a frame's time
             goes), and bin_splats taken apart (prefix sum, mark_owners,
             prefix max, expand_pairs, key sort, the rest).
  train_path the same scene and configuration under make_train_step with
             default_optimizer: steps towards a target rendered from the
             scene with perturbed colours and positions.  Launch counters
             are zeroed just before and read just after.  On the card the
             step is captured (call 1 eager, call 2 captured and replayed,
             then replays); beside it the same four lines run eagerly here
             with the same capturable optimizer from the same start: the
             losses and the parameters bit-equal, the same counts, and a
             replay's trace holding 4 scans, 1 projection forward (payload
             form) and 1 backward (masked), 1 gather_payload, 1
             scatter_payload, 1 mark_owners, 1 expand_pairs, 1 forward, 1
             backward and 1 segment sum;
             median_step_ms (captured) beside
             median_eager_step_ms.
  train_stages  one training step taken apart (where a step's time goes).
  trained_path  the JAX package's trained-statistics configuration at full
             size (bench.py --scene trained): trained_like_splats(1M,
             extent 1.2, sh_scale 0.1, seed 0), three orbit cameras at
             1920x1080, packed, eps 1e-3, the budget tuned at headroom 1.02,
             tile_capacity 4096 unless a tile of those frames holds more
             pairs, then the smallest multiple of the chunk that drops none
             (printed).  The binning of camera 0's whole frame: the frame
             glue and the scans on the frame's own counts and marks
             bit-equal to their plain versions, and bin_splats through the
             kernels bit-equal to bin_splats through the plain versions, with
             and without the gradient map (the key form, packed or wide, and
             whether the exact-coverage cull ran printed); the frames through
             render(), eager and captured (each replay bit-equal to its eager
             frame); bench.py's forward+backward (the gradient of
             sum(render(...)[..., :3]) over the six fields) eager and
             captured in a CUDA graph, every call and replay bit-equal to the
             first eager one; make_train_step's captured step as train_path
             runs it (losses and parameters bit-equal to the eager four
             lines); dropped_pairs 0 in every frame, gradient and step, the
             launch counters zeroed before and read after each part against
             the expected counts; then every kernel the path launched held
             to its plain version at the path's inputs (the thresholds of
             scripts/verify_tpu.py:111-115 or tighter: images within 1e-5 and
             bit-equal stop counters, the backward's rows within 1e-5 of each
             row's max, the segment sum's within 2e-4 of each row's max
             and 2-norm (its plain version adds with atomics), project_bwd within
             1e-6 of each field's max and 2e-4 in the 2-norm, the frame glue
             and the scans bit-equal), the plain versions on the whole frame,
             the backward and the segment sum on the gradient frame's image
             cotangent; their rows (names ending in @trained) on the kernels
             line.  Prints splats, size, capacity, chunk, budget, each
             camera's pairs, dropped_pairs, the medians (frame, gradient,
             step, eager and captured), the losses, peak memory, graph pool
             bytes, launches and the phase's seconds.
  envelope_path  the reference's 2^23 budget envelope (bench.py:30-43):
             8,388,608 splats of the main path's scene, tile_capacity 16384
             (raised as above to the smallest multiple of 256 that drops
             none, printed), chunk 256 (the backward at 210 KB of shared
             memory, one block an SM); the same checks and numbers as
             trained_path but the step (the binning takes the wide
             (tile, rank) key and skips the exact-coverage cull above
             GSPLAT_SAT_MAX_N), and bench.py's wireframe frame
             (render_wireframe, float32 payload, the untuned budget; its
             dropped_pairs printed, its band test held to the plain version;
             rows ending in @envelope).
  host_scene_path  the same scene composited into a host scene: float32
             payload, the depth test against a slanted plane of view depth
             2.0 -> 3.5 and an opaque grey scene colour; five frames, a check
             that the plane kills pixels, one full-size gradient of an L1 loss
             through the depth-tested render, three wireframe frames and three
             wire-over frames.  Launch counters are zeroed just before each
             part and read just after.
  scene_path the host runtime at full width: the main path's scene written
             with save_ply into a temporary directory (outside the repo)
             and loaded back on the card with load_ply (positions within
             1e-6, opacities within 1e-5: the JAX package's round-trip
             gates), registered as two clusters (rows [0, n/2) and
             [n/2, n)) in a SceneRegistry with the main path's settings and
             a pair budget tuned on the loaded scene, and the five orbit
             frames rendered through include_in_render_pass / render /
             post_render, re-sorted every frame and then sorted once (a
             movement threshold above the orbit's): launch counters zeroed
             just before and read just after (2 scans + 1 projection +
             1 gather_payload + 1 mark_owners + 1 expand_pairs + 1 forward
             a frame),
             the registry's deferred dropped_pairs 0, each frame bit-equal
             to render_cuda of the registry's cached rebased scene with its
             origin camera and the order it used, at most 1e-3 of the
             pixels beyond 2e-3 of the direct render of the loaded scene
             (every frame re-sorted, frame 0 sorted once; the aged order's
             share is printed); 4096 ray queries against a numpy slab
             test (hits equal); the native helpers (built with g++) against
             their plain versions.  Prints the save, load, geometry, frame
             and overhead times beside the direct frame's.
  examples   examples/render_ply_torch.py on that PLY at 1280x720 (an image
             written, alpha not all zero) and examples/fit_scene_torch.py
             --steps 20 (a falling loss), each in a child process.
  ply_fit    the JAX package's PLY fit gate through the kernels: the
             heavy-tailed 800-splat scene through save_ply and load_ply,
             4 views at 96x96, a seeded perturbation, 120 Adam steps round
             robin (one captured make_train_step a view, one optimizer);
             view 0 must end above 26 dB and its start + 3 dB.
  calibrate  the speed-of-light constants measured on this card
             (gsplat_tpu_torch/utils/sol_calibrate.py: ALU probe, gather probe
             on the main path's indices and on random ones, torch.sort, HBM
             copy), then sol_ms and sol_fraction of the serving frame, the
             training step and the host-scene frame.  Probe counters are
             zeroed just before and read just after.
  kernels    each kernel at the shapes (and, for the compositors, the very
             inputs) of its path: error against the plain version, its time,
             the plain version's, a library call's where one exists, and the
             least time the card could take (bound, from utils/sol.py: the
             data sheet's rates; bound_measured_ms at this run's rates; the
             compositors priced on the pixel updates with alpha != 0, the
             all-pixel bound beside; the forward rows with the warps a pair
             has live, reaches and keeps; the segment sum's bound on 32-byte
             sectors beside its useful-byte bound, and its time on a float32
             space); the scans' device operations a call from a profiler
             trace; the strided rows at rank 0's inputs on the sharded path;
             the projection's forward at the main path's inputs (in the
             serving frame's payload form, the raw form's time beside it)
             and its backward at the train path's, each with its device
             time from a trace and its share of the bytes bound;
             gather_payload, mark_owners and expand_pairs at the main
             path's inputs, with the same, and index_select's and
             scatter_reduce_'s times beside the gather and the marks.
             The scan, forward, projection and glue rows' launches are the
             main path's and the scene path's registry frames
             (launches_by_path).  The rows of trained_path and envelope_path
             come after them, their bounds priced at this run's rates here.

--profile also traces three frames and three training steps, eager and
replayed from their graphs, and prints each one's device_busy_share.

python3 chip_smoke.py --frame-digest prints only the SHA-256 of the main
path's first frame and of its forward kernel's image and stop counters, to
hold the kernels of two trees to each other.

The last line is {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import dataclasses
import datetime
import itertools
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False - this script needs a CUDA card\n")
    sys.exit(1)

import gsplat_tpu_torch as gt
from gsplat_tpu_torch import graphs
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.ops import wireframe as wire
from gsplat_tpu_torch.ops import kernels as kernel_table
from gsplat_tpu_torch.ops.kernels import _build
from gsplat_tpu_torch.ops.kernels import frame_glue as kglue
from gsplat_tpu_torch.ops.kernels import composite as kcomp
from gsplat_tpu_torch.ops.kernels import probes as kprobes
from gsplat_tpu_torch.ops.kernels import projection as kproj
from gsplat_tpu_torch.ops.kernels import scan as kscan
from gsplat_tpu_torch.ops.kernels import segsum as ksegsum
from gsplat_tpu_torch.ops.projection import ProjectedSplats, project_splats
from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, sanitize_projected
from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth
from gsplat_tpu_torch.parallel import collectives as coll
from gsplat_tpu_torch.parallel import render_sharded as rsh
from gsplat_tpu_torch.render import render_strip
from gsplat_tpu_torch.train.loss import render_loss
from gsplat_tpu_torch.utils import profile_gather, sol, sol_calibrate
from gsplat_tpu_torch.utils.profiling import PhaseTimer, cuda_time_ms, measure_fps, start_trace, stop_trace

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
# The large configurations' segment sums (trained_path, envelope_path) are
# held at the on-chip gate's gradient threshold (GRAD_TOL) of each row's max
# and in its 2-norm: a splat there has up to hundreds of pairs, and the plain
# version adds them with index_add_'s atomics, whose order changes from run
# to run (on the trained scene the kernel's worst row read 8.1e-7 and
# 1.02e-6 of the row's max against two plain runs on the same inputs).
# Whole-render gradients against autograd through the plain tiled renderer
# (the thresholds of the JAX package's on-chip gate): relative to
# max(1, |g|max) of the field.  The sharded paths hold their gradients to the
# single-device ones by the same number with no floor (grad_rel_err).
GRAD_TOL = 2e-4
GRAD_TOL_PACKED_COLOR = 2e-2
SPLAT_FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")

# ALU probe against its plain chain: the two float32 chains bit for bit (the
# fused link is exact in float64 and rounded once), the expf chain (torch.exp
# against the kernel's expf, either may round a link differently) within
# ALU_TOL relative to the value; gather probe sums in float64 in another
# order, relative to the sum of the magnitudes.
ALU_TOL = 1e-6
GATHER_TOL = 1e-9
# Wireframe kernel path against the O(N*H*W) oracle: the share of pixels at
# band corners the binning box misses (see phase_reference).
WIRE_EDGE_SHARE = 1e-3
# Bounds: utils/sol.py, at the data sheet's rates (bound_ms) and at this
# run's measured rates (bound_measured_ms) once the calibrate phase has run.
DEVICE = dict(sol.H100)
LINE_PX = 1.0
TRACE_DIR = "build/traces"


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


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
    """The main path's own stages up to the compositor (render_cuda's):
    project_fwd writing sanitized, quantized fields, the depth order,
    gather_payload (the payload the forward kernel reads: packed, or the
    float32 rows, row 10 = view-z with cfg.depth_test) and the binning on
    its operands, with the gradient map if asked."""
    nty, ntx = binning.tile_grid(cam.width, cam.height, cfg.tile_h, cfg.tile_w)
    fields = project_splats(splats, cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff,
                            only_sh=cfg.only_sh, payload_dtype=cfg.payload_dtype).fields
    glue = binning.gather_frame(fields, torch.argsort(fields[10], stable=True), cam.width, cam.height, cfg)
    b = binning.bin_splats(None, cam.width, cam.height, cfg, with_tiles=False, with_grad_map=with_grad_map,
                           operands=glue.operands)
    return (glue.payload, b.pair_splat, b.tile_base, b.tile_phi, b.tile_span, nty, ntx, cam.height, cam.width,
            cfg), b


def occluder(width, height):
    """A slanted plane of view depth 2.0 -> 3.5 across the image and an opaque
    grey scene colour (the JAX package's tests/test_depth_composite.py)."""
    xs = torch.linspace(0, 1, width, device=DEV)[None, :]
    bgd = ((2.0 + 1.5 * xs) * torch.ones((height, 1), device=DEV)).contiguous()
    bg_rgba = torch.cat([torch.full((height, width, 3), 0.3, device=DEV),
                         torch.ones((height, width, 1), device=DEV)], dim=-1)
    return bgd, bg_rgba


def compare_compositor(args, label, bgd=None, offsets=(0, 0)):
    """The forward against its plain version (image within IMAGE_TOL, stop
    counters equal) and its warp mask audited (audit_forward)."""
    img_k, used_k = kcomp.composite_splats(*args, bg_depth=bgd, offsets=offsets)
    torch.cuda.synchronize()
    audit_forward(args, img_k, used_k, label, bgd, offsets)
    img_p, used_p = kcomp.composite_splats_plain(*args, bg_depth=bgd, offsets=offsets)
    torch.cuda.synchronize()
    if img_k.shape != img_p.shape or not torch.isfinite(img_k).all():
        fail(f"compositor {label}: bad output {tuple(img_k.shape)}")
    err = float((img_k - img_p).abs().max())
    used_equal = bool(torch.equal(used_k, used_p))
    if not (err < IMAGE_TOL) or not used_equal:
        fail(f"compositor {label}: max|diff| {err:.3e} (tolerance {IMAGE_TOL}), used equal: {used_equal}")
    return err, used_k


# Forward calls audited in this process: both runs bit-equal, the audit
# instance found no skipped pixel with α != 0 and kept exactly the plain
# mask's (pair, warp) couples.
AUDITED_FWD = {"two_runs": 0, "audit_instance": 0, "skipped_live_pixels": 0}


def audit_forward(args, img, used, label, bgd=None, offsets=(0, 0)):
    """The forward's warp mask on these inputs: a second run bit-equal to the
    first, and the audit instance, which evaluates α in every warp the mask
    skipped, finding no pixel with α != 0, writing the same image and stop
    counters bit for bit, and keeping exactly the (pair, warp) couples of
    the plain mask (kcomp.walked_pair_counts' kept_warps)."""
    img2, used2 = kcomp.composite_splats(*args, bg_depth=bgd, offsets=offsets)
    if not (torch.equal(img, img2) and torch.equal(used, used2)):
        fail(f"composite_fwd {label}: two runs on the same input differ")
    AUDITED_FWD["two_runs"] += 1
    a_img, a_used, skipped, kept = kcomp.composite_splats_audit(*args, bg_depth=bgd, offsets=offsets)
    plain_kept = pair_counts(args, used, bgd, offsets)["kept_warps"]
    same = bool(torch.equal(a_img, img) and torch.equal(a_used, used))
    if skipped != 0 or not same or kept != plain_kept:
        fail(f"composite_fwd {label}: the warp mask skipped {skipped} pixels with alpha != 0, kept {kept} "
             f"(pair, warp) couples against the plain mask's {plain_kept} (audit output bit-equal: {same})")
    AUDITED_FWD["audit_instance"] += 1


def zero_counters():
    """Every launch counter of the table (gsplat_tpu_torch/ops/kernels/__init__.py) to 0."""
    kernel_table.zero()


def read_counters():
    """Every launch counter of the table, by name."""
    return kernel_table.counts()


def expect_counts(**launched):
    """Every counter 0 but those named."""
    want = {k: 0 for k in read_counters()}
    want.update(launched)
    return want


def frame_counts(frames):
    """The launch counts of `frames` serving frames (phase_main_path's)."""
    return expect_counts(scan_i32_add=frames, scan_i32_max=frames, scan_i32=2 * frames, composite_fwd=frames,
                         project_fwd=frames, project_fwd_payload=frames, gather_payload=frames,
                         expand_pairs=frames, mark_owners=frames)


def gradient_counts(calls):
    """The launch counts of `calls` gradient frames (a training step's
    kernels: 4 scans, the checkpointed forward, the backward, the segment
    sum, the projection both ways and the frame glue both ways)."""
    return expect_counts(scan_i32_add=calls, scan_i32_max=3 * calls, scan_i32=4 * calls,
                         composite_fwd=calls, composite_fwd_checkpoint=calls, composite_bwd=calls, segsum=calls,
                         project_fwd=calls, project_fwd_payload=calls, project_bwd=calls, gather_payload=calls,
                         scatter_payload=calls, expand_pairs=calls, mark_owners=calls)


def backward_inputs(splats, cam, cfg, seed):
    """The gradient path's own stages up to the backward kernel: binning with
    the gradient map, and a seeded cotangent."""
    fwd, b = compositor_inputs(splats, cam, cfg, with_grad_map=True)
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    d_out = torch.randn((cam.height, cam.width, 4), generator=g, device=DEV)
    g_pad = binning.grad_pad_size(b.dest_of_exp.shape[0], fwd[5] * fwd[6], cfg.chunk)
    return fwd, b, d_out, g_pad


def compare_checkpoint(fwd, label, bgd=None, offsets=(0, 0)):
    """The checkpoint variant: image and stop counters bit-equal to the
    variant without, checkpoints equal to the plain version's on the chunks
    a tile walked."""
    img, used = kcomp.composite_splats(*fwd, bg_depth=bgd, offsets=offsets)
    img_c, used_c, tchk = kcomp.composite_splats(*fwd, checkpoint=True, bg_depth=bgd, offsets=offsets)
    torch.cuda.synchronize()
    if not (torch.equal(img, img_c) and torch.equal(used, used_c)):
        fail(f"checkpoint variant {label}: image or stop counters differ from the variant without")
    _, _, tchk_p = kcomp.composite_splats_plain(*fwd, checkpoint=True, bg_depth=bgd, offsets=offsets)
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
    """The pair-major gradient space, (G, 9) float32 or (G, 8) int32, as nine
    float32 rows (9, G), one a sum."""
    if not packed:
        return gspace.t()
    cg, cb = kcomp.unpack2(gspace[:, 6])
    return torch.cat([gspace[:, 0:6].view(torch.float32).t(), cg[None], cb[None],
                      gspace[:, 7:8].view(torch.float32).t()], dim=0)


# Backward calls audited in this process: both runs bit-equal, and (hard
# cutoff) the audit instance found no skipped pixel with α != 0.
AUDITED = {"two_runs": 0, "audit_instance": 0}


def audit_backward(args, got, label, bgd=None, offsets=(0, 0)):
    """The backward's reach test on these inputs: a second run bit-equal to
    the first, and (hard cutoff) the audit instance, which evaluates α in
    every warp the test skipped, finding no pixel with α != 0 and writing the
    same gradient space bit for bit.  Returns the skipped live pixels (None
    in soft mode, which has no reach test)."""
    again = kcomp.composite_bwd(*args, bg_depth=bgd, offsets=offsets)
    if not torch.equal(got, again):
        fail(f"composite_bwd {label}: two runs on the same input differ")
    AUDITED["two_runs"] += 1
    if args[-1].soft_cutoff:
        return None
    audited, skipped = kcomp.composite_bwd_audit(*args, bg_depth=bgd, offsets=offsets)
    if skipped != 0 or not torch.equal(audited, got):
        fail(f"composite_bwd {label}: the reach test skipped {skipped} pixels with alpha != 0 "
             f"(audit output bit-equal: {bool(torch.equal(audited, got))})")
    AUDITED["audit_instance"] += 1
    return skipped


def compare_backward(fwd, b, used, tchk, d_out, g_pad, label, bgd=None, offsets=(0, 0)):
    """composite_bwd against composite_bwd_plain, row by row, and its reach
    test audited (audit_backward)."""
    cfg = fwd[-1]
    packed = cfg.payload_dtype == "packed"
    args = fwd[:5] + (used, b.grad_base, d_out, tchk, g_pad) + fwd[5:]
    got = kcomp.composite_bwd(*args, bg_depth=bgd, offsets=offsets)
    torch.cuda.synchronize()
    audit_backward(args, got, label, bgd, offsets)
    want = kcomp.composite_bwd_plain(*args, bg_depth=bgd, offsets=offsets)
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


def compare_segsum(gspace, b, packed, label, tol=SEGSUM_TOL, norm_tol=None):
    """segsum_by_splat against its plain version: each row within `tol` of
    the row's max (and, with `norm_tol`, of its 2-norm), two runs
    bit-equal, the storage-order result the rank-order one permuted, empty
    ranks exact zeros."""
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
        if err > tol * scale:
            fail(f"segsum {label}: row {r} differs by {err:.3e} (row max {scale:.3e})")
        norm = float(want[r].norm())
        if norm_tol is not None and float((got[r] - want[r]).norm()) > norm_tol * norm:
            fail(f"segsum {label}: row {r} differs by more than {norm_tol} of its 2-norm {norm:.3e}")
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


def strided_inputs(splats, cam, cfg, strides, offsets, strip_h, strip_w, with_grad_map=False):
    """One strip's compositor inputs under the strided tile mapping: the
    whole frame's projected splats, binned into the (strip_h, strip_w) strip
    whose local tile (ty, tx) is the frame's tile (offsets[0] +
    ty*strides[0], offsets[1] + tx*strides[1])."""
    cfg = dataclasses.replace(cfg, row_stride=strides[0], col_stride=strides[1])
    p = project_splats(splats, cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff)
    p = sort_by_depth(quantize_payload(sanitize_projected(p), cfg))
    b = binning.bin_splats(p, strip_w, strip_h, cfg, row_offset=offsets[0], col_offset=offsets[1],
                           with_tiles=False, with_grad_map=with_grad_map)
    nty, ntx = binning.tile_grid(strip_w, strip_h, cfg.tile_h, cfg.tile_w)
    payload = kcomp.pack_payload(p.fields) if cfg.payload_dtype == "packed" else p.fields[:10].contiguous()
    return (payload, b.pair_splat, b.tile_base, b.tile_phi, b.tile_span, nty, ntx, strip_h, strip_w, cfg), b


def check_strided(fwd, b, offsets, label, seed):
    """Both compositors in the strided mode against their plain versions:
    the forward (and its checkpoint variant) bit for bit, the backward rows
    within GRAD_ROW_TOL.  Returns (backward worst row rel err, tiles that
    stopped early)."""
    err, used = compare_compositor(fwd, label, offsets=offsets)
    if err != 0.0:
        fail(f"strided compositor {label}: not bit-equal to its plain version (max|diff| {err:.3e})")
    used_c, tchk, _ = compare_checkpoint(fwd, label, offsets=offsets)
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    d_out = torch.randn((fwd[7], fwd[8], 4), generator=g, device=DEV)
    g_pad = binning.grad_pad_size(b.dest_of_exp.shape[0], fwd[5] * fwd[6], fwd[-1].chunk)
    _, e_bwd, _ = compare_backward(fwd, b, used_c, tchk, d_out, g_pad, label, offsets=offsets)
    if pairs_walked(used, b) == 0:
        fail(f"strided compositor {label}: the strip walked no pairs")
    return e_bwd, int((used < b.tile_span).sum())


# (strides, offsets in tiles) of the strided checks: the cyclic grids of the
# sharded renderer, and a contiguous strip at a row offset
STRIDED_CHECKS = (((2, 2), (0, 0)), ((2, 2), (1, 1)), ((1, 4), (0, 3)), ((4, 1), (3, 0)), ((1, 1), (17, 0)))


class _PlainProjectSplats:
    """Stands in for ProjectSplats: the plain forward (and, with a payload
    dtype, the plain sanitize and quantize), differentiated by autograd, in
    place of the two kernels."""

    @staticmethod
    def apply(*args):
        *inputs, payload_dtype = args
        raw = kproj.project_fields_plain(*inputs)
        return raw if payload_dtype is None else kproj.payload_fields_plain(raw, payload_dtype)


@contextlib.contextmanager
def plain_path():
    """project_splats through its plain forward under autograd, and the
    frame glue (gather_payload, scatter_payload, mark_owners, expand_pairs)
    through their plain versions, for the plain side of a comparison: on
    CUDA tensors project_splats and the binning otherwise run project_fwd,
    project_bwd and the glue kernels, whatever the renderer's backend.
    Fails if one of those kernels launched inside."""
    from gsplat_tpu_torch.ops import projection as proj_mod

    glue = ("gather_payload", "scatter_payload", "mark_owners", "expand_pairs")
    watched = ("project_fwd", "project_bwd") + glue
    before = {k: read_counters()[k] for k in watched}
    saved = (proj_mod.ProjectSplats,) + tuple(getattr(kglue, k) for k in glue)
    proj_mod.ProjectSplats = _PlainProjectSplats
    for k in glue:
        setattr(kglue, k, getattr(kglue, f"{k}_plain"))
    try:
        yield
    finally:
        proj_mod.ProjectSplats = saved[0]
        for k, fn in zip(glue, saved[1:]):
            setattr(kglue, k, fn)
    if {k: read_counters()[k] for k in watched} != before:
        fail("a projection or frame-glue kernel launched on the plain side of a comparison")


def splat_grads(splats, cam, cfg, weights, backend, bgd=None):
    leaves = {f: getattr(splats, f).detach().clone().requires_grad_(True) for f in SPLAT_FIELDS}
    image = gt.render(dataclasses.replace(splats, **leaves), cam, cfg, backend=backend, background_depth=bgd)
    (image * weights).sum().backward()
    return {f: leaves[f].grad for f in SPLAT_FIELDS}


def grad_rel_err(got, want, scale):
    """A gradient block against its reference: {"max": max|got - want| over
    the field's own max|g| over the whole scene (`scale`, no floor), "l2":
    the 2-norm of the difference over the 2-norm of `want`}."""
    norm = float(want.norm())
    if not bool(torch.isfinite(got).all()):
        return {"max": math.inf, "l2": math.inf}
    return {"max": float((got - want).abs().max()) / scale if scale > 0 else math.inf,
            "l2": float((got - want).norm()) / norm if norm > 0 else math.inf}


def worst_entries(got, want, other, k=3):
    """The k entries where got and want differ most, with `other` beside."""
    idx = torch.topk((got - want).abs().flatten(), k).indices.tolist()
    return [[float(t.flatten()[i]) for t in (got, want, other)] for i in idx]


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
    kproj._library()
    kglue._library()
    emit("build", seconds=round(time.time() - t0, 2), directory=str(out),
         sources=sorted(f"gsplat_tpu_torch/csrc/{n}.cu" for n in _build.EXTRA_FLAGS))


def check_alu(x, steps, variant, label):
    """The ALU probe at `steps` and at `steps` - 1 links against its plain
    chain: the float32 chains bit for bit, the expf chain within ALU_TOL.
    The comparison can fail: one link fewer must move nearly every value by
    more than the tolerance (a float32 sum of eight chains can round back to
    its old value, rarely), and the values must differ across x.  So a
    kernel that ran fewer links, or lost its start, cannot pass.  Returns
    (max abs err, max rel err) at `steps`."""
    exact = variant != "expf"
    tol = 0.0 if exact else ALU_TOL
    out = []
    for st in (steps, steps - 1):
        got = kprobes.alu_probe(x, st, variant)
        want = kprobes.alu_probe_plain(x, st, variant)
        rel = float(((got - want).abs() / want.abs()).max())
        if not torch.isfinite(got).all() or (exact and not torch.equal(got, want)) or not rel <= ALU_TOL:
            fail(f"alu_probe[{variant}] {label}, {st} links: relative error {rel:.3e} "
                 f"({'bit-equal required' if exact else f'tolerance {ALU_TOL}'})")
        out.append((got, float((got - want).abs().max()), rel))
    (got, err, rel), (fewer, _, _) = out
    still = float(((fewer - got).abs() <= tol * got.abs()).float().mean())
    if still > 1e-3:
        fail(f"alu_probe[{variant}] {label}: one link fewer leaves {still:.2e} of the values within the tolerance")
    if torch.unique(got).numel() <= min(x.numel() // 8, 1000):
        fail(f"alu_probe[{variant}] {label}: the values hardly depend on x")
    return err, rel


def check_probes():
    """Both probes against their plain versions at small and ragged shapes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=DEV)
    g.manual_seed(7)
    out = {"alu_max_rel_err": {}, "gather_max_abs_err": {}}
    for n in (sms * kprobes.THREADS, 1000):
        x = torch.rand((n,), generator=g, device=DEV) * 0.5 + 0.25
        for variant in kprobes.ALU_VARIANTS:
            _, rel = check_alu(x, 64, variant, f"n={n}")
            out["alu_max_rel_err"][variant] = max(out["alu_max_rel_err"].get(variant, 0.0), rel)
    # one query; a few; a block's span one past the staging tile, so that
    # every block of the column sweeps takes a second, one-query tile
    sweep_edge = kprobes.GATHER_TILE * kprobes.gather_blocks(DEV, "column") + 1
    for n_cols, p in ((1 << 16, 100_003), (1000, 7), (1000, 1), (1 << 16, sweep_edge)):
        mat = torch.randn((kprobes.PROBE_ROWS, n_cols), generator=g, device=DEV)
        idx = torch.randint(0, n_cols, (p,), generator=g, device=DEV, dtype=torch.int32)
        for access in kprobes.GATHER_ACCESSES:
            m = mat.t().contiguous() if access == "row" else mat
            if access == "column_write":
                got = kprobes.gather_probe(torch.zeros_like(mat), idx, access)
                want = kprobes.gather_probe_plain(torch.zeros_like(mat), idx, access)
                err = 0.0 if torch.equal(got, want) else float((got - want).abs().max())
                ok = err == 0.0
            else:
                got_t = kprobes.gather_probe(m, idx, access)
                if not torch.equal(got_t, kprobes.gather_probe(m, idx, access)):
                    fail(f"gather_probe[{access}] ({n_cols} columns, {p} queries): two runs differ")
                got = float(got_t)
                want = float(kprobes.gather_probe_plain(m, idx, access))
                scale = float(kprobes.gather_probe_plain(m.abs(), idx, access))
                err = abs(got - want)
                ok = err <= GATHER_TOL * max(scale, 1.0)
            if not ok:
                fail(f"gather_probe[{access}] ({n_cols} columns, {p} queries) differs by {err:.3e}")
            out["gather_max_abs_err"][access] = max(out["gather_max_abs_err"].get(access, 0.0), err)
    return out


# The scan stress of the checks: back-to-back calls on one stream, kinds and
# lengths alternating, the scratch poisoned with random words before and
# between them.
SCAN_STRESS_CALLS = 200
SCAN_STRESS_LENGTHS = (1, 4095, 4096, 4097, 1 << 20, 2_359_296, (1 << 24) + 3)


def scan_input(kind, n, g):
    if kind == "add":
        return torch.randint(0, 40, (n,), generator=g, device=DEV, dtype=torch.int32)
    return torch.randint(-(2**31), 2**31 - 1, (n,), generator=g, device=DEV, dtype=torch.int64).to(torch.int32)


def poison_scan_scratch(g):
    """Random 64-bit words over every scratch tensor the scan module holds,
    enqueued on the current stream."""
    for buf in kscan._scratch.values():
        buf.copy_(torch.randint(-(2**63), 2**63 - 1, buf.shape, generator=g, device=DEV, dtype=torch.int64))


def check_scan_stress(g):
    """SCAN_STRESS_CALLS calls alternating kind and length with no host wait
    between them, each bit-equal to its plain version; the scratch poisoned
    before the first and every 25 calls."""
    inputs = {(k, n): scan_input(k, n, g) for k in kscan.KINDS for n in SCAN_STRESS_LENGTHS}
    want = {key: kscan.scan_i32_plain(x, key[0]) for key, x in inputs.items()}
    kscan.scan_i32(inputs[("add", max(SCAN_STRESS_LENGTHS))], "add")  # the scratch at its largest
    calls = []
    for i in range(SCAN_STRESS_CALLS):
        if i % 25 == 0:
            poison_scan_scratch(g)
        key = (kscan.KINDS[i % 2], SCAN_STRESS_LENGTHS[(i // 2) % len(SCAN_STRESS_LENGTHS)])
        calls.append((key, kscan.scan_i32(inputs[key], key[0])))
    torch.cuda.synchronize()
    bad = [(i, key) for i, (key, got) in enumerate(calls) if not torch.equal(got, want[key])]
    if bad:
        fail(f"scan stress: {len(bad)} of {SCAN_STRESS_CALLS} calls differ from the plain version, first {bad[:3]}")
    return len(calls)


# The poisoned-growth check runs in a child process under this limit: with
# a scratch that trusts what the allocator hands back, the look-back can
# spin forever, and a hang must end as a failed check.
SCAN_GROWTH_TIMEOUT_S = 180


def scan_growth_probe():
    """In a fresh process: twice (kind add, then max) an int64 block of the
    size the scan's next scratch growth requests is filled with the tags of
    the epoch a fresh scratch's first call takes (1) - an epoch word of 0,
    both counters (epoch << 32) | 5 and every status word (2 * epoch) << 32,
    an aggregate of 0 ready to be read - and freed, then a scan forces the
    growth.  The caching allocator hands the block back
    (checked by its address); the result must be bit-equal to torch.cumsum /
    torch.cummax.  Prints one JSON line; exit 1 if a result differs."""
    g = torch.Generator(device=DEV)
    g.manual_seed(13)
    dev = torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    out = []
    for kind, n in (("add", 5 * kscan.TILE + 3), ("max", None)):
        held = kscan._scratch.get((dev, stream))
        if n is None:  # a length whose scratch needs twice what is held
            n = (2 * held.numel() - 1) * kscan.TILE
        want_words = max(kscan.scratch_words(n), 0 if held is None else 2 * held.numel())
        x = scan_input(kind, n, g)
        want = (torch.cumsum(x, 0, dtype=torch.int32) if kind == "add" else torch.cummax(x, 0).values)
        e = 1  # the epoch of a fresh scratch's first call (csrc/scan.cu)
        # guards on both sides, so that the freed block cannot merge with
        # free neighbours and go to another request of the call first
        guard0 = torch.empty((64,), dtype=torch.int64, device=DEV)
        poison = torch.full((want_words,), (2 * e) << 32, dtype=torch.int64, device=DEV)
        guard1 = torch.empty((64,), dtype=torch.int64, device=DEV)
        poison[0] = e - 1
        poison[1:3] = (e << 32) | 5
        ptr = poison.data_ptr()
        torch.cuda.synchronize()
        del poison
        got = kscan.scan_i32(x, kind)
        torch.cuda.synchronize()
        del guard0, guard1
        buf = kscan._scratch[(dev, stream)]
        out.append({"kind": kind, "length": n, "scratch_words": buf.numel(), "epoch": e,
                    "block_handed_back": buf.data_ptr() == ptr, "bit_equal": bool(torch.equal(got, want))})
    print(json.dumps(out), flush=True)
    return 0 if all(r["bit_equal"] and r["block_handed_back"] for r in out) else 1


def check_scan_growth():
    """scan_growth_probe in a child process under SCAN_GROWTH_TIMEOUT_S."""
    code = "import sys, chip_smoke; sys.exit(chip_smoke.scan_growth_probe())"
    try:
        res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent,
                             capture_output=True, text=True, timeout=SCAN_GROWTH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"scan growth over a poisoned block: no result within {SCAN_GROWTH_TIMEOUT_S} s (a hang)")
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        fail(f"scan growth over a poisoned block: exit {res.returncode}, {res.stdout[-2000:]} {res.stderr[-2000:]}")
    return json.loads(lines[-1])


SCAN_CAPTURE_REPLAYS = 5
# The test hook's epoch end for the forced wrap: epochs 1 and 2, then the
# last block zeroes the scratch.
SCAN_WRAP_EPOCH_END = 3


def check_scan_capture(g):
    """The scan under CUDA graph capture (gsplat_tpu_torch.graphs.capture):
    a scan of 1M elements (add) and of 2,359,296 (max) captured, replayed
    SCAN_CAPTURE_REPLAYS times with new inputs copied in, each replay
    bit-equal to torch.cumsum / torch.cummax and counted as one launch (the
    capture as none); the same again across forced epoch wraps (the test
    hook's epoch end 3: the scratch is zeroed on the device every second
    call), with an eager call between the replays on the capture stream's
    scratch; and one replay's device operations in a trace: the one kernel,
    no memset."""
    out = {}
    for kind, n in (("add", 1_000_000), ("max", 2_359_296)):
        x = scan_input(kind, n, g)
        plain = (lambda v: torch.cumsum(v, 0, dtype=torch.int32)) if kind == "add" else \
            (lambda v: torch.cummax(v, 0).values)
        res = {}
        for label, end in (("replays", None), ("replays_across_wraps", SCAN_WRAP_EPOCH_END)):
            kscan.set_epoch_end(end)
            try:
                before = kscan.launches_by_kind[kind]
                graph = graphs.capture(lambda: kscan.scan_i32(x, kind))
                if kscan.launches_by_kind[kind] != before + 1:  # the warm-up's launch only
                    fail(f"scan capture [{kind}]: the capture counted launches")
                if graph.launches != {(kscan, "launches", None): 1, (kscan, "launches_by_kind", kind): 1}:
                    fail(f"scan capture [{kind}]: a replay counts {graph.launches}")
                equal = 0
                for r in range(SCAN_CAPTURE_REPLAYS):
                    x.copy_(scan_input(kind, n, g))
                    got = graph.replay()
                    if torch.equal(got, plain(x)):
                        equal += 1
                    if end is not None and r == 1:  # an eager call on the same scratch between replays
                        side = graphs.run_on_capture_stream(kscan.scan_i32, x, kind)
                        if not torch.equal(side, plain(x)):
                            fail(f"scan capture [{kind}]: an eager call between replays differs")
                if equal != SCAN_CAPTURE_REPLAYS:
                    fail(f"scan capture [{kind}] {label}: {SCAN_CAPTURE_REPLAYS - equal} of "
                         f"{SCAN_CAPTURE_REPLAYS} replays differ from the plain version")
                if kscan.launches_by_kind[kind] != before + 1 + SCAN_CAPTURE_REPLAYS + (end is not None):
                    fail(f"scan capture [{kind}]: counts {kscan.launches_by_kind[kind] - before}")
                res[label] = "bit-equal"
                if end is None:
                    traced = traced_calls(graph.replay, 10)
                    if traced["device_ops_per_call"] != 1:
                        fail(f"scan capture [{kind}]: a replay enqueued {traced['device_ops_per_call']} "
                             "device operations, not 1")
                    res.update(replay_device_ops=traced["device_ops_per_call"],
                               replay_device_us=traced["device_us_per_call"])
            finally:
                kscan.set_epoch_end(None)
            del graph
        out[f"{kind}_{n}"] = res
    return out


# Projection kernels against their plain versions: the forward bit for bit
# (it repeats ATen's rounding op for op); the backward against its plain
# version (the analytic VJP in the kernel's order) bit for bit where the two
# round alike, else within PROJ_BWD_TOL of each field's max |g|; both
# backwards against autograd of the plain forward within GRAD_TOL of each
# field's max |g| and in the 2-norm (autograd sums in another order, and the
# VJP is not additive at an axis-aligned eigenvector, ROADMAP.md queue 3).
PROJ_BWD_TOL = 1e-6
PAYLOAD_DTYPES = ("float32", "packed", "bfloat16")
PROJ_SIZES = (1, 255, 257, 1_000_000)
PROJ_MODES = tuple((sh, tight, only) for sh in range(4) for tight in (False, True) for only in (False, True))


def bits_equal(a, b):
    """Equal bit for bit (NaN payloads and the sign of zero included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def proj_args(splats, cam, sh_order=3, tight=True, only_sh=False):
    """The projection kernels' arguments for a scene and a camera, as
    ops/projection.py hands them over."""
    f32 = torch.float32
    return ([getattr(splats, f).to(f32).contiguous() for f in SPLAT_FIELDS]
            + [cam.view, cam.proj, cam.position.to(f32).contiguous(), cam.width, cam.height, sh_order, tight,
               only_sh])


def field_rel_errs(got, want):
    """Per field: max |diff| and the 2-norm of the difference, each over the
    field's own max |want| and 2-norm (None where both are None)."""
    out = {}
    for f, a, b in zip(SPLAT_FIELDS, got, want):
        if a is None or b is None:
            if (a is None) != (b is None):
                fail(f"projection backward: gradient of {f} is {a is None and 'missing' or 'extra'}")
            continue
        scale = float(b.abs().max())
        norm = float(b.norm())
        d = (a - b).abs()
        out[f] = (float(d.max()) / scale if scale else float(d.max()),
                  float(d.norm()) / norm if norm else float(d.norm()))
    return out


def check_projection():
    """project_fwd against project_fields_plain (bit-equal) and project_bwd
    against project_fields_bwd_plain and autograd of the plain forward, at
    N = 1, 255, 257 and 1M over sh_order 0-3 x tight_footprint x only_sh, on
    a scene in front of the camera and on one half behind it (camera at the
    origin), with an explicit camera position, a black splat with zero SH
    (max0's tie) and an axis-aligned splat (ay, bx exactly -0.0); then NaN
    inputs (the forward's NaN where the plain version's, bit-equal
    elsewhere); each forward also in the frame's form, sanitized and
    quantized to every payload dtype (bit-equal to payload_fields_plain of
    the plain forward), and each backward also in its masked form, the
    gradient of that form, on a row-major and a splat-major cotangent
    (bit-equal to the unmasked form of the cotangent zeroed in the invalid
    columns)."""
    res = {"forward_cases": 0, "forward": "bit-equal", "payload_cases": 0, "backward_cases": 0,
           "masked_backward_cases": 0, "masked_backward": "bit-equal to the unmasked form of the masked cotangent",
           "backward_bit_equal_cases": 0,
           "backward_worst_rel_err_vs_plain": 0.0, "vs_autograd_worst_max_rel": 0.0,
           "vs_autograd_worst_2norm_rel": 0.0, "backward_tolerance_vs_plain": PROJ_BWD_TOL,
           "tolerance_vs_autograd": GRAD_TOL}
    front = orbit_cameras(640, 360, 1)[0]
    behind = gt.make_camera(eye=[0.0, 0.0, 0.0], target=[0, 0, -1], width=640, height=360, device=DEV)
    explicit = gt.camera_from_numpy(front.view.cpu().numpy(), front.proj.cpu().numpy(), 640, 360,
                                    explicit_camera_pos=np.array([0.3, 0.2, 2.5], np.float32), device=DEV)
    g = torch.Generator(device=DEV)
    g.manual_seed(13)
    for n in PROJ_SIZES:
        scene = bench_scene(n, seed=20 + n % 7)
        if n >= 2:
            color, sh, orient = scene.color.clone(), scene.sh.clone(), scene.orient.clone()
            color[:, 0] = 0.0
            sh[:, 0] = 0.0
            orient[:, 1] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=DEV)
            scene = dataclasses.replace(scene, color=color, sh=sh, orient=orient)
        for cam_name, cam in (("front", front), ("behind", behind), ("explicit_position", explicit)):
            if cam_name == "explicit_position" and n != 257:
                continue
            for sh_order, tight, only_sh in PROJ_MODES:
                label = f"projection n={n} {cam_name} sh={sh_order} tight={tight} only_sh={only_sh}"
                args = proj_args(scene, cam, sh_order, tight, only_sh)
                out = kproj.project_fields(*args)
                torch.cuda.synchronize()
                plain_raw = kproj.project_fields_plain(*args)
                if not bits_equal(out, plain_raw):
                    fail(f"{label}: project_fwd differs from its plain version")
                res["forward_cases"] += 1
                # the serving frame's form: sanitized and quantized in the same launch
                for payload in PAYLOAD_DTYPES:
                    got = kproj.project_fields(*args, payload_dtype=payload)
                    if not bits_equal(got, kproj.payload_fields_plain(plain_raw, payload)):
                        fail(f"{label}: project_fwd with payload_dtype={payload} differs from its plain version")
                    res["payload_cases"] += 1
                cot = torch.randn((16, n), generator=g, device=DEV)
                got = kproj.project_fields_bwd(*args, cot)
                torch.cuda.synchronize()
                plain = kproj.project_fields_bwd_plain(*args, cot)
                e_plain = field_rel_errs(got, plain)
                if all(bits_equal(a, b) for a, b in zip(got, plain) if a is not None):
                    res["backward_bit_equal_cases"] += 1
                worst = max(m for m, _ in e_plain.values())
                if not worst <= PROJ_BWD_TOL or not all(torch.isfinite(a).all() for a in got if a is not None):
                    fail(f"{label}: project_bwd against its plain version {e_plain} (tolerance {PROJ_BWD_TOL})")
                res["backward_worst_rel_err_vs_plain"] = max(res["backward_worst_rel_err_vs_plain"], worst)
                # the masked form (the gradient of the payload form's fields):
                # the unmasked form of the cotangent zeroed in invalid columns
                want_m = kproj.project_fields_bwd(*args, torch.where(plain_raw[11] > 0.5, cot, 0.0))
                # the cotangent row-major and splat-major (as scatter_payload writes it)
                for c in (cot, cot.T.contiguous().T):
                    got_m = kproj.project_fields_bwd(*args, c, masked=True)
                    if not all((a is None and b is None) or bits_equal(a.contiguous(), b.contiguous())
                               for a, b in zip(got_m, want_m)):
                        fail(f"{label}: project_bwd's masked form (cotangent strides {c.stride()}) differs from "
                             "its unmasked form of the masked cotangent")
                    res["masked_backward_cases"] += 1
                del got_m, want_m
                leaves = [a.clone().requires_grad_(True) for a in args[:6]]
                with torch.enable_grad():
                    f = kproj.project_fields_plain(*leaves, *args[6:])
                    auto = torch.autograd.grad((f * cot).sum(), leaves, allow_unused=True)
                for which, grads in (("kernel", got), ("plain", plain)):
                    e = field_rel_errs(grads, auto)
                    m = max(v[0] for v in e.values())
                    n2 = max(v[1] for v in e.values())
                    if not (m <= GRAD_TOL and n2 <= GRAD_TOL):
                        fail(f"{label}: the {which} backward against autograd of the plain forward {e} "
                             f"(tolerance {GRAD_TOL})")
                    res["vs_autograd_worst_max_rel"] = max(res["vs_autograd_worst_max_rel"], m)
                    res["vs_autograd_worst_2norm_rel"] = max(res["vs_autograd_worst_2norm_rel"], n2)
                res["backward_cases"] += 1
    # NaN inputs: a NaN position, opacity, scale and SH coefficient
    scene = bench_scene(257, seed=29)
    pos, op, scale, sh = scene.pos.clone(), scene.opacity.clone(), scene.scale.clone(), scene.sh.clone()
    pos[0, 3] = float("nan")
    op[5] = float("nan")
    scale[1, 9] = float("nan")
    sh[4, 11] = float("nan")
    scene = dataclasses.replace(scene, pos=pos, opacity=op, scale=scale, sh=sh)
    nan_cases = 0
    for sh_order, tight, only_sh in PROJ_MODES:
        args = proj_args(scene, front, sh_order, tight, only_sh)
        raw = kproj.project_fields_plain(*args)
        for payload in (None,) + PAYLOAD_DTYPES:
            out = kproj.project_fields(*args, payload_dtype=payload)
            want = raw if payload is None else kproj.payload_fields_plain(raw, payload)
            nan_w = torch.isnan(want)
            if not torch.equal(torch.isnan(out), nan_w) or not bits_equal(out[~nan_w], want[~nan_w]):
                fail(f"projection with NaN inputs sh={sh_order} tight={tight} only_sh={only_sh} "
                     f"payload_dtype={payload}: the forward's NaN entries or its other entries differ from the "
                     "plain version's")
            nan_cases += 1
    res["nan_input_cases"] = nan_cases
    res["nan_inputs"] = "NaN where the plain version has NaN, bit-equal elsewhere"
    return res


# The frame glue's modes: (name, RenderConfig fields, tile offsets).  "no_sat"
# lowers GSPLAT_SAT_MAX_N's threshold below the scene (the cull off).
GLUE_MODES = (
    ("packed", dict(payload_dtype="packed"), (0, 0)),
    ("float32", dict(), (0, 0)),
    ("bfloat16", dict(payload_dtype="bfloat16"), (0, 0)),
    ("depth_test", dict(depth_test=True), (0, 0)),
    ("wireframe", dict(wireframe=True), (0, 0)),
    ("soft_cutoff", dict(soft_cutoff=True), (0, 0)),
    ("strided", dict(row_stride=2, col_stride=3), (1, 2)),
    ("no_sat", dict(), (0, 0)),
)
GLUE_SIZES = ((1, 70, 45), (257, 70, 45), (100_000, 640, 360))
BIN_ARRAYS = ("pair_splat", "pair_tile", "tile_start", "tile_count", "tile_base", "tile_phi", "tile_span",
              "grad_base", "dropped_pairs", "dest_of_exp", "exp_offsets", "exp_counts", "exp_rank")


@contextlib.contextmanager
def sat_max_n(value):
    """binning's GSPLAT_SAT_MAX_N threshold set to `value` inside."""
    saved, binning._SAT_CULL_MAX_N = binning._SAT_CULL_MAX_N, value
    try:
        yield
    finally:
        binning._SAT_CULL_MAX_N = saved


def same_words(a, b):
    """Both None, or equal 32-bit words of one shape."""
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and bits_equal(a.contiguous(), b.contiguous())


def check_glue_case(splats, cam, cfg, offsets, label, res):
    """gather_payload (also its float32 rows for the differentiable frame),
    scatter_payload, mark_owners, expand_pairs and the scans (on the frame's
    counts and marks) against their plain versions, bit for bit, on one
    scene, camera and mode; then bin_splats through the kernels against
    bin_splats through the plain versions (plain_path), in the frame's form
    (operands) with and without the gradient map and in the order= form with
    it."""
    n, w, h = splats.count, cam.width, cam.height
    if cfg.wireframe:
        fields = wire._wireframe_projected(splats, cam, LINE_PX).fields
    else:
        fields = kproj.project_fields(*proj_args(splats, cam, cfg.sh_order, not cfg.soft_cutoff, cfg.only_sh),
                                      payload_dtype=cfg.payload_dtype)
    order = torch.argsort(fields[10], stable=True)
    sat_cull, rho_ok = binning.sat_flags(n, w, h, cfg)
    # the frame's payload with an int64 and an int32 order, and the float32
    # rows of the differentiable frame
    for od, float_rows in ((order, False), (order.to(torch.int32), False), (order, True)):
        want = kglue.gather_payload_plain(fields, order, w, h, cfg, rho_ok, *offsets, float_rows=float_rows)
        got = kglue.gather_payload(fields, od, w, h, cfg, rho_ok, *offsets, float_rows=float_rows)
        form = f"{od.dtype}, float_rows={float_rows}"
        for name in ("counts", "nx", "tile0", "thr_q"):
            if not same_words(getattr(got.operands, name), getattr(want.operands, name)):
                fail(f"gather_payload {label} ({form}): {name} differs from its plain version")
        if not same_words(got.payload, want.payload):
            fail(f"gather_payload {label} ({form}): the payload differs from its plain version")
        res["gather_cases"] += 1
    # the gather's gradient, for the float32 rows it wrote
    g = torch.Generator(device=DEV)
    g.manual_seed(n)
    d_payload = torch.randn(tuple(got.payload.shape), generator=g, device=DEV)
    if not same_words(kglue.scatter_payload(d_payload, order), kglue.scatter_payload_plain(d_payload, order)):
        fail(f"scatter_payload {label}: differs from its plain version")
    res["scatter_cases"] += 1
    del d_payload, got, want
    ops = kglue.gather_payload(fields, order, w, h, cfg, rho_ok, *offsets).operands
    nty, ntx = binning.tile_grid(w, h, cfg.tile_h, cfg.tile_w)
    cum = kscan.scan_i32(ops.counts, "add")
    if not same_words(cum, kscan.scan_i32_plain(ops.counts, "add")):
        fail(f"scan_i32[add] {label}: differs from its plain version on the frame's counts")
    total = int(cum[-1])
    for budget in (cfg.pair_budget(n), max(1, total // 2)):  # the second drops pairs
        offs, marks = kglue.mark_owners(cum, ops.counts, budget)
        want_offs, want_marks = kglue.mark_owners_plain(cum, ops.counts, budget)
        if not same_words(offs, want_offs) or not same_words(marks, want_marks):
            fail(f"mark_owners {label} budget={budget}: differs from its plain version")
        res["marks_cases"] += 1
        smax = kscan.scan_i32(marks[:budget], "max")
        if not same_words(smax, kscan.scan_i32_plain(marks[:budget].contiguous(), "max")):
            fail(f"scan_i32[max] {label} budget={budget}: differs from its plain version on the frame's marks")
        # the frame's tile count, and one whose (tile, rank) key does not fit 31 bits
        for num_tiles in (nty * ntx, 1 << 28):
            for with_rank in (False, True):
                a = kglue.expand_pairs(smax, cum, offs, ops, budget, num_tiles, ntx, cfg, *offsets, sat_cull,
                                       rho_ok, with_rank)
                b = kglue.expand_pairs_plain(smax, cum, offs, ops, budget, num_tiles, ntx, cfg, *offsets,
                                             sat_cull, rho_ok, with_rank)
                for name in ("key", "tile", "rank", "exp_rank"):
                    if not same_words(getattr(a, name), getattr(b, name)):
                        fail(f"expand_pairs {label} budget={budget} tiles={num_tiles}: {name} differs from its "
                             "plain version")
                res["expand_cases"] += 1
                res["key_split_cases"] += int(a.key is None)
                tile = a.tile if a.key is None else a.key >> kglue.rank_bits(n)
                real = torch.arange(budget, device=DEV) < min(total, budget)
                res["sat_culled_pairs"] += int(((tile == num_tiles) & real).sum())
    forms = (("operands", lambda: binning.bin_splats(None, w, h, cfg, row_offset=offsets[0], col_offset=offsets[1],
                                                      operands=ops)),
             ("operands, gradient map", lambda: binning.bin_splats(None, w, h, cfg, row_offset=offsets[0],
                                                                    col_offset=offsets[1], operands=ops,
                                                                    with_grad_map=True)),
             ("order", lambda: binning.bin_splats(ProjectedSplats(fields=fields), w, h, cfg,
                                                   row_offset=offsets[0], col_offset=offsets[1], order=order,
                                                   with_grad_map=True)))
    for form, fn in forms:
        got_b = fn()
        with plain_path():
            want_b = fn()
        for name in BIN_ARRAYS:
            if not same_words(getattr(got_b, name), getattr(want_b, name)):
                fail(f"bin_splats {label} ({form} form): {name} through the kernels differs from the plain versions")
        res["bin_splats_cases"] += 1


def check_frame_glue():
    """The frame glue's four kernels against their plain versions, bit for
    bit, in every mode of GLUE_MODES at GLUE_SIZES, and at the main path's
    1M splats at 1080p (packed)."""
    res = {"gather_cases": 0, "scatter_cases": 0, "marks_cases": 0, "expand_cases": 0, "key_split_cases": 0, "bin_splats_cases": 0,
           "sat_culled_pairs": 0, "equal": "bit-equal"}
    for n, w, h in GLUE_SIZES:
        scene = bench_scene(n, seed=30 + n % 11)
        cam = gt.make_camera(eye=[0.0, 0.4, 3.0], target=[0, 0, 0], width=w, height=h, device=DEV)
        for name, kw, offsets in GLUE_MODES:
            cfg = gt.RenderConfig(warn_on_drop=False, pairs_per_splat=8.0, **kw)
            with sat_max_n(0 if name == "no_sat" else binning._SAT_CULL_MAX_N):
                check_glue_case(scene, cam, cfg, offsets, f"{name} n={n} {w}x{h}", res)
    # the main path's size and settings, and a scene half behind the camera
    main = bench_scene(1_000_000, seed=0)
    cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3, warn_on_drop=False)
    check_glue_case(main, orbit_cameras(1920, 1080, 1)[0], cfg, (0, 0), "main path 1M 1920x1080", res)
    behind = gt.make_camera(eye=[0.0, 0.0, 0.0], target=[0, 0, -1], width=640, height=360, device=DEV)
    check_glue_case(bench_scene(100_000, seed=31), behind, cfg, (0, 0), "half behind 640x360", res)
    if res["sat_culled_pairs"] <= 0:
        fail("frame glue checks: the exact-coverage cull removed no pair in any case")
    return res


def phase_checks():
    """Small and ragged shapes: every kernel against its plain version."""
    g = torch.Generator(device=DEV)
    g.manual_seed(1)
    scan_cases = 0
    # lengths around one tile of the kernel (8192) and past many
    for n in (0, 1, 1023, 4096, 4097, 8192, 8193, 1_000_000, 3_000_001):
        for kind in kscan.KINDS:
            x = scan_input(kind, n, g)
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
    stress_calls = check_scan_stress(g)
    scan_growth = check_scan_growth()
    scan_capture = check_scan_capture(g)

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
    dense = bench_scene(100_000, seed=3)
    dense = dataclasses.replace(dense, opacity=torch.full_like(dense.opacity, 0.95))
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
    # The depth test, forward and backward: a slanted plane through the
    # splats, with one row of NaN depths (a NaN kills, as jnp.where does).
    depth_cases = 0
    # (hard/soft, eps) cases per image size
    depth_cases_by_size = (((640, 360), ((False, 1e-3), (True, 0.0))), ((70, 45), ((False, 0.0), (True, 1e-3))))
    for (w, h), cases in depth_cases_by_size:
        cam = gt.make_camera(eye=[0.0, 0.4, 3.0], target=[0, 0, 0], width=w, height=h, device=DEV)
        bgd, _ = occluder(cam.width, cam.height)
        bgd[cam.height // 2] = float("nan")
        for soft, eps in cases:
            cfg = gt.RenderConfig(depth_test=True, soft_cutoff=soft, transmittance_eps=eps,
                                  warn_on_drop=False, pairs_per_splat=8.0 if soft else 3.0)
            label = f"depth {w}x{h} {'soft' if soft else 'hard'} eps={eps}"
            args, b = compositor_inputs(splats, cam, cfg)
            err, used = compare_compositor(args, label, bgd=bgd)
            worst = max(worst, err)
            stops += int((used < b.tile_span).sum())
            comp_cases += 1
            depth_cases += 1
            fwd, bb, d_out, g_pad = backward_inputs(splats, cam, cfg, seed=41 + depth_cases)
            used_c, tchk, e_chk = compare_checkpoint(fwd, label, bgd=bgd)
            _, e_bwd, _ = compare_backward(fwd, bb, used_c, tchk, d_out, g_pad, label, bgd=bgd)
            bwd["cases"] += 1
            bwd["checkpoint_max_abs_err"] = max(bwd["checkpoint_max_abs_err"], e_chk)
            bwd["bwd_worst_rel_err"] = max(bwd["bwd_worst_rel_err"], e_bwd)
    # The wireframe band test: the wireframe pass's own inputs, two line
    # widths, with and without the early stop; and the band test on a packed
    # beauty payload, as render(config.wireframe=True) runs it.  (line_px,
    # eps, soft) cases per image size.
    wire_cases = 0
    # A soft-cutoff config runs the same band test (the band reads no cutoff).
    for (w, h), cases in (((640, 360), ((1.0, 1e-3, False), (2.5, 0.0, False), (1.0, 1e-3, True))),
                          ((70, 45), ((1.0, 0.0, False),))):
        cam = gt.make_camera(eye=[0.0, 0.4, 3.0], target=[0, 0, 0], width=w, height=h, device=DEV)
        for line_px, eps, soft in cases:
            cfg = gt.RenderConfig(transmittance_eps=eps, soft_cutoff=soft, warn_on_drop=False, pairs_per_splat=12.0)
            args, b = wire._wireframe_inputs(splats, cam, cfg, line_px)
            err, used = compare_compositor(args, f"wireframe {w}x{h} line_px={line_px} eps={eps} soft={soft}")
            worst = max(worst, err)
            stops += int((used < b.tile_span).sum())
            comp_cases += 1
            wire_cases += 1
    for soft in (False, True):
        cfg = gt.RenderConfig(payload_dtype="packed", wireframe=True, soft_cutoff=soft, transmittance_eps=1e-3,
                              warn_on_drop=False, pairs_per_splat=8.0 if soft else 3.0)
        err, _ = compare_compositor(compositor_inputs(splats, cam, cfg)[0],
                                    f"wireframe band on a packed payload, soft={soft}")
        worst = max(worst, err)
        comp_cases += 1
        wire_cases += 1
    # The strided/offset tile mapping of the sharded renderer, forward and
    # backward: every grid of STRIDED_CHECKS on the packed payload with the
    # early stop, and a 2 x 2 cell on float32 without it.
    strided_cases, strided_bwd = 0, 0.0
    cam = gt.make_camera(eye=[0.0, 0.4, 3.0], target=[0, 0, 0], width=640, height=720, device=DEV)
    cases = [(s, o, "packed", 1e-3) for s, o in STRIDED_CHECKS] + [((2, 2), (1, 1), "float32", 0.0)]
    for (dy, dx), offsets, payload, eps in cases:
        if (dy, dx) == (1, 1):
            strip_h, strip_w = 4 * 32, cam.width  # tile rows 17..20
        else:
            strip_h = -(-cam.height // (dy * 32)) * 32
            strip_w = -(-cam.width // (dx * 32)) * 32
        cfg = gt.RenderConfig(payload_dtype=payload, transmittance_eps=eps, warn_on_drop=False)
        label = f"strided {dy}x{dx} at {offsets} {payload} eps={eps}"
        fwd, b = strided_inputs(splats, cam, cfg, (dy, dx), offsets, strip_h, strip_w, with_grad_map=True)
        e_bwd, n_stop = check_strided(fwd, b, offsets, label, seed=61 + strided_cases)
        strided_bwd = max(strided_bwd, e_bwd)
        stops += n_stop
        strided_cases += 1
        comp_cases += 1
        bwd["cases"] += 1
    bwd["bwd_worst_rel_err"] = max(bwd["bwd_worst_rel_err"], strided_bwd)
    probe = check_probes()
    projection = check_projection()
    frame_glue = check_frame_glue()
    emit("checks", scan_cases=scan_cases, scan="bit-equal", scan_stress_calls=stress_calls,
         scan_stress="bit-equal, scratch poisoned every 25 calls", scan_growth_over_next_epoch_tags=scan_growth,
         scan_capture=scan_capture,
         compositor_cases=comp_cases,
         depth_test_cases=depth_cases, wireframe_cases=wire_cases, strided_cases=strided_cases,
         strided_forward="bit-equal (and its checkpoint variant)", strided_bwd_worst_row_rel_err=strided_bwd,
         probes=probe,
         compositor_max_abs_err=worst, tolerance=IMAGE_TOL, tiles_stopped_early=stops, used="equal",
         backward_cases=bwd["cases"], checkpoint_variant="image and used bit-equal",
         backward_audited=dict(AUDITED, skipped_live_pixels=0), forward_audited=dict(AUDITED_FWD),
         checkpoint_max_abs_err=bwd["checkpoint_max_abs_err"],
         composite_bwd_worst_row_rel_err=bwd["bwd_worst_rel_err"], composite_bwd_row_tolerance=GRAD_ROW_TOL,
         segsum_worst_row_rel_err=bwd["segsum_worst_rel_err"], segsum_row_tolerance=SEGSUM_TOL,
         segsum_two_runs="bit-equal", projection=projection, frame_glue=frame_glue)


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
        with plain_path():
            tiles = gt.render(splats, cam, cfg, backend="tiles")
            oracle = gt.render(splats, cam, cfg, backend="reference")
        e_tiles = float((main - tiles).abs().max())
        e_oracle = float((main - oracle).abs().max())
        if not (e_tiles < IMAGE_TOL and e_oracle < IMAGE_TOL):
            fail(f"reference {payload}: main path vs tiles {e_tiles:.3e}, vs oracle {e_oracle:.3e}")
        if float(main[..., 3].max()) < 0.5:
            fail("reference scene rendered (nearly) empty")
        out[payload] = {"vs_tiles": e_tiles, "vs_oracle": e_oracle}
    # The whole gradient d splats through the kernels (projection forward and
    # backward, compositor forward and backward, segment sum) against autograd
    # through the plain projection and the plain tiled renderer.
    gw = torch.Generator(device=DEV)
    gw.manual_seed(6)
    weights = torch.randn((120, 200, 4), generator=gw, device=DEV)
    grad_err = {}
    for payload in ("float32", "packed"):
        cfg = gt.RenderConfig(tile_capacity=1024, transmittance_eps=0.0, payload_dtype=payload)
        g_main = splat_grads(splats, cam, cfg, weights, "auto")
        with plain_path():
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
    # Compositing into a host scene: the depth test through the kernels
    # against the plain renderers, and its gradient.
    bgd, bg_rgba = occluder(200, 120)
    cfg = gt.RenderConfig(tile_capacity=1024, transmittance_eps=0.0)
    main = gt.render(splats, cam, cfg, backend="auto", background_rgba=bg_rgba, background_depth=bgd)
    with plain_path():
        tiles = gt.render(splats, cam, cfg, backend="tiles", background_rgba=bg_rgba, background_depth=bgd)
        oracle = gt.render(splats, cam, cfg, backend="reference", background_rgba=bg_rgba, background_depth=bgd)
    untested = gt.render(splats, cam, cfg, backend="auto", background_rgba=bg_rgba)
    e_tiles = float((main - tiles).abs().max())
    e_oracle = float((main - oracle).abs().max())
    killed = float((main - untested).abs().max())
    if not (e_tiles < IMAGE_TOL and e_oracle < IMAGE_TOL):
        fail(f"reference depth test: main path vs tiles {e_tiles:.3e}, vs oracle {e_oracle:.3e}")
    if not killed > 1e-3:
        fail("reference depth test: the plane killed nothing")
    out["depth_test"] = {"vs_tiles": e_tiles, "vs_oracle": e_oracle, "vs_untested": killed}
    g_main = splat_grads(splats, cam, cfg, weights, "auto", bgd=bgd)
    with plain_path():
        g_tiles = splat_grads(splats, cam, cfg, weights, "tiles", bgd=bgd)
    grad_err["depth_test"] = {}
    for f in SPLAT_FIELDS:
        scale = max(1.0, float(g_tiles[f].abs().max()))
        err = float((g_main[f] - g_tiles[f]).abs().max())
        if not torch.isfinite(g_main[f]).all() or not err <= GRAD_TOL * scale:
            fail(f"reference depth test: gradient of {f} differs by {err:.3e} (tolerance {GRAD_TOL} x {scale:.3e})")
        grad_err["depth_test"][f] = err / scale
    # The wireframe views against the O(N*H*W) wireframe oracle.  The oracle
    # tests every pixel, the kernel path only the tiles a splat was binned
    # to: its box (grown by line_px) can miss a band pixel at a rotated or
    # faint splat's corner, where the JAX package's kernel and oracle differ
    # alike.  So: equal but on at most WIRE_EDGE_SHARE of the pixels.
    wcfg = dataclasses.replace(cfg, pairs_per_splat=12.0)
    w_main = gt.render_wireframe(splats, cam, wcfg, line_px=LINE_PX, background=[0.2, 0.3, 0.4])
    with plain_path():
        w_oracle = gt.render_wireframe(splats, cam, wcfg, line_px=LINE_PX, background=[0.2, 0.3, 0.4],
                                       backend="reference")
    differ = (w_main - w_oracle).abs().amax(dim=-1) > IMAGE_TOL
    share = float(differ.float().mean())
    if share > WIRE_EDGE_SHARE or float(w_main[..., 3].sum()) < 100:
        fail(f"reference wireframe: kernel vs oracle differ on {share:.2e} of the pixels, "
             f"covered {float(w_main[..., 3].sum())}")
    over = gt.render_wire_over(splats, cam, wcfg, line_px=LINE_PX)
    beauty = gt.render(splats, cam, wcfg, backend="tiles")
    wire_k = gt.render_wireframe(splats, cam, wcfg, line_px=LINE_PX)
    e_over = float((over - (wire_k + beauty * (1.0 - wire_k[..., 3:4]))).abs().max())
    if not e_over < IMAGE_TOL:
        fail(f"reference wire-over: kernel path vs its composition over the tiled beauty pass {e_over:.3e}")
    out["wireframe"] = {"pixels_differing_from_oracle": int(differ.sum()), "share": share,
                        "wire_over_vs_composition": e_over}
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
        ms, (image, stats) = cuda_time_ms(lambda: gt.render(splats, cam, cfg, backend="auto", with_stats=True))
        times.append(ms)
        images.append(image)
        dropped.append(int(stats.dropped_pairs))
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated()

    # serving pays for no training: no checkpoints, no backward, no gradient map
    want = frame_counts(frames)
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
    graph = captured_frame(splats, cams, cfg, images, want)
    nty, ntx = binning.tile_grid(width, height, cfg.tile_h, cfg.tile_w)
    emit("main_path", splats=n_splats, size=f"{width}x{height}", frames=frames,
         payload_dtype=cfg.payload_dtype, transmittance_eps=cfg.transmittance_eps,
         pair_budget=cfg.pair_budget(n_splats), pairs=pairs, tiles=nty * ntx,
         dropped_pairs=dropped, warmup_frames=WARMUP_FRAMES, frame_ms=times,
         median_frame_ms=statistics.median(times), min_frame_ms=min(times),
         median_graph_frame_ms=graph["median_graph_frame_ms"],
         peak_memory_bytes=peak, covered_share=coverage, launches=counts,
         graph={k: v for k, v in graph.items() if k != "serve"})
    return splats, cams, cfg, counts, graph


def captured_frame(splats, cams, cfg, images, want):
    """The main path's frame captured as bench.py:157 jits it: one CUDA graph
    of render(..., with_stats=True) over a camera whose tensors each orbit
    camera's matrices are copied into before its replay.  Each replay (timed
    with its copies) bit-equal to the eager frame of its camera in this run,
    dropped_pairs 0, the launch counters (zeroed before, read after) those of
    the eager frames, and one replay's kernels in a profiler trace the same
    counts.  Returns the graph's line and `serve`, a frame of a camera."""
    width, height = cams[0].width, cams[0].height
    live = gt.Camera(view=cams[0].view.clone(), proj=cams[0].proj.clone(), width=width, height=height,
                     derived_pos=cams[0].derived_pos.clone())
    t0 = time.time()
    graph = graphs.capture(lambda: gt.render(splats, live, cfg, backend="auto", with_stats=True))
    capture_s = time.time() - t0

    def serve(cam):
        live.view.copy_(cam.view)
        live.proj.copy_(cam.proj)
        live.derived_pos.copy_(cam.derived_pos)
        return graph.replay()

    for k in range(WARMUP_FRAMES):
        serve(cams[k % len(cams)])
    torch.cuda.synchronize()
    zero_counters()
    times, dropped, equal = [], [], 0
    for cam, image_eager in zip(cams, images):
        ms, (image, stats) = cuda_time_ms(lambda: serve(cam))
        times.append(ms)
        equal += int(torch.equal(image, image_eager))
        dropped.append(int(stats.dropped_pairs))
    counts = read_counters()
    if counts != want:
        fail(f"captured frame: launch counts {counts}, expected {want}")
    if equal != len(cams):
        fail(f"captured frame: {len(cams) - equal} of {len(cams)} replays differ from the eager frame")
    if any(dropped):
        fail(f"captured frame: dropped_pairs {dropped}")
    traced = traced_calls(lambda: serve(cams[0]), 3)
    per_replay = {k: v // len(cams) for k, v in counts.items() if k in OUR_KERNELS}
    if traced["our_kernels_per_call"] != per_replay:
        fail(f"captured frame: a replay's trace holds {traced['our_kernels_per_call']}, the counters {per_replay}")
    return {"median_graph_frame_ms": statistics.median(times), "graph_frame_ms": times,
            "min_graph_frame_ms": min(times), "bit_equal_to_eager": equal, "dropped_pairs": dropped,
            "capture_s": capture_s, "graph_pool_bytes": graph.pool_bytes, "launches": counts,
            "replay_device_ops": traced["device_ops_per_call"], "replay_device_us": traced["device_us_per_call"],
            "replay_kernels_traced": traced["our_kernels_per_call"], "serve": serve}


def phase_frame_digest(n_splats, width, height):
    """--frame-digest: the main path's scene, settings and first camera
    (phase_main_path's), rendered once through render() and once through the
    forward kernel at its own inputs; SHA-256 of the bytes."""
    import hashlib

    splats = bench_scene(n_splats, seed=0)
    cams = orbit_cameras(width, height, 5)
    cfg = gt.tune_pair_budget(splats, cams, gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3),
                              headroom=1.02)
    image = gt.render(splats, cams[0], cfg, backend="auto")
    k_image, used = kcomp.composite_splats(*compositor_inputs(splats, cams[0], cfg)[0])

    def digest(t):
        return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()

    emit("frame_digest", render_image_sha256=digest(image), kernel_image_sha256=digest(k_image),
         kernel_used_sha256=digest(used), used_sum=int(used.sum()))


def phase_stages(splats, cam, cfg, reps=7):
    """Where a frame's time goes: the stages of render_cuda's serving frame,
    each between two CUDA events with a synchronise before it (so the sum
    exceeds the frame time, which overlaps host and device work).  The
    binning's stages: its prefix sum, the marks' scatter, its prefix max,
    expand_pairs, the key sort and the descriptors after it."""
    nty, ntx = binning.tile_grid(cam.width, cam.height, cfg.tile_h, cfg.tile_w)
    state = {}

    def project():  # project_fwd, writing sanitized, quantized fields
        state["f"] = project_splats(splats, cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff,
                                    only_sh=cfg.only_sh, payload_dtype=cfg.payload_dtype).fields

    def depth_sort():
        state["order"] = torch.argsort(state["f"][10], stable=True)

    def gather():
        state["glue"] = binning.gather_frame(state["f"], state["order"], cam.width, cam.height, cfg)

    def bin_pairs():
        state["b"] = binning.bin_splats(None, cam.width, cam.height, cfg, with_tiles=False,
                                        operands=state["glue"].operands)

    def composite():
        b = state["b"]
        kcomp.composite_splats(state["glue"].payload, b.pair_splat, b.tile_base, b.tile_phi, b.tile_span,
                               nty, ntx, cam.height, cam.width, cfg)

    stages = [("project", project), ("depth_sort", depth_sort), ("gather_payload", gather),
              ("bin_splats", bin_pairs), ("composite_fwd", composite)]
    samples = {name: [] for name, _ in stages}
    for _ in range(reps):
        for name, fn in stages:
            samples[name].append(cuda_time_ms(fn)[0])
    med = {name: statistics.median(v) for name, v in samples.items()}
    bins = binning_stages(splats.count, cam, cfg, state["glue"].operands, reps)
    emit("stages", reps=reps, median_ms=med, sum_ms=sum(med.values()), bin_splats_stages_ms=bins)


def binning_stages(n, cam, cfg, ops, reps):
    """bin_splats taken apart on the frame's operands (each stage's median
    ms, as phase_stages times them)."""
    nty, ntx = binning.tile_grid(cam.width, cam.height, cfg.tile_h, cfg.tile_w)
    budget = cfg.pair_budget(n)
    sat_cull, rho_ok = binning.sat_flags(n, cam.width, cam.height, cfg)
    st = {}

    def prefix_sum():
        st["cum"] = kscan.scan_i32(ops.counts, "add")

    def marks():
        st["offsets"], st["marks"] = kglue.mark_owners(st["cum"], ops.counts, budget)

    def prefix_max():
        st["smax"] = kscan.scan_i32(st["marks"][:budget], "max")

    def expand():
        st["pk"] = kglue.expand_pairs(st["smax"], st["cum"], st["offsets"], ops, budget, nty * ntx, ntx, cfg, 0,
                                      0, sat_cull, rho_ok, False)

    def sort():
        st["sorted"] = torch.sort(st["pk"].key).values

    def whole():
        binning.bin_splats(None, cam.width, cam.height, cfg, with_tiles=False, operands=ops)

    stages = [("prefix_sum", prefix_sum), ("marks", marks), ("prefix_max", prefix_max),
              ("expand_pairs", expand), ("key_sort", sort), ("bin_splats", whole)]
    samples = {name: [] for name, _ in stages}
    for _ in range(reps):
        for name, fn in stages:
            samples[name].append(cuda_time_ms(fn)[0])
    med = {name: statistics.median(v) for name, v in samples.items()}
    med["descriptors_and_rest"] = med["bin_splats"] - sum(v for k, v in med.items() if k != "bin_splats")
    return med


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


def eager_train_step(optimizer, cam, cfg, lambda_dssim=0.2):
    """make_train_step's four lines, run eagerly here: zero_grad, the loss
    of the render over white, backward, the optimizer's step."""

    def step(params, target):
        optimizer.zero_grad(set_to_none=True)
        img = gt.render(gt.splats_from_params(params), cam, cfg, backend="auto")
        loss = render_loss(img[..., :3] + (1.0 - img[..., 3:4]), target, lambda_dssim)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def timed_steps(step, params, target, steps):
    """WARMUP_STEPS calls of step(params, target), then `steps` timed ones
    with the launch counters zeroed just before and read just after."""
    warm = [float(step(params, target)) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    losses, times = [], []
    for _ in range(steps):
        ms, loss = cuda_time_ms(lambda: step(params, target))
        times.append(ms)
        losses.append(float(loss))
    counts = read_counters()
    return warm, losses, times, counts, torch.cuda.max_memory_allocated()


def phase_train_path(splats, cam, cfg, steps):
    """make_train_step with default_optimizer on the production scene (see
    train_run); prints the train_path line."""
    cfg, target, counts, line = train_run(splats, cam, cfg, steps)
    emit("train_path", **line)
    return cfg, target, counts, line["median_step_ms"]


def train_run(splats, cam, cfg, steps):
    """make_train_step with default_optimizer: the captured step (call 1
    eager, call 2 captured and replayed once, then replays), and beside it
    the same four lines run eagerly with the same capturable optimizer from
    the same start - losses and parameters bit-equal.  Returns the step's
    config, its target, its launch counts and its line."""
    n = splats.count
    target = perturbed_target(splats, cam, cfg)
    # a budget with room for the few steps the parameters move
    cfg = gt.tune_pair_budget(splats, [cam], cfg, headroom=1.05)
    params = gt.params_from_splats(splats)
    start = {k: v.detach().clone() for k, v in params.as_dict().items()}
    optimizer = gt.default_optimizer(params)
    step = gt.make_train_step(optimizer, cam, cfg, backend="auto")
    warm, losses, times, counts, peak = timed_steps(step, params, target, steps)
    reserved = torch.cuda.memory_reserved()

    want = gradient_counts(steps)
    if counts != want:
        fail(f"train path launch counts {counts}, expected {want}")
    if not all(math.isfinite(x) for x in warm + losses):
        fail(f"non-finite loss: {warm + losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall over {steps} steps: {losses}")
    traced = traced_calls(lambda: step(params, target), 2)
    per_step = {k: v // steps for k, v in counts.items() if k in OUR_KERNELS}
    if traced["our_kernels_per_call"] != per_step:
        fail(f"captured step: a replay's trace holds {traced['our_kernels_per_call']}, the counters {per_step}")
    # The traced calls moved the parameters: the eager comparison below
    # takes as many steps before it compares them.
    extra = traced["calls_made"]

    # The eager step: the four lines of make_train_step with the same
    # capturable optimizer, from the same start.
    eparams = gt.params_from_splats(splats)
    eopt = gt.default_optimizer(eparams)
    eager_step = eager_train_step(eopt, cam, cfg)
    ewarm, elosses, etimes, ecounts, epeak = timed_steps(eager_step, eparams, target, steps)
    if ecounts != want:
        fail(f"eager step launch counts {ecounts}, expected {want}")
    if ewarm + elosses != warm + losses:
        fail(f"captured losses {warm + losses} differ from the eager step's {ewarm + elosses}")
    for _ in range(extra):
        eager_step(eparams, target)
    differ = [k for k, v in params.as_dict().items() if not torch.equal(v, eparams.as_dict()[k])]
    if differ:
        fail(f"captured and eager steps left different parameters: {differ}")
    del eparams, eopt
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
    line = dict(splats=n, size=f"{cam.width}x{cam.height}", steps=steps, warmup_steps=WARMUP_STEPS,
                payload_dtype=cfg.payload_dtype, transmittance_eps=cfg.transmittance_eps,
                pair_budget=cfg.pair_budget(n), optimizer="Adam, one group per field (default_optimizer, capturable)",
                lambda_dssim=0.2, warmup_losses=warm, losses=losses, step_ms=times,
                median_step_ms=statistics.median(times), min_step_ms=min(times),
                median_eager_step_ms=statistics.median(etimes), min_eager_step_ms=min(etimes), eager_step_ms=etimes,
                eager_losses="bit-equal", eager_parameters="bit-equal", peak_memory_bytes=peak,
                eager_peak_memory_bytes=epeak, reserved_bytes=reserved, graph_pool_bytes=step.graph.pool_bytes,
                replay_device_ops=traced["device_ops_per_call"], replay_device_us=traced["device_us_per_call"],
                replay_kernels_traced=traced["our_kernels_per_call"],
                dropped_pairs=dropped, max_abs_move=moved_by, launches=counts,
                launches_per_step={k: v / steps for k, v in counts.items()})
    return cfg, target, counts, line


def phase_train_stages(splats, cam, cfg, target, reps=3):
    """Where a training step's time goes: one step taken apart by cutting the
    graph at the image and at the projected field rows, each piece between two
    CUDA events with a synchronise before it."""
    from gsplat_tpu_torch.train.loss import render_loss

    nty, ntx = binning.tile_grid(cam.width, cam.height, cfg.tile_h, cfg.tile_w)
    params = gt.params_from_splats(splats)
    optimizer = gt.default_optimizer(params)
    st = {}

    def project():  # project_fwd, writing sanitized, quantized fields
        st["s"] = gt.splats_from_params(params)
        st["fields"] = project_splats(st["s"], cam, cfg.sh_order, tight_footprint=not cfg.soft_cutoff,
                                      only_sh=cfg.only_sh, payload_dtype=cfg.payload_dtype).fields

    def depth_sort():
        st["order"] = torch.argsort(st["fields"][10].detach(), stable=True)

    def gather():  # the float32 rows and the binning operands, differentiable
        st["glue"] = binning.gather_frame(st["fields"], st["order"], cam.width, cam.height, cfg,
                                          differentiable=True)

    def bin_with_grad_map():
        st["b"] = binning.bin_splats(None, cam.width, cam.height, cfg, with_tiles=False, with_grad_map=True,
                                     operands=st["glue"].operands)

    def composite_forward():
        st["f"] = st["glue"].payload.detach().requires_grad_(True)
        st["img"] = kcomp.composite_splats_diff(st["f"], st["b"], nty, ntx, cam.height, cam.width, cfg)

    def loss_forward():
        st["img_leaf"] = st["img"].detach().requires_grad_(True)
        rgb = st["img_leaf"][..., :3] + (1.0 - st["img_leaf"][..., 3:4])
        st["loss"] = render_loss(rgb, target, 0.2)

    def loss_backward():
        st["loss"].backward()

    def composite_backward():  # backward kernel + segment sum + per-splat combine
        st["img"].backward(st["img_leaf"].grad)

    def projection_backward():  # scatter_payload, project_bwd (masked), activations
        optimizer.zero_grad(set_to_none=True)
        st["glue"].payload.backward(st["f"].grad)

    def optimizer_step():
        optimizer.step()

    stages = [("project", project), ("depth_sort", depth_sort), ("gather_payload", gather),
              ("bin_splats_grad_map", bin_with_grad_map), ("composite_fwd_checkpoint", composite_forward),
              ("loss_forward", loss_forward), ("loss_backward", loss_backward),
              ("composite_backward_total", composite_backward), ("projection_backward", projection_backward),
              ("optimizer_step", optimizer_step)]
    samples = {name: [] for name, _ in stages}
    for rep in range(reps + 1):
        for name, fn in stages:
            ms, _ = cuda_time_ms(fn)
            if rep > 0:  # the first pass warms the allocator
                samples[name].append(ms)
    med = {name: statistics.median(v) for name, v in samples.items()}
    emit("train_stages", reps=reps, median_ms=med, sum_ms=sum(med.values()),
         note="composite_backward_total = backward kernel + segment sum + per-splat combine; "
              "projection_backward = scatter_payload + project_bwd (masked) + the activations' backward; "
              "their own times are on the kernels line")


# ----------------------------------------------------------------- large configurations

# The JAX package's large configurations, at full size through the normal
# entry points (bench.py --scene trained; bench.py:30-43's 2^23 envelope):
# 1920x1080, packed payload, eps 1e-3, the pair budget tuned at headroom
# 1.02 on the phase's cameras.
TRAINED_SPLATS = 1_000_000
ENVELOPE_SPLATS = 8_388_608
ENVELOPE_CAPACITY = 16384
ENVELOPE_CHUNK = 256
# orbit cameras of the two phases' frames, and their timed gradient calls
# (the bench camera's, eager and then replayed)
LARGE_FRAMES = 3
LARGE_GRAD_CALLS = 3


def uncapped_tile_counts(splats, cam, cfg):
    """The (T,) pairs each tile of the frame holds, with no tile_capacity
    (the binning's capped count under a capacity that caps nothing)."""
    budget = cfg.pair_budget(splats.count)
    wide = dataclasses.replace(cfg, tile_capacity=-(-budget // cfg.chunk) * cfg.chunk)
    return compositor_inputs(splats, cam, wide)[1].tile_count


def fit_capacity(splats, cams, cfg):
    """cfg's tile_capacity where no tile of these cameras' frames holds more
    pairs, else the smallest multiple of the chunk that drops none; and the
    deepest tile's pairs."""
    deepest = max(int(uncapped_tile_counts(splats, c, cfg).max()) for c in cams)
    if deepest <= cfg.tile_capacity:
        return cfg, deepest
    return dataclasses.replace(cfg, tile_capacity=-(-deepest // cfg.chunk) * cfg.chunk), deepest


def check_path_binning(splats, cam, cfg, label):
    """The frame glue and the binning of a path's whole frame against their
    plain versions (check_glue_case); the key form the binning took and
    whether the exact-coverage cull ran."""
    n, w, h = splats.count, cam.width, cam.height
    res = {"gather_cases": 0, "scatter_cases": 0, "marks_cases": 0, "expand_cases": 0, "key_split_cases": 0,
           "bin_splats_cases": 0, "sat_culled_pairs": 0}
    check_glue_case(splats, cam, cfg, (0, 0), label, res)
    nty, ntx = binning.tile_grid(w, h, cfg.tile_h, cfg.tile_w)
    sat_cull, rho_ok = binning.sat_flags(n, w, h, cfg)
    return {"bin_splats": "bit-equal through the kernels and through the plain versions (operands form with and "
                          "without the gradient map, order= form with it)",
            "key_form": "packed" if kglue.key_fits(nty * ntx, n) else "wide", "sat_cull": sat_cull, "rho_ok": rho_ok,
            "cases": res}


def large_frames(splats, cams, cfg, label):
    """The frames of a large path through render(..., with_stats=True),
    eager (launch counters zeroed before, read after) and captured
    (captured_frame: each replay bit-equal to its eager frame)."""
    w, h = cams[0].width, cams[0].height
    frames = len(cams)
    gt.render(splats, cams[0], cfg, backend="auto")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    times, images, dropped = [], [], []
    for cam in cams:
        ms, (image, stats) = cuda_time_ms(lambda: gt.render(splats, cam, cfg, backend="auto", with_stats=True))
        times.append(ms)
        images.append(image)
        dropped.append(int(stats.dropped_pairs))
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated()
    want = frame_counts(frames)
    if counts != want:
        fail(f"{label} frames: launch counts {counts}, expected {want}")
    if any(dropped):
        fail(f"{label} frames: dropped_pairs {dropped}")
    coverage = []
    for image in images:
        check_frame(image, w, h, f"{label} frame")
        coverage.append(round(float((image[..., 3] > 0.5).float().mean()), 4))
    if min(coverage) < 0.01:
        fail(f"{label} frames (nearly) empty: covered shares {coverage}")
    graph = captured_frame(splats, cams, cfg, images, want)
    del graph["serve"], images
    return {"frame_ms": times, "median_frame_ms": statistics.median(times), "dropped_pairs": dropped,
            "covered_share": coverage, "peak_memory_bytes": peak, "launches": counts,
            "median_graph_frame_ms": graph.pop("median_graph_frame_ms"), "graph": graph}


def large_gradient(splats, cam, cfg, calls, label):
    """bench.py's forward+backward: the gradient of sum(render(...)[..., :3])
    over all six fields, eager (`calls` timed, every call bit-equal to the
    first) and captured in a CUDA graph (every replay bit-equal to the eager
    gradient), dropped_pairs 0, the launch counters zeroed before and read
    after each, a replay's trace holding the counted kernels."""
    leaves = {f: getattr(splats, f).detach().clone().requires_grad_(True) for f in SPLAT_FIELDS}
    scene = dataclasses.replace(splats, **leaves)

    def fwd_bwd():
        image, stats = gt.render(scene, cam, cfg, backend="auto", with_stats=True)
        grads = torch.autograd.grad(image[..., :3].sum(), [leaves[f] for f in SPLAT_FIELDS])
        return grads + (stats.dropped_pairs,)

    def same(a, b):
        return all(bits_equal(x, y) for x, y in zip(a, b))

    fwd_bwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    times, first, equal = [], None, 0
    for _ in range(calls):
        ms, out = cuda_time_ms(fwd_bwd)
        times.append(ms)
        if first is None:
            first = out
        equal += int(same(out, first))
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated()
    want = gradient_counts(calls)
    if counts != want:
        fail(f"{label} gradient: launch counts {counts}, expected {want}")
    if equal != calls:
        fail(f"{label} gradient: {calls - equal} of {calls} eager calls differ from the first")
    if int(first[-1]):
        fail(f"{label} gradient: dropped_pairs {int(first[-1])}")
    grad_max = {}
    for f, g in zip(SPLAT_FIELDS, first):
        if not torch.isfinite(g).all():
            fail(f"{label} gradient of {f} holds non-finite values")
        grad_max[f] = float(g.abs().max())
    if max(grad_max.values()) == 0.0:
        fail(f"{label} gradient is all zero")
    del out
    t0 = time.time()
    graph = graphs.capture(fwd_bwd)
    capture_s = time.time() - t0
    for _ in range(WARMUP_STEPS):
        graph.replay()
    torch.cuda.synchronize()
    zero_counters()
    gtimes, gequal = [], 0
    for _ in range(calls):
        ms, out = cuda_time_ms(graph.replay)
        gtimes.append(ms)
        gequal += int(same(out, first))
    gcounts = read_counters()
    if gcounts != want:
        fail(f"{label} captured gradient: launch counts {gcounts}, expected {want}")
    if gequal != calls:
        fail(f"{label} captured gradient: {calls - gequal} of {calls} replays differ from the eager gradient")
    traced = traced_calls(graph.replay, 2)
    per_call = {k: v // calls for k, v in gcounts.items() if k in OUR_KERNELS}
    if traced["our_kernels_per_call"] != per_call:
        fail(f"{label} captured gradient: a replay's trace holds {traced['our_kernels_per_call']}, "
             f"the counters {per_call}")
    out = {"calls": calls, "grad_ms": times, "median_grad_ms": statistics.median(times),
           "median_graph_grad_ms": statistics.median(gtimes), "graph_grad_ms": gtimes,
           "bit_equal_to_eager": gequal, "dropped_pairs": 0, "grad_abs_max": grad_max, "peak_memory_bytes": peak,
           "graph_pool_bytes": graph.pool_bytes, "capture_s": capture_s, "launches": counts,
           "graph_launches": gcounts, "replay_device_ops": traced["device_ops_per_call"],
           "replay_device_us": traced["device_us_per_call"], "replay_kernels_traced": traced["our_kernels_per_call"]}
    del graph, first
    return out


def large_wireframe(splats, cams, cfg, label):
    """bench.py's wireframe frame (bench.py:114-130): render_wireframe with
    the float32 payload and the untuned budget, one frame a camera between
    two CUDA events; its dropped_pairs printed."""
    w, h = cams[0].width, cams[0].height
    wcfg = dataclasses.replace(cfg, payload_dtype="float32", pair_budget_override=0)
    gt.render_wireframe(splats, cams[0], wcfg, line_px=LINE_PX)
    zero_counters()
    times, images = [], []
    for cam in cams:
        ms, image = cuda_time_ms(lambda: gt.render_wireframe(splats, cam, wcfg, line_px=LINE_PX))
        times.append(ms)
        images.append(image)
    counts = read_counters()
    frames = len(cams)
    want = dict(frame_counts(frames), composite_fwd_wire=frames)
    if counts != want:
        fail(f"{label} wireframe: launch counts {counts}, expected {want}")
    for image in images:
        check_frame(image, w, h, f"{label} wireframe")
    covered = float((images[0][..., 3] > 0.5).float().mean())
    if not covered > 0.01:
        fail(f"{label} wireframe frame (nearly) empty: {covered:.4f} of the pixels covered")
    dropped = [int(wire._wireframe_inputs(splats, c, wcfg, LINE_PX)[1].dropped_pairs) for c in cams]
    return wcfg, {"payload_dtype": wcfg.payload_dtype, "pair_budget": wcfg.pair_budget(splats.count),
                  "line_px": LINE_PX, "frame_ms": times, "median_frame_ms": statistics.median(times),
                  "dropped_pairs": dropped, "covered_share": covered, "launches": counts}


def large_kernel_rows(splats, cam, cfg, counts, tag, wcfg=None, wire_launches=0):
    """Every kernel of a large path held to its plain version at the path's
    own inputs (its first camera, its config; the backward and the segment
    sum on the gradient frame's image cotangent, ones on the colour rows),
    with its time, the plain version's, the library call's and the bound
    (rows named with `tag`; `counts` the path's launches)."""
    n = splats.count
    g = torch.Generator(device=DEV)
    g.manual_seed(9)
    rows = [scan_row(kind, length, g, counts[f"scan_i32_{kind}"], tag=tag)
            for kind, length in (("add", n), ("max", cfg.pair_budget(n)))]
    rows.append(forward_row(splats, cam, cfg, counts["composite_fwd"] - counts["composite_fwd_checkpoint"]
                            - counts["composite_fwd_wire"], tag=tag))
    rows.append(projection_row(False, splats, cam, cfg, counts["project_fwd"], payload_dtype=cfg.payload_dtype,
                               tag=tag))
    rows += glue_rows(splats, cam, cfg, {"path": counts}, counts, tag=tag)
    d_out = torch.zeros((cam.height, cam.width, 4), device=DEV)
    d_out[..., :3] = 1.0
    rows += phase_train_kernels(splats, cam, cfg, counts, tag=tag, d_out=d_out, seg_tols=(GRAD_TOL, GRAD_TOL))
    if wcfg is not None:
        rows.append(wire_row(splats, cam, wcfg, wire_launches, tag=tag))
    return rows


def add_counts(*counts):
    return {k: sum(c.get(k, 0) for c in counts) for k in counts[0]}


def large_path(phase, splats, cams, base, steps=0, wireframe=False):
    """One of the JAX package's large configurations on the card (see
    phase_trained_path, phase_envelope_path): the binning checked whole, the
    frames eager and captured, the gradient eager and captured, with
    `steps` the training step, with `wireframe` the wireframe frame, then
    every kernel of the path held to its plain version at its inputs.
    Prints the phase's line; returns its kernel rows."""
    t0 = time.time()
    n = splats.count
    cam = cams[0]
    w, h = cam.width, cam.height
    cfg = gt.tune_pair_budget(splats, cams, base, headroom=1.02)
    cfg, deepest = fit_capacity(splats, cams, cfg)
    nty, ntx = binning.tile_grid(w, h, cfg.tile_h, cfg.tile_w)
    pairs = [gt.measure_pairs(splats, c, cfg) for c in cams]
    line = {"splats": n, "size": f"{w}x{h}", "frames": len(cams), "payload_dtype": cfg.payload_dtype,
            "transmittance_eps": cfg.transmittance_eps, "tile_capacity": cfg.tile_capacity,
            "tile_capacity_asked": base.tile_capacity, "deepest_tile_pairs": deepest, "chunk": cfg.chunk,
            "max_chunks": kcomp.max_chunks(cfg), "pair_budget": cfg.pair_budget(n), "pairs": pairs,
            "tiles": nty * ntx}
    line["binning"] = check_path_binning(splats, cam, cfg, phase)
    line["frames_path"] = large_frames(splats, cams, cfg, phase)
    line["gradient"] = large_gradient(splats, cam, cfg, LARGE_GRAD_CALLS, phase)
    runs = [line["frames_path"]["launches"], line["frames_path"]["graph"]["launches"],
            line["gradient"]["launches"], line["gradient"]["graph_launches"]]
    wcfg = None
    if steps:
        step_cfg, target, step_counts, step = train_run(splats, cam, cfg, steps)
        del target
        runs.append(step_counts)
        line["step"] = {k: step[k] for k in (
            "steps", "pair_budget", "warmup_losses", "losses", "median_step_ms", "step_ms", "median_eager_step_ms",
            "eager_losses", "eager_parameters", "peak_memory_bytes", "graph_pool_bytes", "replay_device_ops",
            "replay_device_us", "dropped_pairs", "launches")}
        line["step"]["tile_capacity"] = step_cfg.tile_capacity
    if wireframe:
        wcfg, line["wireframe"] = large_wireframe(splats, cams, cfg, phase)
        runs.append(line["wireframe"]["launches"])
    counts = add_counts(*runs)
    line["dropped_pairs"] = {"frames": line["frames_path"]["dropped_pairs"],
                             "graph_frames": line["frames_path"]["graph"]["dropped_pairs"],
                             "gradient": line["gradient"]["dropped_pairs"]}
    line["peak_memory_bytes"] = max(line["frames_path"]["peak_memory_bytes"], line["gradient"]["peak_memory_bytes"])
    line["graph_pool_bytes"] = {"frame": line["frames_path"]["graph"]["graph_pool_bytes"],
                                "gradient": line["gradient"]["graph_pool_bytes"]}
    line["seconds_paths"] = round(time.time() - t0, 1)
    torch.cuda.empty_cache()
    t1 = time.time()
    tag = "@" + phase.replace("_path", "")
    rows = large_kernel_rows(splats, cam, cfg, counts, tag, wcfg,
                             line["wireframe"]["launches"]["composite_fwd_wire"] if wireframe else 0)
    line["kernels_checked"] = {r["name"]: {"max_abs_err": r["max_abs_err"], "ms": r["ms"],
                                           "bound_ms": r["bound_ms"], "plain_ms": r["plain_ms"]} for r in rows}
    line["launches"] = counts
    line["seconds_kernels"] = round(time.time() - t1, 1)
    line["seconds"] = round(time.time() - t0, 1)
    emit(phase, **line)
    torch.cuda.empty_cache()
    return rows


def phase_trained_path(width, height, steps):
    """The trained-statistics scene at 1M splats (bench.py --scene trained:
    trained_like_splats(1M, extent 1.2, sh_scale 0.1), seed 0)."""
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    splats = gt.trained_like_splats(g, TRAINED_SPLATS, extent=1.2, sh_scale=0.1, device=DEV)
    base = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3)
    return large_path("trained_path", splats, orbit_cameras(width, height, LARGE_FRAMES), base, steps=steps)


def phase_envelope_path(width, height):
    """The reference's 2^23 budget envelope: 8,388,608 splats of the main
    path's scene (bench_scene), tile_capacity 16384, chunk 256."""
    splats = bench_scene(ENVELOPE_SPLATS, seed=0)
    base = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3, tile_capacity=ENVELOPE_CAPACITY,
                           chunk=ENVELOPE_CHUNK)
    return large_path("envelope_path", splats, orbit_cameras(width, height, LARGE_FRAMES), base, wireframe=True)


def check_frame(image, width, height, label):
    if tuple(image.shape) != (height, width, 4) or image.dtype != torch.float32:
        fail(f"{label}: image shape/dtype {tuple(image.shape)} {image.dtype}")
    if not torch.isfinite(image).all():
        fail(f"{label}: image holds non-finite values")
    a = image[..., 3]
    if float(a.min()) < 0.0 or float(a.max()) > 1.0:
        fail(f"{label}: alpha outside [0, 1]: [{float(a.min())}, {float(a.max())}]")


def phase_host_scene(splats, cams, frames, main_cfg):
    """Compositing into a host scene at full size: the depth-tested beauty
    pass (float32 payload, the plane occluder, the grey scene colour), its
    gradient, and the wireframe and wire-over views."""
    cam = cams[0]
    width, height = cam.width, cam.height
    n = splats.count
    bgd, bg_rgba = occluder(width, height)
    cfg = gt.RenderConfig(payload_dtype="float32", transmittance_eps=1e-3)
    cfg = gt.tune_pair_budget(splats, cams, cfg, headroom=1.02)
    dcfg = dataclasses.replace(cfg, depth_test=True)
    out = {}

    def frame(c):
        return gt.render(splats, c, cfg, backend="auto", with_stats=True,
                         background_rgba=bg_rgba, background_depth=bgd)

    for k in range(WARMUP_FRAMES):
        frame(cams[k % len(cams)])
    zero_counters()
    times, dropped, images = [], [], []
    for c in cams[:frames]:
        ms, (image, stats) = cuda_time_ms(lambda: frame(c))
        times.append(ms)
        dropped.append(int(stats.dropped_pairs))
        images.append(image)
    counts = read_counters()
    want = dict(frame_counts(frames), composite_fwd_depth=frames)
    if counts != want:
        fail(f"host-scene frames: launch counts {counts}, expected {want}")
    if any(dropped):
        fail(f"host-scene frames: dropped_pairs {dropped}")
    for image in images:
        check_frame(image, width, height, "host-scene frame")
        if float((image[..., 3] < 1.0 - 1e-6).float().mean()) > 1e-3:
            fail("host-scene frame: the opaque scene colour left pixels uncovered")
    untested = gt.render(splats, cam, cfg, backend="auto", background_rgba=bg_rgba)
    killed = float((images[0] - untested).abs().max())
    killed_share = float(((images[0] - untested).abs().amax(dim=-1) > 1e-6).float().mean())
    if not killed > 1e-3:
        fail(f"host-scene frame: the plane killed nothing (max|diff| {killed:.3e} against the untested frame)")
    out["frames"] = {"frames": frames, "frame_ms": times, "median_frame_ms": statistics.median(times),
                     "min_frame_ms": min(times), "dropped_pairs": dropped, "launches": counts,
                     "vs_untested_max_abs": killed, "pixels_changed_share": killed_share}

    # One full-size gradient of an L1 loss through the depth-tested render,
    # towards the untested frame.
    target = untested[..., :3].detach()
    leaves = {f: getattr(splats, f).detach().clone().requires_grad_(True) for f in SPLAT_FIELDS}
    zero_counters()

    def grad_step():
        image = gt.render(dataclasses.replace(splats, **leaves), cam, cfg, backend="auto",
                          background_rgba=bg_rgba, background_depth=bgd)
        loss = gt.l1_loss(image[..., :3], target)
        loss.backward()
        return loss

    grad_ms, loss = cuda_time_ms(grad_step)
    counts = read_counters()
    want = dict(gradient_counts(1), composite_fwd_depth=1, composite_bwd_depth=1)
    if counts != want:
        fail(f"host-scene gradient: launch counts {counts}, expected {want}")
    grad_max = {}
    for f in SPLAT_FIELDS:
        g = leaves[f].grad
        if g is None or not torch.isfinite(g).all():
            fail(f"host-scene gradient of {f} missing or non-finite")
        grad_max[f] = float(g.abs().max())
    if max(grad_max.values()) == 0.0:
        fail("host-scene gradient is all zero")
    out["gradient"] = {"loss": float(loss.detach()), "ms": grad_ms, "grad_abs_max": grad_max, "launches": counts}

    # The wireframe views; the budget fits the wireframe pass's own pairs
    # (boxes grown by the line width, no exact-coverage cull).
    wire_pairs = max(int(binning.count_pairs(wire._wireframe_projected(splats, c, LINE_PX), width, height,
                                             dataclasses.replace(cfg, wireframe=True)))
                     for c in cams[:3])
    beauty_budget = main_cfg.pair_budget(n)
    budget = max(beauty_budget, -(-int(wire_pairs * 1.02) // (1 << 17)) * (1 << 17))
    wcfg = dataclasses.replace(main_cfg, pair_budget_override=budget)
    for k in range(2):
        gt.render_wireframe(splats, cams[k], wcfg, line_px=LINE_PX)
        gt.render_wire_over(splats, cams[k], wcfg, line_px=LINE_PX)
    # one frame a camera of the three, each between two CUDA events
    zero_counters()
    cam3 = itertools.cycle(cams[:3]).__next__
    wire_fps = measure_fps(lambda: gt.render_wireframe(splats, cam3(), wcfg, line_px=LINE_PX),
                           iters=3, warmup=0, device=bgd.device)
    counts_w = read_counters()
    zero_counters()
    over_fps = measure_fps(lambda: gt.render_wire_over(splats, cam3(), wcfg, line_px=LINE_PX),
                           iters=3, warmup=0, device=bgd.device)
    counts_o = read_counters()
    wire_imgs = [gt.render_wireframe(splats, c, wcfg, line_px=LINE_PX) for c in cams[:3]]
    over_imgs = [gt.render_wire_over(splats, c, wcfg, line_px=LINE_PX) for c in cams[:3]]
    if counts_w != dict(frame_counts(3), composite_fwd_wire=3):
        fail(f"wireframe frames: launch counts {counts_w}")
    if counts_o != dict(frame_counts(6), composite_fwd_wire=3):
        fail(f"wire-over frames: launch counts {counts_o}")
    args, b = wire._wireframe_inputs(splats, cam, wcfg, LINE_PX)
    if int(b.dropped_pairs) != 0:
        fail(f"wireframe: dropped_pairs {int(b.dropped_pairs)} with a budget of {budget}")
    for img in wire_imgs + over_imgs:
        check_frame(img, width, height, "wireframe")
    covered = float((wire_imgs[0][..., 3] > 0.5).float().mean())
    if not covered > 0.01:
        fail(f"wireframe frame (nearly) empty: {covered:.4f} of the pixels covered")
    out["wireframe"] = {"line_px": LINE_PX, "pair_budget": budget, "pairs": wire_pairs, "dropped_pairs": 0,
                        "frames": wire_fps["iters"], "median_frame_ms": wire_fps["median_ms"],
                        "covered_share": covered, "launches": counts_w}
    out["wire_over"] = {"frames": over_fps["iters"], "median_frame_ms": over_fps["median_ms"], "launches": counts_o}
    emit("host_scene_path", splats=n, size=f"{width}x{height}", payload_dtype=cfg.payload_dtype,
         transmittance_eps=cfg.transmittance_eps, pair_budget=cfg.pair_budget(n),
         occluder="view depth 2.0 -> 3.5 across the image, opaque grey 0.3", **out)
    return dcfg, bgd, wcfg, out


# ----------------------------------------------------------------- host runtime

# The JAX package's PLY round-trip gates (tests/test_fit_quality.py:57-62) and
# its rebase gate (tests/test_scene.py:155-156).
PLY_POS_TOL = 1e-6
PLY_OPACITY_TOL = 1e-5
REBASE_TOL = 2e-3
RAYS = 4096
EXAMPLE_TIMEOUT_S = 300


def slab_test_numpy(lo, hi, org, dir_):
    """The ray/bbox slab test in float32 numpy, written apart from
    ops/queries.py: (hit, t_entry)."""
    parallel = np.abs(dir_) <= np.float32(1e-30)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.float32(1.0) / np.where(parallel, np.float32(1.0), dir_)
        t0 = (lo - org) * inv
        t1 = (hi - org) * inv
    inside = (org >= lo) & (org <= hi)
    inf = np.float32(np.inf)
    lo_t = np.where(parallel, np.where(inside, -inf, inf), np.minimum(t0, t1))
    hi_t = np.where(parallel, np.where(inside, inf, -inf), np.maximum(t0, t1))
    t_near, t_far = lo_t.max(axis=-1), hi_t.min(axis=-1)
    t_entry = np.maximum(t_near, np.float32(0.0))
    return (t_far >= t_near) & (t_far >= 0.0), t_entry


def check_ray_queries(loaded):
    """intersect_rays_bbox on the card against the numpy slab test: hits
    exactly equal, distances within 1e-6 of their size."""
    g = torch.Generator(device=DEV)
    g.manual_seed(13)
    orgs = 4.0 * torch.randn((RAYS, 3), generator=g, device=DEV)
    dirs = torch.randn((RAYS, 3), generator=g, device=DEV)
    dirs[::16, 0] = 0.0   # parallel to the x slabs
    dirs[::64, 2] = 0.0
    ms, hit = cuda_time_ms(lambda: gt.intersect_rays_bbox(loaded, orgs, dirs), 10, warmup=2)
    lo, hi = (t.cpu().numpy() for t in loaded.bbox())
    want_hit, want_t = slab_test_numpy(lo, hi, orgs.cpu().numpy(), dirs.cpu().numpy())
    got_hit, got_t = hit.hit.cpu().numpy(), hit.distance.cpu().numpy()
    if not np.array_equal(got_hit, want_hit):
        fail(f"ray queries: {int((got_hit != want_hit).sum())} of {RAYS} hits differ from the numpy slab test")
    t_err = float(np.abs(got_t[got_hit] - want_t[got_hit]).max(initial=0.0))
    if not t_err <= 1e-6 * max(1.0, float(np.abs(want_t[got_hit]).max(initial=0.0))):
        fail(f"ray queries: distances differ by {t_err:.3e}")
    return {"rays": RAYS, "hits": int(got_hit.sum()), "max_abs_distance_err": t_err, "ms": ms}


def check_native(loaded):
    """io/native.py built with g++ on this machine: the radix argsort of the
    depth keys and the Morton order of the positions against their plain
    versions."""
    from gsplat_tpu_torch.io import native

    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    pos = loaded.pos.cpu().numpy()
    keys = ((pos - np.float32(0.3)) ** 2).sum(axis=0).astype(np.float32)
    t0 = time.perf_counter()
    order = native.radix_argsort(keys)
    sort_s = time.perf_counter() - t0
    if not np.array_equal(order, native.radix_argsort_plain(keys)):
        fail("native radix_argsort differs from its plain version on the depth keys")
    t0 = time.perf_counter()
    morton = native.morton_order(pos)
    morton_s = time.perf_counter() - t0
    if not np.array_equal(np.sort(morton), np.arange(pos.shape[1], dtype=np.int32)):
        fail("native morton_order is not a permutation")
    return {"build_or_load_s": build_s, "radix_argsort_s": sort_s, "morton_order_s": morton_s,
            "keys": int(keys.shape[0])}


def registry_run(reg, ids, cams, label):
    """Five registry frames (include, render, post_render), the launch
    counters zeroed just before and read just after; each frame's image,
    depth order and deferred stats kept for the checks."""
    zero_counters()
    times, images, orders, stats = [], [], [], []
    for cam in cams:
        def frame():
            for rid in ids:
                reg.include_in_render_pass(rid)
            image = reg.render(cam)
            stats.append(reg._last_stats)
            orders.append(reg._order)
            reg.post_render()
            return image
        ms, image = cuda_time_ms(frame)
        times.append(ms)
        images.append(image)
    counts = read_counters()
    n = len(cams)
    want = frame_counts(n)
    if counts != want:
        fail(f"scene_path {label}: launch counts {counts}, expected {want}")
    dropped = [int(s.dropped_pairs) for s in stats]
    if any(dropped):
        fail(f"scene_path {label}: dropped_pairs {dropped} (the registry's deferred stats)")
    return times, images, orders, counts, dropped


def phase_scene_path(splats, cams, tmp, card):
    """The host runtime at full width: the 1M-splat scene written to a PLY,
    loaded back on the card, registered as two clusters and rendered through
    SceneRegistry; ray queries; the native helpers."""
    n = splats.count
    path = tmp / "bench_scene.ply"
    t0 = time.perf_counter()
    gt.save_ply(path, splats)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = gt.load_ply(path, device=DEV)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    pos_err = float((loaded.pos - splats.pos).abs().max())
    op_err = float((loaded.opacity - splats.opacity).abs().max())
    if not (pos_err <= PLY_POS_TOL and op_err <= PLY_OPACITY_TOL):
        fail(f"PLY round trip: pos {pos_err:.3e} (gate {PLY_POS_TOL}), opacity {op_err:.3e} (gate {PLY_OPACITY_TOL})")

    # two clusters, rows [0, n/2) and [n/2, n): their concat is the loaded scene's row order
    d = gt.to_numpy_dict(loaded)
    half = n // 2
    halves = [gt.splats_from_numpy({k: v[:half] for k, v in d.items()}, device=DEV),
              gt.splats_from_numpy({k: v[half:] for k, v in d.items()}, device=DEV)]
    del d
    cfg = gt.tune_pair_budget(loaded, cams, gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3),
                              headroom=1.02)
    render_cfg = dataclasses.replace(cfg, warn_on_drop=False)  # the registry's own render config
    # what the registry accumulates over the orbit: each frame's squared
    # distance from the camera of the last sort (frame 0)
    moved = sum(float(((c.host_position - cams[0].host_position) ** 2).sum()) for c in cams[1:])

    def new_registry(threshold):
        reg = gt.SceneRegistry(cfg)
        reg.sort_movement_threshold = threshold
        return reg, [reg.register_update(f"half_{k}", h) for k, h in enumerate(halves)]

    warm, warm_ids = new_registry(0.0)
    for k in range(WARMUP_FRAMES):
        for rid in warm_ids:
            warm.include_in_render_pass(rid)
        warm.render(cams[k % len(cams)])
        warm.post_render()
    del warm
    torch.cuda.synchronize()

    direct_ms, direct = [], []
    for cam in cams:
        ms, img = cuda_time_ms(lambda: gt.render(loaded, cam, cfg, backend="auto"))
        direct_ms.append(ms)
        direct.append(img)

    out = {}
    for label, threshold in (("resort_every_frame", 0.0), ("one_sort", 2.0 * moved + 1e-3)):
        reg, ids = new_registry(threshold)
        for rid in ids:
            reg.include_in_render_pass(rid)
        geometry_ms, built = cuda_time_ms(reg.generate_render_geometry)
        if not built or reg._cached.count != n:
            fail(f"scene_path {label}: the geometry was not built ({built}, {reg._cached.count} splats)")
        times, images, orders, counts, dropped = registry_run(reg, ids, cams, label)
        if threshold > 0.0 and not all(o is orders[0] for o in orders):
            fail(f"scene_path {label}: the depth order was recomputed under a threshold of {threshold}")
        if threshold == 0.0 and any(a is b for a, b in zip(orders, orders[1:])):
            fail(f"scene_path {label}: a frame reused the depth order at threshold 0")
        # (a) each frame bit-equal to render_cuda of the cached, rebased scene
        # with its origin camera and the order it used
        bit_equal = []
        cached_ms = []
        for cam, image, order in zip(cams, images, orders):
            ocam = reg._origin_camera(cam)
            ms, (want, _) = cuda_time_ms(
                lambda: gt.render_cuda(reg._cached, ocam, render_cfg, order=order, with_stats=True))
            cached_ms.append(ms)
            bit_equal.append(bool(torch.equal(image, want)))
            check_frame(image, cam.width, cam.height, f"scene_path {label}")
        if not all(bit_equal):
            fail(f"scene_path {label}: registry frames bit-equal to render_cuda of the cached scene: {bit_equal}")
        origin_ms = cuda_time_ms(lambda: reg._origin_camera(cams[-1]), 20, warmup=2)[0]
        diffs = [(image - ref).abs().amax(dim=-1) for image, ref in zip(images, direct)]
        max_abs = [float(x.max()) for x in diffs]
        share = [float((x > REBASE_TOL).float().mean()) for x in diffs]
        out[label] = {
            "sort_movement_threshold": threshold, "first_geometry_ms": geometry_ms, "frame_ms": times,
            "median_frame_ms": statistics.median(times), "cached_render_cuda_ms": cached_ms,
            "median_cached_render_cuda_ms": statistics.median(cached_ms),
            "registry_overhead_ms": statistics.median(times) - statistics.median(cached_ms),
            "origin_camera_ms": origin_ms, "dropped_pairs": dropped, "launches": counts,
            "bit_equal_to_render_cuda": bit_equal, "sorts": len({id(o) for o in orders}),
            "vs_direct_max_abs": max_abs, "vs_direct_share_over_tol": share,
        }
        del reg
    # The rebase's rounding may flip single pixels across the 1/255 alpha
    # cutoff; with the order fresh each frame at most WIRE_EDGE_SHARE of them.
    # One sort ages the order over the orbit: printed, and held at frame 0.
    a, b = out["resort_every_frame"], out["one_sort"]
    if max(a["vs_direct_share_over_tol"]) > WIRE_EDGE_SHARE or b["vs_direct_share_over_tol"][0] > WIRE_EDGE_SHARE:
        fail(f"scene_path: pixels beyond {REBASE_TOL} of the direct render: re-sorted {a['vs_direct_share_over_tol']}, "
             f"one sort {b['vs_direct_share_over_tol']} (allowed {WIRE_EDGE_SHARE})")
    rays = check_ray_queries(loaded)
    host = check_native(loaded)
    emit("scene_path", card=card, splats=n, size=f"{cams[0].width}x{cams[0].height}", clusters=[half, n - half],
         ply_bytes=path.stat().st_size, save_ply_s=save_s, load_ply_s=load_s, ply_pos_err=pos_err,
         ply_opacity_err=op_err, payload_dtype=cfg.payload_dtype, transmittance_eps=cfg.transmittance_eps,
         pair_budget=cfg.pair_budget(n), orbit_movement_sq=moved, direct_frame_ms=direct_ms,
         median_direct_frame_ms=statistics.median(direct_ms), rebase_tolerance=REBASE_TOL,
         share_allowed=WIRE_EDGE_SHARE, ray_queries=rays, native=host, **out)
    counts = {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
    return counts


def run_example(args, label):
    """One of examples/*_torch.py in a child process; its output, or fail."""
    cmd = [sys.executable, str(Path(__file__).resolve().parent / "examples" / args[0]), *args[1:]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S)
    if proc.returncode != 0:
        fail(f"{label}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - t0


def phase_examples(ply, tmp):
    """examples/render_ply_torch.py on the 1M-splat PLY at 1280x720 and
    examples/fit_scene_torch.py --steps 20 at its default size."""
    png = tmp / "render_ply_torch.png"
    stdout, render_s = run_example(["render_ply_torch.py", str(ply), str(png), "--eye", "0", "0.4", "3",
                                    "--width", "1280", "--height", "720"], "render_ply_torch.py")
    written = png.stat().st_size if png.exists() else 0
    alpha_max = float(next(line for line in stdout.splitlines() if line.startswith("alpha:")).split()[2].rstrip(","))
    if not written or not alpha_max > 0.0:
        fail(f"render_ply_torch.py: {written} bytes written, alpha max {alpha_max}")
    stdout, fit_s = run_example(["fit_scene_torch.py", "--steps", "20"], "fit_scene_torch.py")
    losses = [float(line.split()[3]) for line in stdout.splitlines() if line.startswith("step")]
    if len(losses) < 2 or not losses[-1] < losses[0]:
        fail(f"fit_scene_torch.py: loss did not fall: {losses}")
    emit("examples", render_ply_torch={"size": "1280x720", "alpha_max": alpha_max, "image_bytes": written,
                                       "seconds": render_s},
         fit_scene_torch={"steps": 20, "losses": losses, "seconds": fit_s})


def heavy_tailed_scene(n=800, seed=0):
    """The JAX package's heavy-tailed fit scene (tests/test_fit_quality.py),
    from the same numpy draws."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scale = np.exp(rng.normal(-4.2, 0.8, (n, 3))).astype(np.float32)
    opacity = (1.0 / (1.0 + np.exp(-rng.normal(0.5, 1.0, n)))).astype(np.float32)
    color = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    sh = (0.08 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    return gt.make_splats(pos, q, scale, opacity, color, sh, device=DEV)


def phase_ply_fit(tmp, steps=120):
    """The JAX package's PLY fit gate (tests/test_fit_quality.py:48-106) through
    the kernels: the heavy-tailed 800-splat scene written with save_ply and
    read with load_ply, 4 views at 96x96, a seeded perturbation, Adam over
    120 steps round robin (one captured make_train_step a view, over one
    optimizer); view 0 must end above 26 dB and start + 3 dB."""
    scene = heavy_tailed_scene()
    path = tmp / "fit_scene.ply"
    gt.save_ply(path, scene)
    loaded = gt.load_ply(path, device=DEV)
    pos_err = float((loaded.pos - scene.pos).abs().max())
    op_err = float((loaded.opacity - scene.opacity).abs().max())
    if not (pos_err <= PLY_POS_TOL and op_err <= PLY_OPACITY_TOL):
        fail(f"fit PLY round trip: pos {pos_err:.3e}, opacity {op_err:.3e}")
    cfg = gt.RenderConfig()
    cams, targets = [], []
    with torch.no_grad():
        for v in range(4):
            ang = 2 * np.pi * v / 4
            cam = gt.make_camera([2.4 * np.sin(ang), 0.4, 2.4 * np.cos(ang)], [0, 0, 0], 96, 96, device=DEV)
            img = gt.render(loaded, cam, cfg, backend="auto")
            cams.append(cam)
            targets.append(img[..., :3] + (1.0 - img[..., 3:4]))
    n = loaded.count
    g = torch.Generator(device=DEV)
    g.manual_seed(5)
    dpos = torch.randn((3, n), generator=g, device=DEV)
    dcol = torch.randn((3, n), generator=g, device=DEV)
    perturbed = dataclasses.replace(loaded, pos=loaded.pos + 0.015 * dpos,
                                    color=torch.clamp(loaded.color + 0.1 * dcol, 0.0, 1.0))
    params = gt.params_from_splats(perturbed)
    opt = gt.default_optimizer(params, lr_pos=1.5e-3)
    step_fns = [gt.make_train_step(opt, cam, cfg, backend="auto", lambda_dssim=0.2) for cam in cams]

    def view0_psnr():
        with torch.no_grad():
            img = gt.render(gt.splats_from_params(params), cams[0], cfg, backend="auto")
            return float(gt.psnr(img[..., :3] + (1.0 - img[..., 3:4]), targets[0]))

    start = view0_psnr()
    zero_counters()
    times, losses = [], []
    for it in range(steps):
        ms, loss = cuda_time_ms(lambda: step_fns[it % 4](params, targets[it % 4]))
        times.append(ms)
        losses.append(float(loss))
    counts = read_counters()
    end = view0_psnr()
    want = gradient_counts(steps)
    if counts != want:
        fail(f"ply fit: launch counts {counts}, expected {want}")
    if not (math.isfinite(end) and end > start + 3.0 and end > 26.0):
        fail(f"ply fit: view-0 PSNR {start:.2f} -> {end:.2f} dB (gate: > start + 3 and > 26)")
    emit("ply_fit", splats=n, views=4, size="96x96", steps=steps, lr_pos=1.5e-3, lambda_dssim=0.2,
         start_psnr_db=start, end_psnr_db=end, first_loss=losses[0], last_loss=losses[-1],
         median_step_ms=statistics.median(times), min_step_ms=min(times),
         step="make_train_step: each view's call 1 eager, call 2 captured, then CUDA graph replays",
         graph_pool_bytes=[s.graph.pool_bytes for s in step_fns], launches=counts)


def pairs_walked(used, b):
    """Live pair positions each tile walked before it stopped."""
    return int((torch.minimum(used, b.tile_span) - torch.where(b.tile_span > 0, b.tile_phi, 0)).clamp(min=0).sum())


def phase_calibrate(splats, cam, cfg, main_ms, train_cfg, step_ms, host_cfg, host_bgd, host_ms):
    """The speed-of-light constants on this card, and the floor of a frame,
    a training step and a host-scene frame at those rates."""
    n = splats.count
    args, b = compositor_inputs(splats, cam, cfg)
    pc = pair_counts(args, kcomp.composite_splats(*args)[1])
    zero_counters()
    res = sol_calibrate.calibrate(pair_splat=b.pair_splat)
    res["gather_random"] = sol_calibrate.gather_rates(
        profile_gather.random_indices(b.pair_splat.numel(), device=b.pair_splat.device))
    counts = read_counters()
    if counts["alu_probe"] == 0 or counts["gather_probe"] == 0 or any(
            v for k, v in counts.items() if k not in ("alu_probe", "gather_probe")):
        fail(f"calibrate: launch counts {counts}")
    by_probe = dict(kprobes.launches)
    device = sol.device_from_calibration(res)
    DEVICE.clear()
    DEVICE.update(device)
    hargs, hb = compositor_inputs(splats, cam, host_cfg)
    hpc = pair_counts(hargs, kcomp.composite_splats(*hargs, bg_depth=host_bgd)[1], host_bgd)
    floors = {}
    for name, budget, ms, fwd_only, c, mode in (
            ("serving_frame", cfg.pair_budget(n), main_ms, True, pc, "beauty"),
            ("training_step", train_cfg.pair_budget(n), step_ms, False, pc, "beauty"),
            ("host_scene_frame", host_cfg.pair_budget(n), host_ms, True, hpc, "depth")):
        floors[name] = (sol.report(n, cam.width, cam.height, budget, ms, fwd_only, device, c["pairs"], mode,
                                   c["live_pixel_updates"]),
                        sol.speed_of_light(n, cam.width, cam.height, budget, fwd_only, device, c["pairs"], mode,
                                           c["live_pixel_updates"]))
    emit("calibrate", card=res["card"], sm_clock_hz=res["alu"]["sm_clock_hz"],
         f32_issue_rate=device["f32_issue_rate"], mul_add_rate=device["mul_add_rate"],
         expf_rate=device["expf_rate"], expf_sass_slots=res.get("expf_sass_slots"),
         hbm_bytes_per_s=device["hbm_bw"], sort_pairs_per_s=device["sort_rate"],
         alu=res["alu"], gather_path=res["gather"], gather_random=res["gather_random"], sort=res["sort"],
         hbm=res["hbm"], launches=counts, launches_by_probe=by_probe,
         sol={k: dict(v[0], achieved_ms=v[0]["sol_ms"] / v[0]["sol_fraction"],
                      stages={s_: ms_ for s_, (ms_, _u) in v[1]["stages"].items()}) for k, v in floors.items()})
    return res, by_probe


def device_events(path, after=None):
    """(name, microseconds) of every device-side event (kernel, copy, fill)
    of a Chrome trace written by stop_trace; with `after`, only those that
    start after the host range of that name began."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    t0 = min((float(e["ts"]) for e in events if e.get("ph") == "X" and e.get("name") == after),
             default=None) if after else None
    if after and t0 is None:
        fail(f"the profiler trace holds no host range {after!r}")
    return [(e["name"], float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and (t0 is None or float(e["ts"]) >= t0)]


# The port's production kernels by counter name, and what their device
# events' names hold (the counter table's kernels).
OUR_KERNELS = {name: c.kernel for name, c in kernel_table.counters().items() if c.kernel}

# Traces a traced_calls may take: a session whose trace comes back with
# fewer device events than calls (every traced call enqueues at least one;
# the tracer's failure, seen on the card with no event at all and, once CUDA
# graphs had run in the process, with a few of the calls' events; and for
# mark_owners' two kernels, one of them missing from every call) is taken
# again; what a trace with as many events a call as the call is known to
# enqueue, or more, shows is never retried.
TRACE_ATTEMPTS = 5


def traced_calls(fn, calls, ops_per_call=1):
    """fn() `calls` times under torch.profiler: the device operations one
    call enqueues and their device microseconds a call, from the trace.
    One more call runs first in the session and is not counted: after CUDA
    graphs had run, a session's trace has come back without the first
    device events it should hold (a captured frame's first kernel).
    `ops_per_call`: the device operations a call is known to enqueue (a
    wrapper of two kernels); a trace with fewer than that a call is taken
    again like one with fewer events than calls (the tracer has come back
    with one of mark_owners' two kernels missing from every call of a
    session)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        start_trace(TRACE_DIR)
        fn()
        torch.cuda.synchronize()
        with torch.profiler.record_function("chip_smoke_counted_calls"):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = device_events(stop_trace(), after="chip_smoke_counted_calls")
        if len(events) >= calls * ops_per_call:
            break
    else:
        fail(f"the profiler trace holds fewer than {ops_per_call} device events a call ({TRACE_ATTEMPTS} sessions)")
    return {"device_ops_per_call": len(events) / calls,
            "device_us_per_call": sum(d for _, d in events) / calls,
            "device_op_names": sorted({n[:60] for n, _ in events}), "trace_sessions": attempt,
            "calls_made": 1 + attempt * (calls + 1),
            "our_kernels_per_call": {k: sum(sub in n for n, _ in events) // calls
                                     for k, sub in OUR_KERNELS.items()}}


def phase_profile(label, units):
    """Optional (--profile): a torch.profiler trace (utils/profiling.py) over
    a few units of work (frames or training steps, each a callable), written
    under build/traces — the device's busy share of the window and the
    kernels that take most device time."""
    units[0]()
    torch.cuda.synchronize()
    start_trace(TRACE_DIR)
    units[0]()  # absorbs the tracer's start-up
    torch.cuda.synchronize()
    t0 = time.time()
    for unit in units:
        unit()
    torch.cuda.synchronize()
    t1 = time.time()
    path = stop_trace()
    wall_ms = (t1 - t0) * 1e3
    # Device-side events only (kernels, copies, fills): an operator's event
    # repeats the time of the kernels it launched.
    kernels = {}
    for name, dur in device_events(path):
        tot, cnt = kernels.get(name, (0.0, 0))
        kernels[name] = (tot + dur, cnt + 1)
    total = len(units) + 1  # the traced window holds one extra unit
    top = sorted(((tot, name, cnt) for name, (tot, cnt) in kernels.items()), reverse=True)
    busy_ms = sum(t for t, _, _ in top) / 1e3 / total
    unit_ms = wall_ms / len(units)
    emit("profile", of=label, units=len(units), trace=path, unit_ms_traced=unit_ms,
         device_busy_ms_per_unit=busy_ms, device_busy_share=busy_ms / unit_ms if unit_ms else None,
         kernel_launches_per_unit=sum(c for _, _, c in top) / total,
         note="unit_ms_traced is host wall time with the tracer on, longer than untraced",
         top=[{"name": name[:90], "device_ms_per_unit": tot / 1e3 / total, "calls_per_unit": cnt / total}
              for tot, name, cnt in top[:14]])


def compositor_bounds(counts, nbytes, kind, mode):
    """A compositor row's bounds from utils/sol.py, priced on the pixel
    updates these inputs need (counts["live_pixel_updates"], α != 0; every
    pixel in soft mode): issue slots at the data sheet's rate (bound_ms), at
    this run's measured rates (bound_measured_ms), the earlier slices' flop
    bound; beside them the same at every pixel of every walked pair
    (bound_all_pixels_ms, the earlier rule)."""
    if kind == "fwd":
        slots, n_expf, flops = sol.FWD_SLOTS[mode], sol.FWD_EXPF[mode], sol.FWD_FLOPS[mode]
    else:
        slots, n_expf, flops = sol.BWD_SLOTS[mode], 1, sol.BWD_FLOPS[mode]
    b = sol.compositor_bound(counts["live_pixel_updates"], nbytes, slots, n_expf, flops, DEVICE)
    a = sol.compositor_bound(counts["pairs"] * 1024, nbytes, slots, n_expf, flops, DEVICE)
    return {"bound_ms": b["issue_datasheet_ms"], "bound_by": b["issue_datasheet_bound_by"],
            "bound_measured_ms": b["issue_ms"], "bound_flops_ms": b["flops_datasheet_ms"],
            "bound_bytes_ms": b["bytes_datasheet_ms"], "issue_slots": b["issue_slots"],
            "bound_all_pixels_ms": a["issue_datasheet_ms"], "bound_all_pixels_measured_ms": a["issue_ms"],
            "bound_rule": f"{slots} slots + {n_expf} expf a live pixel update (utils/sol.py)"}


def bytes_bounds(nbytes):
    b = sol.bytes_bound(nbytes, DEVICE)
    return {"bound_ms": b["datasheet_ms"], "bound_by": "bytes", "bound_measured_ms": b["measured_ms"],
            REPRICE: lambda: bytes_bounds(nbytes)}


# A row's key for the function that prices its bounds again: a row taken
# before the calibrate phase has its measured-rate bounds at the data
# sheet's rates until priced_rows prices them at this run's.
REPRICE = "_reprice"


def priced_rows(rows):
    """The rows with their bounds priced at DEVICE's rates now."""
    for row in rows:
        fresh = row.pop(REPRICE, None)
        if fresh is not None:
            fresh = fresh()
            fresh.pop(REPRICE, None)
            row.update(fresh)
    return rows


def pair_counts(fwd, used, bgd=None, offsets=(0, 0)):
    """kcomp.walked_pair_counts of a compositor call's inputs and stop
    counters."""
    pay, pair_splat, tile_base, tile_phi, _, nty, ntx, _, _, cfg = fwd
    return kcomp.walked_pair_counts(pay, pair_splat, tile_base, tile_phi, used, nty, ntx, cfg, bgd, offsets)


def compositor_row(name, source, replaces, launches, err, ms, plain_ms, counts, nbytes, kind, mode, **extra):
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    row.update(compositor_bounds(counts, nbytes, kind, mode))
    row[REPRICE] = lambda: compositor_bounds(counts, nbytes, kind, mode)
    row["library_ms"] = None
    pairs = max(counts["pairs"], 1)
    row.update(pairs_walked=counts["pairs"], live_pixel_updates=counts["live_pixel_updates"],
               live_share=counts["live_pixel_updates"] / (pairs * 1024),
               live_warps_per_pair=counts["live_warps"] / pairs, reach_warps_per_pair=counts["reach_warps"] / pairs,
               bytes=nbytes, **extra)
    if kind == "fwd":  # what the forward's mask keeps (the depth kill included)
        row["kept_warps_per_pair"] = counts["kept_warps"] / pairs
    return row


FWD_SRC = "gsplat_tpu_torch/csrc/composite_fwd.cu"
BWD_SRC = "gsplat_tpu_torch/csrc/composite_bwd.cu"


PROJ_SRC = "gsplat_tpu_torch/csrc/projection.cu"
PROJ_REPLACES = "none: XLA's fusion of gsplat_tpu/ops/projection.py:142 under jax.jit"


def projection_row(backward, splats, cam, cfg, launches, payload_dtype=None, masked=False, tag="", **extra):
    """project_fwd or project_bwd at a path's inputs: error against the plain
    version, the kernel's time (a caller's, back to back, every call reading
    300 or 520 MB at 1M: more than the L2 holds) and its device time from a
    trace, the plain version's time, and the bytes bound (utils/sol.py).
    ``payload_dtype``: the forward in the frame's form, sanitized and
    quantized (its time without that beside it); ``masked``: the backward of
    that form (an invalid splat's cotangent zeroed), on a splat-major
    cotangent as the training path gives it.  ``tag``: appended to the
    row's name (the shapes of another path).  The backward is also held to
    its plain version in the 2-norm of each field (GRAD_TOL)."""
    n = splats.count
    args = proj_args(splats, cam, cfg.sh_order, not cfg.soft_cutoff, cfg.only_sh)
    if backward:
        g = torch.Generator(device=DEV)
        g.manual_seed(12)
        cot = torch.randn((16, n), generator=g, device=DEV)
        if masked:  # splat-major, as the path's scatter_payload writes it
            cot = cot.T.contiguous().T
        got = kproj.project_fields_bwd(*args, cot, masked=masked)
        want = kproj.project_fields_bwd_plain(*args, cot, masked=masked)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want) if a is not None)
        equal = all(bits_equal(a, b) for a, b in zip(got, want) if a is not None)
        rels = list(field_rel_errs(got, want).values())
        rel = max(m for m, _ in rels)
        rel_l2 = max(l2 for _, l2 in rels)
        if not (rel <= PROJ_BWD_TOL and rel_l2 <= GRAD_TOL):
            fail(f"project_bwd at the path's inputs{tag}: {rel:.3e} of a field's max, {rel_l2:.3e} of its 2-norm "
                 "against its plain version")
        kernel = lambda: kproj.project_fields_bwd(*args, cot, masked=masked)
        plain = lambda: kproj.project_fields_bwd_plain(*args, cot, masked=masked)
        extra = dict(extra, masked=masked, max_rel_err_2norm=rel_l2)
    else:
        def plain():
            raw = kproj.project_fields_plain(*args)
            return raw if payload_dtype is None else kproj.payload_fields_plain(raw, payload_dtype)

        def kernel():
            return kproj.project_fields(*args, payload_dtype=payload_dtype)

        got, want = kernel(), plain()
        err = float((got - want).abs().max())
        equal = bits_equal(got, want)
        if not equal:
            fail(f"project_fwd (payload_dtype={payload_dtype}) at the path's inputs{tag} differs from its plain "
                 "version")
        extra = dict(extra, payload_dtype=payload_dtype,
                     ms_raw_fields=cuda_time_ms(lambda: kproj.project_fields(*args), 50, warmup=3)[0])
    del got, want
    ms = cuda_time_ms(kernel, 50, warmup=3)[0]
    plain_ms = cuda_time_ms(plain, 5, warmup=1)[0]
    traced = traced_calls(kernel, 20)
    nbytes = sol.projection_bytes(n, cfg.sh_order, backward, cfg.only_sh, not cfg.soft_cutoff, masked)
    row = {"name": ("project_bwd" if backward else "project_fwd") + tag, "route": "cuda", "source": PROJ_SRC,
           "replaces": PROJ_REPLACES, "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    row.update(bytes_bounds(nbytes))
    row.update(library_ms=None, library="none: no single PyTorch call computes the projection",
               bound_share=row["bound_ms"] / ms, device_us_per_call=traced["device_us_per_call"],
               device_ops_per_call=traced["device_ops_per_call"],
               bound_share_of_device_time=row["bound_ms"] * 1e3 / traced["device_us_per_call"],
               bit_equal_to_plain=equal, splats=n, sh_order=cfg.sh_order, tight_footprint=not cfg.soft_cutoff,
               bytes=nbytes, bytes_per_splat=nbytes / n, **extra)
    if traced["device_ops_per_call"] != 1:
        fail(f"{row['name']}: one call enqueued {traced['device_ops_per_call']} device operations, not 1")
    return row


def phase_train_kernels(splats, cam, cfg, counts, tag="", d_out=None, seg_tols=(SEGSUM_TOL, None)):
    """The training path's kernels at that path's own inputs, or with `tag`
    (appended to the rows' names) at another path's, with its image
    cotangent `d_out` (else a seeded one); `seg_tols`: compare_segsum's
    tolerances (of each row's max, of its 2-norm)."""
    n = splats.count
    packed = cfg.payload_dtype == "packed"
    fwd, b, seeded, g_pad = backward_inputs(splats, cam, cfg, seed=31)
    d_out = seeded if d_out is None else d_out
    del seeded
    label = f"train-path frame{tag}"
    payload, pair_splat = fwd[0], fwd[1]
    chunk = cfg.chunk
    rows = []

    # checkpoint variant of the forward
    used, tchk, e_chk = compare_checkpoint(fwd, label)
    ms_chk = cuda_time_ms(lambda: kcomp.composite_splats(*fwd, checkpoint=True), 10, warmup=2)[0]
    ms_nochk = cuda_time_ms(lambda: kcomp.composite_splats(*fwd), 10, warmup=2)[0]
    plain_chk_ms, _ = cuda_time_ms(lambda: kcomp.composite_splats_plain(*fwd, checkpoint=True))
    pc = pair_counts(fwd, used)
    chunks_walked = int(((used + chunk - 1) // chunk).sum())
    in_bytes = (payload.numel() + pair_splat.numel() + 3 * b.tile_base.numel()) * 4
    img_bytes = cam.height * cam.width * 16
    chk_bytes = chunks_walked * 1024 * 4
    rows.append(compositor_row(
        "composite_fwd_checkpoint" + tag, FWD_SRC, "gsplat_tpu/ops/pallas/composite.py:852",
        counts["composite_fwd_checkpoint"], e_chk, ms_chk, plain_chk_ms, pc,
        in_bytes + img_bytes + used.numel() * 4 + chk_bytes, "fwd", "beauty",
        ms_without_checkpoints=ms_nochk, chunks_walked=chunks_walked, checkpoint_bytes_written=chk_bytes,
        checkpoint_bytes_allocated=tchk.numel() * 4))

    # backward compositor
    gspace, e_bwd, e_bwd_abs = compare_backward(fwd, b, used, tchk, d_out, g_pad, label)
    bargs = fwd[:5] + (used, b.grad_base, d_out, tchk, g_pad) + fwd[5:]
    ms_bwd = cuda_time_ms(lambda: kcomp.composite_bwd(*bargs), 10, warmup=2)[0]
    plain_bwd_ms, _ = cuda_time_ms(lambda: kcomp.composite_bwd_plain(*bargs))
    nbytes = in_bytes + 2 * used.numel() * 4 + img_bytes + chk_bytes + gspace.numel() * 4
    rows.append(compositor_row(
        "composite_bwd" + tag, BWD_SRC, "gsplat_tpu/ops/pallas/composite.py:853", counts["composite_bwd"],
        e_bwd_abs, ms_bwd, plain_bwd_ms, pc, nbytes, "bwd", "beauty",
        max_abs_err_is="float32 rows; the two bf16 halves are held to one bf16 step",
        worst_row_rel_err=e_bwd, row_tolerance=GRAD_ROW_TOL, grad_space_columns=g_pad,
        audit="0 skipped live pixels, audit output and a second run bit-equal"))

    # segment sum
    e_seg, e_seg_abs = compare_segsum(gspace, b, packed, label, *seg_tols)
    sargs = (gspace, b.dest_of_exp, b.exp_offsets, b.exp_counts)
    ms_seg = cuda_time_ms(lambda: ksegsum.segsum_by_splat(*sargs, packed=packed), 20, warmup=2)[0]
    plain_seg_ms = cuda_time_ms(lambda: ksegsum.segsum_by_splat_plain(*sargs, packed=packed), 5, warmup=2)[0]
    # The library yardstick: index_add_ of the already gathered expansion-order
    # rows by rank (the port never calls it on the card).
    keep = b.dest_of_exp >= 0
    pair_rows = gspace_rows(gspace, packed).t()[torch.where(keep, b.dest_of_exp, 0).long()] * keep[:, None]
    rank = torch.clamp(b.exp_rank, min=0).long()
    out = torch.zeros((n, 9), device=DEV)
    lib_ms = cuda_time_ms(lambda: out.zero_().index_add_(0, rank, pair_rows), 10, warmup=2)[0]
    del pair_rows, out
    # The same inputs in a float32 space (the depth test's and the float32
    # payload's).
    gs32 = gspace_rows(gspace, packed).t().contiguous()
    e_f32, _ = compare_segsum(gs32, b, False, f"{label}, float32 space", *seg_tols)
    f32_ms = cuda_time_ms(lambda: ksegsum.segsum_by_splat(*(gs32,) + sargs[1:]), 20, warmup=2)[0]
    del gs32
    kept = int(keep.sum())
    other = b.dest_of_exp.numel() * 4 + 2 * n * 4 + 9 * n * 4
    nbytes = kept * gspace.shape[1] * 4 + other
    sector_bytes = kept * 32 * (1 if packed else 2) + other
    row = {"name": "segsum" + tag, "route": "cuda", "source": "gsplat_tpu_torch/csrc/segsum.cu",
           "replaces": "gsplat_tpu/ops/pallas/segsum.py:148", "launches": counts["segsum"],
           "max_abs_err": e_seg_abs, "ms": ms_seg, "plain_ms": plain_seg_ms}
    row.update(bytes_bounds(nbytes))
    row.update(library_ms=lib_ms, library="Tensor.index_add_ on pre-gathered rows",
               sector_bytes=sector_bytes, bound_sectors_ms=sector_bytes / DEVICE["hbm_bw_datasheet"] * 1e3,
               bound_sectors_rule="one 32-byte sector a kept pair (two in float32 mode) beside the useful bytes",
               grad_space=f"pair-major {tuple(gspace.shape)} {str(gspace.dtype).replace('torch.', '')}",
               worst_row_rel_err=e_seg, row_tolerance=seg_tols[0], norm_tolerance=seg_tols[1], pairs_kept=kept,
               pair_budget=b.dest_of_exp.numel(), bytes=nbytes,
               float32_space_ms=f32_ms,
               float32_space_worst_row_rel_err=e_f32,
               float32_space_bound_ms=(kept * 36 + other) / DEVICE["hbm_bw_datasheet"] * 1e3,
               float32_space_bound_sectors_ms=(kept * 64 + other) / DEVICE["hbm_bw_datasheet"] * 1e3)
    rows.append(row)
    rows.append(projection_row(True, splats, cam, cfg, counts["project_bwd"], masked=True, tag=tag))
    return rows


def phase_host_kernels(splats, cam, dcfg, bgd, wcfg, host_counts):
    """The host-scene path's kernels at its own inputs: the forward with the
    depth test, the backward with the depth test, the forward's wireframe
    mode."""
    rows = []
    # forward with the depth test, at the frame's own inputs
    args, b = compositor_inputs(splats, cam, dcfg)
    err, used = compare_compositor(args, "host-scene frame", bgd=bgd)
    ms = cuda_time_ms(lambda: kcomp.composite_splats(*args, bg_depth=bgd), 10, warmup=2)[0]
    plain_ms, _ = cuda_time_ms(lambda: kcomp.composite_splats_plain(*args, bg_depth=bgd))
    pc = pair_counts(args, used, bgd)
    in_bytes = (args[0].numel() + args[1].numel() + 3 * b.tile_base.numel()) * 4
    img_bytes = cam.height * cam.width * 16
    depth_bytes = cam.height * cam.width * 4
    rows.append(compositor_row(
        "composite_fwd_depth", FWD_SRC, "gsplat_tpu/ops/pallas/composite.py:271",
        host_counts["frames"]["launches"]["composite_fwd_depth"], err, ms, plain_ms, pc,
        in_bytes + depth_bytes + img_bytes + used.numel() * 4, "fwd", "depth",
        variant="depth test (payload row 10 = view-z against the scene depth)",
        pairs_binned=int(b.tile_count.sum()), tiles_stopped_early=int((used < b.tile_span).sum())))

    # backward with the depth test
    fwd, bb, d_out, g_pad = backward_inputs(splats, cam, dcfg, seed=51)
    used_c, tchk, _ = compare_checkpoint(fwd, "host-scene frame", bgd=bgd)
    gspace, e_bwd, e_bwd_abs = compare_backward(fwd, bb, used_c, tchk, d_out, g_pad, "host-scene frame", bgd=bgd)
    bargs = fwd[:5] + (used_c, bb.grad_base, d_out, tchk, g_pad) + fwd[5:]
    ms_bwd = cuda_time_ms(lambda: kcomp.composite_bwd(*bargs, bg_depth=bgd), 10, warmup=2)[0]
    plain_bwd_ms, _ = cuda_time_ms(lambda: kcomp.composite_bwd_plain(*bargs, bg_depth=bgd))
    pc_b = pair_counts(fwd, used_c, bgd)
    chk_bytes = int(((used_c + dcfg.chunk - 1) // dcfg.chunk).sum()) * 1024 * 4
    nbytes = (fwd[0].numel() + fwd[1].numel() + 3 * bb.tile_base.numel() + 2 * used_c.numel()) * 4 \
        + depth_bytes + img_bytes + chk_bytes + gspace.numel() * 4
    rows.append(compositor_row(
        "composite_bwd_depth", BWD_SRC, "gsplat_tpu/ops/pallas/composite.py:853",
        host_counts["gradient"]["launches"]["composite_bwd_depth"], e_bwd_abs, ms_bwd, plain_bwd_ms, pc_b,
        nbytes, "bwd", "depth", worst_row_rel_err=e_bwd, row_tolerance=GRAD_ROW_TOL,
        audit="0 skipped live pixels, audit output and a second run bit-equal"))

    # the wireframe band test, at the wireframe pass's own inputs
    rows.append(wire_row(splats, cam, wcfg, host_counts["wireframe"]["launches"]["composite_fwd_wire"]
                         + host_counts["wire_over"]["launches"]["composite_fwd_wire"]))
    return rows


def wire_row(splats, cam, wcfg, launches, tag=""):
    """The forward's wireframe band test at a wireframe pass's inputs: held
    to its plain version and audited, its time, the plain version's, its
    bound.  `tag` is appended to the row's name."""
    wargs, wb = wire._wireframe_inputs(splats, cam, wcfg, LINE_PX)
    err, used = compare_compositor(wargs, f"wireframe frame{tag}")
    ms = cuda_time_ms(lambda: kcomp.composite_splats(*wargs), 10, warmup=2)[0]
    plain_ms, _ = cuda_time_ms(lambda: kcomp.composite_splats_plain(*wargs))
    pc = pair_counts(wargs, used)
    nbytes = (wargs[0].numel() + wargs[1].numel() + 3 * wb.tile_base.numel() + used.numel()) * 4 \
        + cam.height * cam.width * 16
    return compositor_row(
        "composite_fwd_wire" + tag, FWD_SRC, "gsplat_tpu/ops/pallas/composite.py:245", launches, err, ms, plain_ms,
        pc, nbytes, "fwd", "wire", variant=f"wireframe band, line_px {LINE_PX}",
        pairs_binned=int(wb.tile_count.sum()), tiles_stopped_early=int((used < wb.tile_span).sum()),
        dropped_pairs=int(wb.dropped_pairs))


def phase_probe_kernels(calib, by_probe, path_idx):
    """The two probes at the calibrate phase's own shapes: error against the
    plain versions, the calibrate phase's times, the plain versions' times."""
    rows = []
    alu = calib["alu"]
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    x = torch.rand((alu["threads"],), generator=g, device=DEV) * 0.5 + 0.25
    expf_slots = DEVICE["expf_slots"]
    for variant in kprobes.ALU_VARIANTS:
        st = alu[variant]["steps"]
        err, rel = check_alu(x, st, variant, "at the calibration's shape")
        plain_ms, _ = cuda_time_ms(lambda: kprobes.alu_probe_plain(x, st, variant))
        work = kprobes.alu_ops(alu["threads"], st, variant)
        # an expf link: the expf's slots and the subtraction's one
        slots = work["issue_slots"] if "issue_slots" in work else work["links"] * (expf_slots + 1)
        rows.append({
            "name": f"alu_probe_{variant}", "route": "cuda", "source": "gsplat_tpu_torch/csrc/probes.cu",
            "replaces": "scripts/sol_calibrate.py:52", "launches": by_probe[variant], "max_abs_err": err,
            "max_rel_err": rel, "ms": alu[variant]["ms"], "plain_ms": plain_ms,
            "bound_ms": slots / DEVICE["f32_issue_rate_datasheet"] * 1e3, "bound_by": "operations",
            "bound_measured_ms": slots / DEVICE["f32_issue_rate"] * 1e3, "library_ms": None,
            "threads": alu["threads"], "sms": alu["sms"], "steps": st, "links": work["links"],
            "links_per_s": alu[variant]["links_per_s"], "links_per_sm_clock": alu[variant]["links_per_sm_clock"],
            "sm_clock_hz": alu[variant]["sm_clock_hz"],
            "bound_rule": "issue slots at 33.5e12/s (67 TFLOP/s / 2): FMA 1, mul+add 2, "
                          "expf link its SASS count (the expf and the subtraction)",
        })
    for which, res in (("path", calib["gather"]), ("random", calib["gather_random"])):
        idx = path_idx if which == "path" else profile_gather.random_indices(res["queries"], device=DEV)
        mat = torch.randn((kprobes.PROBE_ROWS, res["columns"]), generator=g, device=DEV)
        mats = {"row": mat.t().contiguous()}
        for access in kprobes.GATHER_ACCESSES:
            a = res[access]
            m = mats.get(access, mat)
            if access == "column_write":
                plain = lambda: kprobes.gather_probe_plain(torch.zeros_like(mat), idx, access)
            else:
                plain = lambda: kprobes.gather_probe_plain(m, idx, access)
            row = {"name": f"gather_probe_{access}_{which}", "route": "cuda",
                   "source": "gsplat_tpu_torch/csrc/probes.cu", "replaces": "scripts/profile_dma_gather.py:152",
                   "launches": by_probe[access], "launches_are": "both index sets of the calibrate phase",
                   "max_abs_err": res["max_abs_err"][access], "ms": a["ms"], "plain_ms": cuda_time_ms(plain, 3, warmup=2)[0]}
            row.update(bytes_bounds(a["bytes"]))
            row.update(library_ms=a["library_ms"], library=a["library"], queries=res["queries"],
                       columns=res["columns"], ns_per_query=a["ns_per_query"], bytes_per_s=a["bytes_per_s"],
                       bytes=a["bytes"])
            rows.append(row)
    return rows


def scan_row(kind, length, g, launches, tag="", **extra):
    """scan_i32 of `kind` at `length`: bit-equal to its plain version on
    rotating random inputs, its time (a caller's), its device time and
    operations from a trace, the plain version's and the library call's
    times, the bytes bound.  `tag` is appended to the row's name."""
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
        fail(f"scan_i32[{kind}]{tag} differs from its plain version at length {length}")
    lib = (lambda x: torch.cumsum(x, 0, dtype=torch.int32)) if kind == "add" else (lambda x: torch.cummax(x, 0).values)
    nxt = itertools.cycle(xs).__next__
    ms = cuda_time_ms(lambda: kscan.scan_i32(nxt(), kind), 50, warmup=2)[0]
    plain_ms = cuda_time_ms(lambda: kscan.scan_i32_plain(nxt(), kind), 50, warmup=2)[0]
    library_ms = cuda_time_ms(lambda: lib(nxt()), 50, warmup=2)[0]
    # One call under the profiler: what it enqueues on the device, and
    # the device time alone (ms above is a caller's: host launch
    # included, back to back); the same for the library call.
    traced = traced_calls(lambda: kscan.scan_i32(nxt(), kind), 20)
    lib_traced = traced_calls(lambda: lib(nxt()), 20)
    row = {"name": f"scan_i32_{kind}{tag}", "route": "cuda", "source": "gsplat_tpu_torch/csrc/scan.cu",
           "replaces": "gsplat_tpu/ops/pallas/scan.py:130", "launches": launches, **extra, "length": length,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    row.update(bytes_bounds(8.0 * length))
    row["library_ms"] = library_ms
    row.update(device_ops_per_call=traced["device_ops_per_call"], trace_sessions=traced["trace_sessions"],
               device_us_per_call=traced["device_us_per_call"], device_ops=traced["device_op_names"],
               library_device_ops_per_call=lib_traced["device_ops_per_call"],
               library_device_us_per_call=lib_traced["device_us_per_call"])
    if traced["device_ops_per_call"] != 1:
        fail(f"scan_i32[{kind}]{tag}: one call enqueued {traced['device_ops_per_call']} device operations, not 1")
    return row


def forward_row(splats, cam, cfg, launches, tag="", **extra):
    """The forward compositor at a path's frame (its first camera): held to
    its plain version and audited (compare_compositor), its time, the plain
    version's, its bound.  `tag` is appended to the row's name."""
    args, b = compositor_inputs(splats, cam, cfg)
    err, used = compare_compositor(args, f"frame{tag}")
    ms = cuda_time_ms(lambda: kcomp.composite_splats(*args), 10, warmup=2)[0]
    plain_ms, _ = cuda_time_ms(lambda: kcomp.composite_splats_plain(*args))
    # Work this frame's data needs: the live pair positions each tile walked
    # before it stopped, times 1024 pixels, and every input and output once.
    pc = pair_counts(args, used)
    payload, pair_splat = args[0], args[1]
    nbytes = (payload.numel() + pair_splat.numel() + 3 * b.tile_base.numel()) * 4 \
        + cam.height * cam.width * 16 + used.numel() * 4
    return compositor_row(
        "composite_fwd" + tag, FWD_SRC, "gsplat_tpu/ops/pallas/composite.py:817", launches, err, ms, plain_ms,
        pc, nbytes, "fwd", "beauty", **extra, pairs_binned=int(b.tile_count.sum()),
        tiles_stopped_early=int((used < b.tile_span).sum()))


def phase_kernels(splats, cam, cfg, counts, graph_counts, train_counts, scene_counts):
    """Each kernel at the main path's shapes: error, times, bound.  The scan
    and forward rows' launches are the main path's frames (eager and
    captured) and the scene path's registry frames together
    (launches_by_path)."""
    n = splats.count
    budget = cfg.pair_budget(n)
    g = torch.Generator(device=DEV)
    g.manual_seed(9)
    rows = []
    for kind, length in (("add", n), ("max", budget)):
        name = f"scan_i32_{kind}"
        rows.append(scan_row(kind, length, g, counts[name] + graph_counts[name] + scene_counts[name],
                             launches_by_path={"main_path": counts[name], "main_path_graph": graph_counts[name],
                                               "scene_path": scene_counts[name]},
                             launches_train_path=train_counts[name]))

    rows.append(forward_row(
        splats, cam, cfg, counts["composite_fwd"] + graph_counts["composite_fwd"] + scene_counts["composite_fwd"],
        launches_by_path={"main_path": counts["composite_fwd"], "main_path_graph": graph_counts["composite_fwd"],
                          "scene_path": scene_counts["composite_fwd"]}))
    rows.append(projection_row(
        False, splats, cam, cfg,
        counts["project_fwd"] + graph_counts["project_fwd"] + scene_counts["project_fwd"],
        payload_dtype=cfg.payload_dtype,
        launches_by_path={"main_path": counts["project_fwd"], "main_path_graph": graph_counts["project_fwd"],
                          "scene_path": scene_counts["project_fwd"]},
        launches_train_path=train_counts["project_fwd"]))
    paths = {"main_path": counts, "main_path_graph": graph_counts, "scene_path": scene_counts}
    rows += glue_rows(splats, cam, cfg, paths, train_counts)
    return rows


GLUE_SRC = "gsplat_tpu_torch/csrc/frame_glue.cu"
GLUE_REPLACES = ("none: XLA's fusion of the frame's glue under jax.jit (gsplat_tpu/render.py:41-126; "
                 "gsplat_tpu/ops/binning.py:{})")


def glue_row(name, replaces, kernel, plain, library, library_note, nbytes, paths, train_launches, device_ops=1,
             tag="", **extra):
    """A frame-glue kernel's row: times, its device time from a trace, its
    bytes bound (the caller has held it to its plain version: bit-equal, so
    max_abs_err 0)."""
    ms = cuda_time_ms(kernel, 50, warmup=3)[0]
    plain_ms = cuda_time_ms(plain, 10, warmup=2)[0]
    library_ms = cuda_time_ms(library, 50, warmup=3)[0] if library is not None else None
    traced = traced_calls(kernel, 20, ops_per_call=device_ops)
    if traced["device_ops_per_call"] != device_ops:
        fail(f"{name}{tag}: one call enqueued {traced['device_ops_per_call']} device operations, not {device_ops}")
    row = {"name": name + tag, "route": "cuda", "source": GLUE_SRC, "replaces": replaces,
           "launches": sum(c[name] for c in paths.values()), "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms}
    row.update(bytes_bounds(nbytes))
    row.update(library_ms=library_ms, library=library_note, bound_share=row["bound_ms"] / ms,
               device_us_per_call=traced["device_us_per_call"], device_ops_per_call=traced["device_ops_per_call"],
               bound_share_of_device_time=row["bound_ms"] * 1e3 / traced["device_us_per_call"],
               launches_by_path={k: c[name] for k, c in paths.items()}, launches_train_path=train_launches,
               bit_equal_to_plain=True, bytes=nbytes, **extra)
    return row


def glue_rows(splats, cam, cfg, paths, train_counts, tag=""):
    """gather_payload, scatter_payload, mark_owners and expand_pairs at the
    main path's inputs (its first camera, its tuned budget), or with `tag`
    (appended to the rows' names) at another path's."""
    n, w, h = splats.count, cam.width, cam.height
    fields = kproj.project_fields(*proj_args(splats, cam, cfg.sh_order, not cfg.soft_cutoff, cfg.only_sh),
                                  payload_dtype=cfg.payload_dtype)
    order = torch.argsort(fields[10], stable=True)
    sat_cull, rho_ok = binning.sat_flags(n, w, h, cfg)
    gather = lambda: kglue.gather_payload(fields, order, w, h, cfg, rho_ok)  # noqa: E731
    gather_plain = lambda: kglue.gather_payload_plain(fields, order, w, h, cfg, rho_ok)  # noqa: E731
    got, want = gather(), gather_plain()
    if not all(same_words(getattr(got.operands, k), getattr(want.operands, k))
               for k in ("counts", "nx", "tile0", "thr_q")) or not same_words(got.payload, want.payload):
        fail(f"gather_payload at the path's inputs{tag} differs from its plain version")
    live_rows = 15 if cfg.depth_test else 14
    read = n * (8 + 4 * (13 + int(cfg.depth_test)))
    written = got.payload.numel() * 4 + n * 4 * (3 + int(rho_ok))
    rows = [glue_row(
        "gather_payload", GLUE_REPLACES.format("307 _tile_extents; gsplat_tpu/ops/pallas/composite.py:976-984"),
        gather, gather_plain, lambda: fields[:live_rows].index_select(1, order),
        "index_select of the live rows into depth order (the gather alone, no packing or extents)",
        read + written, paths, train_counts["gather_payload"], tag=tag, splats=n, payload_dtype=cfg.payload_dtype,
        bytes_read=read, bytes_written=written)]
    ops = got.operands
    del got, want
    # the gather's gradient on the training path: the cotangent of the 10
    # float32 rows back into storage order
    g = torch.Generator(device=DEV)
    g.manual_seed(14)
    d_payload = torch.randn((10, n), generator=g, device=DEV)
    if not same_words(kglue.scatter_payload(d_payload, order), kglue.scatter_payload_plain(d_payload, order)):
        fail(f"scatter_payload at the path's inputs{tag} differs from its plain version")
    lib_out = torch.zeros((10, n), device=DEV)
    read, written = n * (8 + 40), n * 64
    rows.append(glue_row(
        "scatter_payload", "none: XLA's fusion of the depth sort's VJP under jax.jit "
        "(gsplat_tpu/ops/rasterize_tiles.py:30-43, gsplat_tpu/ops/permute.py's inverse gather)",
        lambda: kglue.scatter_payload(d_payload, order), lambda: kglue.scatter_payload_plain(d_payload, order),
        lambda: lib_out.index_copy_(1, order, d_payload),
        "index_copy_ of the 10 rows into storage order (the 6 zero rows not written)", read + written,
        {"train_path": train_counts}, train_counts["scatter_payload"], tag=tag, splats=n, bytes_read=read,
        bytes_written=written))
    del d_payload, lib_out
    budget = cfg.pair_budget(n)
    nty, ntx = binning.tile_grid(w, h, cfg.tile_h, cfg.tile_w)
    cum = kscan.scan_i32(ops.counts, "add")
    marks_args = (cum, ops.counts, budget)
    offs, marks = kglue.mark_owners(*marks_args)
    want_offs, want_marks = kglue.mark_owners_plain(*marks_args)
    if not same_words(offs, want_offs) or not same_words(marks, want_marks):
        fail(f"mark_owners at the path's inputs{tag} differs from its plain version")
    del want_offs, want_marks
    lib_marks = torch.zeros((budget + 1,), dtype=torch.int32, device=DEV)
    lib_index = torch.clamp(offs, max=budget).long()
    lib_ranks = torch.arange(1, n + 1, dtype=torch.int32, device=DEV)
    rows.append(glue_row(
        "mark_owners", GLUE_REPLACES.format("340-345, bin_splats' offsets and scatter-max"),
        lambda: kglue.mark_owners(*marks_args), lambda: kglue.mark_owners_plain(*marks_args),
        lambda: lib_marks.scatter_reduce_(0, lib_index, lib_ranks, "amax"),
        "scatter_reduce_ (amax) of the ranks + 1 at the clamped offsets (offsets and indices given)",
        n * 12 + (budget + 1) * 4, paths, train_counts["mark_owners"], device_ops=2, tag=tag, splats=n,
        pair_slots=budget,
        note="a call is two kernels: the marks' zeroing (budget + 1 words, in the bytes bound) and the marks "
             "(12 bytes a rank)"))
    del lib_marks, lib_index, lib_ranks
    smax = kscan.scan_i32(marks[:budget], "max")
    args = (smax, cum, offs, ops, budget, nty * ntx, ntx, cfg, 0, 0, sat_cull, rho_ok, False)
    a, b = kglue.expand_pairs(*args), kglue.expand_pairs_plain(*args)
    if not same_words(a.key, b.key) or not same_words(a.tile, b.tile) or not same_words(a.rank, b.rank):
        fail(f"expand_pairs at the path's inputs{tag} differs from its plain version")
    owners = int(torch.unique(torch.clamp(smax - 1, 0, n - 1)).numel())
    per_owner = 4 * (3 + int(rho_ok)) + 24 * int(sat_cull)
    total = int(cum[-1])
    tile = a.tile if a.key is None else a.key >> kglue.rank_bits(n)
    culled = int((tile == nty * ntx).sum()) - max(budget - total, 0)
    del tile
    rows.append(glue_row(
        "expand_pairs", GLUE_REPLACES.format("386-539, bin_splats' expansion, SAT cull and key"),
        lambda: kglue.expand_pairs(*args), lambda: kglue.expand_pairs_plain(*args), None,
        "none: no single PyTorch call computes the expansion",
        budget * (8 if a.key is not None else 12) + owners * per_owner, paths,
        train_counts["expand_pairs"], tag=tag, pair_slots=budget, pairs=total, owning_ranks=owners,
        pairs_culled_by_sat=culled, sat_cull=sat_cull, rho_ok=rho_ok,
        key_form="packed" if a.key is not None else "wide"))
    return rows


# ----------------------------------------------------------------- sharded

SHARDED_RANKS = 4
SHARDED_STEPS = 3
# A collective that waits longer than this raises in its rank (and the run
# fails) instead of hanging until the script's time limit.
SHARDED_TIMEOUT_S = 300
SHARDED_DIR = Path(__file__).resolve().parent / "build" / "sharded"


def _rank_entry(rank, world, out_dir, task, args, port):
    """A spawned rank: joins the group, runs `task` (a function of this
    module) and leaves its JSON result under out_dir.  With `port` None it
    joins a gloo group through a file under out_dir, every rank on the one
    card; with a port it joins an NCCL group through the standard
    environment (env://, as a launcher starts a rank with one GPU) and
    initialize_distributed makes cuda:LOCAL_RANK its device."""
    timeout = datetime.timedelta(seconds=SHARDED_TIMEOUT_S)
    if port is None:
        torch.cuda.set_device(0)
        gt.initialize_distributed("gloo", init_method=f"file://{out_dir}/rendezvous", world_size=world,
                                  rank=rank, timeout=timeout)
    else:
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        if not gt.initialize_distributed("nccl", timeout=timeout):
            raise RuntimeError("initialize_distributed did not join the group from the environment")
    try:
        result = globals()[task](rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def free_port():
    """A free port on localhost (bound to 0 and released)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(task, world, *args, port=None):
    """Runs `task` in `world` processes started with the spawn method (never
    fork after CUDA is up) and returns their results in rank order.  A rank
    that fails ends the others and fails the run.  `port`: an NCCL group
    joined through the environment at that port (else gloo, see
    _rank_entry)."""
    out_dir = SHARDED_DIR / task
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    try:
        torch.multiprocessing.spawn(_rank_entry, args=(world, str(out_dir), task, args, port), nprocs=world,
                                    join=True, start_method="spawn")
    except Exception as e:  # a rank failed or was killed: the others are ended
        fail(f"{task}: a rank failed: {e}")
    results = []
    for r in range(world):
        with open(out_dir / f"rank{r}.json") as f:
            results.append(json.load(f))
    return results


def one_rank_at_a_time(rank, world, fn):
    """fn() on each rank in turn, the others parked at a barrier: ranks
    sharing a card would otherwise share its time and each other's events."""
    out = None
    for r in range(world):
        dist.barrier()
        if r == rank:
            out = fn()
            torch.cuda.synchronize()
    dist.barrier()
    return out


def strip_geometry(cfg, cam, d):
    """What render_sharded makes of d ranks: the cyclic (dy, dx) grid and the
    strip size, and the local config."""
    nty, ntx = binning.tile_grid(cam.width, cam.height, cfg.tile_h, cfg.tile_w)
    dy, dx = rsh._factor_grid(d, nty, ntx)
    strip_h = -(-cam.height // (dy * cfg.tile_h)) * cfg.tile_h
    strip_w = -(-cam.width // (dx * cfg.tile_w)) * cfg.tile_w
    return (dy, dx), strip_h, strip_w, dataclasses.replace(cfg, row_stride=dy, col_stride=dx)


def rank_strip_inputs(local, cam, cfg_local, mesh, strip_h, strip_w, with_grad_map=False):
    """This rank's compositor inputs on the sharded path (the steps of
    local_strip_render: project its block, exchange, sort, bin its cell).
    Collective: every rank calls it."""
    d = mesh.sp
    p = project_splats(local, cam, cfg_local.sh_order, tight_footprint=not cfg_local.soft_cutoff)
    p = quantize_payload(sanitize_projected(p), cfg_local)
    full, _ = rsh.exchange_projected(p, cam.width, strip_h, d, cfg_local, mesh.sp_group)
    ps = sort_by_depth(full)
    offsets = (mesh.sp_index // cfg_local.col_stride, mesh.sp_index % cfg_local.col_stride)
    b = binning.bin_splats(ps, strip_w, strip_h, cfg_local, row_offset=offsets[0], col_offset=offsets[1],
                           with_tiles=False, with_grad_map=with_grad_map,
                           budget=cfg_local.strip_pair_budget(ps.count, d))
    nty, ntx = binning.tile_grid(strip_w, strip_h, cfg_local.tile_h, cfg_local.tile_w)
    fwd = (kcomp.pack_payload(ps.fields), b.pair_splat, b.tile_base, b.tile_phi, b.tile_span,
           nty, ntx, strip_h, strip_w, cfg_local)
    return fwd, b, offsets


def frame_diff_bound(splats, cam, cfg):
    """How far a strip may differ from the single-device frame when tiles
    stop early: the two walk the same pairs in the same order, but each
    stops on the chunk grid of its own segment base, so one may go on after
    every pixel of the tile has T <= eps - adding at most eps * (largest
    colour) to a pixel, and at most eps to its alpha."""
    p = quantize_payload(sanitize_projected(project_splats(splats, cam, cfg.sh_order)), cfg)
    return cfg.transmittance_eps * max(1.0, float(p.fields[6:9].max())) + 1e-6


def rank_sharded_render(rank, world, n_splats, width, height, frames):
    """sharded_path on one rank: the main path's scene and settings through
    render_sharded over `world` ranks of the one card."""
    mesh = gt.splat_mesh(world, device=DEV)
    splats = bench_scene(n_splats, seed=0)
    cams = orbit_cameras(width, height, frames)
    cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3)
    cfg = gt.tune_pair_budget(splats, cams, cfg, headroom=1.02)
    local = gt.shard_splats(splats, mesh)
    grid, strip_h, strip_w, cfg_local = strip_geometry(cfg, cams[0], world)
    out = {"rank": rank, "grid": grid, "strip": [strip_h, strip_w], "block_columns": local.count}

    for k in range(WARMUP_FRAMES):
        gt.render_sharded(local, cams[k % len(cams)], cfg, mesh)
    torch.cuda.synchronize()
    dist.barrier()
    zero_counters()
    images, dropped, ex_dropped, wall = [], [], [], []
    for cam in cams:
        dist.barrier()
        t0 = time.perf_counter()
        image, stats = gt.render_sharded(local, cam, cfg, mesh, with_stats=True)
        torch.cuda.synchronize()
        dist.barrier()
        wall.append((time.perf_counter() - t0) * 1e3)
        images.append(image)
        dropped.append(int(stats.dropped_pairs))
        ex_dropped.append(int(stats.exchange_dropped))
    counts = read_counters()
    want = expect_counts(scan_i32_add=frames, scan_i32_max=frames, scan_i32=2 * frames,
                         composite_fwd=frames, composite_fwd_strided=frames, project_fwd=frames,
                         expand_pairs=frames, mark_owners=frames)
    if counts != want:
        fail(f"sharded frames, rank {rank}: launch counts {counts}, expected {want}")
    if any(dropped) or any(ex_dropped):
        fail(f"sharded frames, rank {rank}: dropped_pairs {dropped}, exchange_dropped {ex_dropped}")
    diffs = []
    for cam, image in zip(cams, images):
        check_frame(image, width, height, "sharded frame")
        single = gt.render(splats, cam, cfg, backend="auto")
        bound = frame_diff_bound(splats, cam, cfg)
        diff = (image - single).abs()
        err = float(diff.max())
        if not err <= bound:
            fail(f"sharded frame, rank {rank}: max|diff| {err:.3e} against the single-device frame "
                 f"(bound {bound:.3e})")
        diffs.append({"max_abs_diff": err, "bound": bound,
                      "pixels_differing_share": float((diff.amax(dim=-1) > 0).float().mean())})
    del images
    out.update(frames=frames, dropped_pairs=dropped, exchange_dropped=ex_dropped, launches=counts,
               frame_ms_4_processes_on_one_card=wall, vs_single_device_eps_1e_3=diffs)

    # transmittance_eps = 0: the same pairs in the same order, so the frame
    # must be the single-device frame bit for bit, under all three exchanges
    cfg0 = dataclasses.replace(cfg, transmittance_eps=0.0)
    tuned = rsh.tune_strip_exchange(splats, cams, world, cfg0)
    if not tuned.strip_exchange_factor > 0.0:
        fail("tune_strip_exchange kept the gather on the main path's scene")
    policies = {
        "f32_gather_cyclic": cfg0,
        "bf16_gather_cyclic": dataclasses.replace(cfg0, payload_dtype="bfloat16"),
        "strip_exchange_contiguous": tuned,
    }
    exact = {}
    for name, c in policies.items():
        image, stats = gt.render_sharded(local, cams[0], c, mesh, with_stats=True)
        single = gt.render(splats, cams[0], dataclasses.replace(c, strip_exchange_factor=0.0), backend="auto")
        equal = bool(torch.equal(image, single))
        d, e = int(stats.dropped_pairs), int(stats.exchange_dropped)
        if not equal or d or e:
            fail(f"sharded {name}, rank {rank}: bit-equal {equal} (max|diff| "
                 f"{float((image - single).abs().max()):.3e}), dropped_pairs {d}, exchange_dropped {e}")
        exact[name] = {"bit_equal": equal, "dropped_pairs": d, "exchange_dropped": e}
    exact["strip_exchange_contiguous"]["factor"] = tuned.strip_exchange_factor
    out["vs_single_device_eps_0"] = exact

    # one gradient of sum(image * w) through render_sharded on the cyclic
    # grid (eps 0), against the single-device gradient
    g = torch.Generator(device=DEV)
    g.manual_seed(77)
    weights = torch.randn((height, width, 4), generator=g, device=DEV)
    leaves = {f: getattr(local, f).detach().clone().requires_grad_(True) for f in SPLAT_FIELDS}
    zero_counters()
    image = gt.render_sharded(dataclasses.replace(local, **leaves), cams[0], cfg0, mesh)
    (image * weights).sum().backward()
    counts = read_counters()
    want = expect_counts(scan_i32_add=1, scan_i32_max=3, scan_i32=4, composite_fwd=1, composite_fwd_checkpoint=1,
                         composite_fwd_strided=1, composite_bwd=1, composite_bwd_strided=1, segsum=1,
                         project_fwd=1, project_bwd=1, expand_pairs=1, mark_owners=1)
    if counts != want:
        fail(f"sharded gradient, rank {rank}: launch counts {counts}, expected {want}")
    full = splat_grads(splats, cams[0], cfg0, weights, "auto")
    cols = slice(mesh.sp_index * local.count, (mesh.sp_index + 1) * local.count)
    grad_err, max_g, bad = {}, {}, []
    for f in SPLAT_FIELDS:
        got, want_g = leaves[f].grad, full[f][..., cols]
        max_g[f] = scale = float(full[f].abs().max())
        grad_err[f] = e = grad_rel_err(got, want_g, scale)
        if not (e["max"] <= GRAD_TOL and e["l2"] <= GRAD_TOL):
            bad.append(f"{f} differs by {e} (max|g| {scale:.3e})")
        if grad_rel_err(torch.zeros_like(got), want_g, scale)["l2"] <= GRAD_TOL:
            bad.append(f"{f}: the gate passes a zero gradient")
    if bad:
        fail(f"sharded gradient, rank {rank}: {bad} (tolerance {GRAD_TOL})")
    # for sharded_gradient_cause, in the parent
    torch.save({f: leaves[f].grad.cpu() for f in SPLAT_FIELDS}, SHARDED_DIR / "rank_sharded_render" / f"grad{rank}.pt")
    out.update(gradient_rel_err=grad_err, gradient_max_abs=max_g, gradient_launches=counts)
    del full, leaves, image

    # this rank's strided kernels at its own inputs (main settings), timed
    # one rank at a time
    fwd, b, offsets = rank_strip_inputs(local, cams[0], cfg_local, mesh, strip_h, strip_w, with_grad_map=True)

    def kernels():
        r = {"offsets": offsets}
        err, used = compare_compositor(fwd, f"sharded rank {rank}", offsets=offsets)
        if err != 0.0:
            fail(f"strided forward, rank {rank}: not bit-equal to its plain version ({err:.3e})")
        r["fwd_ms"] = cuda_time_ms(lambda: kcomp.composite_splats(*fwd, offsets=offsets), 10, warmup=2)[0]
        r["fwd_plain_ms"] = cuda_time_ms(lambda: kcomp.composite_splats_plain(*fwd, offsets=offsets))[0]
        used_c, tchk, _ = compare_checkpoint(fwd, f"sharded rank {rank}", offsets=offsets)
        gd = torch.Generator(device=DEV)
        gd.manual_seed(90 + rank)
        d_out = torch.randn((strip_h, strip_w, 4), generator=gd, device=DEV)
        g_pad = binning.grad_pad_size(b.dest_of_exp.shape[0], fwd[5] * fwd[6], cfg.chunk)
        gspace, e_rel, e_abs = compare_backward(fwd, b, used_c, tchk, d_out, g_pad, f"sharded rank {rank}",
                                                offsets=offsets)
        bargs = fwd[:5] + (used_c, b.grad_base, d_out, tchk, g_pad) + fwd[5:]
        r["bwd_ms"] = cuda_time_ms(lambda: kcomp.composite_bwd(*bargs, offsets=offsets), 10, warmup=2)[0]
        r["bwd_plain_ms"] = cuda_time_ms(lambda: kcomp.composite_bwd_plain(*bargs, offsets=offsets))[0]
        pc = pair_counts(fwd, used, offsets=offsets)
        chk_bytes = int(((used_c + cfg.chunk - 1) // cfg.chunk).sum()) * 1024 * 4
        in_bytes = (fwd[0].numel() + fwd[1].numel() + 3 * b.tile_base.numel()) * 4
        img_bytes = strip_h * strip_w * 16
        r.update(pairs_walked=pc["pairs"], pair_counts=pc, pairs_binned=int(b.tile_count.sum()), fwd_max_abs_err=err,
                 bwd_max_abs_err=e_abs, bwd_worst_row_rel_err=e_rel,
                 fwd_bytes=in_bytes + img_bytes + used.numel() * 4,
                 bwd_bytes=in_bytes + 2 * used.numel() * 4 + img_bytes + chk_bytes + gspace.numel() * 4,
                 tiles_stopped_early=int((used < b.tile_span).sum()))
        return r

    out["kernels"] = one_rank_at_a_time(rank, world, kernels)
    return out


def rank_sharded_train(rank, world, n_splats, width, height, steps):
    """sharded_train_path on one rank: make_sharded_train_step on a dp 2 x
    sp world/2 mesh, cameras 0 and 1 of the orbit, against the single-device
    make_train_step on each camera."""
    dp = 2
    mesh = gt.make_mesh(batch=dp, splat=world // dp, device=DEV)
    splats = bench_scene(n_splats, seed=0)
    cams = orbit_cameras(width, height, dp)
    main_cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3)
    targets = [perturbed_target(splats, c, main_cfg) for c in cams]
    # eps 0: the strips walk the single-device frame's pairs, so loss and
    # gradient can be held to the single-device step's
    cfg = gt.tune_pair_budget(splats, cams, dataclasses.replace(main_cfg, transmittance_eps=0.0), headroom=1.05)
    ref_losses, ref_grads = [], {}
    for c, t in zip(cams, targets):
        params = gt.params_from_splats(splats)
        step = gt.make_train_step(gt.default_optimizer(params), c, cfg, backend="auto")
        ref_losses.append(float(step(params, t)))
        for k, v in params.as_dict().items():
            ref_grads[k] = ref_grads.get(k, 0.0) + v.grad / dp
        del params, step
    # the witness of how far the single-device gradient itself moves when
    # every cotangent moves by an ulp or two: the same loss times 1 + 2^-22,
    # the gradient divided back
    nudge = 1.0 + 2.0 ** -22
    nudged = {}
    for c, t in zip(cams, targets):
        params = gt.params_from_splats(splats)
        img = gt.render(gt.splats_from_params(params), c, cfg, backend="auto")
        (render_loss(img[..., :3] + (1.0 - img[..., 3:4]), t, 0.2) * nudge).backward()
        for k, v in params.as_dict().items():
            nudged[k] = nudged.get(k, 0.0) + v.grad / nudge / dp
        del params, img
    params = gt.shard_params(gt.params_from_splats(splats), mesh)
    step = gt.make_sharded_train_step(gt.default_optimizer(params), cams[0], mesh, cfg, backend="auto")
    views = torch.stack([c.view for c in cams])
    projs = torch.stack([c.proj for c in cams])
    target_batch = torch.stack(targets)
    torch.cuda.synchronize()
    dist.barrier()
    zero_counters()
    losses, wall, grads = [], [], None
    for k in range(steps):
        dist.barrier()
        t0 = time.perf_counter()
        losses.append(float(step(params, views, projs, target_batch)))
        torch.cuda.synchronize()
        dist.barrier()
        wall.append((time.perf_counter() - t0) * 1e3)
        if k == 0:
            grads = {name: t.grad.clone() for name, t in params.as_dict().items()}
    counts = read_counters()
    strided = steps if mesh.sp_index > 0 else 0  # sp index 0's strip is the identity mapping
    want = expect_counts(scan_i32_add=steps, scan_i32_max=3 * steps, scan_i32=4 * steps, composite_fwd=steps,
                         composite_fwd_checkpoint=steps, composite_fwd_strided=strided, composite_bwd=steps,
                         composite_bwd_strided=strided, segsum=steps, project_fwd=steps, project_bwd=steps,
                         expand_pairs=steps, mark_owners=steps)
    if counts != want:
        fail(f"sharded training, rank {rank}: launch counts {counts}, expected {want}")
    want_loss = sum(ref_losses) / dp
    rel = abs(losses[0] - want_loss) / abs(want_loss)
    if not all(math.isfinite(x) for x in losses) or not rel <= 1e-5:
        fail(f"sharded training, rank {rank}: first loss {losses[0]!r} against the single-device mean "
             f"{want_loss!r} (relative {rel:.3e}, tolerance 1e-5)")
    if not losses[-1] < losses[0]:
        fail(f"sharded training, rank {rank}: loss did not fall: {losses}")
    n_local = params.count
    cols = slice(mesh.sp_index * n_local, (mesh.sp_index + 1) * n_local)
    # The gate is the 2-norm of the difference over the 2-norm of the block:
    # single entries move by up to ~5e-4 of max|g| in the single-device
    # gradient itself when the cotangents move by an ulp (`nudged`: the
    # packed payload's bf16 colour sums flip, the projection's backward
    # amplifies the rest), and the sharded loss's strip sums and SSIM halo
    # move them by that much.
    # planted fault: the step without the dp mean (a mesh with no dp group),
    # from the same start; its gradient is this rank's camera's alone
    faulty = gt.shard_params(gt.params_from_splats(splats), mesh)
    faulty_step = gt.make_sharded_train_step(gt.default_optimizer(faulty), cams[0],
                                             dataclasses.replace(mesh, dp_group=None), cfg, backend="auto")
    faulty_step(faulty, views, projs, target_batch)
    grad_err, max_g, caught, witness, bad = {}, {}, {}, {}, []
    for k, v in grads.items():
        want_g = ref_grads[k][..., cols]
        max_g[k] = scale = float(ref_grads[k].abs().max())
        grad_err[k] = e = grad_rel_err(v, want_g, scale)
        witness[k] = {"nudged_single_vs_single": grad_rel_err(nudged[k][..., cols], want_g, scale),
                      "worst_entries_sharded_single_nudged": worst_entries(v, want_g, nudged[k][..., cols])}
        if not e["l2"] <= GRAD_TOL:
            bad.append(f"{k} differs by {e} (max|g| {scale:.3e})")
        caught[k] = {"zero_gradient": grad_rel_err(torch.zeros_like(v), want_g, scale),
                     "no_dp_mean": grad_rel_err(getattr(faulty, k).grad, want_g, scale)}
    missed = [f"{k}: {fault}" for k, c in caught.items() for fault, e in c.items() if e["l2"] <= GRAD_TOL]
    if bad or missed:
        emit("sharded_train_witness", rank=rank, max_abs_grad=max_g, gradient_rel_err=grad_err, witness=witness,
             planted_faults=caught)
        fail(f"sharded training, rank {rank}: {bad} (tolerance {GRAD_TOL}); planted faults passed: {missed}")
    del faulty, faulty_step
    strip_h = -(-height // (mesh.sp * cfg.tile_h)) * cfg.tile_h
    contiguous = dataclasses.replace(cfg, row_assignment="contiguous")
    with torch.no_grad():
        _, stats = rsh.local_strip_render(gt.splats_from_params(params), cams[mesh.dp_index], strip_h, mesh.sp,
                                          contiguous, "auto", mesh.sp_group, with_stats=True)
    dropped, ex = int(stats.dropped_pairs), int(stats.exchange_dropped)
    if dropped or ex:
        fail(f"sharded training, rank {rank}: dropped_pairs {dropped}, exchange_dropped {ex} after the steps")
    return {"rank": rank, "dp_index": mesh.dp_index, "sp_index": mesh.sp_index, "block_columns": n_local,
            "losses": losses, "single_device_losses": ref_losses, "first_loss_rel_err": rel,
            "gradient_rel_err": grad_err, "gradient_max_abs": max_g, "gradient_witness": witness,
            "planted_faults_rel_err": caught,
            "launches": counts, "dropped_pairs": dropped,
            "step_ms_4_processes_on_one_card": wall}


def phase_sharded_path(n_splats, width, height, frames):
    results = spawn_ranks("rank_sharded_render", SHARDED_RANKS, n_splats, width, height, frames)
    r0 = results[0]
    emit("sharded_path", ranks=SHARDED_RANKS, backend="gloo", on="one card shared by the ranks",
         splats=n_splats, size=f"{width}x{height}", grid=r0["grid"], strip=r0["strip"],
         payload_dtype="packed", transmittance_eps=1e-3,
         frame_ms_4_processes_on_one_card=[r["frame_ms_4_processes_on_one_card"] for r in results],
         note="ranks share one card: these times are no scaling number",
         vs_single_device_eps_1e_3=[r["vs_single_device_eps_1e_3"] for r in results],
         vs_single_device_eps_0=r0["vs_single_device_eps_0"],
         gradient_rel_err=[r["gradient_rel_err"] for r in results],
         gradient_max_abs=r0["gradient_max_abs"],
         per_rank=[{"rank": r["rank"], "launches": r["launches"], "gradient_launches": r["gradient_launches"],
                    **{k: v for k, v in r["kernels"].items()}} for r in results])
    emit("sharded_gradient_cause", **sharded_gradient_cause(n_splats, width, height, frames, SHARDED_RANKS))
    return results


def sharded_gradient_cause(n_splats, width, height, frames, world):
    """Where the render_sharded gradient parts from the single-device one,
    taken apart on this one device at the sharded_path's inputs.  Each
    rank's strip gradient with respect to the sorted projected fields must
    equal, bit for bit, the full-frame gradient with the cotangent masked to
    that rank's tiles, and their float32 sum in rank order (what the
    all_gather's transpose adds), carried back through the projection, must
    be the ranks' gradient bit for bit.  The same sum taken in float64 is
    set beside the single-device gradient: the two sides differ only by the
    rounding of one sum of four, which the projection's backward amplifies
    for some splats."""
    splats = bench_scene(n_splats, seed=0)
    cams = orbit_cameras(width, height, frames)
    cfg = gt.tune_pair_budget(splats, cams, gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3),
                              headroom=1.02)
    cfg0 = dataclasses.replace(cfg, transmittance_eps=0.0)
    cam = cams[0]
    (dy, dx), strip_h, strip_w, cfg_local = strip_geometry(cfg0, cam, world)
    g = torch.Generator(device=DEV)
    g.manual_seed(77)
    weights = torch.randn((height, width, 4), generator=g, device=DEV)
    leaves = {f: getattr(splats, f).detach().clone().requires_grad_(True) for f in SPLAT_FIELDS}
    p = project_splats(dataclasses.replace(splats, **leaves), cam, cfg0.sh_order,
                       tight_footprint=not cfg0.soft_cutoff, only_sh=cfg0.only_sh)
    ps = sort_by_depth(quantize_payload(sanitize_projected(p), cfg0))
    fields = ps.fields
    nty, ntx = binning.tile_grid(width, height, cfg0.tile_h, cfg0.tile_w)
    b = binning.bin_splats(ps, width, height, cfg0, with_tiles=False, with_grad_map=True)
    image = kcomp.composite_splats_diff(fields[:10], b, nty, ntx, height, width, cfg0)
    single_f = torch.autograd.grad((image * weights).sum(), fields, retain_graph=True)[0]
    ty = torch.arange(height, device=DEV) // cfg0.tile_h
    tx = torch.arange(width, device=DEV) // cfg0.tile_w
    ly = torch.arange(strip_h, device=DEV)
    lx = torch.arange(strip_w, device=DEV)
    parts, equal = [], []
    for r in range(world):
        ry, rx = r // dx, r % dx
        mask = ((ty % dy == ry)[:, None] & (tx % dx == rx)[None, :])[..., None]
        masked = torch.autograd.grad((image * weights * mask).sum(), fields, retain_graph=True)[0]
        strip, _ = render_strip(ps, strip_w, strip_h, ry, cfg_local, "cuda", n_strips=world, col_offset=rx)
        gy = (ry + (ly // cfg0.tile_h) * dy) * cfg0.tile_h + ly % cfg0.tile_h
        gx = (rx + (lx // cfg0.tile_w) * dx) * cfg0.tile_w + lx % cfg0.tile_w
        inside = ((gy < height)[:, None] & (gx < width)[None, :])[..., None]
        w_strip = weights[gy.clamp(max=height - 1)][:, gx.clamp(max=width - 1)] * inside
        parts.append(torch.autograd.grad((strip * w_strip).sum(), fields, retain_graph=True)[0])
        equal.append(bool(torch.equal(parts[-1], masked)))
        del masked, strip
    if not all(equal):
        fail(f"sharded gradient cause: a strip's gradient differs from the masked full-frame one: {equal}")
    sum32 = parts[0]
    for part in parts[1:]:
        sum32 = sum32 + part
    sum64 = torch.stack(parts).double().sum(0).float()
    leaf_list = [leaves[f] for f in SPLAT_FIELDS]

    def through_projection(cot):
        return dict(zip(SPLAT_FIELDS, torch.autograd.grad(fields, leaf_list, grad_outputs=cot, retain_graph=True)))

    single, rank_sum, rank_sum64 = (through_projection(c) for c in (single_f, sum32, sum64))
    render_path = splat_grads(splats, cam, cfg0, weights, "auto")
    blocks = [torch.load(SHARDED_DIR / "rank_sharded_render" / f"grad{r}.pt") for r in range(world)]
    out = {"strip_gradient_equals_masked_full_frame": equal,
           "fields_rank_sum_vs_single": grad_rel_err(sum32, single_f, float(single_f.abs().max())),
           "fields_rank_sum_float64_vs_single": grad_rel_err(sum64, single_f, float(single_f.abs().max()))}
    for f in SPLAT_FIELDS:
        sharded = torch.cat([blk[f] for blk in blocks], dim=-1)[..., :n_splats].to(DEV)
        scale = float(single[f].abs().max())
        out[f] = {
            "sharded_equals_rank_sum": bool(torch.equal(sharded, rank_sum[f])),
            "single_equals_render_path": bool(torch.equal(single[f], render_path[f])),
            "sharded_vs_single": grad_rel_err(sharded, single[f], scale),
            "rank_sum_float64_vs_single": grad_rel_err(rank_sum64[f], single[f], scale),
            "worst_entries_sharded_single_rank_sum_float64": worst_entries(sharded, single[f], rank_sum64[f]),
        }
        if not (out[f]["sharded_equals_rank_sum"] and out[f]["single_equals_render_path"]):
            fail(f"sharded gradient cause: {f}: the ranks' gradient is not the rank-order sum of the strips' "
                 f"gradients carried through the projection: {out[f]}")
    return out


def phase_sharded_train(n_splats, width, height, steps):
    results = spawn_ranks("rank_sharded_train", SHARDED_RANKS, n_splats, width, height, steps)
    emit("sharded_train_path", ranks=SHARDED_RANKS, mesh="dp 2 x sp 2", backend="gloo",
         on="one card shared by the ranks", splats=n_splats, size=f"{width}x{height}", steps=steps,
         payload_dtype="packed", transmittance_eps=0.0, cameras="orbit 0 and 1, one a dp row",
         losses=results[0]["losses"], single_device_losses=results[0]["single_device_losses"],
         note="ranks share one card: these times are no scaling number",
         per_rank=results)
    return results


def rank_nccl_collectives(rank, world):
    """The collectives of parallel/collectives.py over an NCCL group, on
    CUDA tensors that go to NCCL as they are: the differentiable all_gather
    (f32 and bf16 on the wire) and its transpose, all_to_all, psum and
    pmean, each against what the ranks' seeded inputs give."""
    group = dist.group.WORLD
    dev = torch.device("cuda", torch.cuda.current_device())

    def block(seed, shape):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev)

    xs = [block(100 + r, (16, 1000)) for r in range(world)]
    cots = [block(200 + r, (16, 1000 * world)) for r in range(world)]
    x = xs[rank].clone().requires_grad_(True)
    y = coll.all_gather(x, group, dim=1)
    y.backward(cots[rank])
    want_grad = cots[0][:, rank * 1000 : (rank + 1) * 1000]
    for r in range(1, world):
        want_grad = want_grad + cots[r][:, rank * 1000 : (rank + 1) * 1000]
    y16 = coll.all_gather(xs[rank].bfloat16().float(), group, dim=1, wire_dtype=torch.bfloat16)
    a2a = coll.all_to_all(torch.stack([xs[rank][r] for r in range(world)]), group)
    total = coll.psum(torch.tensor(float(rank + 1), device=dev), group)
    mean = coll.pmean(torch.tensor(float(rank + 1), device=dev), group)
    return {
        "rank": rank, "backend": str(dist.get_backend(group)), "device": str(dev),
        "device_is_local_rank": dev.index == rank,
        "wire_on_card": bool(coll._wire(xs[rank], group).is_cuda),
        "all_gather_equal": bool(torch.equal(y, torch.cat(xs, dim=1))),
        "all_gather_grad_equal": bool(torch.equal(x.grad, want_grad)),
        "all_gather_bf16_equal": bool(torch.equal(y16, torch.cat(xs, dim=1).bfloat16().float())),
        "all_to_all_equal": bool(torch.equal(a2a, torch.stack([xs[r][rank] for r in range(world)]))),
        "psum": float(total), "psum_want": world * (world + 1) / 2,
        "pmean": float(mean), "pmean_want": (world + 1) / 2,
    }


def phase_nccl_group():
    """One rank a card (the one card here) in an NCCL group joined through
    the environment: the deployment path of initialize_distributed that the
    gloo phases do not take."""
    results = spawn_ranks("rank_nccl_collectives", torch.cuda.device_count(), port=free_port())
    for r in results:
        bad = [k for k, v in r.items() if v is False]
        if r["backend"] != "nccl" or bad or r["psum"] != r["psum_want"] or r["pmean"] != r["pmean_want"]:
            fail(f"nccl group, rank {r['rank']}: {r}")
    emit("nccl_group", ranks=len(results), rendezvous="env://", per_rank=results)
    return results


def phase_sharded_kernels(sharded, train):
    """The strided compositors at rank 0's inputs on the sharded path
    (cyclic 2 x 2 grid, the main path's settings): rank 0's times, with
    every rank's beside them."""
    k0 = sharded[0]["kernels"]
    fwd_launches = sum(r["launches"]["composite_fwd_strided"] + r["gradient_launches"]["composite_fwd_strided"]
                       for r in sharded) + sum(r["launches"]["composite_fwd_strided"] for r in train)
    bwd_launches = sum(r["gradient_launches"]["composite_bwd_strided"] for r in sharded) \
        + sum(r["launches"]["composite_bwd_strided"] for r in train)
    per_rank = [{k: r["kernels"][k] for k in ("offsets", "pairs_walked", "fwd_ms", "bwd_ms")} for r in sharded]
    return [
        compositor_row(
            "composite_fwd_strided", FWD_SRC, "gsplat_tpu/ops/pallas/composite.py:314-316", fwd_launches,
            k0["fwd_max_abs_err"], k0["fwd_ms"], k0["fwd_plain_ms"], k0["pair_counts"], k0["fwd_bytes"], "fwd",
            "beauty", variant=f"strided mapping, grid {sharded[0]['grid']}, rank 0 at offsets {k0['offsets']}",
            launches_are="every strided launch of sharded_path and sharded_train_path, all ranks",
            pairs_binned=k0["pairs_binned"], tiles_stopped_early=k0["tiles_stopped_early"], per_rank=per_rank),
        compositor_row(
            "composite_bwd_strided", BWD_SRC, "gsplat_tpu/ops/pallas/composite.py:509-510", bwd_launches,
            k0["bwd_max_abs_err"], k0["bwd_ms"], k0["bwd_plain_ms"], k0["pair_counts"], k0["bwd_bytes"], "bwd",
            "beauty", variant=f"strided mapping, grid {sharded[0]['grid']}, rank 0 at offsets {k0['offsets']}",
            launches_are="every strided launch of sharded_path and sharded_train_path, all ranks",
            worst_row_rel_err=k0["bwd_worst_row_rel_err"], row_tolerance=GRAD_ROW_TOL),
    ]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splats", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--steps", type=int, default=5, help="training steps after warm-up")
    ap.add_argument("--stop-after", choices=("build", "checks", "reference", "sharded", "trained", "envelope",
                                             "host_scene", "scene"),
                    default=None,
                    help="a short run: stop after this phase (prints no result line)")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print what ptxas reports for each kernel (registers, shared memory, spills)")
    ap.add_argument("--frame-digest", action="store_true",
                    help="only print the SHA-256 of the main path's first frame and of its forward kernel's "
                         "image and stop counters (to hold two trees' kernels to each other; no result line)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace three frames and three training steps with torch.profiler "
                         "(device busy share, top kernels)")
    args = ap.parse_args()

    t0 = time.time()
    timer = PhaseTimer()  # host seconds of every phase
    phase = timer.phase
    card = phase_device()
    if args.frame_digest:
        phase_frame_digest(args.splats, args.width, args.height)
        return
    with phase("build"):
        phase_build(args.verbose_build)
    if args.stop_after == "build":
        return
    with phase("checks"):
        phase_checks()
    if args.stop_after == "checks":
        return
    with phase("reference"):
        phase_reference()
    if args.stop_after == "reference":
        return
    with phase("sharded_path"):
        sharded = phase_sharded_path(args.splats, args.width, args.height, args.frames)
    with phase("sharded_train_path"):
        sharded_train = phase_sharded_train(args.splats, args.width, args.height, SHARDED_STEPS)
    with phase("nccl_group"):
        phase_nccl_group()
    if args.stop_after == "sharded":
        return
    with phase("main_path"):
        splats, cams, cfg, counts, graph = phase_main_path(args.splats, args.width, args.height, args.frames)
    with phase("stages"):
        phase_stages(splats, cams[0], cfg)
    if args.profile:
        with phase("profile_frame"):
            phase_profile("frame", [lambda cam=cam: gt.render(splats, cam, cfg, backend="auto") for cam in cams[:3]])
            phase_profile("frame (graph)", [lambda cam=cam: graph["serve"](cam) for cam in cams[:3]])
    with phase("train_path"):
        train_cfg, target, train_counts, step_ms = phase_train_path(splats, cams[0], cfg, args.steps)
    if args.profile:
        with phase("profile_step"):
            params = gt.params_from_splats(splats)
            step = eager_train_step(gt.default_optimizer(params), cams[0], train_cfg)
            phase_profile("training step", [lambda: step(params, target)] * 3)
            params = gt.params_from_splats(splats)
            step = gt.make_train_step(gt.default_optimizer(params), cams[0], train_cfg, backend="auto")
            step(params, target)  # eager, then captured: the trace sees replays only
            step(params, target)
            phase_profile("training step (graph)", [lambda: step(params, target)] * 3)
            del step, params
    with phase("train_stages"):
        phase_train_stages(splats, cams[0], train_cfg, target)
    del target
    with phase("trained_path"):
        large_rows = phase_trained_path(args.width, args.height, args.steps)
    if args.stop_after == "trained":
        return
    with phase("envelope_path"):
        large_rows += phase_envelope_path(args.width, args.height)
    if args.stop_after == "envelope":
        return
    with phase("host_scene_path"):
        dcfg, bgd, wcfg, host = phase_host_scene(splats, cams, args.frames, cfg)
    if args.stop_after == "host_scene":
        return
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        tmp = Path(tmpdir)
        with phase("scene_path"):
            scene_counts = phase_scene_path(splats, cams, tmp, card)
        with phase("examples"):
            phase_examples(tmp / "bench_scene.ply", tmp)
        (tmp / "bench_scene.ply").unlink()
        with phase("ply_fit"):
            phase_ply_fit(tmp)
    if args.stop_after == "scene":
        return
    with phase("calibrate"):
        path_idx = compositor_inputs(splats, cams[0], cfg)[1].pair_splat
        # the serving frame as a server serves it: replayed from its graph
        calib, by_probe = phase_calibrate(splats, cams[0], cfg, graph["median_graph_frame_ms"], train_cfg, step_ms,
                                          dcfg, bgd, host["frames"]["median_frame_ms"])
    with phase("kernels"):
        rows = phase_kernels(splats, cams[0], cfg, counts, graph["launches"], train_counts, scene_counts)
        rows += phase_train_kernels(splats, cams[0], train_cfg, train_counts)
        rows += phase_host_kernels(splats, cams[0], dcfg, bgd, wcfg, host)
        rows += phase_probe_kernels(calib, by_probe, path_idx)
        rows += phase_sharded_kernels(sharded, sharded_train)
        rows += large_rows
    emit("done", seconds=round(time.time() - t0, 1),
         phase_seconds={name: round(v["max_ms"] / 1e3, 1) for name, v in timer.summary().items()})
    print(json.dumps({"kernels": priced_rows(rows)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
