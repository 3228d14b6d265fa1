"""Speed-of-light model of the port on one NVIDIA H100: the least time each
stage of a frame (and of a training step) could take on the card, priced
against the unit that bounds it (counterpart of ``gsplat_tpu.utils.sol``,
whose constants describe another machine and are not carried over).

Three kinds of floor:

* **bytes** — each input read once and each output written once, at the
  HBM rate (streaming stages, the binning, the segment sum, the probes);
* **issue slots** — the compositing kernels: every instruction of a warp
  takes one of an SM's four dispatch slots a clock, so 128 thread-operations
  per SM and clock is the ceiling, whatever the pipe.  The slots are counted
  for a design that may contract a·b + c into one FMA (the kernels compile
  with ``-fmad=false`` today, which costs more); ``expf`` costs its own
  instructions, which the ``expf`` probe measures, and the special-function
  unit's rate bounds it separately;
* **software floor** — ``torch.sort``'s measured rate (a faster sort is
  possible; it is priced as what the port calls).

Beside the issue-slot bound the data sheet's flop bound (67 TFLOP/s, an FMA
counted as two operations) is kept, as the earlier slices stated it.

Every measured constant names the script that measured it and the card and
power limit it ran on; ``device_from_calibration`` builds the same dictionary
from a fresh run of ``utils/sol_calibrate.py`` (which ``chip_smoke.py``
uses, so its bounds come from the run's own card).
"""

from __future__ import annotations

# Data sheet (NVIDIA H100 SXM5 80 GB) and the constants measured on the card.
H100 = {
    "name": "NVIDIA H100 80GB HBM3",
    "sms": 132,
    # --- data sheet
    "hbm_bw_datasheet": 3.35e12,        # B/s
    "f32_flops_datasheet": 67e12,       # flop/s, an FMA counted as two
    # one float32 instruction per lane and clock: 67e12 / 2
    "f32_issue_rate_datasheet": 33.5e12,
    # --- measured by `python -m gsplat_tpu_torch.utils.sol_calibrate` on an
    # NVIDIA H100 80GB HBM3 at a 700.00 W power limit (PERF.md §6)
    "f32_issue_rate": 3.1965e+13,  # FFMA/s over the card (alu_probe "fma"): 122.3 a SM-clock
    "mul_add_rate": 1.6272e+13,    # separately rounded (mul + add) pairs/s: two slots each
    # links/s of the alu_probe "expf" chain, one expf and one subtraction
    # each: a floor under the card's expf rate
    "expf_rate": 3.5455e+12,
    # instructions of one accurate expf in the probe's SASS (cuobjdump): the
    # link's 8.02 less its subtraction; the range reduction on the float32
    # pipe, one MUFU.EX2, the scaling
    "expf_slots": 7.022,
    "sm_clock_hz": 1.9800e+09,     # SM clock nvidia-smi read during the ALU probes
    "hbm_bw": 2.9641e+12,          # B/s, 256 MB read + write
    "sort_rate": 1.0242e+10,       # (int32 key, int32 payload) pairs/s at 2,359,296
    # queries/s: 16 rows at stride N, the path's indices, under the probe's
    # L2-resident row sweep (`python -m gsplat_tpu_torch.utils.profile_gather`
    # on an NVIDIA H100 80GB HBM3, 700.00 W; 4.3010e+09 before the sweep)
    "column_gather_rate": 7.9537e+09,
    "row_gather_rate": 3.9713e+10,     # queries/s: one 64-byte row of (N, 16), same indices
    "measured_on": "NVIDIA H100 80GB HBM3, 700.00 W",
    "source": "python -m gsplat_tpu_torch.utils.sol_calibrate",
}

# Issue slots a pixel update of the forward compositor needs in a design that
# may contract (composite_common.cuh): dy (1), qx, qy (2 FMA), qx² (1),
# power = fma(qy, qy, qx²) (1), max(|qx|, |qy|) (1), ·op (1), the max_alpha
# min (1), the two threshold compares and the select (3), w = α·T (1), three
# colour FMAs (3), T·(1 − α) (2): 17, and the expf.  The depth test adds a
# compare and a select (2).  Wireframe: dy, qx, qy (3), |m − 2| and the max
# (2), the band-width select (2), the compare and the select of α (2), the
# blend (6): 15, no expf.
FWD_SLOTS = {"beauty": 17, "depth": 19, "wire": 15}
FWD_EXPF = {"beauty": 1, "depth": 1, "wire": 0}
# The backward per pixel and pair, α once (a design without the replay): α
# without the blend (11), T and w (3), K (3), K − u, dα (2), the gate (3),
# dp2 (2), dp2·dx, dp2·dy (2), the nine sums (9: five FMAs, four adds), the
# update of u (1): 36, and the expf; the depth test again 2.
BWD_SLOTS = {"beauty": 36, "depth": 38}
# The data sheet's flop counts of the earlier slices (an FMA as two); the
# depth test adds a compare and a select; the wireframe pixel update: dy, qx,
# qy (5), the max, |m − 2| and the compare (3), the band-width compare and
# select (2), the select of α (1), the blend (9).
FWD_FLOPS = {"beauty": 24, "depth": 26, "wire": 20}
BWD_FLOPS = {"beauty": 49, "depth": 51}
# Projection: ~250 float operations a splat (quaternion → covariance → EWA →
# eigen → SH of degree 3); splat parameters 59 float32 values.
PROJ_OPS_PER_SPLAT = 250
PARAM_BYTES = 59 * 4
FIELD_ROWS = 16


def device_from_calibration(calib: dict, base: dict = H100) -> dict:
    """``base`` with the measured constants of one ``sol_calibrate`` run."""
    dev = dict(base)
    alu = calib["alu"]
    dev["f32_issue_rate"] = alu["fma"]["links_per_s"]
    dev["mul_add_rate"] = alu["mul_add"]["links_per_s"]
    dev["expf_rate"] = alu["expf"]["links_per_s"]
    dev["sm_clock_hz"] = alu.get("sm_clock_hz")
    if calib.get("expf_sass_slots"):
        dev["expf_slots"] = calib["expf_sass_slots"]
    dev["hbm_bw"] = calib["hbm"]["bytes_per_s"]
    dev["sort_rate"] = calib["sort"]["pairs_per_s"]
    gather = calib.get("gather", {})
    if "column" in gather:
        dev["column_gather_rate"] = gather["column"]["queries_per_s"]
    if "row" in gather:
        dev["row_gather_rate"] = gather["row"]["queries_per_s"]
    dev["measured_on"] = calib.get("card")
    return dev


def compositor_bound(pixel_updates: float, nbytes: float, slots: int, n_expf: int, flops: int,
                     device: dict = H100) -> dict:
    """Bounds of ``pixel_updates`` pixel updates (those with α ≠ 0 of the
    walked pairs, ``live_pixel_updates``, or pairs walked × 1024) that
    also move ``nbytes``: ``issue_ms`` = max(slots / issue rate, expf / expf
    rate, bytes / HBM) at the measured rates; ``issue_datasheet_ms`` the same
    at the data sheet's rates; ``flops_datasheet_ms`` = max(flops / 67
    TFLOP/s, bytes / 3.35 TB/s), the bound of the earlier slices."""
    total = pixel_updates * (slots + n_expf * device["expf_slots"])
    bytes_ms = nbytes / device["hbm_bw"] * 1e3
    bytes_ds_ms = nbytes / device["hbm_bw_datasheet"] * 1e3
    issue = total / device["f32_issue_rate"] * 1e3
    expf = pixel_updates * n_expf / device["expf_rate"] * 1e3
    issue_ds = total / device["f32_issue_rate_datasheet"] * 1e3
    flops_ds = pixel_updates * flops / device["f32_flops_datasheet"] * 1e3
    return {
        "issue_ms": max(issue, expf, bytes_ms),
        "issue_bound_by": "bytes" if bytes_ms >= max(issue, expf) else "operations",
        "issue_slots": total,
        "issue_datasheet_ms": max(issue_ds, bytes_ds_ms),
        "issue_datasheet_bound_by": "bytes" if bytes_ds_ms >= issue_ds else "operations",
        "flops_datasheet_ms": max(flops_ds, bytes_ds_ms),
        "flops_datasheet_bound_by": "bytes" if bytes_ds_ms >= flops_ds else "operations",
        "bytes_ms": bytes_ms,
        "bytes_datasheet_ms": bytes_ds_ms,
    }


def bytes_bound(nbytes: float, device: dict = H100) -> dict:
    """A stage bound by bytes: at the data sheet's HBM rate and at the
    measured one."""
    return {"datasheet_ms": nbytes / device["hbm_bw_datasheet"] * 1e3,
            "measured_ms": nbytes / device["hbm_bw"] * 1e3}


def projection_bytes(n: int, sh_order: int = 3, backward: bool = False, only_sh: bool = False,
                     tight_footprint: bool = False, masked: bool = False) -> int:
    """Bytes the projection kernels (``csrc/projection.cu``) must move for
    ``n`` splats, each input read once and each output written once.  The
    forward reads pos, orient, scale and opacity (44 B a splat), the colour
    (12 B, not with ``only_sh``) and the SH rows ``sh_order`` reads (0, 36,
    96 or 180 B), and writes the 64 B field column: 300 B at ``sh_order`` 3,
    120 at 0.  The backward reads pos, orient and scale (40 B), the opacity
    only with ``tight_footprint`` (4 B, its footprint radius), the colour and
    the SH only when ``sh_order`` > 0 (max0's gradient needs the colour, not
    with ``only_sh``), and the cotangent's rows that carry a gradient back
    through the geometry (0..5, 10, 12..14) and at ``sh_order`` > 0 the
    colour's 6..8; it writes the gradients of pos, orient and scale and, at
    ``sh_order`` > 0, of the colour and all 45 SH rows.  The opacity's
    gradient is cotangent row 9, and the colour's at ``sh_order`` 0 rows
    6..8, handed back as views: no bytes.  516 B at ``sh_order`` 3 (520 with
    ``tight_footprint``), 120 at 0.  ``masked`` (the backward of the
    sanitized fields): the kernel also reads row 9 and writes the opacity's
    gradient (8 B), and at ``sh_order`` 0 rows 6..8 and the colour's (24 B,
    not with ``only_sh``)."""
    sh_read = 4 * (0, 9, 24, 45)[sh_order]
    if not backward:
        return n * (44 + (0 if only_sh else 12) + sh_read + 4 * FIELD_ROWS)
    color = 12 if sh_order > 0 and not only_sh else 0
    cot_rows = 10 + (3 if sh_order > 0 else 0)
    reads = 40 + (4 if tight_footprint else 0) + color + sh_read + 4 * cot_rows
    writes = 40 + color + (180 if sh_order > 0 else 0)
    if masked:
        passed = 4 + (12 if sh_order == 0 and not only_sh else 0)
        reads, writes = reads + passed, writes + passed
    return n * (reads + writes)


def speed_of_light(
    n_splats: int,
    width: int,
    height: int,
    pair_budget: int,
    fwd_only: bool = False,
    device: dict = H100,
    pairs_walked: int = None,
    mode: str = "beauty",
    live_updates: int = None,
) -> dict:
    """Per-stage floor milliseconds of one frame (``fwd_only``) or one
    training step's render, forward and backward.

    ``pair_budget``: the static pair count the binning's passes walk (the
    tuned budget).  ``pairs_walked``: the pairs the compositors walk before
    the early stop (this frame's data; the budget when not given).
    ``live_updates``: the (pair, pixel) updates with α ≠ 0 among them
    (``ops/kernels/composite.py`` ``live_pixel_updates``), which price the
    compositors; every pixel of every walked pair when not given.  ``mode``:
    ``"beauty"``, ``"depth"`` (11-row float32 payload and the depth test) or
    ``"wire"``.  Returns ``{"sol_ms", "stages"}``; ``stages`` maps a stage to
    ``(floor_ms, bounding unit)``.

    The port's own stages: no payload gather and no image unpack (the kernels
    read the per-splat matrix and write (H, W, 4) directly), one scatter in
    place of the dest-inversion sort, and a segment sum bound by bytes.
    """
    n, p = float(n_splats), float(pair_budget)
    walked = p if pairs_walked is None else float(pairs_walked)
    updates = walked * 1024 if live_updates is None else float(live_updates)
    bw = device["hbm_bw"]
    issue = device["f32_issue_rate"]
    sort_rate = device["sort_rate"]
    pixels = float(width * height)
    ms = 1e3
    stages = {}

    def add(name, seconds, unit):
        stages[name] = (seconds * ms, unit)

    packed = mode == "beauty"
    pay_rows = 8 if packed else (11 if mode == "depth" else 10)
    add("project", max((n * PARAM_BYTES + n * FIELD_ROWS * 4) / bw, n * PROJ_OPS_PER_SPLAT / issue),
        "bytes/issue")
    add("sanitize+quantize", 2 * n * FIELD_ROWS * 4 / bw, "bytes")
    add("depth sort", n / sort_rate, "torch.sort (software floor)")
    live_rows = 15 if mode == "depth" else 14
    add("field permute", (2 * live_rows * 4 * n + 8 * n) / bw, "bytes")
    add("binning scans+scatter", 3 * (4 * (n + p)) / bw, "bytes")
    add("pair key sort", p / sort_rate, "torch.sort (software floor)")
    if packed:
        add("pack payload", (10 + 8) * 4 * n / bw, "bytes")
    fwd_bytes = pay_rows * 4 * n + 4 * p + pixels * 16
    fb = compositor_bound(updates, fwd_bytes, FWD_SLOTS[mode], FWD_EXPF[mode], FWD_FLOPS[mode], device)
    add("fwd kernel", fb["issue_ms"] / ms, f"issue slots ({fb['issue_bound_by']})")
    if not fwd_only:
        if mode == "wire":
            raise ValueError("wireframe mode is forward-only")
        add("gradient map (2 scans + scatter)", 3 * 2 * 4 * p / bw, "bytes")
        bwd_bytes = fwd_bytes + pixels * 16 + 9 * 4 * p
        bb = compositor_bound(updates, bwd_bytes, BWD_SLOTS[mode], 1, BWD_FLOPS[mode], device)
        add("bwd kernel", bb["issue_ms"] / ms, f"issue slots ({bb['issue_bound_by']})")
        add("segment sum", (9 * 4 * p + 4 * p + 2 * 4 * n + 9 * 4 * n) / bw, "bytes")
        add("combine+proj bwd", max(2 * n * PARAM_BYTES / bw, n * PROJ_OPS_PER_SPLAT / issue),
            "bytes/issue")
        add("cotangent unpermute", 2 * 10 * 4 * n / bw, "bytes")

    total = sum(v for v, _ in stages.values())
    return {"sol_ms": total, "stages": stages}


def report(n, width, height, pair_budget, achieved_ms, fwd_only=False, device: dict = H100,
           pairs_walked: int = None, mode: str = "beauty", live_updates: int = None):
    """Floor, achieved, fraction."""
    m = speed_of_light(n, width, height, pair_budget, fwd_only, device, pairs_walked, mode, live_updates)
    return {
        "sol_ms": m["sol_ms"],
        "sol_fraction": m["sol_ms"] / achieved_ms,
        "sol_device": device["measured_on"],
    }
