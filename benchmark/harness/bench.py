"""One run of one cell: set-up, the measured window, the traced calls
(``--trace 1``), the comparison with the reference, and the result line."""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional, Tuple

import torch

from harness import spec as sp
from harness import trace as tr
from harness.spec import Cell

# calls traced in a --trace 1 run
TRACED_CALLS = 5
FORBIDDEN = ("jax", "jaxlib", "flax", "gsplat_tpu")


class LayerContext:
    """What a per-layer metric's reader reads."""

    def __init__(self, trace: Optional[tr.Trace], **facts):
        self.trace = trace
        self.__dict__.update(facts)

    def kernel_s(self, *substrings: str) -> float:
        return self.trace.kernel_s(*substrings) if self.trace is not None else 0.0


def read_metric(name: str, ctx: LayerContext):
    """The value of per-layer metric ``name`` (``metrics/<name>.py``'s
    ``read``), or None where it finds nothing to read."""
    return sp.module("metrics", name).read(ctx)


def kind(cell: Cell):
    """The class that runs the cell's traffic: ``Run`` of ``kinds/<kind>.py``,
    the mix's ``kind``."""
    return sp.module("kinds", cell.traffic["kind"]).Run


class SetupClock:
    """Seconds of each part of set-up, from the mark before it."""

    def __init__(self, t0: float):
        self.t, self.parts = t0, {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self.t
        self.t = now


def forbidden_modules():
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def device_info(device, peak: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", t0: float = None) -> Dict:
    """The result line's object (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``checks``
    last: each number compared, with its limit)."""
    return execute(cell, seed, seconds, trace, device, t0)[1]


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", t0: float = None) -> Tuple[object, Dict]:
    """One run of the cell: set-up, the window, with ``trace`` the traced
    calls, the program's state released and the comparison with the
    reference.  The run (its inputs and what the window kept) and the result
    line's object."""
    t0 = time.perf_counter() if t0 is None else t0
    clock = SetupClock(t0)
    clock.mark("imports")
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.zeros(1, device=device)
        clock.mark("cuda_context")
        torch.cuda.reset_peak_memory_stats(device)
    run = kind(cell)(cell, seed, device)
    run.setup(clock.mark)
    if cuda:
        torch.cuda.synchronize(device)
    clock.mark("warm_up")
    setup_s = time.perf_counter() - t0
    out = run.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traced = None
    if trace:
        from harness import program as prog

        traced = tr.traced_calls(run.traced_call(), TRACED_CALLS, prog.counters, prog.kernel_names())
    run.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gaps = run.check()
    check_s = time.perf_counter() - t_check
    correct = all(v <= float(cell.limits[k]) for k, v in gaps.items())
    # JSON holds no infinity and no NaN: a number that is not finite prints
    # as the largest float
    checks = {k: {"value": v if v <= sys.float_info.max else sys.float_info.max, "limit": float(cell.limits[k])}
              for k, v in gaps.items()}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        ctx = LayerContext(traced, busy_s=traced.busy_s(), window_s=traced.window_s, **run.layer_context())
        metrics = {}
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        e2e = dict(out["metrics"], peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    result["device"] = device_info(device, peak)
    if trace:
        result["device"].update(busy_s=traced.busy_s(), window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
        result["trace"] = {"sessions": traced.sessions, "kernel_launches_lost": traced.lost}
    result["fitted"] = getattr(run, "fitted", {})
    result["setup_parts_s"] = clock.parts
    result["reference_s"] = check_s
    result["checks"] = checks
    return run, result
