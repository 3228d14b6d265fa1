"""Profiling and timing harness (counterpart of ``gsplat_tpu.utils.profiling``).

``trace_span`` names a span in ``torch.profiler`` traces; ``PhaseTimer``
keeps per-phase wall-clock samples; ``measure_fps`` times a callable;
``cuda_time_ms`` times back-to-back calls between CUDA events (the
calibration probes, ``chip_smoke.py``'s kernels, frames and steps);
``start_trace`` / ``stop_trace`` wrap a ``torch.profiler`` session.

Timing on the card: PyTorch returns before the device has finished, so a
phase whose ``block_on`` is a CUDA tensor synchronises that tensor's device
before its clock stops, and ``measure_fps`` brackets CUDA work with CUDA
events.  On the CPU both are plain host clocks.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch


@contextlib.contextmanager
def trace_span(name: str):
    """A named range in ``torch.profiler`` traces (free when no profiler
    runs)."""
    with torch.profiler.record_function(name):
        yield


def _cuda_devices(obj) -> set:
    """The CUDA devices of every tensor in ``obj`` (a tensor or a nested
    list/tuple/dict of them)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.is_cuda else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        out = set()
        for x in obj:
            out |= _cuda_devices(x)
        return out
    return set()


def block_until_ready(obj):
    """Wait for the devices of the CUDA tensors in ``obj``; returns ``obj``."""
    for dev in _cuda_devices(obj):
        torch.cuda.synchronize(dev)
    return obj


class PhaseTimer:
    """Accumulates wall-clock stats per named phase (host clock; a phase with
    a CUDA ``block_on`` waits for that work to finish)."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        if block_on is not None:
            block_until_ready(block_on)
        self.samples.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            out[name] = {
                "count": len(xs),
                "median_ms": statistics.median(xs) * 1e3,
                "mean_ms": statistics.fmean(xs) * 1e3,
                "min_ms": min(xs) * 1e3,
                "max_ms": max(xs) * 1e3,
            }
        return out


def measure_fps(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 3,
    device=None,
) -> Dict[str, float]:
    """Median frames/sec of ``fn(*args)``.

    ``device``: where the work runs — a CUDA device (or ``"cuda"``) times each
    call between two CUDA events on the current stream; ``None`` takes the
    device of the first output's CUDA tensors, else the host clock around a
    call whose outputs are then waited for.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    block_until_ready(out)
    if device is None:
        found = _cuda_devices(out) if out is not None else set()
        device = next(iter(found)) if found else None
    times = []
    if device is not None and torch.device(device).type == "cuda":
        with torch.cuda.device(torch.device(device)):
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                stop.record()
                stop.synchronize()
                times.append(start.elapsed_time(stop) / 1e3)
        clock = "cuda_events"
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            block_until_ready(fn(*args))
            times.append(time.perf_counter() - t0)
        clock = "host"
    dt = statistics.median(times)
    return {"fps": 1.0 / dt, "median_ms": dt * 1e3, "iters": iters, "clock": clock}


def cuda_time_ms(fn: Callable, reps: int = 1, warmup: int = 0):
    """``(ms, out)``: the mean milliseconds of ``fn()`` over ``reps``
    back-to-back calls on the current CUDA stream, between two CUDA events
    (the calls queue without a host wait, so a short kernel is timed without
    the host's gaps), and the last call's result.  ``warmup`` calls run
    first, outside the window; the card is idle when the window opens."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = None
    for _ in range(reps):
        out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, out


_session = None


def start_trace(logdir: str) -> None:
    """Start a ``torch.profiler`` session (CPU, and CUDA where there is a
    card) whose Chrome trace ``stop_trace`` writes into ``logdir``."""
    global _session
    from torch.profiler import ProfilerActivity, profile

    if _session is not None:
        raise RuntimeError("a trace is already running")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    _session = (prof, logdir)


def stop_trace() -> str:
    """Stop the session; returns the path of the trace it wrote."""
    global _session
    if _session is None:
        raise RuntimeError("no trace is running")
    prof, logdir = _session
    _session = None
    prof.__exit__(None, None, None)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    return path
