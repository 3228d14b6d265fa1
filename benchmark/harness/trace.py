"""Device time from a ``torch.profiler`` trace of a few calls.

A session's trace has been seen to come back without the first device events
it should hold once CUDA graphs have run in the process, and without one of
a call's kernels in every call of a session.  So one uncounted call runs
first in every session, the counted calls sit in a host range of their own,
and a session whose trace holds fewer launches of the program's kernels than
the program's launch counters moved over the counted calls is taken again.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

RANGE = "benchmark_counted_calls"
ATTEMPTS = 5
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """The device events of the counted calls of one session."""

    def __init__(self, events: List[dict], calls: int, sessions: int, lost: Dict[str, int]):
        self.calls, self.sessions, self.lost = calls, sessions, lost
        rng = next(e for e in events if e.get("ph") == "X" and e.get("name") == RANGE)
        t0 = float(rng["ts"])
        t1 = t0 + float(rng["dur"])
        self.t0, self.t1 = t0, t1
        self.window_s = (t1 - t0) / 1e6
        self.device = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
                       if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and t0 <= float(e["ts"]) < t1]
        self.host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
                     if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime")
                     and e.get("name") != RANGE and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0]

    def kernel_s(self, *substrings: str) -> float:
        """Device seconds a call in events whose name holds any substring."""
        us = sum(d for n, _, d in self.device if any(s in n for s in substrings))
        return us / 1e6 / self.calls

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return self.window_s - sum(length for _, length in self.gaps()) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """(start, length) in microseconds of each idle stretch of the window."""
        out, end = [], self.t0
        for _, ts, dur in sorted(self.device, key=lambda e: e[1]):
            if ts > end:
                out.append((end, ts - end))
            end = max(end, ts + dur)
        if self.t1 > end:
            out.append((end, self.t1 - end))
        return out

    def breakdown(self) -> Dict[str, list]:
        """The device operations with the most time, and the idle stretches
        by the innermost host operation running when each began, in seconds
        over the traced window."""
        ops = defaultdict(float)
        for n, _, d in self.device:
            ops[n[:120]] += d / 1e6
        idle = defaultdict(float)
        for start, length in self.gaps():
            doing = [(d, n) for n, ts, d in self.host if ts <= start < ts + d]
            idle[min(doing)[1][:120] if doing else "host: between calls"] += length / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def traced_calls(fn: Callable, calls: int, counters: Callable[[], Dict[str, int]], kernels: Dict[str, str]) -> Trace:
    """``fn()`` ``calls`` times under the profiler, after one uncounted call;
    ``counters()`` reads the program's launch counters and ``kernels`` maps
    a counter to the substring of its kernel's name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    lost = {}
    for attempt in range(1, ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            before = counters()
            with torch.profiler.record_function(RANGE):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            after = counters()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        trace = Trace(events, calls, attempt, lost)
        seen = {k: sum(sub in n for n, _, _ in trace.device) for k, sub in kernels.items()}
        missing = {k: after[k] - before[k] - seen[k] for k in kernels if seen[k] < after[k] - before[k]}
        if not missing:
            trace.lost = lost
            return trace
        lost = {k: lost.get(k, 0) + v for k, v in missing.items()}
    raise RuntimeError(f"the profiler lost kernel launches in {ATTEMPTS} sessions: {lost}")
