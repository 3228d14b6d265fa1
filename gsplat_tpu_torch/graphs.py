"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package compiles its training step (``gsplat_tpu/train/trainer.py``,
``@jax.jit def step``) and its benchmark's frame (``bench.py``) into one
program each.  Here the same work is captured once into a CUDA graph and
replayed: a replay launches every kernel and copy of the captured call with
one host call, where the eager call dispatches each of its operations from
Python (~830 for the 1080p frame, ~2000 for a training step).

:func:`capture` runs a function once eagerly (the warm-up: kernels built,
the scan's scratch sized, lazily made state created), captures it and
returns a :class:`CapturedGraph`; ``replay()`` runs the captured work again.
``make_train_step`` (``train/trainer.py``) captures its step this way on
CUDA parameters.

What a capture fixes: every tensor's address, shape and dtype, every Python
number (a config, a learning rate), every branch taken on the host.  A replay
reads the *contents* of the tensors the capture read.  So a captured frame
serves a new camera when the caller copies the new matrices into the
captured camera's tensors (``view``, ``proj``, ``derived_pos``, and
``explicit_camera_pos`` where set) before the replay, and a captured step
trains on a new target copied into its target buffer.  Replacing a tensor
(a new ``Camera``, a new parameter tensor) does not reach the graph.

Outputs are the graph's own tensors, written again by every replay.  All
graphs made here share one memory pool per device (they replay one after
another, and the pool then holds the largest graph's working memory rather
than the sum), so a replay of *another* graph may overwrite them too: read or
copy what a graph returns before any other graph of the device replays.
Graphs must replay in one stream's order, never on two streams at once: they
share that pool and the scan's scratch (``ops/kernels/scan.py``).

Launch counters: the kernel wrappers (``ops/kernels``) count their Python
calls, and a replay makes none.  A capture therefore records how much each
counter moved while it was captured, takes that back (a capture runs
nothing), and adds it on every replay, so the counters stay a count of
launches that ran.

Streams: every capture and every warm-up runs on one side stream a device,
the capture stream, ordered after the caller's stream and before its later
work.  The scan keys its scratch by stream, so the warm-up on that stream is
what sizes the scratch a capture reads; replays run on the caller's stream.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from .ops import kernels

# device index -> the capture stream / (the memory pool every graph shares,
# the graphs alive in it)
_streams: Dict[int, torch.cuda.Stream] = {}
_pools: Dict[int, Tuple[Any, weakref.WeakSet]] = {}


def _index(device) -> int:
    if device is None:
        return torch.cuda.current_device()
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs run on a CUDA device, not {device}")
    return torch.cuda.current_device() if device.index is None else device.index


def capture_stream(device=None) -> torch.cuda.Stream:
    """The side stream every capture and warm-up of ``device`` runs on."""
    dev = _index(device)
    s = _streams.get(dev)
    if s is None:
        s = torch.cuda.Stream(device=dev)
        _streams[dev] = s
    return s


def _pool(dev: int) -> Tuple[Any, weakref.WeakSet]:
    entry = _pools.get(dev)
    # A pool lives only while a graph captured into it does: once the last
    # one is gone, PyTorch releases it and its handle may not be used again.
    if entry is None or not entry[1]:
        with torch.cuda.device(dev):
            entry = (torch.cuda.graph_pool_handle(), weakref.WeakSet())
        _pools[dev] = entry
    return entry


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def run_on_capture_stream(fn: Callable, *args, device=None):
    """``fn(*args)`` eagerly on the capture stream, after the work queued on
    the current stream and before the work queued after it.  What it returns
    may be used on the current stream (its tensors are recorded there)."""
    dev = _index(device)
    cur = torch.cuda.current_stream(dev)
    side = capture_stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn(*args)
    cur.wait_stream(side)
    for t in _tensors(out):
        if t.is_cuda:
            t.record_stream(cur)
    return out


def counter_values() -> Dict[Tuple[Any, str, Any], int]:
    """Every launch counter of the kernel wrappers (the table of
    ``ops/kernels/__init__.py``), keyed by (module, name, key of a dict
    counter or None)."""
    return kernels.slot_values()


def _set_counts(values: Dict[Tuple[Any, str, Any], int], add: bool = False) -> None:
    kernels.set_slots(values, add=add)


class CapturedGraph:
    """A captured call: ``replay()`` runs it again and returns ``outputs``,
    the tensors the captured call returned (the graph's own: see the module
    notes on when they are overwritten).

    ``launches``: how much each kernel counter moves a replay (only those
    that move).  ``pool_bytes``: how much the device's reserved memory grew
    while this graph was captured, i.e. what its capture added to the shared
    pool (a later graph that fits in the pool adds nothing)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs, launches, pool_bytes: int):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.pool_bytes = pool_bytes

    def replay(self):
        """Launch the captured work on the current stream."""
        self.graph.replay()
        _set_counts(self.launches, add=True)
        return self.outputs


def capture(fn: Callable, *args, warm_up: bool = True, device=None) -> CapturedGraph:
    """Capture ``fn(*args)`` into a CUDA graph on the capture stream.

    ``warm_up``: first run ``fn(*args)`` once eagerly on the capture stream
    (:func:`run_on_capture_stream`).  Pass False only when that stream has
    just run the same work (``make_train_step``'s first call): a capture
    allocates no scan scratch and builds no kernel.  The capture itself runs
    nothing; the returned graph has not replayed yet.  A capture that fails
    raises, with the launch counters as they were before it."""
    dev = _index(device)
    if warm_up:
        run_on_capture_stream(fn, *args, device=dev)
    side = capture_stream(dev)
    before = counter_values()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    pool, members = _pool(dev)
    try:
        with torch.cuda.graph(graph, pool=pool, stream=side):
            outputs = fn(*args)
    finally:
        after = counter_values()
        _set_counts(before)  # nothing ran: take the capture's counts back
    launches = {key: after[key] - v for key, v in before.items() if after[key] != v}
    pool_bytes = torch.cuda.memory_reserved(dev) - reserved
    captured = CapturedGraph(graph, outputs, launches, pool_bytes)
    members.add(captured)
    return captured
