"""The port's hand-written CUDA kernels (``csrc/``) and their wrappers.

Launch counters.  Each wrapper module keeps its counters as module attributes
(an int, or a dict of ints by variant) that its wrapper adds one to where it
launches its kernel, and nowhere else, and registers each of them here with
:func:`register`.  Whatever reads or resets the counters reads this one
table, :func:`counters`: the replay bookkeeping of CUDA graphs
(``graphs.py``), and ``chip_smoke.py``'s counts around each path and its
reading of which kernels a profiler trace holds.
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
from typing import Any, Dict, Iterator, Optional, Tuple

# Every wrapper module, imported before the table is read so that it is whole.
_MODULES = ("scan", "composite", "segsum", "projection", "frame_glue", "probes")


@dataclasses.dataclass(frozen=True)
class Counter:
    """One named counter: ``module.attr`` (an int), or the sum of
    ``module.attr[k]`` over ``keys`` (a dict counter).  ``kernel``: a
    substring of the kernel's name in a profiler trace, where the counter
    counts every launch of that kernel and nothing else."""

    name: str
    module: Any
    attr: str
    keys: Optional[Tuple[str, ...]] = None
    kernel: Optional[str] = None

    def slots(self) -> Iterator[Tuple[Any, str, Any]]:
        """``(module, attr, key)`` of each int it sums (key None for an int
        attribute)."""
        if self.keys is None:
            yield self.module, self.attr, None
        else:
            for k in self.keys:
                yield self.module, self.attr, k

    def value(self) -> int:
        v = getattr(self.module, self.attr)
        return v if self.keys is None else sum(v[k] for k in self.keys)


_TABLE: Dict[str, Counter] = {}


def register(name: str, module_name: str, attr: str, keys=None, kernel: str = None) -> None:
    """Register ``module_name``'s counter ``attr`` (``keys``: of a dict
    counter, the keys it sums) under ``name``.  Called by each wrapper module
    at import."""
    _TABLE[name] = Counter(name, sys.modules[module_name], attr, tuple(keys) if keys else None, kernel)


def counters() -> Dict[str, Counter]:
    """The whole table, by name."""
    for m in _MODULES:
        importlib.import_module(f"{__name__}.{m}")
    return dict(_TABLE)


def counts() -> Dict[str, int]:
    """Every counter's value, by name."""
    return {name: c.value() for name, c in counters().items()}


def slot_values() -> Dict[Tuple[Any, str, Any], int]:
    """Every int a counter sums, by ``(module, attr, key)``."""
    return {slot: _get(slot) for c in counters().values() for slot in c.slots()}


def set_slots(values: Dict[Tuple[Any, str, Any], int], add: bool = False) -> None:
    """Set (or with ``add``, add to) the ints :func:`slot_values` keys."""
    for slot, v in values.items():
        module, attr, key = slot
        new = _get(slot) + v if add else v
        if key is None:
            setattr(module, attr, new)
        else:
            getattr(module, attr)[key] = new


def zero() -> None:
    """Set every counter to 0."""
    set_slots({slot: 0 for slot in slot_values()})


def _get(slot) -> int:
    module, attr, key = slot
    v = getattr(module, attr)
    return v if key is None else v[key]
