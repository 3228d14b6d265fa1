"""JSON save/load of a splat cluster (counterpart of ``gsplat_tpu.io.json_io``).

The document stores every field of :class:`GaussianSplats` as a
base64-encoded little-endian array (a bit-exact round trip) with its shape
and dtype, plus a format name and version.  It is the JAX package's document
field for field, so either package reads the other's file, and for the same
float32 splats the two writers' texts are equal.

For large scenes prefer :mod:`gsplat_tpu_torch.io.ply` (interchange) or
:mod:`gsplat_tpu_torch.io.checkpoint`; JSON is the human-inspectable,
VCS-friendly option for small scenes and fixtures.
"""

from __future__ import annotations

import base64
import json

import numpy as np
import torch

from ..models.camera import resolve_device
from ..models.splats import GaussianSplats
from ..version import __version__

_FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")


def _encode(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return {
        "dtype": a.dtype.str,
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def _decode(d: dict) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"]))
    return a.reshape(d["shape"])


def save_json(path: str, splats: GaussianSplats) -> None:
    """Write the cluster to ``path`` (bit-exact round trip)."""
    doc = {
        "format": "gsplat_tpu.splats",
        "version": __version__,
        "count": int(splats.count),
        "fields": {
            name: _encode(getattr(splats, name).detach().cpu().numpy()) for name in _FIELDS
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def load_json(path: str, device=None) -> GaussianSplats:
    """Load a cluster written by :func:`save_json` (of either package) onto
    ``device`` (``None``: the card)."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != "gsplat_tpu.splats":
        raise ValueError(f"{path}: not a gsplat_tpu.splats JSON document")
    dev = resolve_device(device)
    fields = {
        name: torch.from_numpy(_decode(doc["fields"][name]).copy()).to(dev) for name in _FIELDS
    }
    return GaussianSplats(**fields).validate()
