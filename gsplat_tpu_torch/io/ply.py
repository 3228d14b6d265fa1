"""3DGS PLY import and export (counterpart of ``gsplat_tpu.io.ply``).

A standard 3DGS ``point_cloud.ply`` stores pre-activation values; loading
applies the activations the JAX package applies:

  * ``opacity`` → sigmoid;
  * ``scale_*`` are log-scales → ``exp``;
  * ``rot_0..3`` is (w, x, y, z), scalar first → ``orient`` xyzw, normalized;
  * ``f_dc_*`` → ``color = f_dc·SH_C0 + 0.5`` (the DC term baked in);
  * ``f_rest_0..44`` planar → 15 RGB band coefficients (x = j, y = j+15,
    z = j+30).

The parser and writer are numpy on the host, the same code as the JAX
package's, so the two packages write the same bytes for the same float32
splats; :func:`load_ply` moves the arrays to ``device`` (``None``: the card).
"""

from __future__ import annotations

import io as _io
from typing import Dict, Tuple

import numpy as np

from ..models.splats import GaussianSplats, make_splats, to_numpy_dict
from ..ops.sh import SH_C0

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(f) -> Tuple[int, np.dtype, str]:
    """Parse a PLY header for the vertex element.  Returns (count, dtype, fmt)."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    count = None
    fields = []
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.strip().decode("ascii", "replace").split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex = tokens[1] == "vertex"
            if in_vertex:
                count = int(tokens[2])
        elif tokens[0] == "property" and in_vertex:
            if tokens[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            fields.append((tokens[2], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"unsupported PLY format {fmt!r}")
    if count is None:
        raise ValueError("no vertex element in PLY")
    endian = "<"
    dtype = np.dtype([(name, endian + code) for name, code in fields])
    return count, dtype, fmt


def read_ply_raw(path) -> Dict[str, np.ndarray]:
    """Read the vertex element of a PLY file into a dict of 1-D arrays."""
    with open(path, "rb") as f:
        count, dtype, fmt = _parse_header(f)
        if fmt == "ascii":
            rows = np.loadtxt(
                _io.StringIO(f.read().decode("ascii")), dtype=np.float64, ndmin=2
            )[:count]
            return {
                name: rows[:, i].astype(dtype[name]) for i, name in enumerate(dtype.names)
            }
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
    return {name: np.ascontiguousarray(data[name]) for name in dtype.names}


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def load_ply(path, max_sh_degree: int = 3, device=None) -> GaussianSplats:
    """Load a standard 3DGS ``point_cloud.ply`` with the activations above,
    onto ``device`` (``None``: the card)."""
    raw = read_ply_raw(path)
    n = raw["x"].shape[0]
    pos = np.stack([raw["x"], raw["y"], raw["z"]], axis=-1).astype(np.float32)

    if all(f"rot_{i}" in raw for i in range(4)):
        # PLY rot_0..3 = (w, x, y, z) → orient xyzw, normalized.
        quat = np.stack(
            [raw["rot_1"], raw["rot_2"], raw["rot_3"], raw["rot_0"]], axis=-1
        ).astype(np.float32)
        norm = np.linalg.norm(quat, axis=-1, keepdims=True)
        orient = quat / np.maximum(norm, 1e-12)
    else:
        orient = None

    if all(f"scale_{i}" in raw for i in range(3)):
        scale = np.exp(
            np.stack([raw["scale_0"], raw["scale_1"], raw["scale_2"]], axis=-1)
        ).astype(np.float32)
    else:
        scale = None

    opacity = _sigmoid(raw["opacity"]).astype(np.float32) if "opacity" in raw else None

    if all(f"f_dc_{i}" in raw for i in range(3)):
        dc = np.stack([raw["f_dc_0"], raw["f_dc_1"], raw["f_dc_2"]], axis=-1)
        color = (dc * SH_C0 + 0.5).astype(np.float32)
    else:
        color = None

    sh = None
    n_rest = sum(1 for k in raw if k.startswith("f_rest_"))
    if n_rest:
        n_coeffs = min(n_rest // 3, 15)
        sh = np.zeros((n, 15, 3), dtype=np.float32)
        # planar: x = f_rest_j, y = f_rest_{j+K}, z = f_rest_{j+2K}
        k = n_rest // 3
        for j in range(n_coeffs):
            sh[:, j, 0] = raw[f"f_rest_{j}"]
            sh[:, j, 1] = raw[f"f_rest_{j + k}"]
            sh[:, j, 2] = raw[f"f_rest_{j + 2 * k}"]
        if max_sh_degree < 3:
            keep = (max_sh_degree + 1) ** 2 - 1
            sh[:, keep:, :] = 0.0

    return make_splats(pos, orient, scale, opacity, color, sh, device=device)


def save_ply(path, splats: GaussianSplats) -> None:
    """Write a standard 3DGS PLY (inverse activations: logit/log)."""
    arr = to_numpy_dict(splats)  # per-splat (N, ·) row conventions
    n = arr["pos"].shape[0]
    op = np.clip(arr["opacity"].astype(np.float64), 1e-7, 1.0 - 1e-7)
    fields = (
        [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        + [(f"f_dc_{i}", "<f4") for i in range(3)]
        + [(f"f_rest_{i}", "<f4") for i in range(45)]
        + [("opacity", "<f4")]
        + [(f"scale_{i}", "<f4") for i in range(3)]
        + [(f"rot_{i}", "<f4") for i in range(4)]
    )
    out = np.zeros(n, dtype=np.dtype(fields))
    out["x"], out["y"], out["z"] = arr["pos"].T
    dc = (arr["color"].astype(np.float64) - 0.5) / SH_C0
    for i in range(3):
        out[f"f_dc_{i}"] = dc[:, i]
    for j in range(15):
        out[f"f_rest_{j}"] = arr["sh"][:, j, 0]
        out[f"f_rest_{j + 15}"] = arr["sh"][:, j, 1]
        out[f"f_rest_{j + 30}"] = arr["sh"][:, j, 2]
    out["opacity"] = np.log(op / (1.0 - op))
    logs = np.log(np.maximum(arr["scale"].astype(np.float64), 1e-12))
    for i in range(3):
        out[f"scale_{i}"] = logs[:, i]
    # orient xyzw → rot_0..3 = (w, x, y, z)
    q = arr["orient"]
    out["rot_0"], out["rot_1"], out["rot_2"], out["rot_3"] = q[:, 3], q[:, 0], q[:, 1], q[:, 2]

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in fields]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(out.tobytes())
