"""Port vs JAX package: PLY and JSON I/O (``io/ply.py``, ``io/json_io.py``).

Gates (all exact): for the same float32 splats the two PLY writers write the
same bytes and the two JSON writers the same text; each package's loader
reads the other's file into bit-equal arrays; the raw reader's binary, ASCII
and garbage-rejection paths and the ``max_sh_degree`` truncation agree bit
for bit (the same numpy code on both sides), and garbage raises the same
exception type.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.io.ply import read_ply_raw as j_read_raw
from gsplat_tpu_torch.io.ply import read_ply_raw as t_read_raw
from torch_port_helpers import CPU, splats_to_torch

FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")


def _jax_splats(n=50, seed=0):
    s = gj.random_splats(jax.random.PRNGKey(seed), n, sh_scale=0.3)
    # opacity strictly inside (0, 1), as the JAX package's round-trip test keeps it
    return dataclasses.replace(s, opacity=jnp.clip(s.opacity, 0.01, 0.99))


def _same_arrays(j_splats, t_splats):
    jd, td = gj.to_numpy_dict(j_splats), gt.to_numpy_dict(t_splats)
    for k in FIELDS:
        assert np.array_equal(np.asarray(jd[k]), td[k]), k


def test_ply_writers_write_the_same_bytes_and_read_each_other(tmp_path):
    js = _jax_splats()
    ts = splats_to_torch(js)
    jp, tp = tmp_path / "jax.ply", tmp_path / "torch.ply"
    gj.save_ply(jp, js)
    gt.save_ply(tp, ts)
    assert jp.read_bytes() == tp.read_bytes()
    # each package reads the other's file bit for bit, and its own the same
    _same_arrays(gj.load_ply(tp), gt.load_ply(jp, device=CPU))
    _same_arrays(gj.load_ply(jp), gt.load_ply(tp, device=CPU))
    loaded = gt.load_ply(tp, device=CPU)
    assert loaded.device.type == "cpu" and loaded.pos.dtype == ts.pos.dtype
    # the round trip keeps positions exactly and the rest to activation precision
    assert np.array_equal(gt.to_numpy_dict(loaded)["pos"], gt.to_numpy_dict(ts)["pos"])


@pytest.mark.parametrize("degree", [0, 2])
def test_sh_degree_truncation_matches_jax(tmp_path, degree):
    path = tmp_path / "scene.ply"
    gj.save_ply(path, _jax_splats(n=20, seed=1))
    t = gt.load_ply(path, max_sh_degree=degree, device=CPU)
    _same_arrays(gj.load_ply(path, max_sh_degree=degree), t)
    keep = (degree + 1) ** 2 - 1
    assert not t.sh_n153[:, keep:].any() and (keep == 0 or t.sh_n153[:, :keep].any())


def _hand_written_ply(path, fmt):
    """The JAX package's tiny PLY (one splat with known raw values) and a
    second at half those values, written binary or ASCII, with a face
    element after the vertices."""
    names = ["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "opacity",
             "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
    values = [1.0, 2.0, 3.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 2.0, 0.0, 0.0, 0.0]
    header = ["ply", f"format {fmt} 1.0", "comment made by hand", "element vertex 2"]
    header += [f"property float {name}" for name in names]
    header += ["element face 0", "property list uchar int vertex_indices", "end_header", ""]
    rows = [values, [v * 0.5 for v in values]]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        if fmt == "ascii":
            f.write("".join(" ".join(str(v) for v in r) + "\n" for r in rows).encode("ascii"))
        else:
            f.write(np.asarray(rows, "<f4").tobytes())


@pytest.mark.parametrize("fmt", ["binary_little_endian", "ascii"])
def test_raw_reader_and_activations_match_jax(tmp_path, fmt):
    path = tmp_path / f"tiny_{fmt}.ply"
    _hand_written_ply(path, fmt)
    j_raw, t_raw = j_read_raw(path), t_read_raw(path)
    assert list(j_raw) == list(t_raw)
    for k in j_raw:
        assert t_raw[k].dtype == j_raw[k].dtype and np.array_equal(t_raw[k], j_raw[k]), k
    t = gt.load_ply(path, device=CPU)
    _same_arrays(gj.load_ply(path), t)
    # (w=2, x=y=z=0) normalized → orient xyzw (0, 0, 0, 1); sigmoid(0) = 0.5
    assert np.array_equal(gt.to_numpy_dict(t)["orient"][0], [0, 0, 0, 1])
    assert float(t.opacity[0]) == 0.5


GARBAGE = {
    "not_ply": b"not a ply\n",
    "unterminated": b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n",
    "big_endian": b"ply\nformat binary_big_endian 1.0\nelement vertex 1\nproperty float x\nend_header\n",
    "no_vertex": b"ply\nformat ascii 1.0\nelement face 0\nend_header\n",
    "vertex_list": b"ply\nformat ascii 1.0\nelement vertex 1\nproperty list uchar float x\nend_header\n",
    "unknown_type": b"ply\nformat ascii 1.0\nelement vertex 1\nproperty quad x\nend_header\n",
}


def test_garbage_rejected_like_jax(tmp_path):
    for name, data in GARBAGE.items():
        path = tmp_path / f"{name}.ply"
        path.write_bytes(data)
        kinds = []
        for reader in (j_read_raw, t_read_raw):
            with pytest.raises(Exception) as info:
                reader(path)
            kinds.append(type(info.value))
        assert kinds[0] is kinds[1], (name, kinds)


def test_json_texts_equal_and_read_each_other(tmp_path):
    js = gj.random_splats(jax.random.PRNGKey(3), 77, sh_scale=0.3)
    ts = splats_to_torch(js)
    jp, tp = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    gj.save_json(jp, js)
    gt.save_json(tp, ts)
    with open(jp) as a, open(tp) as b:
        assert a.read() == b.read()
    _same_arrays(gj.load_json(tp), gt.load_json(jp, device=CPU))
    back = gt.load_json(tp, device=CPU)
    for f in FIELDS:
        assert np.array_equal(getattr(back, f).numpy(), np.asarray(getattr(js, f))), f


def test_json_rejects_a_foreign_document(tmp_path):
    p = tmp_path / "x.json"
    p.write_text('{"format": "something_else"}')
    with pytest.raises(ValueError):
        gt.load_json(str(p), device=CPU)
    with pytest.raises(ValueError):
        gj.load_json(str(p))
