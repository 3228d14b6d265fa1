"""Port vs JAX package: attribute-dict ingest (``io/attributes.py``) and the
``GaussianSplats`` methods the registry and the queries use.

Gates: on every case of the JAX package's ``tests/test_io.py`` attribute
tests, the resolved splats, SH arrays and detail config are bit-equal (the
same numpy code on both sides), the same inputs raise the same exception
type, and the missing-attribute logs carry the same texts.  ``astype``,
``concat``, ``head`` and ``bbox`` are exact; ``barycenter`` (a float32 mean
summed in another order) within 1e-6.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.io import attributes as ja
from gsplat_tpu_torch.io import attributes as ta
from torch_port_helpers import CPU, LogRecords, npy, splats_to_torch

FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")


def _base(n=4):
    rng = np.random.default_rng(0)
    return {
        "P": rng.normal(size=(n, 3)).astype(np.float32),
        "Cd": rng.uniform(size=(n, 3)).astype(np.float32),
        "orient": np.tile([0, 0, 0, 1.0], (n, 1)).astype(np.float32),
        "scale": rng.uniform(0.1, 1.0, size=(n, 3)).astype(np.float32),
    }


def _sh_conventions(n=5):
    sh_full = np.random.default_rng(1).normal(size=(n, 15, 3)).astype(np.float32)
    rest = {}
    for j in range(15):
        rest[f"f_rest_{j}"] = sh_full[:, j, 0]
        rest[f"f_rest_{j + 15}"] = sh_full[:, j, 1]
        rest[f"f_rest_{j + 30}"] = sh_full[:, j, 2]
    return sh_full, {
        "sh_coefficients": {"sh_coefficients": sh_full},
        "sh_vec3": {f"sh{j + 1}": sh_full[:, j, :] for j in range(15)},
        "f_rest": rest,
        "truncated": {"sh_coefficients": np.ones((n, 3, 3), np.float32)},
        "none": {},
    }


def _cases():
    """The attribute dicts of tests/test_io.py's TestAttributes, plus each SH
    convention riding on a full point set."""
    alpha = dict(_base(), Alpha=np.full(4, 0.25, np.float32))
    both = dict(alpha, opacity=np.full(4, 0.75, np.float32))
    cases = {"alpha": alpha, "opacity_over_alpha": both, "defaults": {"P": np.zeros((3, 3), np.float32)}}
    _, conv = _sh_conventions(n=4)
    for name, attrs in conv.items():
        cases[f"sh_{name}"] = dict(_base(), opacity=np.full(4, 0.5, np.float32), **attrs)
    return cases


def _same(j_splats, t_splats):
    jd, td = gj.to_numpy_dict(j_splats), gt.to_numpy_dict(t_splats)
    for k in FIELDS:
        assert np.array_equal(np.asarray(jd[k]), td[k]), k


def test_splats_from_attributes_matches_jax():
    for name, attrs in _cases().items():
        t = ta.splats_from_attributes(attrs, device=CPU)
        assert t.device.type == "cpu", name
        _same(ja.splats_from_attributes(attrs), t)
    t = ta.splats_from_attributes(_cases()["opacity_over_alpha"], device=CPU)
    assert torch.all(t.opacity == 0.75)


def test_resolve_sh_matches_jax():
    sh_full, conv = _sh_conventions()
    for name, attrs in conv.items():
        j, t = ja.resolve_sh(attrs, 5), ta.resolve_sh(attrs, 5)
        if name == "none":
            assert j is None and t is None
            continue
        assert t.dtype == j.dtype and np.array_equal(t, j), name
        if name != "truncated":
            assert np.array_equal(t, sh_full), name
    t = ta.resolve_sh(conv["truncated"], 5)
    assert np.all(t[:, :3] == 1.0) and not t[:, 3:].any()


def test_bad_inputs_raise_like_jax():
    bad = [
        {"Cd": np.zeros((3, 3))},                                   # no P
        {"P": np.zeros((3, 2))},                                    # P not (N, 3)
        dict(_base(), scale=np.ones((4, 2), np.float32)),           # scale not (N, 3)
        dict(_base(), sh_coefficients=np.ones((4, 16, 3))),         # K > 15
        dict(_base(), sh2=np.ones((4, 2), np.float32), sh1=np.ones((4, 3))),  # sh2 not (N, 3)
    ]
    for attrs in bad:
        kinds = []
        for fn in (ja.splats_from_attributes, lambda a: ta.splats_from_attributes(a, device=CPU)):
            with pytest.raises(Exception) as info:
                fn(attrs)
            kinds.append(type(info.value))
        assert kinds[0] is kinds[1] is ValueError, kinds


def test_detail_config_matches_jax():
    for attrs in ({"gsplat__explicit_camera_pos": [1.0, 2.0, 3.0], "gsplat__sh_order": 2},
                  {"gsplat__sh_order": 7}, {"gsplat__sh_order": -1}, {}):
        (jc, jo), (tc, to) = ja.detail_config(attrs), ta.detail_config(attrs)
        assert jo == to
        assert (jc is None and tc is None) or np.array_equal(jc, tc)
    assert ta.detail_config({"gsplat__sh_order": 7})[1] == 0
    assert ta.detail_config({}) == (None, 3)


def test_missing_attribute_logs_match_jax():
    """The defaults' error logs and the no-SH warning: the same texts at the
    same levels, once each, in both packages."""
    got = {}
    for pkg, mod in (("gsplat_tpu", ja), ("gsplat_tpu_torch", ta)):
        handler = LogRecords()
        logger = logging.getLogger(f"{pkg}.io.attributes")
        logger.addHandler(handler)
        mod.log._seen.clear()
        try:
            kwargs = {"device": CPU} if mod is ta else {}
            mod.splats_from_attributes({"P": np.zeros((2, 3), np.float32)}, **kwargs)
            mod.splats_from_attributes({"P": np.zeros((2, 3), np.float32)}, **kwargs)  # once only
            mod.detail_config({"gsplat__sh_order": 9})
        finally:
            logger.removeHandler(handler)
        got[pkg] = handler.records
    assert got["gsplat_tpu"] == got["gsplat_tpu_torch"]
    assert len(got["gsplat_tpu"]) == 6, got["gsplat_tpu"]


@pytest.fixture(scope="module")
def pair():
    a = gj.random_splats(jax.random.PRNGKey(7), 37, extent=0.8, sh_scale=0.2)
    b = gj.random_splats(jax.random.PRNGKey(8), 23, extent=0.5, sh_scale=0.2)
    return a, b, splats_to_torch(a), splats_to_torch(b)


def test_concat_head_astype_match_jax(pair):
    ja_, jb, ta_, tb = pair
    _same(ja_.concat(jb), ta_.concat(tb))
    for k in (0, 5, 37):
        _same(ja_.head(k), ta_.head(k))
    jh, th = ja_.astype(jnp.bfloat16), ta_.astype(torch.bfloat16)
    assert th.pos.dtype == torch.float32 and th.opacity.dtype == torch.bfloat16
    for f in FIELDS:
        want = np.asarray(getattr(jh, f)).astype(np.float32)
        assert np.array_equal(getattr(th, f).float().numpy(), want), f


def test_barycenter_and_bbox_match_jax(pair):
    for js, ts in ((pair[0], pair[2]), (pair[1], pair[3])):
        assert ts.barycenter().shape == (3,)
        np.testing.assert_allclose(npy(ts.barycenter()), np.asarray(js.barycenter()), rtol=0, atol=1e-6)
        for got, want in zip(ts.bbox(), js.bbox()):
            assert np.array_equal(npy(got), np.asarray(want))
