"""The harness finds what a cell names by name, and holds the program and
the reference to every render setting of a configuration."""

import dataclasses
import json

import pytest
import torch

from conftest import SEED
from harness import bench, program as prog, scenes, spec
from reference import render as ref


def test_every_cell_names_files_that_are_there():
    bench_file = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench_file["workloads"]:
        cell = spec.load(w["name"])
        assert bench.kind(cell).__name__ == "Run"
        scene_kind = spec.module("scenes", cell.config["scene"]["kind"])
        assert callable(scene_kind.geometry) and callable(scene_kind.appearance)
        assert set(cell.limits)


def test_a_new_kind_is_found_by_its_file_name(tmp_path, monkeypatch):
    (tmp_path / "kinds").mkdir()
    (tmp_path / "kinds" / "probe_kind.py").write_text("class Run:\n    found = True\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    cell = spec.Cell(name="x", config={}, traffic={"kind": "probe_kind"}, limits={}, chips=1, end_to_end=[],
                     per_layer=[])
    assert bench.kind(cell).found
    with pytest.raises(SystemExit):
        spec.module("kinds", "no_such_kind")


@pytest.mark.parametrize("name", ["trained_1m.serve", "envelope_8m.train"])
def test_every_render_setting_reaches_the_program(name):
    render = spec.load(name).config["render"]
    cfg = prog.render_config(render)
    for k, v in render.items():
        if k not in prog.CAMERA_KEYS:
            assert getattr(cfg, k) == v, k
    assert ref.settings(render) is render


@pytest.mark.parametrize("key, value", [("soft_cutoff", True), ("max_alpha", 0.999), ("payload_dtype", "bfloat16"),
                                        ("depth_test", True), ("no_such_setting", 1)])
def test_a_setting_the_reference_does_not_state_is_refused(key, value):
    render = dict(spec.load("trained_1m.serve").config["render"], **{key: value})
    with pytest.raises(ValueError):
        ref.settings(render)


def test_a_setting_the_program_does_not_have_is_refused():
    render = dict(spec.load("trained_1m.serve").config["render"], no_such_setting=1)
    with pytest.raises(ValueError):
        prog.render_config(render)


def test_the_capacity_fit_is_the_least_that_drops_nothing(tiny_cell):
    cell = tiny_cell("trained_1m.serve")
    r = cell.config["render"]
    w, h = r["width"], r["height"]
    fields = scenes.scene(cell.config["scene"], SEED, "cpu")
    splats = prog.splats_of(fields)
    cams = [prog.camera_of(p, w, h, "cpu") for p in scenes.camera_set(cell.traffic, SEED, w, h, "cpu")]
    base = dataclasses.replace(prog.render_config(r), tile_capacity=128)
    cfg, _ = prog.tune(splats, cams, base, 1.02)
    fitted, least = prog.fit_capacity(splats, cams, cfg)
    assert fitted.tile_capacity == least and least % cfg.chunk == 0

    def dropped(capacity):
        c = dataclasses.replace(cfg, tile_capacity=capacity, warn_on_drop=False)
        with torch.no_grad():
            return sum(int(prog.gt.render(splats, cam, c, with_stats=True)[1].dropped_pairs) for cam in cams)

    assert dropped(least) == 0
    if least > cfg.chunk:
        assert dropped(least - cfg.chunk) > 0
    more, _ = prog.fit_capacity(splats, cams, cfg, headroom=1.5)
    assert more.tile_capacity >= 1.5 * least and more.tile_capacity % cfg.chunk == 0
