"""The frozen reference against the program's plain path at a tiny size on
the CPU: the same frame, and through the harness the same first steps."""

import torch

from conftest import SEED
from harness import bench, program as prog, scenes
from reference import render as ref


def test_reference_frame_matches_the_program(tiny_cell):
    for name in ("trained_1m.serve", "envelope_8m.serve"):
        cell = tiny_cell(name)
        r = cell.config["render"]
        w, h = r["width"], r["height"]
        fields = scenes.scene(cell.config["scene"], SEED, "cpu")
        splats = prog.splats_of(fields)
        for pose in scenes.camera_set(cell.traffic, SEED, w, h, "cpu")[:2]:
            cfg = prog.gt.tune_pair_budget(splats, [prog.camera_of(pose, w, h, "cpu")], prog.render_config(r), 1.02)
            image = prog.gt.render(splats, prog.camera_of(pose, w, h, "cpu"), cfg)
            frame = ref.render(fields, pose.view_t, pose.proj_t, pose.pos_t, w, h, r)
            assert frame.counts["pairs_walked"] > 0 and frame.counts["live_pixel_updates"] > 0
            assert float(frame.image[..., 3].max()) > 0.5
            assert ref.gap(image, frame.image)["max_abs"] < 1e-5


def test_harness_runs_are_correct(tiny_cell):
    for name in ("trained_1m.serve", "trained_1m.train"):
        res = bench.run_cell(tiny_cell(name), SEED, 0.2, False, "cpu")
        assert res["correct"], res["checks"]
        assert res["attempted"] >= 1 and res["failed"] == 0
        assert list(res)[-1] == "checks"


def test_reference_gradient_matches_autograd_of_the_program(tiny_cell):
    """The reference's first gradient against the gradient of the program's
    CPU render of the same loss."""
    from reference import train as rtrain

    cell = tiny_cell("trained_1m.train")
    r, t = cell.config["render"], cell.traffic
    w, h = r["width"], r["height"]
    fields = scenes.scene(cell.config["scene"], SEED, "cpu")
    pose = scenes.camera_set(t, SEED, w, h, "cpu")[0]
    target = scenes.targets(t, SEED, 1, w, h, "cpu")[0]
    run = rtrain.steps(fields, [pose], [target], w, h, r, t["learning_rates"], t["lambda_dssim"])
    params = prog.gt.params_from_splats(prog.splats_of(fields))
    cfg = prog.gt.tune_pair_budget(prog.splats_of(fields), [prog.camera_of(pose, w, h, "cpu")],
                                   prog.render_config(r), 1.05)
    img = prog.gt.render(prog.gt.splats_from_params(params), prog.camera_of(pose, w, h, "cpu"), cfg)
    loss = prog.gt.render_loss(img[..., :3] + (1.0 - img[..., 3:4]), target, t["lambda_dssim"])
    loss.backward()
    got = dict(zip(rtrain.FIELDS, (params.pos.grad, params.quat.grad, params.log_scale.grad,
                                   params.logit_opacity.grad, params.color.grad, params.sh.grad)))
    assert abs(float(loss.detach()) - run["losses"][0]) <= 1e-6 * abs(run["losses"][0])
    assert rtrain.norm_gap(got, run["first_grad"]) < 1e-3
    # the packed payload's gradient space holds the colour cotangent in
    # bfloat16: within a bfloat16 step of the reference's float32, over the
    # field (an element whose terms cancel may be off by more than its own)
    want = run["first_grad"]["color"]
    assert float(torch.linalg.norm(got["color"] - want)) <= 2 ** -8 * float(torch.linalg.norm(want))
