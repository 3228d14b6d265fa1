"""A run whose timed path is broken underneath comes out not correct: for
each fault a cell can have.  The harness runs on the CPU (its look for a
chip is skipped), at a size a test run holds."""

import pytest
import torch

from conftest import SEED
from harness import bench, faults, program as prog


@pytest.mark.parametrize("value", [0.25, float("nan")])
def test_an_altered_frame_is_not_correct(tiny_cell, monkeypatch, value):
    render = prog.gt.render

    def altered(*args, **kw):
        image, stats = render(*args, **kw)
        one = torch.arange(image.numel()).reshape(image.shape) == 7
        return torch.where(one, image + value, image), stats

    monkeypatch.setattr(prog.gt, "render", altered)
    res = bench.run_cell(tiny_cell("trained_1m.serve"), SEED, 0.2, False, "cpu")
    assert not res["correct"], res["checks"]


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(tiny_cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = bench.run_cell(tiny_cell("trained_1m.train"), SEED, 0.2, False, "cpu")
    assert not res["correct"], res["checks"]


def test_a_loss_over_half_the_batch_is_not_correct(tiny_cell, monkeypatch):
    from gsplat_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "render_loss", faults.half_batch(trainer.render_loss))
    res = bench.run_cell(tiny_cell("trained_1m.train"), SEED, 0.2, False, "cpu")
    assert not res["correct"], res["checks"]
