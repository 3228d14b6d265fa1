"""Traffic of kind ``train``: a trainer, steps dispatched one after another.

Set-up makes the training views and their targets from the seed, fits the
pair budget (over the heaviest view, with the mix's headroom for the splats
that Adam moves) and the tile capacity, builds the parameters with
``params_from_splats``, the optimizer with ``default_optimizer`` and the step
with ``make_train_step`` over a camera whose tensors each step's view is
copied into.  It then takes the first three steps through that same step
(call 1 runs eagerly, call 2 captures the step and replays it, call 3
replays) on three different views, keeping each loss, the first gradient
(Adam's first moment after one step, over 1 - beta1) and the parameters'
change after the three, for the reference to follow.

Every epoch of the window, and the first three steps, start from the same
state: the parameters as built and Adam's state at zero, restored in place
(the copy is inside the window and counted in ``step_ms``).  Without it
Adam's learning rates move the scene over a window's steps until the fitted
budget drops pairs; with it every epoch does the same work.  An epoch takes
the views in an order shuffled from the seed; the loss is read every
``loss_every`` steps.  A step fails when the program reports dropped pairs
(its own deferred read of the previous step's counter, a warning of the
``gsplat_tpu_torch.binning`` logger, once for each run of steps that drop)
or when a loss read is not finite.
"""

from __future__ import annotations

import gc
import logging
import math
import time
from typing import Dict, List

import torch

from harness import program as prog
from harness import scenes
from reference import render as ref
from reference import train as rtrain

CHECK_STEPS = 3


class _Drops(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.count = 0

    def emit(self, record):
        if "dropped" in record.getMessage():
            self.count += 1


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        r = cell.config["render"]
        self.width, self.height = int(r["width"]), int(r["height"])

    def setup(self, mark) -> None:
        """``mark(name)`` after each part of set-up."""
        cell, dev, t = self.cell, self.device, self.cell.traffic
        ref.settings(cell.config["render"])
        self.fields = scenes.scene(cell.config["scene"], self.seed, dev)
        splats = prog.splats_of(self.fields)
        self.views = scenes.camera_set(t, self.seed, self.width, self.height, dev)
        self.targets = scenes.targets(t, self.seed, len(self.views), self.width, self.height, dev)
        cams = [prog.camera_of(p, self.width, self.height, dev) for p in self.views]
        base = prog.render_config(cell.config["render"])
        mark("inputs")
        cfg, self.heaviest = prog.tune(splats, cams, base, float(t["pair_headroom"]))
        mark("pair_budget")
        cams.insert(0, cams.pop(self.heaviest))
        self.cfg, self.capacity_need = prog.fit_capacity(splats, cams, cfg, float(t["capacity_headroom"]))
        self.fitted = {"pair_budget": self.cfg.pair_budget_override, "tile_capacity": self.cfg.tile_capacity,
                       "capacity_need": self.capacity_need}
        mark("tile_capacity")
        del cams
        self.params = prog.gt.params_from_splats(splats)
        del splats
        self.start = {k: v.detach().clone() for k, v in self.params.as_dict().items()}
        self.opt = prog.gt.default_optimizer(self.params)
        self.live = prog.live_camera(self.views[0], self.width, self.height)
        self.step = prog.gt.make_train_step(self.opt, self.live, self.cfg, lambda_dssim=float(t["lambda_dssim"]))
        mark("step")
        self.order0 = self.epoch_order(0)
        self.losses, self.first_grad, self.change = [], None, None
        beta1 = self.opt.param_groups[0]["betas"][0]
        for i in range(CHECK_STEPS):
            self.losses.append(float(self.take(self.order0[i])))
            if i == 0:
                # a step that made no state reads as a gradient of zeros
                self.first_grad = {k: (self.opt.state.get(v, {}).get("exp_avg", torch.zeros_like(v)).detach()
                                       / (1.0 - beta1)).cpu() for k, v in self.params.as_dict().items()}
        self.change = {k: (v.detach() - self.start[k]).cpu() for k, v in self.params.as_dict().items()}
        mark("first_steps")
        self.pool_bytes = self.step.graph.pool_bytes if self.step.graph is not None else None
        self.restore()

    def epoch_order(self, epoch: int) -> List[int]:
        rng = scenes.host_rng(self.seed, 100 + epoch)
        return [int(v) for v in rng.permutation(len(self.views))]

    def take(self, view: int):
        prog.set_camera(self.live, self.views[view])
        return self.step(self.params, self.targets[view])

    def restore(self) -> None:
        with torch.no_grad():
            for k, v in self.params.as_dict().items():
                v.copy_(self.start[k])
                for s in self.opt.state.get(v, {}).values():
                    s.zero_()

    def window(self, seconds: float) -> Dict:
        every = int(self.cell.traffic["loss_every"])
        drops = _Drops()
        log = logging.getLogger("gsplat_tpu_torch.binning")
        log.addHandler(drops)
        steps = bad = epoch = 0
        try:
            t0 = time.perf_counter()
            done = False
            while not done:
                self.restore()
                for v in self.epoch_order(epoch):
                    loss = self.take(v)
                    steps += 1
                    if steps % every == 0 and not math.isfinite(float(loss)):
                        bad += 1
                    if time.perf_counter() - t0 >= seconds:
                        done = True
                        break
                epoch += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            log.removeHandler(drops)
        return {"attempted": steps, "failed": drops.count + bad, "metrics": {"step_ms": wall / steps * 1e3}}

    def traced_call(self):
        v = self.order0[0]

        def call():
            self.restore()
            return self.take(v)

        return call

    def release(self) -> None:
        self.step = self.opt = self.params = self.live = self.start = None
        gc.collect()  # make_train_step's step refers to itself: a reference cycle holds its graph

    def _reference(self, dtype=torch.float32) -> Dict:
        """The reference's first steps on the views and targets of the
        program's first steps."""
        t, steps = self.cell.traffic, self.order0[:CHECK_STEPS]
        return rtrain.steps(self.fields, [self.views[v] for v in steps], [self.targets[v] for v in steps],
                            self.width, self.height, self.cell.config["render"], t["learning_rates"],
                            float(t["lambda_dssim"]), dtype=dtype)

    def check(self) -> Dict:
        """The first three steps against the reference's; the reference's
        counts of the first step's frame."""
        run = self._reference()
        self.counts = run["counts"]
        return rtrain.gaps(self.losses, self.first_grad, self.change, run)

    def control(self) -> Dict:
        """The reference's first steps computed in bfloat16 against the same
        in float32."""
        low = self._reference(torch.bfloat16)
        return rtrain.gaps(low["losses"], low["first_grad"], low["change"], self._reference())

    def layer_context(self) -> Dict:
        return {"pool_bytes": self.pool_bytes, "counts": getattr(self, "counts", None),
                "render": self.cell.config["render"]}

