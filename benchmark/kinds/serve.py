"""Traffic of kind ``serve``: a viewer, closed loop, one frame in flight.

Set-up fits the pair budget (``tune_pair_budget`` over the camera set's
heaviest pose) and the tile capacity (the heaviest pose first) to the
camera set, captures ``render(..., with_stats=True)`` over a camera whose
tensors each frame's pose is copied into (the program's counterpart of
``jax.jit``), and serves every pose once.  The window cycles the poses: a frame copies its pose in,
replays the graph and reads the frame's ``dropped_pairs``, which waits for
the frame to complete.  The frames of a few poses drawn from the seed, and
of the heaviest pose, are kept as they were served and compared with the
reference once the window has closed.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from harness import program as prog
from harness import scenes
from reference import render as ref


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
        self.splats = prog.splats_of(self.fields)
        self.poses = scenes.camera_set(t, self.seed, self.width, self.height, dev)
        cams = [prog.camera_of(p, self.width, self.height, dev) for p in self.poses]
        base = prog.render_config(cell.config["render"])
        mark("inputs")
        cfg, self.heaviest = prog.tune(self.splats, cams, base, float(t["pair_headroom"]))
        mark("pair_budget")
        cams.insert(0, cams.pop(self.heaviest))
        self.cfg, self.capacity_need = prog.fit_capacity(self.splats, cams, cfg)
        self.fitted = {"pair_budget": self.cfg.pair_budget_override, "tile_capacity": self.cfg.tile_capacity,
                       "capacity_need": self.capacity_need}
        mark("tile_capacity")
        del cams
        rng = scenes.host_rng(self.seed, 2)
        others = [k for k in range(len(self.poses)) if k != self.heaviest]
        picked = rng.choice(len(others), size=min(int(t["check_frames"]) - 1, len(others)), replace=False)
        self.checked = sorted({self.heaviest, *(others[int(i)] for i in picked)})
        self.live = prog.live_camera(self.poses[0], self.width, self.height)

        def frame():
            return prog.gt.render(self.splats, self.live, self.cfg, with_stats=True)

        if dev.type == "cuda":
            self.graph = prog.graphs.capture(frame)
            self.replay = self.graph.replay
            self.pool_bytes = self.graph.pool_bytes
        else:
            self.graph, self.replay, self.pool_bytes = None, frame, None
        mark("capture")
        for pose in self.poses:
            self.serve(pose)

    def serve(self, pose):
        prog.set_camera(self.live, pose)
        image, stats = self.replay()
        return image, int(stats.dropped_pairs)

    def window(self, seconds: float) -> Dict:
        poses, checked = self.poses, set(self.checked)
        kept: Dict[int, torch.Tensor] = {}
        frames = failed = 0
        submit = 0.0
        t0 = time.perf_counter()
        while True:
            k = frames % len(poses)
            a = time.perf_counter()
            prog.set_camera(self.live, poses[k])
            image, stats = self.replay()
            submit += time.perf_counter() - a
            if k in checked and k not in kept:
                kept[k] = image.clone()
            failed += int(stats.dropped_pairs) > 0          # waits for the frame
            frames += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.kept = kept
        self.submit_us = submit / frames * 1e6
        return {"attempted": frames, "failed": failed, "metrics": {"frame_ms": wall / frames * 1e3}}

    def traced_call(self):
        pose = self.poses[self.heaviest]
        return lambda: self.serve(pose)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.graph = self.replay = self.splats = self.live = None
        gc.collect()  # the program's captured closures hold their graphs in reference cycles

    def _reference(self, k: int, dtype=torch.float32):
        p = self.poses[k]
        with torch.no_grad():
            return ref.render(self.fields, p.view_t, p.proj_t, p.pos_t, self.width, self.height,
                              self.cell.config["render"], dtype=dtype)

    def check(self) -> Dict:
        """The served frames against the reference; the reference's counts of
        the heaviest pose's work."""
        gaps = []
        for k, image in sorted(self.kept.items()):
            frame = self._reference(k)
            gaps.append(ref.gap(image, frame.image))
            if k == self.heaviest:
                self.counts = frame.counts
        return {key: max(g[key] for g in gaps) for key in gaps[0]}

    def control(self) -> Dict:
        """The reference computed in bfloat16 against the reference in float32,
        on the frames ``check`` compared."""
        gaps = [ref.gap(self._reference(k, torch.bfloat16).image.float(), self._reference(k).image)
                for k in sorted(self.kept)]
        return {key: max(g[key] for g in gaps) for key in gaps[0]}

    def layer_context(self) -> Dict:
        return {"submit_us": self.submit_us, "pool_bytes": self.pool_bytes, "counts": getattr(self, "counts", None),
                "render": self.cell.config["render"]}
