"""Entry ``infer_batch``: ``agents/qfunction.make_infer_fn``'s act program
at the cell's ``batch``, host observations in and the actions on the host
out (the voxel Q field stays on the device, as the agent leaves it).

A unit is one call; the next is sent when the last has returned. The
observations form a pool drawn at set-up, cycled a batch at a time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import acts, flops, traffic
from portbench.harness.core import reservoir_keep, sub_seed
from portbench.reference.qnet import draw_params


class Entry:
    def __init__(self, ctx):
        from voxactb_tpu_torch.agents.qfunction import make_infer_fn
        from voxactb_tpu_torch.config import MethodConfig

        self.ctx = ctx
        dev = ctx.device
        conf = ctx.config
        self.cameras = conf["cameras"]
        self.role = ctx.cell["policies"][0]
        cfg = MethodConfig(**ctx.method(self.role))
        if cfg.low_dim_size() != ctx.low_dim_size(self.role):
            raise ValueError(f"the port takes {cfg.low_dim_size()} proprio values")
        self.spec = ctx.spec(self.role)
        gen = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, 10))
        self.params = draw_params(self.spec, gen, dev)
        self.model, self.infer = make_infer_fn(cfg, device=dev)
        self.model.load_state_dict(self.params)
        self.b = int(ctx.traffic["batch"])
        pool = traffic.observations(ctx.traffic, ctx.rng(1), self.cameras,
                                    ctx.low_dim_size(self.role))
        if len(pool) % self.b:
            raise ValueError("the pool must hold whole batches")
        self.pool = pool
        self.scene = np.asarray(conf["scene_bounds"], np.float32)
        f32 = lambda xs: np.stack(xs).astype(np.float32)  # noqa: E731
        self.calls = []
        for s in range(0, len(pool), self.b):
            part = pool[s:s + self.b]
            self.calls.append((
                tuple(f32([o[f"{c}_rgb"] for o in part]) for c in self.cameras),
                tuple(f32([o[f"{c}_point_cloud"] for o in part]) for c in self.cameras),
                f32([o["low_dim_state"] for o in part]),
                f32([o["lang_goal_emb"] for o in part]),
                f32([o["lang_token_embs"] for o in part]),
                np.tile(self.scene, (self.b, 1))))
        self.resolution = ctx.method(self.role)["rotation_resolution"]
        self.sample_rng = ctx.rng(2)
        self.k = int(ctx.cell["check_samples"])
        self.kept, self.seen, self.failed, self.i = [], 0, 0, 0

    def warm(self):
        for _ in range(int(self.ctx.cell["warm_units"])):
            self.unit(window=False)

    def sync(self):
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.synchronize()

    def unit(self, window: bool):
        j = self.i % len(self.calls)
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.call"):
            out = self.infer(self.model, *self.calls[j])
        with torch.profiler.record_function("portbench.to_host"):
            host = (out.trans_idx.cpu().numpy(), out.rot_grip_idx.cpu().numpy(),
                    out.continuous_action.cpu().numpy())
        latency = time.perf_counter() - t0
        self.i += 1
        if window:
            self.seen += 1
            self.failed += int((~np.isfinite(host[2])).any(-1).sum())
            reservoir_keep(self.sample_rng, self.kept, (j, host, out.q_trans), self.seen,
                           self.k)
        return self.b, latency

    def flops_per_unit(self) -> float:
        return flops.forward_flops(self.spec, self.b)

    def window_extras(self) -> dict:
        return {"failed": self.failed}

    def trace_extras(self, rec: dict) -> dict:
        return {"samples": rec["units"] * self.b,
                "k3_bound_s": rec["units"] * flops.k3_call_bound_s(self.spec, self.b)}

    def release(self):
        self.model = self.infer = None

    def _items(self):
        items = []
        for j, (t_idx, rg, cont), q in self.kept:
            for r in range(self.b):
                obs = self.pool[j * self.b + r]
                items.append(acts.Served(
                    self.role, [obs[f"{c}_rgb"] for c in self.cameras],
                    [obs[f"{c}_point_cloud"] for c in self.cameras], self.scene,
                    np.asarray(obs["low_dim_state"], np.float32), obs["lang_token_embs"],
                    t_idx[r], rg[r], cont[r], q[r]))
        return items

    def check(self) -> dict:
        return acts.check({self.role: self.params}, {self.role: self.spec}, self._items(),
                          self.ctx.device, self.resolution)

    def control(self) -> dict:
        return acts.check({self.role: self.params}, {self.role: self.spec}, self._items(),
                          self.ctx.device, self.resolution, control=True)
