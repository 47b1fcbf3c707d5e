"""Entry ``agent_act``: ``QAttentionBCAgent.act`` at batch 1, one or more
policies taking turns.

A unit is one act, timed on the host from the observation dict to the
action on the host. The cell's ``policies`` are the configuration's
policies in the order they act; each has its own seeded weights. Cropped
traffic passes each observation's episode bounds as ``new_scene_bounds``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import acts, flops, traffic
from portbench.harness.core import reservoir_keep, sub_seed
from portbench.reference.qnet import draw_params


def proprio_of(obs: dict, mode: str) -> np.ndarray:
    """The proprio vector the policy consumes: ``dominant_assistive`` takes
    the left arm's first three values and the right arm's four."""
    if mode == "dominant_assistive":
        return np.concatenate([obs["low_dim_state_left_arm"][:3],
                               obs["low_dim_state_right_arm"]]).astype(np.float32)
    return np.asarray(obs["low_dim_state"], np.float32)


class Entry:
    def __init__(self, ctx):
        from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
        from voxactb_tpu_torch.config import MethodConfig

        ctx.mark("port")
        self.ctx = ctx
        dev = ctx.device
        conf = ctx.config
        self.cameras = conf["cameras"]
        self.roles = ctx.cell["policies"]
        self.agents, self.params, self.specs, self.kwargs, self.proprio = {}, {}, {}, {}, {}
        for i, role in enumerate(dict.fromkeys(self.roles)):
            cfg = MethodConfig(**ctx.method(role))
            if cfg.low_dim_size() != ctx.low_dim_size(role):
                raise ValueError(f"{role}: the port takes {cfg.low_dim_size()} proprio values")
            spec = ctx.spec(role)
            gen = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, 10 + i))
            self.params[role] = draw_params(spec, gen, dev)
            self.specs[role] = spec
            agent = QAttentionBCAgent(cfg, self.cameras, conf["scene_bounds"], device=dev)
            agent.build(training=False)
            agent.params = self.params[role]
            self.agents[role] = agent
            pol = conf["policies"][role]
            self.kwargs[role] = pol.get("act_kwargs", {})
            self.proprio[role] = pol.get("proprio", "low_dim_state")
        ctx.mark("weights_agents")
        low_dim = max(ctx.low_dim_size(r) for r in self.roles)
        self.pool = traffic.observations(ctx.traffic, ctx.rng(1), self.cameras, low_dim)
        ctx.mark("traffic")
        self.resolution = ctx.method(self.roles[0])["rotation_resolution"]
        self.n = self.specs[self.roles[0]].voxel_size
        self.scene = np.asarray(conf["scene_bounds"], np.float32)
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
        j = self.i % len(self.pool)
        obs = self.pool[j]
        role = self.roles[self.i % len(self.roles)]
        bounds = obs.get("_bounds")
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.act"):
            res = self.agents[role].act(self.i, obs, new_scene_bounds=bounds,
                                        **self.kwargs[role])
        latency = time.perf_counter() - t0
        self.i += 1
        if window:
            self.seen += 1
            action = np.asarray(res.action)
            self.failed += int(not np.isfinite(action).all())
            reservoir_keep(self.sample_rng, self.kept, (j, role, res), self.seen, self.k)
        return 1, latency

    def flops_per_unit(self) -> float:
        return sum(flops.forward_flops(self.specs[r], 1) for r in self.roles) / len(self.roles)

    def window_extras(self) -> dict:
        return {"failed": self.failed}

    def trace_extras(self, rec: dict) -> dict:
        out = {"samples": rec["units"]}
        if len(set(self.roles)) == 1:  # one policy: K3's one tail per act
            out["k3_bound_s"] = rec["units"] * flops.k3_call_bound_s(self.specs[self.roles[0]], 1)
        return out

    def release(self):
        self.agents = {}

    def _items(self):
        items = []
        for j, role, res in self.kept:
            obs = self.pool[j]
            el = res.observation_elements
            items.append(acts.Served(
                role, [obs[f"{c}_rgb"] for c in self.cameras],
                [obs[f"{c}_point_cloud"] for c in self.cameras],
                obs.get("_bounds", self.scene), proprio_of(obs, self.proprio[role]),
                obs["lang_token_embs"], np.asarray(el["trans_action_indicies"]),
                np.asarray(el["rot_grip_action_indicies"]), np.asarray(res.action),
                res.info["q_depth0"].reshape((self.n,) * 3)))
        return items

    def check(self) -> dict:
        return acts.check(self.params, self.specs, self._items(), self.ctx.device,
                          self.resolution)

    def control(self) -> dict:
        return acts.check(self.params, self.specs, self._items(), self.ctx.device,
                          self.resolution, control=True)
