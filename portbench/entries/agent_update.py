"""Entry ``agent_update``: ``QAttentionBCAgent.update`` on batches drawn as
``cli.train`` draws them (``replay.TaskUniformReplayBuffer`` ->
``replay/dataset.PrefetchIterator``), each update dispatched without
waiting on the last.

Set-up builds one agent and one feed and drives them through the first
three steps, which the check follows: each step's loss, the first step's
heads (taken by a forward hook on the step's module, which set-up removes
again), the first gradient (read from the optimizer's first moments after
one step) and each leaf's change after three steps are kept. The window then trains on from that
state. A unit is one update; the window ends in a synchronise.

Once the window (and any traced slice) is over, the same agent makes one
more update through the same call and feed from a snapshot of the state the
window left (parameters, LAMB's moments and count), and its heads, its
gradient (from the change of the first moments) and each leaf's change are
kept: the check follows that late step from the snapshot, so a path that
changes only after the first steps (a captured graph, a filled cache) is
held too.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import compare, flops, traffic
from portbench.harness.core import sub_seed
from portbench.reference import train as ref_train
from portbench.reference.qnet import draw_params

CHECKED_STEPS = 3
B1 = 0.9  # LAMB's first-moment decay: mu after one step is (1 - B1) g


class Entry:
    def __init__(self, ctx):
        from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
        from voxactb_tpu_torch.config import MethodConfig
        from voxactb_tpu_torch.replay.buffer import (
            TaskUniformReplayBuffer, bc_replay_signature)
        from voxactb_tpu_torch.replay.dataset import PrefetchIterator

        ctx.mark("port")
        self.ctx = ctx
        dev = ctx.device
        conf = ctx.config
        self.cameras = conf["cameras"]
        self.role = ctx.cell["policies"][0]
        self.method = ctx.method(self.role)
        cfg = MethodConfig(**self.method)
        low_dim = ctx.low_dim_size(self.role)
        if cfg.low_dim_size() != low_dim:
            raise ValueError(f"the port takes {cfg.low_dim_size()} proprio values")
        self.spec = ctx.spec(self.role)
        self.b = int(ctx.traffic["batch"])
        gen = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, 10))
        self.params0 = draw_params(self.spec, gen, dev)
        self.agent_seed = sub_seed(ctx.seed, 4)
        self.agent = QAttentionBCAgent(
            cfg, self.cameras, conf["scene_bounds"], batch_size=self.b,
            training_iterations=int(ctx.cell["training_iterations"]), device=dev,
            seed=self.agent_seed)
        self.agent.build(training=True)
        self.agent.params = self.params0
        self.module = self.agent._train_step.model
        ctx.mark("weights_agents")
        self.rows = traffic.replay_rows(ctx.traffic, ctx.rng(1), self.cameras, low_dim)
        image = ctx.traffic["image"]
        buffer = TaskUniformReplayBuffer(
            len(self.rows), bc_replay_signature(
                self.cameras, (image, image), low_dim_size=low_dim,
                crop_target_obj_voxel=self.method["crop_target_obj_voxel"],
                arm_pred_loss=self.method["arm_pred_loss"]),
            seed=sub_seed(ctx.seed, 3))
        buffer.extend(self.rows)
        self.feed = PrefetchIterator(lambda: buffer.sample_transition_batch(self.b),
                                     device=dev)
        ctx.mark("traffic")
        self.step = 0
        self.data_wait = 0.0
        self.losses = []
        self.checked = {}

    # -- the program ---------------------------------------------------------------

    def _update(self, batch):
        out = self.agent.update(self.step, batch)
        self.step += 1
        return out["total_loss"]

    def _hooked_update(self, heads: dict):
        """One update through the window's call, its heads kept in ``heads``
        by a forward hook that is removed again; returns the batch's row
        numbers and the loss."""

        def keep_heads(module, args, out):
            if not heads:
                heads.update({k: out[k].detach().float().clone() for k in ref_train.HEADS})

        hook = self.module.register_forward_hook(keep_heads)
        try:
            batch = next(self.feed)
            ids = batch["reward"].detach().clone()
            return ids, self._update(batch)
        finally:
            hook.remove()

    def warm(self):
        """The three checked steps (which also build and warm every shape)."""
        ids, losses, heads = [], [], {}
        for i in range(CHECKED_STEPS):
            if i == 0:
                row_ids, loss = self._hooked_update(heads)
            else:
                batch = next(self.feed)
                row_ids, loss = batch["reward"].detach().clone(), self._update(batch)
            ids.append(row_ids)
            losses.append(loss)
            if i == 0:
                mu = self.agent._state.opt_state.mu
                grads = compare.leaf_norms({k: v / (1.0 - B1) for k, v in mu.items()})
        params = self.agent._state.params
        deltas = compare.leaf_norms({k: params[k] - self.params0[k] for k in params})
        self.checked = {"ids": [t.cpu().numpy().astype(np.int64) for t in ids],
                        "losses": [float(x) for x in losses], "grads": grads,
                        "deltas": deltas, "out": heads}

    def sync(self):
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.synchronize()

    def unit(self, window: bool):
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.feed"):
            batch = next(self.feed)
        if window:
            self.data_wait += time.perf_counter() - t0
        with torch.profiler.record_function("portbench.update"):
            loss = self._update(batch)
        if window:
            self.losses.append(loss)
        return self.b, None

    def flops_per_unit(self) -> float:
        return flops.train_flops(self.spec, self.b)

    def window_extras(self) -> dict:
        failed = int((~torch.isfinite(torch.stack(self.losses))).sum()) if self.losses else 0
        distinct = len(np.unique(np.concatenate(self.checked["ids"])))
        return {"failed": failed, "data_wait_s": self.data_wait,
                "checked_rows_distinct": distinct}

    def trace_extras(self, rec: dict) -> dict:
        return {"samples": rec["units"] * self.b,
                "k4_bound_s": rec["units"] * flops.k4_step_bound_s(self.spec, self.b)}

    def _late_step(self):
        """One more update after the window, from a snapshot of its state."""
        state = self.agent._state
        opt = state.opt_state
        snap = {"skip": self.step, "count": int(opt.count),
                "params": {k: v.detach().clone() for k, v in state.params.items()},
                "mu": {k: v.detach().clone() for k, v in opt.mu.items()},
                "nu": {k: v.detach().clone() for k, v in opt.nu.items()}}
        heads = {}
        ids, loss = self._hooked_update(heads)
        after = self.agent._state
        mu = after.opt_state.mu
        grads = compare.leaf_norms({k: (mu[k] - B1 * snap["mu"][k]) / (1.0 - B1) for k in mu})
        deltas = compare.leaf_norms({k: after.params[k] - snap["params"][k]
                                     for k in after.params})
        self.checked["late"] = {**snap, "ids": ids.cpu().numpy().astype(np.int64),
                                "losses": [float(loss)], "grads": grads, "deltas": deltas,
                                "out": heads}

    def release(self):
        """The window is over: the late step, then the program is freed."""
        self._late_step()
        self.feed.close()
        self.agent = self.feed = None
        self.losses = []

    # -- the reference -------------------------------------------------------------

    def _batch(self, ids):
        rows = [self.rows[i] for i in ids]
        return {k: torch.as_tensor(np.stack([np.asarray(r[k]) for r in rows]),
                                   device=self.ctx.device) for k in rows[0]}

    def _reference(self, precision="exact", half=False, frozen=False) -> dict:
        """The first three steps from the drawn weights, and the late step
        from the snapshot, with the generator advanced past the steps
        between (their draws taken and dropped)."""
        dev = self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(self.agent_seed)
        losses, grads, out, params = ref_train.run_steps(
            self.params0, self.spec, self.method, self.cameras,
            [self._batch(ids) for ids in self.checked["ids"]], gen,
            precision=precision, half=half, frozen=frozen)
        deltas = compare.leaf_norms({k: params[k] - self.params0[k] for k in params})
        first = {"losses": losses, "grads": compare.leaf_norms(grads), "deltas": deltas,
                 "out": out}
        late = self.checked["late"]
        gen = torch.Generator(device=dev).manual_seed(self.agent_seed)
        ref_train.skip_steps(gen, self.spec, self.method, self.b, late["skip"])
        losses, grads, out, params = ref_train.run_steps(
            late["params"], self.spec, self.method, self.cameras, [self._batch(late["ids"])],
            gen, precision=precision, half=half, frozen=frozen,
            opt_state=(late["count"], late["mu"], late["nu"]))
        deltas = compare.leaf_norms({k: params[k] - late["params"][k] for k in params})
        first["late"] = {"losses": losses, "grads": compare.leaf_norms(grads),
                         "deltas": deltas, "out": out}
        return first

    @staticmethod
    def _readings(prog: dict, ref: dict) -> dict:
        late = compare.train_readings(prog["late"], ref["late"], prefix="late_")
        # the late gradient's gap is not compared: at a trained state the
        # program's own bf16 rounding reads as high as the control (PERF.md);
        # it stays among the details
        del late["late_grad_gap"]
        return {**compare.train_readings(prog, ref), **late}

    def check(self) -> dict:
        self.ref = self._reference()
        return self._readings(self.checked, self.ref)

    def control(self) -> dict:
        self.control_ref = self._reference("fp8")
        return self._readings(self.control_ref, self.ref)

    def half_batch(self) -> dict:
        """The readings of a step that leaves out half of the batch (the
        reference put in the program's place)."""
        self.half_ref = self._reference(half=True)
        return self._readings(self.half_ref, self.ref)

    def frozen(self) -> dict:
        """The readings of a step that returns its state unchanged (the
        reference put in the program's place): the losses at the parameters
        it started from, the first moments unchanged (so a first gradient of
        0, and a late one equal to the moments before), no change."""
        ref = self._reference(frozen=True)
        zero = {k: 0.0 for k in ref["grads"]}
        late = self.checked["late"]
        stale = compare.leaf_norms(late["mu"])
        return self._readings(
            {"losses": ref["losses"], "grads": zero, "deltas": zero, "out": ref["out"],
             "late": {"losses": ref["late"]["losses"], "grads": stale, "deltas": zero,
                      "out": ref["late"]["out"]}}, self.ref)

    def details(self) -> dict:
        """What the program's, the control's and the half batch's numbers
        are made of (``compare.train_details``)."""
        out = {"program": compare.train_details(self.checked, self.ref),
               "program_late": compare.train_details(self.checked["late"], self.ref["late"])}
        for name in ("control_ref", "half_ref"):
            if hasattr(self, name):
                ref = getattr(self, name)
                out[name] = compare.train_details(ref, self.ref)
                out[name + "_late"] = compare.train_details(ref["late"], self.ref["late"])
        return out
