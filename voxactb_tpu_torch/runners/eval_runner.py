"""Checkpoint evaluation orchestration: sweep weights, roll episodes, score, log.

Counterpart of ``IndependentEnvRunner`` / ``_IndependentEnvRunner``
(yarr/runners/independent_env_runner.py:19-146, _independent_env_runner.py:27-380) and
the checkpoint-selection logic in peract/eval.py:144-199:

- ``eval_type='missing'``: score every saved weight step not already present in
  ``eval_data.csv`` (skip-already-scored, eval.py:148-152);
- ``'best'``: read the eval CSV and evaluate the best step on the test seed;
- ``'last'``: newest weights only; an int evaluates that specific step.
- dual-policy eval: an independently-selected stabilizing (left-arm) checkpoint rides
  along (eval.py:206-241, conf/eval.yaml left_arm_ckpt).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np

from voxactb_tpu_torch.agents.base import Agent
from voxactb_tpu_torch.envs.base import BimanualEnv
from voxactb_tpu_torch.runners.rollout import RolloutGenerator
from voxactb_tpu_torch.utils.loggers import CsvWriter, StatAccumulator


def existing_weight_steps(weightsdir: str) -> List[int]:
    if not os.path.isdir(weightsdir):
        return []
    return sorted(int(d) for d in os.listdir(weightsdir) if d.isdigit())


def already_scored_steps(csv_path: str) -> List[int]:
    if not os.path.exists(csv_path):
        return []
    with open(csv_path) as f:
        return [int(float(r["step"])) for r in csv.DictReader(f) if r.get("step")]


def select_checkpoints(weightsdir: str, eval_type, eval_csv: str) -> List[int]:
    """eval.py:144-199 selection semantics."""
    steps = existing_weight_steps(weightsdir)
    if not steps:
        return []
    if isinstance(eval_type, int):
        return [eval_type] if eval_type in steps else []
    if eval_type == "last":
        return [steps[-1]]
    if eval_type == "missing":
        done = set(already_scored_steps(eval_csv))
        return [s for s in steps if s not in done]
    if eval_type == "best":
        best_step, best_ret = None, -np.inf
        if os.path.exists(eval_csv):
            with open(eval_csv) as f:
                for r in csv.DictReader(f):
                    ret = float(r.get("eval_envs/return", "nan") or "nan")
                    if np.isfinite(ret) and ret >= best_ret:
                        best_ret, best_step = ret, int(float(r["step"]))
        return [best_step] if best_step is not None else [steps[-1]]
    raise ValueError(f"unknown eval_type {eval_type!r}")


class EvalRunner:
    def __init__(
        self,
        env: BimanualEnv,
        agent: Agent,
        weightsdir: str,
        logdir: str,
        left_arm_agent: Optional[Agent] = None,
        left_arm_ckpt: Optional[str] = None,
        eval_episodes: int = 25,
        episode_length: int = 25,
        which_arm: str = "dominant_assistive",
        crop_target_obj_voxel: bool = True,
        crop_radius: float = 0.3,
        auto_crop: bool = False,
        eval_from_eps_number: int = 0,
        csv_name: str = "eval_data.csv",
        selection_csv_name: Optional[str] = None,
    ):
        """``selection_csv_name``: CSV used by checkpoint SELECTION when it
        differs from the one being written — the reference's test pass selects
        'best' from the validation eval_data.csv while writing test_data.csv
        (peract/eval.py:144-199 + conf/eval.yaml)."""
        self._env = env
        self._agent = agent
        self._left_arm_agent = left_arm_agent
        self._left_arm_ckpt = left_arm_ckpt
        self._weightsdir = weightsdir
        self._logdir = logdir
        self._eval_episodes = eval_episodes
        self._episode_length = episode_length
        self._which_arm = which_arm
        self._crop = crop_target_obj_voxel
        self._crop_radius = crop_radius
        self._auto_crop = auto_crop
        self._eval_from = eval_from_eps_number
        self._csv_path = os.path.join(logdir, csv_name)
        self._selection_csv_path = os.path.join(
            logdir, selection_csv_name) if selection_csv_name else self._csv_path
        self._rollout = RolloutGenerator()

    def _score_episodes(self) -> Dict[str, float]:
        """Roll self._eval_episodes episodes with the currently-loaded agents
        and return the accumulated stat fields (the shared per-checkpoint loop
        of start() and sweep_stabilizing())."""
        acc = StatAccumulator()
        for ep in range(self._eval_from, self._eval_from + self._eval_episodes):
            total_reward, length = 0.0, 0
            for rt in self._rollout.generator(
                self._env, self._agent, self._episode_length, eval=True,
                left_arm_agent=self._left_arm_agent, which_arm=self._which_arm,
                crop_target_obj_voxel=self._crop, crop_radius=self._crop_radius,
                auto_crop=self._auto_crop, demo_index=ep,
            ):
                total_reward += rt.reward
                length += 1
            acc.step_episode(total_reward, length)
        return {s.name: s.value for s in acc.pop()}

    def _eval_checkpoint(self, step: int) -> Dict[str, float]:
        self._agent.load_weights(os.path.join(self._weightsdir, str(step)))
        if self._left_arm_agent is not None and self._left_arm_ckpt:
            self._left_arm_agent.load_weight(self._left_arm_ckpt)
        return {"step": step, **self._score_episodes()}

    def start(self, eval_type="missing",
              num_procs: int = 1) -> List[Dict[str, float]]:
        """Evaluate selected checkpoints; ``num_procs > 1`` fans one process out
        per checkpoint (peract/eval.py:242-261's Process-per-ckpt round-robin),
        keeping the skip-already-scored CSV contract — the parent writes rows."""
        steps = select_checkpoints(self._weightsdir, eval_type,
                                   self._selection_csv_path)
        if num_procs > 1 and len(steps) > 1:
            return self._start_parallel(steps, num_procs)
        self._agent.build(training=False)
        if self._left_arm_agent is not None:
            self._left_arm_agent.build(training=False)
        self._env.launch()
        writer = CsvWriter(self._csv_path)
        results = []
        try:
            for step in steps:
                row = self._eval_checkpoint(step)
                writer.write(row)
                results.append(row)
        finally:
            self._env.shutdown()
        return results

    def _worker(self, step: int, queue) -> None:
        """Child-process body: build fresh, score one checkpoint, ship the row."""
        try:
            self._agent.build(training=False)
            if self._left_arm_agent is not None:
                self._left_arm_agent.build(training=False)
            self._env.launch()
            try:
                queue.put(("ok", self._eval_checkpoint(step)))
            finally:
                self._env.shutdown()
        except Exception as e:  # surface worker failures to the parent
            queue.put(("err", f"step {step}: {type(e).__name__}: {e}"))

    def _start_parallel(self, steps: List[int],
                        num_procs: int) -> List[Dict[str, float]]:
        import multiprocessing as mp

        import torch

        if torch.cuda.is_initialized():
            # a forked child cannot use the CUDA context its parent made
            raise RuntimeError(
                "parallel checkpoint eval forks one process per checkpoint, and "
                "CUDA is already initialised in this process: the children could "
                "not use the card. Run it from a process that has not touched "
                "CUDA (each child builds its agent itself), or pass num_procs=1")
        ctx = mp.get_context("fork")  # agents/envs need not be picklable
        queue = ctx.Queue()
        writer = CsvWriter(self._csv_path)
        results: List[Dict[str, float]] = []
        pending = list(steps)
        running: List = []
        errors: List[str] = []
        n_outstanding = 0
        import queue as pyqueue

        while pending or n_outstanding > 0:
            while pending and n_outstanding < num_procs:
                p = ctx.Process(target=self._worker,
                                args=(pending.pop(0), queue))
                p.start()
                running.append(p)
                n_outstanding += 1
            try:
                kind, payload = queue.get(timeout=30.0)
            except pyqueue.Empty:
                # liveness check: a child that hard-crashed (segfault/OOM/
                # os._exit) never enqueues and would hang this get() forever;
                # reap it and charge an error instead
                for p in list(running):
                    if not p.is_alive():
                        p.join()
                        running.remove(p)
                        if p.exitcode != 0:
                            errors.append(f"eval worker (pid {p.pid}) died "
                                          f"with exitcode {p.exitcode}")
                            n_outstanding -= 1
                continue
            n_outstanding -= 1
            if kind == "err":
                errors.append(payload)
            else:
                writer.write(payload)
                results.append(payload)
        # a worker that reported and THEN died nonzero can double-decrement;
        # drain any rows its message left behind before judging errors
        while not queue.empty():
            kind, payload = queue.get_nowait()
            if kind == "err":
                errors.append(payload)
            else:
                writer.write(payload)
                results.append(payload)
        for p in running:
            p.join()
        if errors:
            raise RuntimeError("parallel eval worker(s) failed: "
                               + "; ".join(errors))
        return sorted(results, key=lambda r: r["step"])

    def sweep_stabilizing(self, acting_step: int,
                          stabilizing_weightsdir: str) -> List[Dict[str, float]]:
        """Dual-policy selection: fix the (best) acting checkpoint and sweep every
        stabilizing checkpoint independently (eval.py:206-241's best-acting x
        sweep-stabilizing protocol). Rows carry both step ids."""
        self._agent.build(training=False)
        if self._left_arm_agent is None:
            raise ValueError("sweep_stabilizing needs a left_arm_agent")
        self._left_arm_agent.build(training=False)
        self._env.launch()
        sweep_csv = os.path.join(self._logdir, "stabilizing_sweep.csv")
        # resume: skip left steps already scored for THIS acting step
        done = set()
        if os.path.exists(sweep_csv):
            with open(sweep_csv) as f:
                done = {int(float(r["left_step"])) for r in csv.DictReader(f)
                        if r.get("left_step")
                        and int(float(r["step"])) == acting_step}
        writer = CsvWriter(sweep_csv)
        results = []
        try:
            self._agent.load_weights(
                os.path.join(self._weightsdir, str(acting_step)))
            for left_step in existing_weight_steps(stabilizing_weightsdir):
                if left_step in done:
                    continue
                self._left_arm_agent.load_weights(
                    os.path.join(stabilizing_weightsdir, str(left_step)))
                row: Dict[str, float] = {"step": acting_step,
                                         "left_step": left_step,
                                         **self._score_episodes()}
                writer.write(row)
                results.append(row)
        finally:
            self._env.shutdown()
        return results
