"""Online environment runner: background rollout collection into replay.

Counterpart of YARR's legacy online-RL harness (yarr/runners/env_runner.py /
_env_runner.py + PyTorchTrainRunner:305 — present in the reference but unused by
VoxAct-B's offline BC). Collector threads roll episodes with the current agent
weights and push transitions into the (thread-safe) replay buffer while a train loop
consumes them; weight refresh is a simple params swap.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

import numpy as np

from voxactb_tpu_torch.agents.base import Agent
from voxactb_tpu_torch.runners.rollout import RolloutGenerator
from voxactb_tpu_torch.utils.loggers import StatAccumulator


class EnvRunner:
    def __init__(
        self,
        env_factory: Callable,
        agent: Agent,
        replay_buffer,
        num_envs: int = 1,
        episodes: Optional[int] = None,      # None = run until stop()
        episode_length: int = 25,
        which_arm: str = "right",
        crop_target_obj_voxel: bool = False,
        stat_accumulator: Optional[StatAccumulator] = None,
        left_arm_agent: Optional[Agent] = None,
    ):
        self._env_factory = env_factory
        self._agent = agent
        self._left_arm_agent = left_arm_agent
        self._replay = replay_buffer
        self._num_envs = num_envs
        self._episodes = episodes
        self._episode_length = episode_length
        self._which_arm = which_arm
        self._crop = crop_target_obj_voxel
        self._stats = stat_accumulator or StatAccumulator()
        self._stop = threading.Event()
        self._threads = []
        self.total_transitions = 0
        self.total_episodes = 0
        self._lock = threading.Lock()
        self._errors = []

    def _worker(self, worker_id: int) -> None:
        try:
            self._worker_inner(worker_id)
        except Exception as e:  # noqa: BLE001 — surfaced on join()
            logging.exception("env worker %d died", worker_id)
            self._errors.append(e)

    def _worker_inner(self, worker_id: int) -> None:
        env = self._env_factory()
        env.launch()
        gen = RolloutGenerator()
        ep = 0
        try:
            while not self._stop.is_set():
                if self._episodes is not None and ep >= self._episodes:
                    return
                reward, length, completed = 0.0, 0, True
                for rt in gen.generator(
                    env, self._agent, self._episode_length, eval=False,
                    left_arm_agent=self._left_arm_agent,
                    which_arm=self._which_arm,
                    crop_target_obj_voxel=self._crop,
                ):
                    transition = dict(rt.observation)
                    transition.update(
                        reward=rt.reward, terminal=rt.terminal,
                        timeout=rt.timeout, demo=False,
                    )
                    self._replay.add(self._strip(transition))
                    reward += rt.reward
                    length += 1
                    if self._stop.is_set():
                        completed = rt.terminal  # cut mid-episode?
                        break
                with self._lock:
                    self.total_transitions += length
                    if completed:
                        self.total_episodes += 1
                if completed:
                    # a partial episode cut by stop() must not bias the
                    # return/length statistics downward
                    self._stats.step_episode(reward, length)
                ep += 1
        finally:
            env.shutdown()

    def _strip(self, transition: dict) -> dict:
        """Drop non-array entries, squeeze env batch dims, fit signature widths.

        Envs may carry wider proprio vectors than a given arm-mode's replay spec
        (extra time/arm-id channels) — trailing channels are trimmed to the spec.
        """
        signature = getattr(self._replay, "_signature", {})
        out = {}
        for k, v in transition.items():
            if isinstance(v, str):
                continue
            a = np.asarray(v)
            if a.dtype == object:
                continue
            if a.ndim > 1 and a.shape[0] == 1:
                a = a[0]
            spec = signature.get(k)
            if spec is not None and spec.shape and a.ndim == len(spec.shape):
                if a.shape != tuple(spec.shape) and all(
                    x >= y for x, y in zip(a.shape, spec.shape)
                ):
                    a = a[tuple(slice(0, y) for y in spec.shape)]
            out[k] = a
        return out

    def start(self, background: bool = True) -> None:
        for i in range(self._num_envs):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)
        if not background:
            self.join()

    def join(self, timeout: Optional[float] = None) -> None:
        for t in self._threads:
            t.join(timeout)
        if self._errors:
            raise RuntimeError("env worker failed") from self._errors[0]

    def stop(self) -> None:
        self._stop.set()
        self.join(timeout=5.0)

    def summaries(self):
        return self._stats.pop()
