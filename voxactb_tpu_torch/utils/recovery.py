"""Failure detection and recovery helpers.

The reference's resilience is ad-hoc but real (SURVEY §5): sim-crash recovery
restarts CoppeliaSim and reloads the task (custom_rlbench_env_two_robots.py:328-368),
LLM calls retry with sleep (LMP.py:100-105), infeasible episode placement retries
(scene_two_robots.py:152-280), SE(3) augmentation raises after bounded attempts.
This module centralizes those policies.

A copy of ``voxactb_tpu.utils.recovery``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Tuple, Type

from voxactb_tpu_torch.envs.base import BimanualEnv, Transition


def retry(fn: Callable, attempts: int = 3, delay: float = 5.0,
          exceptions: Tuple[Type[BaseException], ...] = (Exception,),
          on_retry: Optional[Callable[[int, BaseException], None]] = None):
    """Bounded retry with sleep — the LMP.py:100-105 / rlbench_env.py:662-667 policy."""
    last = None
    for attempt in range(attempts):
        try:
            return fn()
        except exceptions as e:  # noqa: BLE001 — policy is caller-chosen
            last = e
            if on_retry:
                on_retry(attempt, e)
            logging.warning("attempt %d/%d failed: %s", attempt + 1, attempts, e)
            if attempt < attempts - 1:
                time.sleep(delay)
    raise last


class RecoveringEnv(BimanualEnv):
    """Env wrapper that relaunches the underlying env when reset/step crash.

    The reset path mirrors ``reset_to_demo_voxposer``'s catch -> restart sim ->
    reload task flow (custom_rlbench_env_two_robots.py:328-368); ``env_factory``
    rebuilds a fresh env (the "restart CoppeliaSim" step).
    """

    def __init__(self, env_factory: Callable[[], BimanualEnv],
                 max_restarts: int = 3, retry_delay: float = 1.0):
        self._factory = env_factory
        self._env = env_factory()
        self._max_restarts = max_restarts
        self._retry_delay = retry_delay
        self.restarts = 0

    def _restart(self) -> None:
        self.restarts += 1
        if self.restarts > self._max_restarts:
            raise RuntimeError(
                f"env restarted {self.restarts - 1} times; giving up")
        logging.warning("restarting environment (restart #%d)", self.restarts)
        try:
            self._env.shutdown()
        except Exception:  # noqa: BLE001 — dying env may throw anything
            pass
        time.sleep(self._retry_delay)
        self._env = self._factory()
        self._env.launch()

    def launch(self) -> None:
        self._env.launch()

    def shutdown(self) -> None:
        self._env.shutdown()

    def reset(self):
        for _ in range(self._max_restarts + 1):
            try:
                out = self._env.reset()
                # the restart budget is PER INCIDENT (the reference restarts
                # the sim as often as needed across a run,
                # custom_rlbench_env_two_robots.py:328-368) — a success
                # re-arms it
                self.restarts = 0
                return out
            except Exception:  # noqa: BLE001
                self._restart()
        raise RuntimeError("unreachable")

    def reset_to_demo(self, i: int):
        for _ in range(self._max_restarts + 1):
            try:
                out = self._env.reset_to_demo(i)
                self.restarts = 0
                return out
            except Exception:  # noqa: BLE001
                self._restart()
        raise RuntimeError("unreachable")

    def step(self, action, which_arm: str) -> Transition:
        try:
            return self._env.step(action, which_arm)
        except Exception as e:  # noqa: BLE001
            # a crashed step ends the episode; the runner resets (and we restart)
            logging.warning("env.step crashed (%s); ending episode", e)
            self._restart()
            # self.reset() (not self._env.reset()): the fresh env's first
            # reset can itself fail and must go through the retry path too
            return Transition(self.reset(), 0.0, True,
                              info={"needs_reset": True, "env_crash": True})

    # passthroughs -------------------------------------------------------------

    def target_object_world_coords(self):
        return self._env.target_object_world_coords()

    def auto_crop_radius(self):
        return self._env.auto_crop_radius()

    def dominant_arm(self):
        return self._env.dominant_arm()

    @property
    def task_name(self):
        # without this passthrough the base-class default '' masks the task
        # identity and task-keyed rollout heuristics (e.g. the OpenJar gripper
        # switch, rollout.py) silently disable
        return getattr(self._env, "task_name", "")

    @property
    def env_language_goal(self):
        return self._env.env_language_goal

    @property
    def episode_length(self):
        return self._env.episode_length
