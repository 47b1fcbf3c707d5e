"""Offline BC training loop with resume, checkpoint rotation, and CSV/TB logging.

Counterpart of YARR's ``OfflineTrainRunner`` (yarr/runners/offline_train_runner.py:28-172):
resume from the newest weight dir (:112-122), iterate (sample -> update -> log,
:130-163), save weights every ``save_freq`` with rotation keeping
``num_weights_to_keep`` (:81-90). Differences: batches arrive through a background
PrefetchIterator (host-to-device copies overlapped with compute) instead of torch DataLoader
workers, and there is no per-iteration host sync — loss fetches happen only at log
steps.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import time
from typing import Dict, Iterable

from voxactb_tpu_torch.agents.base import Agent, ScalarSummary
from voxactb_tpu_torch.utils.loggers import LogWriter


def interval_scalars(spans, steps: int, wall_s: float) -> Dict[str, float]:
    """What a log interval of ``steps`` steps did: its wall seconds per step
    between the two log points' syncs, and from its collection of spans the
    update's and the feed's host milliseconds per step and the feed's
    stalls."""
    return {"time/step_s": wall_s / steps,
            "time/update_ms": 1e3 * spans.seconds("vx.update") / steps,
            "time/feed_next_ms": 1e3 * spans.seconds("vx.feed.next") / steps,
            "feed/stalls": float(spans.counts.get("feed.stalls", 0))}


class OfflineTrainRunner:
    def __init__(
        self,
        agent: Agent,
        dataset: Iterable,
        logdir: str,
        weightsdir: str,
        training_iterations: int = 1_000_000,
        save_freq: int = 10_000,
        log_freq: int = 100,
        num_weights_to_keep: int = 60,
        tensorboard_logging: bool = True,
        csv_logging: bool = True,
        load_existing_weights: bool = True,
    ):
        self._agent = agent
        self._dataset = dataset
        self._logdir = logdir
        self._weightsdir = weightsdir
        self._training_iterations = training_iterations
        self._save_freq = save_freq
        self._log_freq = log_freq
        self._num_weights_to_keep = num_weights_to_keep
        self._load_existing_weights = load_existing_weights
        self._writer = LogWriter(logdir, tensorboard_logging, csv_logging)

    # -- checkpoints ------------------------------------------------------------------

    def _existing_weight_steps(self):
        from voxactb_tpu_torch.runners.eval_runner import existing_weight_steps

        if self._weightsdir is None:  # log-only run (weights never saved)
            return []
        return existing_weight_steps(self._weightsdir)

    def _save_model(self, step: int) -> None:
        d = os.path.join(self._weightsdir, str(step))
        os.makedirs(d, exist_ok=True)
        self._agent.save_weights(d)
        # rotation (offline_train_runner.py:81-90)
        steps = self._existing_weight_steps()
        while len(steps) > self._num_weights_to_keep:
            victim = steps.pop(0)
            shutil.rmtree(os.path.join(self._weightsdir, str(victim)),
                          ignore_errors=True)

    def resume_step(self) -> int:
        """Latest saved step, loading its weights (offline_train_runner.py:112-122)."""
        steps = self._existing_weight_steps()
        if not self._load_existing_weights or not steps:
            return 0
        latest = steps[-1]
        self._agent.load_weights(os.path.join(self._weightsdir, str(latest)))
        logging.info("resuming from weights at step %d", latest)
        return latest + 1

    # -- the loop ---------------------------------------------------------------------

    def start(self) -> None:
        self._agent.build(training=True)
        start = self.resume_step()
        if start >= self._training_iterations:
            logging.info("already trained to %d; nothing to do", start)
            return
        if start > 0:
            # rows logged past the checkpoint belong to the interrupted leg —
            # drop them so the CSV holds exactly one run's trajectory
            self._writer.truncate_from(start)

        from voxactb_tpu_torch.utils.profiling import collect, host_gauges

        data_iter = iter(self._dataset)
        mark = None  # (step, time) at the last log point's sync
        with contextlib.ExitStack() as interval:
            spans = interval.enter_context(collect())
            for i in range(start, self._training_iterations):
                batch = next(data_iter)
                result = self._agent.update(i, batch)

                if i % self._log_freq == 0:
                    # a 0-dim tensor on the device: float() syncs and copies it
                    loss = float(result["total_loss"])
                    now = time.perf_counter()
                    scalars = host_gauges()
                    if mark is not None:
                        scalars.update(interval_scalars(spans, i - mark[0], now - mark[1]))
                    logging.info("train step %d | loss %.4f | step %.3fs", i, loss,
                                 scalars.get("time/step_s", float("nan")))
                    self._writer.add_summaries(i, self._agent.update_summaries() + [
                        ScalarSummary(f"train/{k}", v) for k, v in scalars.items()])
                    mark = (i, now)
                    interval.close()
                    spans = interval.enter_context(collect())

                if self._save_freq > 0 and i % self._save_freq == 0 and \
                        self._weightsdir is not None:
                    self._save_model(i)

        if self._weightsdir is not None:
            self._save_model(self._training_iterations - 1)
        self._writer.close()
