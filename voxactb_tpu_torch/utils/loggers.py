"""Metric logging: append-only CSVs with backfill + optional TensorBoard.

Counterpart of YARR's ``LogWriter`` (yarr/utils/log_writer.py:13-124: tensorboard +
train/env CSVs whose field set can grow over time — missing keys backfill empty) and
``SimpleAccumulator`` (yarr/utils/stat_accumulator.py:129: per-env return/length stats).
"""

from __future__ import annotations

import csv
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from voxactb_tpu_torch.agents.base import ScalarSummary, Summary


class CsvWriter:
    """Append rows whose key set may grow; older rows backfill empty columns."""

    def __init__(self, path: str):
        self._path = path
        self._fieldnames: List[str] = []
        self._rows: List[Dict] = []
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # resume: adopt an existing file's rows + header so the first write
        # after a restart appends (or rewrites WITH the old rows) instead of
        # truncating — the 'missing' eval sweep and train resume depend on
        # previously scored rows surviving (peract/eval.py:148-152)
        if os.path.exists(path) and os.path.getsize(path) > 0:
            try:
                with open(path, newline="") as f:
                    r = csv.DictReader(f)
                    self._fieldnames = list(r.fieldnames or [])
                    self._rows = [dict(row) for row in r]
            except Exception:
                self._fieldnames, self._rows = [], []

    def write(self, row: Dict) -> None:
        with self._lock:
            new_fields = [k for k in row if k not in self._fieldnames]
            self._rows.append(dict(row))
            if new_fields:
                self._fieldnames.extend(new_fields)
                self._rewrite()
            else:
                write_header = not os.path.exists(self._path) or \
                    os.path.getsize(self._path) == 0
                with open(self._path, "a", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=self._fieldnames)
                    if write_header:
                        w.writeheader()
                    w.writerow({k: row.get(k, "") for k in self._fieldnames})

    def truncate_from(self, step: int) -> None:
        """Drop rows with ``step`` >= the given step and rewrite the file.

        Called on train resume: the run restarts from the last checkpoint, so
        rows logged AFTER that checkpoint belong to the interrupted leg and
        would otherwise duplicate once the resumed run re-logs them (the
        reference's append-only LogWriter has this artifact-mixing flaw on
        resume; yarr/utils/log_writer.py:75-124)."""
        with self._lock:
            kept = []
            for r in self._rows:
                try:
                    if float(r.get("step", -1)) >= step:
                        continue
                except (TypeError, ValueError):
                    pass
                kept.append(r)
            if len(kept) != len(self._rows):
                self._rows = kept
                self._rewrite()

    def _rewrite(self) -> None:
        with open(self._path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames)
            w.writeheader()
            for r in self._rows:
                w.writerow({k: r.get(k, "") for k in self._fieldnames})


class LogWriter:
    """train/env metric sink: CSV always; TensorBoard and wandb when available
    (the reference's optional wandb path, train.py:75-89)."""

    def __init__(self, logdir: str, tensorboard_logging: bool = True,
                 csv_logging: bool = True, wandb_run=None):
        self._logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._csv = CsvWriter(os.path.join(logdir, "train_data.csv")) \
            if csv_logging else None
        self._env_csv = CsvWriter(os.path.join(logdir, "env_data.csv")) \
            if csv_logging else None
        self._wandb = wandb_run
        self._tb = None
        if tensorboard_logging:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except Exception:
                self._tb = None

    def add_scalar(self, step: int, name: str, value) -> None:
        if self._tb is not None:
            self._tb.add_scalar(name, float(value), step)
        if self._wandb is not None:
            self._wandb.log({name: float(value)}, step=step)

    def add_summaries(self, step: int, summaries: List[Summary],
                      env: bool = False) -> None:
        row = {"step": step}
        for s in summaries:
            if isinstance(s, ScalarSummary) or np.isscalar(s.value) or (
                hasattr(s.value, "ndim") and getattr(s.value, "ndim", 1) == 0
            ):
                try:
                    v = float(np.asarray(s.value))
                except (TypeError, ValueError):
                    continue
                row[s.name] = v
                self.add_scalar(step, s.name, v)
        sink = self._env_csv if env else self._csv
        if sink is not None and len(row) > 1:
            sink.write(row)

    def truncate_from(self, step: int) -> None:
        """Drop CSV rows at/after ``step`` (see ``CsvWriter.truncate_from``)."""
        for sink in (self._csv, self._env_csv):
            if sink is not None:
                sink.truncate_from(step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


class StatAccumulator:
    """Episode return/length accumulation for eval envs
    (yarr/utils/stat_accumulator.py:62-146)."""

    def __init__(self):
        self._returns: List[float] = []
        self._lengths: List[int] = []
        self._lock = threading.Lock()

    def step_episode(self, total_reward: float, length: int) -> None:
        with self._lock:
            self._returns.append(float(total_reward))
            self._lengths.append(int(length))

    def pop(self) -> List[Summary]:
        with self._lock:
            if not self._returns:
                return []
            out = [
                ScalarSummary("eval_envs/return", float(np.mean(self._returns))),
                ScalarSummary("eval_envs/length", float(np.mean(self._lengths))),
                ScalarSummary("eval_envs/episodes", float(len(self._returns))),
            ]
            self._returns.clear()
            self._lengths.clear()
            return out

    def peak(self) -> Optional[float]:
        with self._lock:
            return float(np.mean(self._returns)) if self._returns else None
