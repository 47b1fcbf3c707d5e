#!/usr/bin/env python3
"""Train and score one protocol task to the end on one NVIDIA GPU, the way the
JAX package's round-5 table was made, and write where its time went.

    python3 protocol_done.py [--iters 6000] [--save-freq 2000] [--episodes 25]
        [--kernels] [--probes] [--out build/protocol_done]
        [--json chiprun_out/protocol_done.json]

It runs ``voxactb_tpu_torch.tools.run_protocol_eval.main`` on open_jar with
10 demos and ``--extra`` the overrides that make the run's config equal to
``eval_artifacts/open_jar/train_dominant/open_jar/PERACT_BC/seed0/config.json``
(the wrist pair of cameras at 32^2; everything else is ``COMMON``: f32, no
kernel flags), through its three stages: the 'missing' sweep on the val seed,
the stabilizing sweep, 'best' on the test seed. Around it, it times each
stage, every train step (synchronised: the median step is the card's), every
act, sim step, demo and checkpoint save and load, and writes them with the
summary and the card's name and power limit to ``--json``, and the run's CSVs
into the directory of that name without ``.json`` plus ``_csv``. The tool resumes
policies already trained to their last step and CSV rows already scored, so
a cut run can be continued from its ``--out``. A run of 50 iterations
(``--iters 50 --save-freq 25 --episodes 2``) sizes the whole.

``--kernels`` runs the same model on the kernel path: ``compute_dtype``
bfloat16 with ``pallas_front``, ``pallas_attention``, ``pallas_decoder`` and
``pallas_attention_train`` (round 5's heads of 32 go through the attention
kernels zero-padded to 64), into ``build/protocol_done_kernels`` and
``chiprun_out/protocol_done_kernels.json`` unless ``--out`` / ``--json`` say
otherwise; the record then holds the kernels' launch counts. Every record
holds the run's TF32 setting (torch's defaults; nothing here changes them).
``--probes`` then runs the diagnosis probes on the run's checkpoints, which
stay on the machine: ``probe_replay_accuracy`` on the acting and the
stabilizing policy at the first saved step after 0 and the last, and
``probe_policy_open_loop`` with and without ``--live`` on the tested pair;
their records go into the JSON under ``probes``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TASK = "open_jar"
DEMOS = 10
KERNEL_EXTRA = ["method.compute_dtype=bfloat16", "method.pallas_front=True",
                "method.pallas_attention=True", "method.pallas_decoder=True",
                "method.pallas_attention_train=True"]
OPEN_LOOP_EPISODES = 3


def round5_extra(task: str):
    """The overrides beyond ``COMMON`` that round 5's config snapshot holds."""
    with open(os.path.join(HERE, "eval_artifacts", task, "train_dominant", task,
                           "PERACT_BC", "seed0", "config.json")) as f:
        rl = json.load(f)["rlbench"]
    return [f"rlbench.cameras={json.dumps(rl['cameras'])}",
            f"rlbench.camera_resolution={json.dumps(rl['camera_resolution'])}"]


@contextlib.contextmanager
def wrapped(owner, attr, wrap):
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def timed(sink, sync=False):
    import torch

    def wrap(fn):
        def call(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            sink.append(time.perf_counter() - t0)
            return out
        return call
    return wrap


def stats(seconds):
    return dict(count=len(seconds), sum_s=sum(seconds),
                median_ms=statistics.median(seconds) * 1e3 if seconds else None)


def run_probes(summary: dict, acting_dir: str, iters: int, save_freq: int,
               device=None) -> dict:
    """The diagnosis probes on the run's checkpoints: replay accuracy of each
    policy at the first saved step after 0 and the last, and the open-loop
    probe with and without ``--live`` on the tested pair (on ``device``: the
    card unless another is named)."""
    from voxactb_tpu_torch.cli.train import build_replay_and_agent
    from voxactb_tpu_torch.tools import probe_policy_open_loop, probe_replay_accuracy

    stab_dir = acting_dir.replace("train_dominant", "train_assistive")
    steps = sorted({min(save_freq, iters - 1), iters - 1})
    out = {"replay_accuracy": {}, "open_loop": {}}
    for arm, seed_dir in (("dominant", acting_dir), ("assistive", stab_dir)):
        replay = None
        for step in steps:
            t0 = time.perf_counter()
            agent, cfg = probe_policy_open_loop.load_agent(seed_dir, step, arm, device)
            if replay is None:
                replay, _ = build_replay_and_agent(cfg, device=device)
            rec = probe_replay_accuracy.replay_accuracy(agent, cfg, replay, task=TASK)
            rec["seconds"] = time.perf_counter() - t0
            out["replay_accuracy"][f"{arm}_{step}"] = rec
            print(json.dumps({"replay_accuracy": {"arm": arm, "step": step, **rec}}),
                  flush=True)
            del agent
    acting_step = int(summary["test"][0]["step"])
    stab_step = int(summary.get("stab_sweep", {}).get("best_left_step", iters - 1))
    for live in (False, True):
        argv = ["--task", TASK, "--acting-dir", acting_dir, "--stab-dir", stab_dir,
                "--ckpt-step", str(acting_step), "--stab-step", str(stab_step),
                "--episodes", str(OPEN_LOOP_EPISODES)] + (["--live"] if live else [])
        t0 = time.perf_counter()
        rec = probe_policy_open_loop.main(argv, device=device)
        out["open_loop"]["live" if live else "open_loop"] = dict(
            pair=[acting_step, stab_step], summary=rec["summary"],
            episodes=rec["episodes"], seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=6000)
    ap.add_argument("--save-freq", type=int, default=2000)
    ap.add_argument("--episodes", type=int, default=25)
    ap.add_argument("--kernels", action="store_true",
                    help="bf16 with the four kernel flags (the kernel path)")
    ap.add_argument("--probes", action="store_true",
                    help="run the diagnosis probes on the checkpoints afterwards")
    ap.add_argument("--out", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    name = "protocol_done_kernels" if args.kernels else "protocol_done"
    args.out = args.out or os.path.join("build", name)
    args.json = args.json or os.path.join("chiprun_out", f"{name}.json")

    import torch

    if not torch.cuda.is_available():
        print("protocol_done: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.tools import run_protocol_eval as tool

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    extra = round5_extra(TASK) + (KERNEL_EXTRA if args.kernels else [])
    tf32 = dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                cudnn=torch.backends.cudnn.allow_tf32)
    argv = ["--tasks", TASK, "--iters", str(args.iters),
            "--save-freq", str(args.save_freq), "--demos", str(DEMOS),
            "--episodes", str(args.episodes), "--out", args.out, "--extra", *extra]
    print(f"[protocol_done] {card}; TF32 {tf32}; run_protocol_eval {' '.join(argv)}",
          flush=True)
    sinks = {k: [] for k in ("train_step", "act", "sim_step", "demo", "save", "load",
                             "train_dominant", "train_assistive", "stage1_val",
                             "stage2_stab_sweep", "stage3_test")}
    stage_names = {("missing", "eval_data.csv"): "stage1_val",
                   ("best", "test_data.csv"): "stage3_test"}

    def train_stage(fn):
        def call(task, arm, *a, **kw):
            t0 = time.perf_counter()
            out = fn(task, arm, *a, **kw)
            sinks[f"train_{arm}"].append(time.perf_counter() - t0)
            return out
        return call

    def eval_stage(fn):
        def call(task, acting_dir, stab_ckpt, episodes, seed, eval_type, csv_name,
                 *a, **kw):
            t0 = time.perf_counter()
            out = fn(task, acting_dir, stab_ckpt, episodes, seed, eval_type, csv_name,
                     *a, **kw)
            sinks[stage_names[(eval_type, csv_name)]].append(time.perf_counter() - t0)
            return out
        return call

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(tool, "train_policy", train_stage))
        stack.enter_context(wrapped(tool, "run_eval", eval_stage))
        stack.enter_context(wrapped(tool, "run_stab_sweep",
                                    timed(sinks["stage2_stab_sweep"])))
        stack.enter_context(wrapped(QAttentionBCAgent, "update",
                                    timed(sinks["train_step"], sync=True)))
        stack.enter_context(wrapped(QAttentionBCAgent, "act", timed(sinks["act"])))
        stack.enter_context(wrapped(QAttentionBCAgent, "save_weights",
                                    timed(sinks["save"])))
        stack.enter_context(wrapped(QAttentionBCAgent, "load_weights",
                                    timed(sinks["load"])))
        stack.enter_context(wrapped(BimanualTaskEnvironment, "get_demo",
                                    timed(sinks["demo"])))
        stack.enter_context(wrapped(BimanualTaskEnvironment, "step",
                                    timed(sinks["sim_step"])))
        summary = tool.main(argv)
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    # the first step of each policy builds its optimizer state
    steps = sinks["train_step"]
    record = dict(card=card, argv=argv, kernels=args.kernels, tf32=tf32,
                  launches={k: v for k, v in launches.items() if v},
                  wall_s=wall_s, summary=summary.get(TASK),
                  stages_s={k: sum(sinks[k]) for k in (
                      "train_dominant", "train_assistive", "stage1_val",
                      "stage2_stab_sweep", "stage3_test")},
                  train_step_median_ms_after_first=(
                      statistics.median(steps[1:]) * 1e3 if len(steps) > 1 else None),
                  **{k: stats(v) for k, v in sinks.items()
                     if k in ("train_step", "act", "sim_step", "demo", "save", "load")})
    # the run's CSVs (train losses, every eval row) beside the record
    csv_dir = os.path.splitext(args.json)[0] + "_csv"
    os.makedirs(csv_dir, exist_ok=True)
    acting_dir = summary[TASK]["acting_dir"]
    for arm_dir in (acting_dir, acting_dir.replace("train_dominant", "train_assistive")):
        arm = "dominant" if arm_dir == acting_dir else "assistive"
        for path in glob.glob(os.path.join(arm_dir, "*.csv")):
            shutil.copy(path, os.path.join(csv_dir, f"{arm}_{os.path.basename(path)}"))
    if args.probes:
        t1 = time.perf_counter()
        record["probes"] = run_probes(summary[TASK], acting_dir, args.iters, args.save_freq)
        record["probes_s"] = time.perf_counter() - t1
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k not in ("summary", "probes")}),
          flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
