"""BASELINE staged config #5 at protocol scale: train acting+stabilizing policies
on scripted demos for the four benchmark tasks, then run the reference's full
checkpoint-selection protocol — 'missing' sweep on the validation seed (43),
the stabilizing-checkpoint sweep, 'best' on the test seed (88), 25 episodes
each — and leave eval_data.csv / test_data.csv artifacts per task under
``--out`` (peract/eval.py:144-241, conf/eval.yaml). Counterpart of
``tools/run_protocol_eval.py``.

Run:  python3 -m voxactb_tpu_torch.tools.run_protocol_eval --out build/protocol \\
          [--device cuda] [--quick] [--extra key=value ...]

The agents train and act on one CUDA device unless ``--device`` names another
(``--device cpu`` runs the plain PyTorch versions); without CUDA and without
``--device`` the tool raises. Checkpoints are the ``.pt`` files ``cli.train``
writes, or a JAX run's ``.msgpack`` ones. ``summary.json`` and the CSVs go under ``--out`` only.

The model is a small-but-structured config: voxel 50^3 with the VoxAct-B VLM
crop (radius 0.3 -> 1.2 cm voxels — the reference operating point, and the
precision the backend's 40-degree approach cone demands; see
``oracle_protocol_check``), latents 64, depth 2, f32 and no kernel flags.
Training is real BC from scripted bimanual demos through the replay pipeline;
eval runs the dominant_assistive rollout branch with the VLM crop and the
stricter round-3 grasp model. ``--extra`` overrides are applied after
``COMMON``; the kernels run only where they set ``method.compute_dtype=bfloat16``,
the ``pallas_*`` flags and head dims of 64.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time

TASKS = ["open_jar", "open_drawer", "put_item_in_drawer", "hand_over_item"]
CKPT_SUFFIXES = (".pt", ".msgpack")  # the port's, and a JAX run's

COMMON = [
    "rlbench.demo_path=sim",
    # front + both wrist cameras, like the reference's policy rig
    # (observation_config_two_robots.py wrist/wrist2/front). Round-4
    # diagnosis (tools/probe_replay_ambiguity.py): with the 32x32 wrist-only
    # rig, crop-grid coverage had a median of 103 points (min 1) and
    # successive keyframe inputs were indistinguishable (d_occ <= 2), so the
    # replay itself was unlearnable — hand_over_item exact-match on its OWN
    # replay capped at 55% trans / 94% grip and every rollout scored 0.
    'rlbench.cameras=["front","wrist","wrist2"]',
    "rlbench.camera_resolution=[64,64]",
    # 25 steps (the reference's episode_length): strict assistive/dominant
    # alternation skips turns once one arm's keyframes run out, so an episode
    # needs ~2x the longest arm's keyframe count in slots
    "rlbench.episode_length=25",
    # voxel 50 IS the VoxAct-B operating point (50^3 crop at radius 0.3 ->
    # 1.2 cm voxels). oracle_protocol_check: discretized demo keyframes
    # score 1.00 on all four benchmark tasks at 50, but 0.00 at 20 (3 cm voxels
    # put discretized grasps outside the backend's 40-degree approach cone)
    "method.voxel_sizes=[50]",
    "method.num_latents=64",
    "method.latent_dim=64",
    "method.transformer_depth=2",
    "method.cross_dim_head=32",
    "method.latent_dim_head=32",
    "method.final_dim=16",
    "method.crop_target_obj_voxel=True",
    "method.crop_radius=0.3",
    "method.arm_pred_loss=True",
    # SE(3) augmentation OFF for the small-model artifact: at this capacity
    # (latents 64, depth 2) the +-0.125 m shifts keep trans CE at a ~7.4
    # plateau and every rollout scores 0.0; without it the same budget reaches
    # CE ~1 and 50% val success (calibrated on the JAX package, open_jar, 6k
    # iters). The full-scale model trains WITH aug like the reference
    # (PERACT_BC.yaml transform_augmentation) — flip via --extra.
    "method.apply_se3=False",
    # the no-duplicate keyframe scanner (demo_loading_utils.py:228): without it
    # the dominant-arm scanner emits 'arm idling at home' keyframes every
    # stop-buffer window while the assistive arm works; the policy learns them
    # faithfully and then wastes its alternation turns / locks its gripper
    # closed at eval (open_drawer scored 0.0 with padding keyframes, oracle
    # 1.00 either way)
    "method.keypoint_discovery_no_duplicate=True",
    "replay.batch_size=4",
]


def train_policy(task: str, arm: str, out_root: str, iters: int, demos: int,
                 save_freq: int, extra=(), device=None) -> str:
    """Train one policy through ``cli.train`` with ``COMMON``, then ``extra``,
    then the task's own overrides; returns its seed dir."""
    from voxactb_tpu_torch.cli import train

    # resume support: if a prior (interrupted) run already trained this policy
    # to the final step, reuse it instead of retraining — the reference's
    # train.py likewise exits when already trained past target
    # (peract/train.py:67-73); the 'missing' eval sweep then skips any steps
    # already present in eval_data.csv (peract/eval.py:148-152)
    prior = os.path.join(out_root, f"train_{arm}", task, "PERACT_BC", "seed0")
    final_w = os.path.join(prior, "weights", str(iters - 1))
    if os.path.isdir(final_w) and any(
            f.endswith(CKPT_SUFFIXES) for f in os.listdir(final_w)):
        print(f"[{task}/{arm}] already trained to {iters - 1} -> {prior} "
              f"(skipping train)", flush=True)
        return prior

    t0 = time.time()
    seed_dir = train.main(COMMON + list(extra) + [
        f"rlbench.task_name={task}", f'rlbench.tasks=["{task}"]',
        f"rlbench.demos={demos}",
        f"method.which_arm={arm}",
        f"framework.training_iterations={iters}",
        f"framework.save_freq={save_freq}",
        "framework.log_freq=100",
        f"log_dir={out_root}/train_{arm}",
    ], device=device)
    print(f"[{task}/{arm}] trained {iters} iters in {time.time()-t0:.0f}s "
          f"-> {seed_dir}", flush=True)
    return seed_dir


def ckpt_file(seed_dir: str, step: int = None) -> str:
    """Path of the checkpoint at ``step`` (default: newest): the port's
    ``.pt`` or a JAX run's ``.msgpack``."""
    from voxactb_tpu_torch.runners.eval_runner import existing_weight_steps

    wd = os.path.join(seed_dir, "weights")
    steps = existing_weight_steps(wd)
    if not steps:
        raise FileNotFoundError(f"no saved weight steps under {wd} — "
                                "was the training leg interrupted before "
                                "its first save?")
    step = steps[-1] if step is None else step
    final = os.path.join(wd, str(step))
    files = sorted(f for f in os.listdir(final) if f.endswith(CKPT_SUFFIXES))
    if not files:
        raise FileNotFoundError(f"no checkpoint ({' or '.join(CKPT_SUFFIXES)}) in {final}")
    pt = [f for f in files if f.endswith(".pt")]
    return os.path.join(final, (pt or files)[0])


def make_runner(task: str, acting_dir: str, stab_ckpt, episodes: int,
                seed: int, csv_name: str = "eval_data.csv",
                selection_csv: str = None, crop_source: str = "gt",
                device=None):
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.config import Config
    from voxactb_tpu_torch.runners.eval_runner import EvalRunner
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

    cfg = Config.load(os.path.join(acting_dir, "config.json"))
    vlm = None
    if crop_source == "vlm":
        # pixels-derived crops: the reference's eval path runs the VLM on the
        # rendered front camera once per episode (scene_two_robots.py:494,
        # vlm.py:144-194); the detector here is the renderer-appropriate
        # color segmenter (vlm/pipeline.py ColorDetector) — no ground-truth
        # object position is consulted anywhere in the crop path
        from voxactb_tpu_torch.vlm.pipeline import VLM, ColorDetector
        vlm = VLM(ColorDetector(task))
    env = BimanualTaskEnvironment(
        TASK_REGISTRY[task], cameras=cfg.rlbench.cameras,
        image_size=cfg.rlbench.camera_resolution[0],
        episode_length=cfg.rlbench.episode_length, seed=seed, vlm=vlm)
    acting = QAttentionBCAgent(cfg.method, cfg.rlbench.cameras,
                               cfg.rlbench.scene_bounds, device=device)
    stab = QAttentionBCAgent(cfg.method, cfg.rlbench.cameras,
                             cfg.rlbench.scene_bounds, device=device)
    return EvalRunner(
        env, acting, weightsdir=os.path.join(acting_dir, "weights"),
        logdir=acting_dir, left_arm_agent=stab, left_arm_ckpt=stab_ckpt,
        eval_episodes=episodes, episode_length=cfg.rlbench.episode_length,
        which_arm="dominant_assistive", crop_target_obj_voxel=True,
        crop_radius=0.3, csv_name=csv_name, selection_csv_name=selection_csv)


def run_eval(task: str, acting_dir: str, stab_ckpt: str, episodes: int,
             seed: int, eval_type, csv_name: str, selection_csv: str = None,
             crop_source: str = "gt", device=None):
    runner = make_runner(task, acting_dir, stab_ckpt, episodes, seed,
                         csv_name, selection_csv, crop_source=crop_source,
                         device=device)
    t0 = time.time()
    rows = runner.start(eval_type)
    print(f"[{task}] eval_type={eval_type} seed={seed} "
          f"{time.time()-t0:.0f}s -> {rows}", flush=True)
    return rows


def best_left_step(rows):
    """The stabilizing step of the best return; the reference keeps the LAST
    argmax on ties (eval.py:178). Returns ``(left_step, return)``."""
    best_left, best_ret = None, -float("inf")
    for r in rows:
        ret = float(r.get("eval_envs/return", "nan") or "nan")
        if ret >= best_ret:
            best_ret, best_left = ret, int(float(r["left_step"]))
    return best_left, best_ret


def run_stab_sweep(task: str, acting_dir: str, stab_dir: str, episodes: int,
                   seed: int, device=None):
    """Protocol stage 2 (peract/eval.py:206-241): fix the best acting
    checkpoint (from eval_data.csv) and sweep every stabilizing checkpoint.
    Returns (best_acting_step, sweep rows, best_left_step)."""
    from voxactb_tpu_torch.runners.eval_runner import select_checkpoints

    eval_csv = os.path.join(acting_dir, "eval_data.csv")
    best = select_checkpoints(os.path.join(acting_dir, "weights"), "best",
                              eval_csv)
    if not best:
        raise RuntimeError(f"[{task}] no best acting checkpoint selectable "
                           f"from {eval_csv}")
    runner = make_runner(task, acting_dir, None, episodes, seed, device=device)
    t0 = time.time()
    runner.sweep_stabilizing(best[0], os.path.join(stab_dir, "weights"))
    # merge resumed rows back in from the CSV (sweep skips already-scored)
    sweep_csv = os.path.join(acting_dir, "stabilizing_sweep.csv")
    with open(sweep_csv) as f:
        all_rows = [r for r in csv.DictReader(f)
                    if int(float(r["step"])) == best[0]]
    best_left, best_ret = best_left_step(all_rows)
    print(f"[{task}] stab sweep (acting={best[0]}) {time.time()-t0:.0f}s -> "
          f"best left={best_left} @ {best_ret}", flush=True)
    return best[0], all_rows, best_left


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/protocol_eval")
    ap.add_argument("--tasks", nargs="*", default=TASKS)
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--save-freq", type=int, default=500)
    ap.add_argument("--demos", type=int, default=10)
    ap.add_argument("--episodes", type=int, default=25)
    ap.add_argument("--val-seed", type=int, default=43)
    ap.add_argument("--test-seed", type=int, default=88)
    ap.add_argument("--device", default=None,
                    help="torch device of the agents (default: cuda, and the "
                         "tool raises without it)")
    ap.add_argument("--extra", nargs="*", default=[],
                    help="extra dotted config overrides appended to COMMON "
                         "(e.g. method.apply_se3=False)")
    ap.add_argument("--no-stab-sweep", action="store_true",
                    help="skip protocol stage 2 (stabilizing-checkpoint "
                         "sweep); the test eval then pairs the newest "
                         "stabilizing checkpoint with the best acting one")
    ap.add_argument("--quick", action="store_true",
                    help="calibration mode: 1 task, few iters/episodes")
    ap.add_argument("--vlm-eval", action="store_true",
                    help="re-evaluate EXISTING protocol artifacts with "
                         "pixels-derived VLM crops (ColorDetector on the "
                         "rendered front camera) instead of ground-truth "
                         "object positions, and record the success-rate "
                         "delta under <task>_vlmcrop in summary.json")
    args = ap.parse_args(argv)
    if args.quick:
        args.tasks = args.tasks[:1]
        args.iters, args.save_freq = 300, 150
        args.episodes = 3
    return args


def vlm_eval(args, summary, summary_path, device):
    for task in args.tasks:
        if task not in summary:
            print(f"[{task}] SKIP vlm eval: no protocol artifact in summary.json — "
                  "run the protocol first", flush=True)
            continue
        acting_dir = summary[task]["acting_dir"]
        stab_dir = acting_dir.replace("train_dominant", "train_assistive")
        best_left = (summary[task].get("stab_sweep") or {}).get(
            "best_left_step")
        try:
            stab_ckpt = ckpt_file(stab_dir, best_left)
        except FileNotFoundError as e:
            # an artifact may keep CSVs but not weights — a vlm re-eval
            # needs the trained checkpoints on disk
            print(f"[{task}] SKIP vlm eval: {e}", flush=True)
            continue
        rows_val = run_eval(task, acting_dir, stab_ckpt, args.episodes,
                            args.val_seed, "best", "eval_data_vlm.csv",
                            selection_csv="eval_data.csv",
                            crop_source="vlm", device=device)
        rows_test = run_eval(task, acting_dir, stab_ckpt, args.episodes,
                             args.test_seed, "best", "test_data_vlm.csv",
                             selection_csv="eval_data.csv",
                             crop_source="vlm", device=device)
        summary[f"{task}_vlmcrop"] = {
            "crop_source": "vlm",
            "detector": "ColorDetector(front-camera pixels)",
            "val": [{"step": r["step"],
                     "return": float(r["eval_envs/return"])}
                    for r in rows_val],
            "test": [{"step": r["step"],
                      "return": float(r["eval_envs/return"])}
                     for r in rows_test],
            "gt_val": summary[task]["val"],
            "gt_test": summary[task]["test"],
            "acting_dir": acting_dir,
        }
        with open(summary_path, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k.endswith("_vlmcrop")}, indent=1))
    return summary


def main(argv=None, device=None) -> dict:
    """Run the protocol (or, with ``--vlm-eval``, its VLM-crop re-evaluation)
    and return the summary. ``device`` overrides ``--device``."""
    from voxactb_tpu_torch.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    extra = list(args.extra)

    # merge into an existing summary so a restart with --tasks <subset>
    # keeps already-finished tasks' rows
    os.makedirs(args.out, exist_ok=True)
    summary_path = os.path.join(args.out, "summary.json")
    summary = {}
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            summary = json.load(f)

    if args.vlm_eval:
        return vlm_eval(args, summary, summary_path, device)

    for task in args.tasks:
        root = os.path.join(args.out, task)
        os.makedirs(root, exist_ok=True)
        acting_dir = train_policy(task, "dominant", root, args.iters,
                                  args.demos, args.save_freq, extra, device)
        stab_dir = train_policy(task, "assistive", root, args.iters,
                                args.demos, args.save_freq, extra, device)
        stab_ckpt = ckpt_file(stab_dir)  # newest; used during the acting sweep

        # stage 1: 'missing' sweep over acting checkpoints (val seed)
        run_eval(task, acting_dir, stab_ckpt, args.episodes, args.val_seed,
                 "missing", "eval_data.csv", device=device)

        # stage 2: stabilizing-checkpoint sweep with the best acting fixed
        # (peract/eval.py:206-241); the winner pairs into the test eval
        stab_sweep = None
        if not args.no_stab_sweep:
            best_acting, sweep_rows, best_left = run_stab_sweep(
                task, acting_dir, stab_dir, args.episodes, args.val_seed,
                device)
            stab_ckpt = ckpt_file(stab_dir, best_left)
            stab_sweep = {
                "acting_step": best_acting,
                "rows": [{"left_step": r["left_step"],
                          "return": float(r["eval_envs/return"])}
                         for r in sweep_rows],
                "best_left_step": best_left,
            }

        # stage 3: 'best' on the test seed with the selected pair
        test_rows = run_eval(task, acting_dir, stab_ckpt, args.episodes,
                             args.test_seed, "best", "test_data.csv",
                             selection_csv="eval_data.csv", device=device)
        with open(os.path.join(acting_dir, "eval_data.csv")) as f:
            val_rows = list(csv.DictReader(f))
        summary[task] = {
            "val": [{"step": r["step"],
                     "return": float(r["eval_envs/return"])}
                    for r in val_rows],
            "test": [{"step": r["step"], "return": float(r["eval_envs/return"])}
                     for r in test_rows],
            "acting_dir": acting_dir,
        }
        if stab_sweep is not None:
            summary[task]["stab_sweep"] = stab_sweep
        with open(summary_path, "w") as f:
            json.dump(summary, f, indent=1)

    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
