"""Exact-match accuracy of a trained policy ON ITS OWN REPLAY SAMPLES.

A train loss near 0 with open-loop keyframe errors (``probe_policy_open_loop``)
can mean two things: (a) the replay's targets are learned and the eval inputs
lie off the training manifold, or (b) the replay holds conflicting or
misaligned samples that the CE loss averages over. This rebuilds the replay
as ``cli/train.py`` does (same config, demos and keypoint scanner), runs the
policy's act program on every stored sample, and reports the exact-match
rates of the trans voxel index and the grip bit.

Counterpart of ``tools/probe_replay_accuracy.py``; the agent comes from
``probe_policy_open_loop.load_agent`` (the port's ``weights/<step>``).

Run:  python3 -m voxactb_tpu_torch.tools.probe_replay_accuracy --task open_jar \\
          --seed-dir <train_dominant/.../seed0> [--ckpt-step 5999] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def replay_accuracy(agent, cfg, replay, *, max_samples: int = 0, task: str = "") -> dict:
    """The policy ``agent`` (built for ``cfg``) on the stored samples of
    ``replay`` (all, or the first ``max_samples``): exact-match rates of the
    trans index and the grip bit, and the first 20 misses."""
    n = replay.size
    cams = cfg.rlbench.cameras
    width = cfg.method.proprio_width()
    hit_t, hit_g, total = 0, 0, 0
    misses = []
    for i in range(n if not max_samples else min(n, max_samples)):
        s = {k: v[0] for k, v in replay.gather(np.asarray([i])).items()}
        rgbs = tuple(np.asarray(s[f"{c}_rgb"], np.float32)[None] for c in cams)
        pcds = tuple(np.asarray(s[f"{c}_point_cloud"], np.float32)[None] for c in cams)
        proprio = np.asarray(s["low_dim_state"], np.float32)[None][:, :width]
        lang_goal = np.asarray(s["lang_goal_emb"], np.float32)[None]
        lang_tok = np.asarray(s["lang_token_embs"], np.float32)[None]
        bounds = np.asarray(s["target_object_scene_bounds"]
                            if "target_object_scene_bounds" in s
                            else cfg.rlbench.scene_bounds, np.float32).reshape(1, 6)
        out = agent._infer(agent.params, rgbs, pcds, proprio, lang_goal, lang_tok, bounds)
        p_t = out.trans_idx.cpu().numpy()[0]
        p_rg = out.rot_grip_idx.cpu().numpy()[0]
        t_t = np.asarray(s["trans_action_indicies"])[:3]
        t_g = int(np.asarray(s["rot_grip_action_indicies"])[3])
        dt = int(np.abs(p_t - t_t).sum())
        ok_t, ok_g = dt == 0, int(p_rg[3]) == t_g
        hit_t += ok_t
        hit_g += ok_g
        total += 1
        if not (ok_t and ok_g):
            misses.append({"i": int(i), "dt": dt, "grip": f"{int(p_rg[3])}/{t_g}"})
    return {
        "task": task, "samples": total,
        "trans_exact": round(hit_t / max(1, total), 4),
        "grip_exact": round(hit_g / max(1, total), 4),
        "misses": misses[:20],
    }


def main(argv=None, device=None) -> dict:
    from voxactb_tpu_torch.cli.train import build_replay_and_agent
    from voxactb_tpu_torch.config import Config
    from voxactb_tpu_torch.device import resolve_device
    from voxactb_tpu_torch.tools.probe_policy_open_loop import load_agent

    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="put_item_in_drawer")
    ap.add_argument("--seed-dir", required=True)
    ap.add_argument("--ckpt-step", type=int, default=5999)
    ap.add_argument("--max-samples", type=int, default=0, help="0 = all stored samples")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(device or args.device)

    agent, cfg = load_agent(args.seed_dir, args.ckpt_step, "policy", device)
    # the replay, rebuilt through the entry the training leg used
    replay, _ = build_replay_and_agent(Config.load(os.path.join(args.seed_dir,
                                                                "config.json")),
                                       device=device)
    print(f"replay rebuilt: {replay.size} samples", flush=True)
    record = replay_accuracy(agent, cfg, replay, max_samples=args.max_samples,
                             task=args.task)
    print(json.dumps(record, indent=1), flush=True)
    return record


if __name__ == "__main__":
    main()
