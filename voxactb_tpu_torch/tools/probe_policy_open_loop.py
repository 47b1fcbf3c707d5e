"""Open-loop policy probe: drive the env along the ORACLE (discretized-demo)
trajectory and, at every step, ask the trained policy what IT would do,
without letting its answer affect the world. The per-step prediction error
against the oracle action separates "the policy never learned the keyframe
map" from "the policy is right open-loop but drifts closed-loop", the two
failure modes a bare success rate cannot tell apart.

Counterpart of ``tools/probe_policy_open_loop.py`` on the port's sim,
``data/fill_replay``, ``utils/keypoints`` and agent, which reads the port's
own ``weights/<step>`` checkpoints. ``load_agent``, ``_rewrite_time``,
``probe_episode`` and ``live_episode`` take the JAX tool's arguments; the
per-step rows print as the JAX tool prints them. ``main`` also prints one
``{"open_loop": ...}`` line per run: per episode the keyframes probed, how
many matched the oracle exactly (trans index, rotation bins, grip bit), the
mean position error, and with ``--live`` the closed-loop reward and the first
step whose predicted trans index left the oracle's.

Run:
  python3 -m voxactb_tpu_torch.tools.probe_policy_open_loop --task open_jar \\
      --acting-dir <train_dominant/.../seed0> --stab-dir <train_assistive/.../seed0> \\
      --ckpt-step 5999 --episodes 3 [--live] [--train-time] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from voxactb_tpu_torch.tools.oracle_protocol_check import continuous_from_discrete


def load_agent(seed_dir, step, which, device=None):
    """The policy of ``seed_dir`` (its ``config.json``) with the weights of
    ``weights/<step>``, built for acting; and the config."""
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.config import Config

    cfg = Config.load(os.path.join(seed_dir, "config.json"))
    agent = QAttentionBCAgent(cfg.method, cfg.rlbench.cameras, cfg.rlbench.scene_bounds,
                              device=device)
    agent.build(training=False)
    agent.load_weights(os.path.join(seed_dir, "weights", str(step)))
    print(f"loaded {which} <- {seed_dir}/weights/{step}", flush=True)
    return agent, cfg


def _rewrite_time(obs, t, episode_length):
    """Overwrite the proprio time channel with the TRAIN-side value.

    Training fills the channel with (1 - k/(T-1))*2-1 where k is the per-arm
    KEYFRAME index (fill_replay -> extract_obs t=k); eval uses the global
    rollout step, the reference's own train/eval inconsistency. Fed the time
    value it was trained to see at this keyframe, a policy keying on the time
    channel snaps to the oracle targets.
    """
    time_ch = (1.0 - t / max(1, episode_length - 1)) * 2.0 - 1.0
    obs = dict(obs)
    for key in ("low_dim_state_right_arm", "low_dim_state_left_arm"):
        v = np.array(obs[key], np.float32)
        v[..., 3] = time_ch
        obs[key] = v
    v = np.array(obs["low_dim_state"], np.float32)
    v[..., 6] = time_ch
    obs["low_dim_state"] = v
    return obs


def oracle_keyframes(frames, dominant, no_duplicate=False):
    """Per arm, the keyframe indices of a demo (two scanners, each tracking
    its own arm)."""
    from voxactb_tpu_torch.utils.keypoints import KeypointConfig, keypoint_discovery

    kcfg = KeypointConfig(no_duplicate=no_duplicate)
    assistive = "left" if dominant == "right" else "right"
    return {
        dominant: keypoint_discovery(frames, which_arm="dominant",
                                     dominant_assistive_arm=dominant, cfg=kcfg)[0],
        assistive: keypoint_discovery(frames, which_arm="assistive",
                                      dominant_assistive_arm=assistive, cfg=kcfg)[0],
    }


def probe_episode(env, agents, ep, voxel_size, rot_res, crop_radius,
                  episode_length, no_duplicate=False, train_time=False, targets=None):
    """The open-loop rows of episode ``ep``: at each step of the oracle's
    alternation (assistive on even steps) the acting arm's policy is asked
    for its action; the oracle's discretized action steps the env. With
    ``targets`` (a dict), each probed step's oracle trans index is put there."""
    from voxactb_tpu_torch.data.fill_replay import (discretize_keyframe,
                                                    scene_bounds_from_crop_np)

    frames, _ = env.get_demo(ep)
    dominant = env.dominant_arm()
    assistive = "left" if dominant == "right" else "right"
    per_arm = oracle_keyframes(frames, dominant, no_duplicate)

    obs = env.reset_to_demo(ep)
    crop_point = env.target_object_world_coords()
    bounds = scene_bounds_from_crop_np(crop_radius, crop_point)

    queues = {"right": [], "left": []}
    for arm, kps in per_arm.items():
        for kp in kps:
            t_idx, rot_grip, _, _ = discretize_keyframe(
                frames[kp], frames[max(kp - 1, 0)], bounds, voxel_size, rot_res, arm)
            queues[arm].append((
                np.asarray(t_idx), np.asarray(rot_grip),
                continuous_from_discrete(t_idx, rot_grip, bounds, voxel_size, rot_res)))

    rows = []
    res = (np.asarray(bounds[3:]) - np.asarray(bounds[:3])) / voxel_size
    kf_counter = {"right": 0, "left": 0}
    for step in range(episode_length):
        arm = assistive if step % 2 == 0 else dominant
        q = queues[arm]
        if not q:
            if not queues[dominant] and not queues[assistive]:
                break
            continue
        t_idx, rot_grip, action = q.pop(0)
        if targets is not None:
            targets[step] = t_idx.tolist()

        agent = agents["dominant"] if arm == dominant else agents["assistive"]
        obs_in = (_rewrite_time(obs, kf_counter[arm], episode_length)
                  if train_time else dict(obs))
        kf_counter[arm] += 1
        pred = agent.act(step, obs_in, deterministic=True, which_arm=arm,
                         new_scene_bounds=np.asarray(bounds).tolist(),
                         dominant_assitive_policy=True)
        p_t = np.asarray(pred.observation_elements["trans_action_indicies"])
        p_rg = np.asarray(pred.observation_elements["rot_grip_action_indicies"])
        rows.append({
            "step": step, "arm": arm,
            "role": "dominant" if arm == dominant else "assistive",
            "trans_idx_err": (p_t - t_idx).tolist(),
            "pos_err_cm": float(np.linalg.norm((p_t - t_idx) * res) * 100),
            "rot_idx_err": (p_rg[:3] - rot_grip[:3]).tolist(),
            "grip_pred": int(p_rg[3]), "grip_target": int(rot_grip[3]),
        })
        tr = env.step(action, arm)  # the oracle's action keeps the demo path
        obs = dict(tr.observation)
        if tr.terminal:
            break
    return rows


def live_episode(env, agents, ep, crop_radius, episode_length, preds=None):
    """A closed-loop episode (the policies' actions step the env): the best
    reward and a line per step. With ``preds`` (a list), each step's
    ``(step, arm, predicted trans index)`` is appended to it."""
    from voxactb_tpu_torch.data.fill_replay import scene_bounds_from_crop_np

    obs = env.reset_to_demo(ep)
    crop_point = env.target_object_world_coords()
    bounds = scene_bounds_from_crop_np(crop_radius, crop_point)
    dominant = env.dominant_arm()
    assistive = "left" if dominant == "right" else "right"

    reward, log = 0.0, []
    for step in range(episode_length):
        arm = assistive if step % 2 == 0 else dominant
        agent = agents["dominant"] if arm == dominant else agents["assistive"]
        pred = agent.act(step, dict(obs), deterministic=True, which_arm=arm,
                         new_scene_bounds=np.asarray(bounds).tolist(),
                         dominant_assitive_policy=True)
        act = np.asarray(pred.action)
        if preds is not None:
            preds.append((step, arm, np.asarray(
                pred.observation_elements["trans_action_indicies"]).tolist()))
        try:
            tr = env.step(act, arm)
        except Exception as e:  # noqa: BLE001 - the step's failure is the finding
            log.append(f"step {step} {arm}: step error {e!r}")
            break
        log.append(f"step {step} {arm}: pos={np.round(act[:3], 3).tolist()} "
                   f"grip={act[7]:.0f} reward={tr.reward}")
        reward = max(reward, tr.reward)
        obs = dict(tr.observation)
        if tr.terminal:
            break
    return reward, log


def episode_summary(rows, targets=None, preds=None, reward=None) -> dict:
    """Counts of one episode's open-loop rows: keyframes probed, exact trans
    indices, rotation bins and grip bits, the mean position error; with the
    oracle's ``targets`` and the live run's ``preds``, its reward and the
    first step whose predicted trans index differs from the oracle's at that
    step (None if none did)."""
    out = {
        "keyframes": len(rows),
        "trans_exact": sum(not any(r["trans_idx_err"]) for r in rows),
        "rot_exact": sum(not any(r["rot_idx_err"]) for r in rows),
        "grip_exact": sum(r["grip_pred"] == r["grip_target"] for r in rows),
        "pos_err_cm_mean": float(np.mean([r["pos_err_cm"] for r in rows])) if rows else None,
    }
    if preds is not None:
        left = next((s for s, _, p in preds if s in targets and targets[s] != p), None)
        out.update(live_reward=reward, live_steps=len(preds), left_oracle_at=left)
    return out


def main(argv=None, device=None) -> dict:
    from voxactb_tpu_torch.device import resolve_device
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="open_drawer")
    ap.add_argument("--acting-dir", required=True)
    ap.add_argument("--stab-dir", required=True)
    ap.add_argument("--ckpt-step", type=int, required=True)
    ap.add_argument("--stab-step", type=int, default=None)
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=43)
    ap.add_argument("--crop-radius", type=float, default=0.3)
    ap.add_argument("--live", action="store_true")
    ap.add_argument("--train-time", action="store_true",
                    help="feed the policy the TRAIN-side time channel (per-arm "
                         "keyframe index) instead of the eval-side rollout step")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(device or args.device)

    acting, cfg = load_agent(args.acting_dir, args.ckpt_step, "acting", device)
    stab, _ = load_agent(args.stab_dir, args.stab_step or args.ckpt_step, "stabilizing",
                         device)
    agents = {"dominant": acting, "assistive": stab}
    env = BimanualTaskEnvironment(
        TASK_REGISTRY[args.task], cameras=cfg.rlbench.cameras,
        image_size=cfg.rlbench.camera_resolution[0],
        episode_length=cfg.rlbench.episode_length, seed=args.seed)

    episodes = []
    summary = []
    for ep in range(args.episodes):
        targets = {}
        rows = probe_episode(env, agents, ep, cfg.method.voxel_sizes[0],
                             cfg.method.rotation_resolution, args.crop_radius,
                             cfg.rlbench.episode_length,
                             no_duplicate=cfg.method.keypoint_discovery_no_duplicate,
                             train_time=args.train_time, targets=targets)
        print(f"\n=== episode {ep} (open-loop on oracle path) ===")
        for r in rows:
            print(json.dumps(r))
        record = dict(episode=ep, rows=rows)
        preds = reward = None
        if args.live:
            preds = []
            reward, log = live_episode(env, agents, ep, args.crop_radius,
                                       cfg.rlbench.episode_length, preds)
            print(f"--- episode {ep} live rollout: reward={reward} ---")
            for line in log:
                print(" ", line)
            record.update(live_reward=reward, live_log=log)
        episodes.append(record)
        summary.append(dict(episode=ep, **episode_summary(rows, targets, preds, reward)))
    print(json.dumps({"open_loop": dict(task=args.task, ckpt_step=args.ckpt_step,
                                        stab_step=args.stab_step or args.ckpt_step,
                                        live=args.live, train_time=args.train_time,
                                        episodes=summary)}), flush=True)
    return dict(episodes=episodes, summary=summary)


if __name__ == "__main__":
    main()
