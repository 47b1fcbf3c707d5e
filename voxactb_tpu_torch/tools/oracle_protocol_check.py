"""Oracle calibration for the protocol eval: play back DISCRETIZED demo keyframe
actions through the dominant_assistive eval step path and report success.

A BC policy's ceiling is the success rate of its own training targets: the next
keyframe per arm, discretized to the voxel grid + rotation bins exactly as
``data/fill_replay.discretize_keyframe`` does, executed through
``BimanualTaskEnvironment.step`` with the eval-time alternation (assistive on
even steps — rollout_generator.py:233-244). If the oracle fails here the gap is
machinery/discretization (bounds, grasp cone, planning), not training scale.

Counterpart of ``tools/oracle_protocol_check.py``; host only (the port's sim,
``data/fill_replay`` and ``utils/keypoints``).

Run:  python3 -m voxactb_tpu_torch.tools.oracle_protocol_check [--episodes 5] [--voxel 20]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
from scipy.spatial.transform import Rotation

TASKS = ["open_jar", "open_drawer", "put_item_in_drawer", "hand_over_item"]


def continuous_from_discrete(trans_idx, rot_grip, bounds, voxel_size,
                             rotation_resolution):
    """Invert discretize_keyframe the way the agent decode does
    (qattention_stack_agent.py:80-89 / ops/geometry.py)."""
    bounds = np.asarray(bounds, np.float64)
    res = (bounds[3:] - bounds[:3]) / voxel_size
    pos = bounds[:3] + res * trans_idx + res / 2.0
    euler = trans_idx_to_euler(rot_grip[:3], rotation_resolution)
    quat = Rotation.from_euler("xyz", euler, degrees=True).as_quat()
    return np.concatenate([pos, quat, [float(rot_grip[3])], [1.0]])


def trans_idx_to_euler(rot_idx, resolution):
    return np.asarray(rot_idx, np.float64) * resolution - 180.0


def oracle_episode(env, voxel_size, rotation_resolution, crop_radius, ep,
                   no_duplicate=False):
    from voxactb_tpu_torch.data.fill_replay import (
        discretize_keyframe,
        scene_bounds_from_crop_np,
    )
    from voxactb_tpu_torch.utils.keypoints import KeypointConfig, keypoint_discovery

    kcfg = KeypointConfig(no_duplicate=no_duplicate)
    frames, _ = env.get_demo(ep)
    dominant = env.dominant_arm()
    assistive = "left" if dominant == "right" else "right"
    # two policies = two scanners, each tracking its own arm (fill_replay:221-228
    # flips dominant_assistive_arm for the assistive policy)
    per_arm = {
        dominant: keypoint_discovery(frames, which_arm="dominant",
                                     dominant_assistive_arm=dominant,
                                     cfg=kcfg)[0],
        assistive: keypoint_discovery(frames, which_arm="assistive",
                                      dominant_assistive_arm=assistive,
                                      cfg=kcfg)[0],
    }

    env.reset_to_demo(ep)
    crop_point = env.target_object_world_coords()
    bounds = scene_bounds_from_crop_np(crop_radius, crop_point)

    queues = {"right": [], "left": []}
    for arm, kps in per_arm.items():
        for kp in kps:
            t_idx, rot_grip, _, _ = discretize_keyframe(
                frames[kp], frames[max(kp - 1, 0)], bounds, voxel_size,
                rotation_resolution, arm)
            queues[arm].append(continuous_from_discrete(
                t_idx, rot_grip, bounds, voxel_size, rotation_resolution))
    kps = per_arm[dominant]

    reward, steps = 0.0, 0
    ep_len = env.episode_length
    ep_len = ep_len() if callable(ep_len) else ep_len
    for step in range(ep_len):
        arm = assistive if step % 2 == 0 else dominant
        q = queues[arm]
        action = q.pop(0) if q else None
        if action is None:
            if not queues[dominant] and not queues[assistive]:
                break
            continue  # this arm is done; let the other arm's turn come
        try:
            tr = env.step(action, arm)
        except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
            return {"success": False, "steps": steps, "error": repr(e)[:120]}
        steps += 1
        reward = max(reward, tr.reward)
        if tr.terminal:
            break
    return {"success": reward > 0, "steps": steps,
            "kps": len(kps), "dominant": dominant}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", nargs="*", default=TASKS)
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--voxel", type=int, default=20)
    ap.add_argument("--crop-radius", type=float, default=0.3)
    ap.add_argument("--rotation-resolution", type=int, default=5)
    ap.add_argument("--seed", type=int, default=43)
    ap.add_argument("--episode-length", type=int, default=12)
    ap.add_argument("--no-duplicate", action="store_true",
                    help="use the no-duplicate keyframe scanner "
                         "(keypoint_discovery_no_duplicate)")
    args = ap.parse_args(argv)

    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

    out = {}
    for task in args.tasks:
        env = BimanualTaskEnvironment(
            TASK_REGISTRY[task], cameras=["wrist", "wrist2"], image_size=32,
            episode_length=args.episode_length, seed=args.seed)
        eps = [oracle_episode(env, args.voxel, args.rotation_resolution,
                              args.crop_radius, i,
                              no_duplicate=args.no_duplicate)
               for i in range(args.episodes)]
        rate = sum(e["success"] for e in eps) / len(eps)
        out[task] = {"success_rate": rate, "episodes": eps}
        print(f"{task}: oracle success {rate:.2f} "
              f"({[e['success'] for e in eps]})", flush=True)
    print(json.dumps({t: v["success_rate"] for t, v in out.items()}))
    return out


if __name__ == "__main__":
    main()
