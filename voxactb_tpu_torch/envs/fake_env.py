"""A deterministic synthetic bimanual environment for harness/rollout testing.

The reference has no sim-free test path — every env test boots CoppeliaSim
(SURVEY §4). This fake env renders a simple RGB-D scene (a colored target cube on a
table plane) from two pinhole cameras, tracks two gripper poses, and scores success
when the commanded arm's gripper reaches the target. It exposes the same hooks the
VoxAct-B rollout uses: per-episode target-object coordinates (standing in for the
OWL-ViT+SAM crop point), an auto crop radius, and a geometric dominant-arm rule
(object on the right half -> right-dominant, mirroring the distance heuristics at
voxposer/envs/rlbench_env.py:580-613).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from voxactb_tpu_torch.envs.base import BimanualEnv, Transition

_WORKSPACE = np.array([-0.4, -0.5, 0.6, 0.6, 0.5, 1.4], np.float32)


def _pinhole_cloud(cam_pos, img: int, rng, target, cube=0.04):
    """Render a crude RGB + point-cloud pair: table plane + target cube splat."""
    # table plane points
    xs = rng.uniform(_WORKSPACE[0], _WORKSPACE[3], (img, img)).astype(np.float32)
    ys = rng.uniform(_WORKSPACE[1], _WORKSPACE[4], (img, img)).astype(np.float32)
    zs = np.full((img, img), _WORKSPACE[2], np.float32)
    pcd = np.stack([xs, ys, zs], -1)
    rgb = np.full((img, img, 3), 120, np.uint8)  # grey table

    # splat the cube into a corner block of the image
    k = max(2, img // 8)
    cube_pts = target[None, None] + rng.uniform(
        -cube, cube, (k, k, 3)).astype(np.float32)
    pcd[:k, :k] = cube_pts
    rgb[:k, :k] = (220, 40, 40)  # red cube
    return rgb, pcd


class FakeBimanualEnv(BimanualEnv):
    """Synthetic two-arm tabletop task: move the commanded gripper to the target."""

    def __init__(self, cameras=("wrist", "wrist2"), image_size: int = 32,
                 episode_length: int = 10, success_radius: float = 0.08,
                 seed: int = 0, task_name: str = "fake_reach"):
        self._cameras = tuple(cameras)
        self._img = image_size
        self._episode_length = episode_length
        self._success_radius = success_radius
        self._seed = seed
        self._task_name = task_name
        self._rng = np.random.default_rng(seed)
        self._launched = False
        self._step_count = 0
        self.step_log = []  # (which_arm, action) history for tests

    # -- lifecycle ---------------------------------------------------------------

    def launch(self) -> None:
        self._launched = True

    def shutdown(self) -> None:
        self._launched = False

    def reset(self) -> Dict[str, Any]:
        assert self._launched, "call launch() first"
        self._step_count = 0
        self.step_log = []
        ws = _WORKSPACE
        self._target = self._rng.uniform(
            ws[:3] + 0.1, ws[3:] - 0.1).astype(np.float32)
        self._gripper = {
            "right": np.array([0.4, -0.3, 1.0], np.float32),
            "left": np.array([0.4, 0.3, 1.0], np.float32),
        }
        self._gripper_open = {"right": 1.0, "left": 1.0}
        return self._observation()

    def reset_to_demo(self, demo_index: int) -> Dict[str, Any]:
        self._rng = np.random.default_rng(self._seed + demo_index)
        return self.reset()

    # -- stepping ----------------------------------------------------------------

    def step(self, action, which_arm: str) -> Transition:
        action = np.asarray(action, np.float32)
        arm = {"dominant": self.dominant_arm(),
               "assistive": "left" if self.dominant_arm() == "right" else "right",
               }.get(which_arm, which_arm)
        self.step_log.append((which_arm, arm, action.copy()))

        self._gripper[arm] = np.clip(action[:3], _WORKSPACE[:3], _WORKSPACE[3:])
        self._gripper_open[arm] = float(action[7] > 0.5)
        self._step_count += 1

        # success: the DOMINANT gripper reaches the target with a closed gripper
        dom = self.dominant_arm()
        dist = np.linalg.norm(self._gripper[dom] - self._target)
        success = dist < self._success_radius and self._gripper_open[dom] == 0.0
        timeout = self._step_count >= self._episode_length
        reward = 100.0 if success else 0.0  # REWARD_SCALE (launch_utils.py:32)
        return Transition(self._observation(), reward, success or timeout,
                          info={"success": success, "dist": float(dist)})

    # -- VoxAct-B hooks ------------------------------------------------------------

    @property
    def task_name(self) -> str:
        return self._task_name

    def target_object_world_coords(self):
        return self._target.copy()

    def auto_crop_radius(self) -> float:
        return 0.3

    def dominant_arm(self) -> str:
        # geometric rule standing in for the reference's VLM/angle heuristics
        return "right" if self._target[1] < 0 else "left"

    @property
    def env_language_goal(self) -> str:
        return f"reach the red cube with the {self.dominant_arm()} hand"

    @property
    def episode_length(self) -> int:
        return self._episode_length

    # -- observation ---------------------------------------------------------------

    def _observation(self) -> Dict[str, Any]:
        obs: Dict[str, Any] = {}
        cam_offsets = {name: i for i, name in enumerate(self._cameras)}
        for cam in self._cameras:
            rgb, pcd = _pinhole_cloud(cam_offsets[cam], self._img, self._rng,
                                      self._target)
            obs[f"{cam}_rgb"] = rgb[None]          # [1, H, W, 3]
            obs[f"{cam}_point_cloud"] = pcd[None]  # [1, H, W, 3]
            obs[f"{cam}_camera_extrinsics"] = np.eye(4, dtype=np.float32)[None]
            obs[f"{cam}_camera_intrinsics"] = np.array(
                [[110.0, 0, self._img / 2], [0, 110.0, self._img / 2], [0, 0, 1]],
                np.float32)[None]

        def arm_state(arm):
            return np.array(
                [self._gripper_open[arm], 0.02, 0.02], np.float32)

        t = self._step_count
        time_channel = (1.0 - t / max(1, self._episode_length - 1)) * 2.0 - 1.0
        # right arm carries [open, f1, f2, time, arm_id] so the dominant_assistive
        # concat left[:3] + right -> the 8-dim training proprio
        # (qattention_peract_bc_agent.py:675, helpers/utils.py:614-618)
        right = np.concatenate([arm_state("right"), [time_channel], [0.0]])
        left = np.concatenate([arm_state("left"), [time_channel]])
        obs["low_dim_state_right_arm"] = right.astype(np.float32)[None]
        obs["low_dim_state_left_arm"] = left.astype(np.float32)[None]
        obs["low_dim_state"] = np.concatenate(
            [left[:3], right]).astype(np.float32)[None]

        # precomputed language embeddings (a CLIP encoder plugs in upstream)
        seed = abs(hash(self.env_language_goal)) % (2 ** 31)
        lrng = np.random.default_rng(seed)
        obs["lang_goal_emb"] = lrng.normal(size=(1024,)).astype(np.float32)
        obs["lang_token_embs"] = lrng.normal(size=(77, 512)).astype(np.float32)
        obs["lang_goal"] = self.env_language_goal

        obs["gripper_right_pose"] = np.concatenate(
            [self._gripper["right"], [0, 0, 0, 1]]).astype(np.float32)
        obs["gripper_left_pose"] = np.concatenate(
            [self._gripper["left"], [0, 0, 0, 1]]).astype(np.float32)
        return obs
