"""Real-robot evaluation environment + offline checkpoint selection.

Counterpart of peract/eval_real.py: ``RealSenseCamera`` (:67 — gated on pyrealsense2,
optional), ``RobotEnv`` (:412 — VLM crop :619, dominant arm :646,
gimbal-lock guards :658-701, hand-eye extrinsics application :702-788,
``move_robot``), and the offline checkpoint-selection protocol
(:1059-1115, :1360-1425 — pick the checkpoint minimizing positional/angular/gripper
errors against held-out validation demos before going live).

A copy of ``voxactb_tpu.realrobot.robot_env``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from voxactb_tpu_torch.envs.base import BimanualEnv, Transition
from voxactb_tpu_torch.realrobot.robot import BimanualURRobot


class RealSenseCamera:
    """Aligned RGB-D capture (eval_real.py:67-266). Needs pyrealsense2 at runtime."""

    def __init__(self, serial: Optional[str] = None, width=640, height=480, fps=30):
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise RuntimeError(
                "RealSenseCamera needs pyrealsense2 (not installed); pass a "
                "custom camera callable to RealRobotEnv instead") from e
        self._rs = rs
        self._pipeline = rs.pipeline()
        cfg = rs.config()
        if serial:
            cfg.enable_device(serial)
        cfg.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
        cfg.enable_stream(rs.stream.color, width, height, rs.format.rgb8, fps)
        self._profile = self._pipeline.start(cfg)
        self._align = rs.align(rs.stream.color)

    def capture(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (rgb uint8 [H,W,3], depth_m [H,W], intrinsics 3x3)."""
        frames = self._align.process(self._pipeline.wait_for_frames())
        depth = frames.get_depth_frame()
        color = frames.get_color_frame()
        scale = self._profile.get_device().first_depth_sensor().get_depth_scale()
        intr = color.profile.as_video_stream_profile().intrinsics
        K = np.array([[intr.fx, 0, intr.ppx], [0, intr.fy, intr.ppy], [0, 0, 1]],
                     np.float32)
        return (np.asanyarray(color.get_data()),
                np.asanyarray(depth.get_data()).astype(np.float32) * scale, K)


def guard_gimbal_lock(quat_xyzw: np.ndarray, max_tilt_deg: float = 30.0,
                      reference=np.array([0.0, 1.0, 0.0, 0.0])) -> np.ndarray:
    """Clamp commanded orientations near singular tool configurations.

    eval_real.py:658-701 rejects predictions whose orientation tilts too far from
    the downward-facing reference; we renormalize toward the reference instead of
    refusing outright, which keeps the live loop moving.
    """
    q = np.asarray(quat_xyzw, np.float64)
    q = q / (np.linalg.norm(q) + 1e-12)
    dot = abs(float(np.dot(q, reference)))
    angle = 2 * math.degrees(math.acos(min(1.0, dot)))
    if angle <= max_tilt_deg:
        return q
    # slerp toward the reference so the tilt equals the limit
    t = max_tilt_deg / max(angle, 1e-9)
    sign = 1.0 if np.dot(q, reference) >= 0 else -1.0
    blended = (1 - t) * reference * sign + t * q
    return blended / np.linalg.norm(blended)


class RealRobotEnv(BimanualEnv):
    """Two UR5s + cameras behind the BimanualEnv contract used by the rollout stack.

    ``cameras``: dict name -> callable returning (rgb, depth_m, K); hand-eye
    ``extrinsics``: dict arm -> 4x4 mapping policy predictions into each robot base
    frame (LEFT/RIGHT_ARM_EXTRINSICS, eval_real.py:1292-1318).
    """

    def __init__(
        self,
        robots: BimanualURRobot,
        cameras: Dict[str, Callable],
        extrinsics: Dict[str, np.ndarray],
        cam_extrinsics: Optional[Dict[str, np.ndarray]] = None,
        vlm=None,
        task_name: str = "",
        episode_length: int = 25,
        dominant_arm: str = "right",
        lang_encoder: Optional[Callable] = None,
        description: str = "",
    ):
        """``lang_encoder``: text -> (sentence_emb [1,1024], token_embs
        [1,77,512]) — the same contract the sim env and replay fill use; when
        absent the observation carries raw BPE ``lang_goal_tokens`` for agents
        built with their own encoder (eval_real.py passes CLIP embeddings)."""
        self._robots = robots
        self._cameras = cameras
        self._extrinsics = extrinsics
        self._cam_extrinsics = cam_extrinsics or {}
        self._vlm = vlm
        self._task_name = task_name
        self._episode_length = episode_length
        self._dominant_arm = dominant_arm
        self._lang_encoder = lang_encoder
        self._description = description or task_name.replace("_", " ")
        self._step_count = 0
        self._crop: Optional[Tuple[np.ndarray, float]] = None
        self._grip = {"right": 1.0, "left": 1.0}

    def launch(self) -> None:
        pass

    def reset(self) -> Dict:
        self._step_count = 0
        self._crop = None
        self._grip = {"right": 1.0, "left": 1.0}
        return self._observation()

    def step(self, action, which_arm: str) -> Transition:
        action = np.asarray(action, np.float64)
        arm = {"dominant": self._dominant_arm,
               "assistive": "left" if self._dominant_arm == "right" else "right",
               }.get(which_arm, which_arm)
        position, quat, grip = action[:3], action[3:7], float(action[7])
        quat = guard_gimbal_lock(quat)

        # hand-eye calibration: policy/world frame -> robot base frame
        # (eval_real.py:1312-1314 tcp_point = EXTRINSICS @ position)
        T = self._extrinsics[arm]
        base_pos = (T @ np.concatenate([position, [1.0]]))[:3]
        self._robots.move_arm(arm, base_pos, quat, gripper_open=grip)
        # no gripper feedback channel: track the COMMANDED grip so proprio
        # reflects the grasp state the policy was trained on
        self._grip[arm] = 1.0 if grip > 0.5 else 0.0
        self._step_count += 1
        terminal = self._step_count >= self._episode_length
        return Transition(self._observation(), 0.0, terminal,
                          info={"arm": arm})

    # -- VoxAct-B hooks ---------------------------------------------------------------

    def target_object_world_coords(self):
        if self._crop is None and self._vlm is not None:
            cam = next(iter(self._cameras))
            rgb, depth, K = self._cameras[cam]()
            pcd = _deproject(depth, K, self._cam_extrinsics.get(cam, np.eye(4)))
            self._crop = self._vlm.get_target_object_world_coords(
                rgb, pcd, self._task_name)
        return None if self._crop is None else self._crop[0]

    def auto_crop_radius(self) -> float:
        return 0.0 if self._crop is None else self._crop[1]

    def dominant_arm(self) -> str:
        return self._dominant_arm

    @property
    def episode_length(self) -> int:
        return self._episode_length

    def _observation(self) -> Dict:
        obs: Dict = {}
        for name, cam in self._cameras.items():
            rgb, depth, K = cam()
            ext = self._cam_extrinsics.get(name, np.eye(4))
            obs[f"{name}_rgb"] = rgb[None]
            obs[f"{name}_point_cloud"] = _deproject(depth, K, ext)[None]
            obs[f"{name}_camera_intrinsics"] = K[None]
            obs[f"{name}_camera_extrinsics"] = ext[None].astype(np.float32)
        robot_obs = self._robots.observation()
        t = self._step_count
        time_ch = (1.0 - t / max(1, self._episode_length - 1)) * 2.0 - 1.0
        states = {}
        for side in ("right", "left"):
            pose = robot_obs[f"gripper_{side}_pose"]
            obs[f"gripper_{side}_pose"] = pose
            g = self._grip[side]
            fingers = 0.04 * g  # commanded grip -> finger estimate [0, 0.04]
            states[side] = np.array([g, fingers, fingers], np.float32)
            tail = [time_ch, 0.0] if side == "right" else [time_ch]
            obs[f"low_dim_state_{side}_arm"] = np.concatenate(
                [states[side], tail]).astype(np.float32)[None]
        # combined proprio for dominant/assistive agents (same layout the sim
        # env emits: left gripper state then the right arm's full vector)
        obs["low_dim_state"] = np.concatenate(
            [states["left"],
             np.asarray(obs["low_dim_state_right_arm"][0])]).astype(
                 np.float32)[None]
        obs["lang_goal"] = self._description
        if self._lang_encoder is not None:
            # same contract as the sim env (environment.py:426-428)
            sent, tok = self._lang_encoder(self._description)
            obs["lang_goal_emb"] = sent
            obs["lang_token_embs"] = tok
        else:
            from voxactb_tpu_torch.utils.bpe import SimpleTokenizer

            obs["lang_goal_tokens"] = np.asarray(
                SimpleTokenizer().tokenize(self._description))
        return obs


def _deproject(depth_m: np.ndarray, K: np.ndarray,
               extrinsics: np.ndarray) -> np.ndarray:
    """Depth + pinhole intrinsics -> world-frame cloud (eval_real.py:167-220)."""
    h, w = depth_m.shape
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    x = (u - K[0, 2]) / K[0, 0] * depth_m
    y = (v - K[1, 2]) / K[1, 1] * depth_m
    cam = np.stack([x, y, depth_m, np.ones_like(depth_m)], -1)
    world = np.einsum("ij,hwj->hwi", extrinsics, cam)[..., :3]
    return world.astype(np.float32)


# -- offline checkpoint selection (eval_real.py:1059-1115, 1360-1425) -----------------


def open_loop_errors(agent, val_transitions: Sequence[Dict], which_arm: str,
                     **act_kwargs) -> Dict[str, float]:
    """Positional / angular / gripper-open errors of a checkpoint on held-out
    validation keyframes (open-loop regression test before live execution)."""
    pos_err, ang_err, grip_err = [], [], []
    for t in val_transitions:
        res = agent.act(0, dict(t["observation"]), which_arm=which_arm,
                        **act_kwargs)
        action = np.asarray(res.action)
        gt = np.asarray(t["action"])
        pos_err.append(np.linalg.norm(action[:3] - gt[:3]))
        dot = abs(float(np.dot(action[3:7] / np.linalg.norm(action[3:7]),
                               gt[3:7] / np.linalg.norm(gt[3:7]))))
        ang_err.append(2 * math.degrees(math.acos(min(1.0, dot))))
        grip_err.append(abs(action[7] - gt[7]))
    return {
        "positional_error": float(np.mean(pos_err)),
        "angular_error": float(np.mean(ang_err)),
        "gripper_error": float(np.mean(grip_err)),
    }


def select_best_checkpoint(agent, weightsdir: str, val_transitions, which_arm: str,
                           csv_path: Optional[str] = None,
                           **act_kwargs) -> Tuple[int, Dict[str, float]]:
    """Sweep saved checkpoints, score open-loop errors, pick the (pos+ang)-best."""
    from voxactb_tpu_torch.runners.eval_runner import existing_weight_steps
    from voxactb_tpu_torch.utils.loggers import CsvWriter

    writer = CsvWriter(csv_path) if csv_path else None
    best_step, best_score, best_row = -1, float("inf"), {}
    for step in existing_weight_steps(weightsdir):
        agent.load_weights(os.path.join(weightsdir, str(step)))
        errs = open_loop_errors(agent, val_transitions, which_arm, **act_kwargs)
        score = errs["positional_error"] + errs["angular_error"] / 100.0
        row = {"step": step, **errs}
        if writer:
            writer.write(row)
        if score < best_score:
            best_step, best_score, best_row = step, score, row
    if best_step >= 0:
        # leave the agent holding the WINNER, not the last swept checkpoint —
        # callers go live with this agent (eval_real.py's select-then-execute)
        agent.load_weights(os.path.join(weightsdir, str(best_step)))
    return best_step, best_row
