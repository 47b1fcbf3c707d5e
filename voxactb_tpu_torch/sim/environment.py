"""Scene orchestration + task environments over a SimBackend.

Counterparts of ``Environment2Robots`` (rlbench/environments_two_robots.py:29-262),
``TaskEnvironment2Robots`` (task_environment_two_robots.py:24-209 — reset /
reset_to_demo / step(action, which_arm) / get_demos) and the observation/demo halves
of ``Scene2Robots`` (backend/scene_two_robots.py:32-2800): camera rigs, episode
placement with retry, per-step observations, and scripted bimanual demo recording that
interleaves left/right waypoints with arm labels.

The action mode reproduces ``EndEffectorPoseViaPlanning2Robots``'s contract
(action_modes/arm_action_modes.py:284-435): workspace bound check, then stepped
path execution to the commanded pose, then the gripper bit
(``MoveArmThenGripper2Robots``, action_mode.py:42).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from voxactb_tpu_torch.envs.base import BimanualEnv, Transition
from voxactb_tpu_torch.sim.backend import ARMS, KinematicBackend, SimBackend
from voxactb_tpu_torch.sim.task import BimanualTask, PlacementError

REWARD_SCALE = 100.0


class InvalidActionError(RuntimeError):
    pass


class TaskEnvironmentError(RuntimeError):
    pass


@dataclass
class SimObservation:
    """Observation2Robots-shaped frame (observation_two_robots.py:5-74) produced by
    the scene; flat per-camera attributes so demos feed fill_replay directly."""

    misc: Dict = field(default_factory=dict)

    def __getattr__(self, item):  # missing camera fields -> clear error
        raise AttributeError(item)


def look_at_extrinsics(eye, target) -> np.ndarray:
    """Camera-to-world 4x4 for a camera at ``eye`` looking at ``target``.

    Frame convention matches RLBench's VisionSensor (vision_sensor.py:155-177 and
    ``pointcloud_from_depth``): +z = optical axis (forward), +x = image right,
    +y = image down; extrinsics columns are those axes in world frame, translation
    is the camera center.
    """
    eye = np.asarray(eye, np.float64)
    forward = np.asarray(target, np.float64) - eye
    forward /= np.linalg.norm(forward) + 1e-12
    up = np.array([0.0, 0.0, 1.0])
    if abs(forward @ up) > 0.99:  # looking straight up/down: pick another up
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, forward)
    right /= np.linalg.norm(right) + 1e-12
    down = np.cross(forward, right)  # completes a proper right-handed rotation
    ext = np.eye(4)
    ext[:3, 0], ext[:3, 1], ext[:3, 2], ext[:3, 3] = right, down, forward, eye
    return ext


class SceneRenderer:
    """Pinhole camera rig over the kinematic scene.

    A real (if minimal) camera model replacing round-1's block splats: every
    camera has true intrinsics K and camera-to-world extrinsics E; object surface
    points are projected through ``K @ inv(E)`` into a z-buffer, and the published
    point cloud is back-projected from the rendered depth with the SAME (K, E) —
    so rgb pixels, depth, and pcd are mutually consistent and consistent with the
    camera parameters in ``misc`` (the property ``fill_replay``/voxelize rely on;
    reference: pyrep/objects/vision_sensor.py:121-177).

    Rig mirrors Scene2Robots' cameras (scene_two_robots.py:57-62): ``front`` is a
    static camera facing the workspace; ``wrist``/``wrist2`` ride the right/left
    gripper, looking at the workspace center from wherever the TCP is.
    """

    FAR = 4.0           # background depth (m)
    BG_COLOR = (110, 110, 110)

    def __init__(self, cameras: Sequence[str], image_size: int, workspace,
                 front_offset=(0.0, -1.0, 0.55)):
        self.cameras = tuple(cameras)
        self.img = int(image_size)
        # surface-sample density per object face scales with resolution so a
        # high-res rig (the reference's add_highres_front_cam_for_llm,
        # environments_two_robots.py:159) renders solid surfaces instead of
        # sparse point splats
        self._obj_m = max(8, self.img // 8)
        self.ws = np.asarray(workspace, np.float64)
        self.center = (self.ws[:3] + self.ws[3:]) / 2.0
        f = float(self.img)  # ~53 deg horizontal FOV
        self.intrinsics = np.array(
            [[f, 0.0, self.img / 2.0], [0.0, f, self.img / 2.0], [0.0, 0.0, 1.0]])
        extent = float(np.max(self.ws[3:] - self.ws[:3]))
        # far enough back that the full workspace fits in the FOV
        off = np.asarray(front_offset, np.float64)
        self._front_eye = self.center + off / np.linalg.norm(off) * (1.3 * extent)

    def camera_extrinsics(self, backend: SimBackend) -> Dict[str, np.ndarray]:
        exts = {}
        for cam in self.cameras:
            # wrist cameras ride the gripper and LOOK AT the end-effector's
            # action zone (a real wrist cam points at the fingers —
            # scene_two_robots.py:57-62 mounts them on the Panda wrists), not
            # at the workspace center: when the TCP is far from the center a
            # center-facing camera misses the manipulation site entirely,
            # which starved the VLM crop of points (median 103, min 1 points
            # in bounds on the hand_over_item replay; probe_replay_ambiguity)
            if cam == "wrist":
                tcp = backend.arm("right").tcp_position
                eye = tcp + np.array([0.06, 0.06, 0.32])
                target = tcp - np.array([0.0, 0.0, 0.05])
            elif cam == "wrist2":
                tcp = backend.arm("left").tcp_position
                eye = tcp + np.array([-0.06, 0.06, 0.32])
                target = tcp - np.array([0.0, 0.0, 0.05])
            else:  # 'front' and any extra static cameras
                eye, target = self._front_eye, self.center
            exts[cam] = look_at_extrinsics(eye, target)
        return exts

    def _scene_points(self, backend: SimBackend):
        """Surface point samples (+colors) of every object, the table, and
        gripper markers at each TCP."""
        pts, cols = [], []

        def cuboid(center, half, color, m=8):
            lin = np.linspace(-1.0, 1.0, m)
            u, v = np.meshgrid(lin, lin, indexing="ij")
            u, v = u.ravel(), v.ravel()
            ones = np.ones_like(u)
            for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)):
                f = np.empty((u.size, 3))
                f[:, axis] = sign * ones
                f[:, (axis + 1) % 3] = u
                f[:, (axis + 2) % 3] = v
                pts.append(center + f * half)
                cols.append(np.broadcast_to(np.asarray(color, np.uint8),
                                            (u.size, 3)))

        # table: only the top face matters visually — one planar sample
        m = 32
        lin = np.linspace(0.0, 1.0, m)
        gx, gy = np.meshgrid(self.ws[0] + lin * (self.ws[3] - self.ws[0]),
                             self.ws[1] + lin * (self.ws[4] - self.ws[1]),
                             indexing="ij")
        table = np.stack([gx.ravel(), gy.ravel(),
                          np.full(m * m, self.ws[2])], -1)
        pts.append(table)
        cols.append(np.broadcast_to(np.asarray((140, 120, 100), np.uint8),
                                    (m * m, 3)))

        for name in backend.object_names():
            obj = backend.get_object(name)
            color = tuple(int(c * 255) for c in obj.color)
            cuboid(obj.position, np.maximum(obj.size / 2, 0.004), color,
                   m=self._obj_m)
        for arm_name in ARMS:
            self._gripper_points(backend.arm(arm_name), arm_name, pts, cols)
        return np.concatenate(pts, 0), np.concatenate(cols, 0)

    @staticmethod
    def _gripper_points(arm, arm_name: str, pts, cols) -> None:
        """Sample a realistic gripper body into the scene: palm + two fingers
        whose separation tracks ``gripper_open`` + a forearm stub, color-coded
        per arm. The reference's cameras see whole Panda grippers
        (scene_two_robots.py camera rig over real meshes); round-3's 1.5 cm TCP
        marker was so small that, at the protocol recipe's 32x32 wrist cameras,
        successive keyframe observations differed by <=2 occupied voxels and
        the replay became unlearnable (tools/probe_replay_ambiguity.py:
        identical inputs with conflicting grip targets on hand_over_item).
        Geometry built in the gripper frame (+z = approach axis, +x = finger
        travel), then rotated by the TCP quaternion."""
        w, x, y, z = (float(arm.tcp_quaternion[3]), float(arm.tcp_quaternion[0]),
                      float(arm.tcp_quaternion[1]), float(arm.tcp_quaternion[2]))
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        color = (40, 40, 220) if arm_name == "right" else (220, 120, 40)
        tcp = arm.tcp_position
        sep = 0.008 + 0.032 * float(arm.gripper_open)  # finger half-separation
        # (center_local, half_extent_local, samples/face)
        parts = [
            (np.array([0.0, 0.0, -0.055]), np.array([0.045, 0.018, 0.022]), 6),
            (np.array([+sep, 0.0, -0.018]), np.array([0.006, 0.009, 0.026]), 4),
            (np.array([-sep, 0.0, -0.018]), np.array([0.006, 0.009, 0.026]), 4),
            (np.array([0.0, 0.0, -0.135]), np.array([0.026, 0.026, 0.055]), 6),
        ]
        for c_local, half, m in parts:
            # rotate a local-frame cuboid: sample axis-aligned, then map
            center = tcp + rot @ c_local
            lin = np.linspace(-1.0, 1.0, m)
            u, v = np.meshgrid(lin, lin, indexing="ij")
            u, v = u.ravel(), v.ravel()
            ones = np.ones_like(u)
            faces = []
            for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)):
                f = np.empty((u.size, 3))
                f[:, axis] = sign * ones
                f[:, (axis + 1) % 3] = u
                f[:, (axis + 2) % 3] = v
                faces.append(f * half)
            local = np.concatenate(faces, 0)
            pts.append(center + local @ rot.T)
            cols.append(np.broadcast_to(
                np.asarray(color, np.uint8), (local.shape[0], 3)))

    def render(self, backend: SimBackend, rng=None) -> Dict[str, np.ndarray]:
        from voxactb_tpu_torch.data.rlbench_format import pointcloud_from_depth

        world, colors = self._scene_points(backend)
        exts = self.camera_extrinsics(backend)
        out = {}
        for cam in self.cameras:
            ext = exts[cam]
            r, c_ = ext[:3, :3], ext[:3, 3]
            cam_pts = (world - c_) @ r  # R^T (x - C): world -> camera frame
            z = cam_pts[:, 2]
            vis = z > 1e-3
            uv = cam_pts[vis, :2] / z[vis, None]
            u = (self.intrinsics[0, 0] * uv[:, 0] + self.intrinsics[0, 2])
            v = (self.intrinsics[1, 1] * uv[:, 1] + self.intrinsics[1, 2])
            ui, vi = u.astype(np.int64), v.astype(np.int64)
            inside = (ui >= 0) & (ui < self.img) & (vi >= 0) & (vi < self.img)
            ui, vi = ui[inside], vi[inside]
            zs = z[vis][inside]
            cs = colors[vis][inside]

            depth = np.full((self.img, self.img), self.FAR, np.float64)
            rgb = np.empty((self.img, self.img, 3), np.uint8)
            rgb[:] = self.BG_COLOR
            # z-buffer: sort far-to-near so the nearest write wins
            order = np.argsort(-zs)
            depth[vi[order], ui[order]] = zs[order]
            rgb[vi[order], ui[order]] = cs[order]

            out[f"{cam}_rgb"] = rgb
            out[f"{cam}_depth"] = depth.astype(np.float32)
            out[f"{cam}_point_cloud"] = pointcloud_from_depth(
                depth.astype(np.float32), ext, self.intrinsics)
            out[f"{cam}_camera_extrinsics"] = ext.astype(np.float32)
            out[f"{cam}_camera_intrinsics"] = self.intrinsics.astype(np.float32)
        return out


_LANG_ENC = None
_LANG_CACHE: Dict[str, tuple] = {}


def default_sim_language_encoder():
    """CLIP text encoding for sim observations, cached per description.
    Reference behavior: launch_utils.py:384-400 CLIP-encodes every
    description with pretrained RN50.

    Weights: when a CLIP checkpoint is on disk
    (``$VOXACTB_WEIGHTS_DIR/clip_rn50.pt``, ``utils/pretrained``), its full
    text tower, as the JAX package's sim does. An unreadable checkpoint
    raises here, where the JAX sim falls back to random weights. Otherwise a
    RANDOM-INIT 2-layer ``ClipTextEncoder`` (real BPE tokenizer +
    transformer, so different descriptions map to different embeddings, but
    NOT semantically meaningful CLIP space), initialised from
    ``torch.Generator().manual_seed(0)``. The JAX package's sim takes the
    same random-init branch, but draws its weights from ``jax.random.key(0)``:
    the two packages' random-init embeddings differ.

    The tower runs on the CPU: it encodes each description once per process
    and its outputs go into the numpy observation dicts the sim hands out.
    """
    def encode(text: str):
        global _LANG_ENC
        if text not in _LANG_CACHE:
            if _LANG_ENC is None:
                from voxactb_tpu_torch.utils.pretrained import load_clip_text

                loaded = load_clip_text(device="cpu")
                _LANG_ENC = _make_text_encoder(None, _LANG_CACHE,
                                               model=None if loaded is None else loaded[0])
            return _LANG_ENC(text)
        return _LANG_CACHE[text]

    return encode


def _make_text_encoder(params, cache: Dict[str, tuple], model=None):
    """A text tower as a cached description -> numpy (sentence, tokens)
    encoder: ``model`` (a loaded ``ClipTextEncoder`` on the CPU), else the
    seeded 2-layer tower, whose weights ``params`` (a flax parameter tree of
    numpy arrays) replaces (``weights.load_flax_params``)."""
    import torch

    from voxactb_tpu_torch.models.clip_text import ClipTextEncoder
    from voxactb_tpu_torch.utils.bpe import SimpleTokenizer

    if model is None:
        model = ClipTextEncoder(layers=2, generator=torch.Generator().manual_seed(0))
        if params is not None:
            from voxactb_tpu_torch.weights import load_flax_params

            load_flax_params(model, params)
    model.eval()
    tok = SimpleTokenizer()

    def encode(text: str):
        if text not in cache:
            tokens = torch.as_tensor(np.asarray(tok.tokenize(text)), dtype=torch.long)
            with torch.inference_mode():
                sent, tok_embs = model(tokens.reshape(1, -1))
            cache[text] = (sent[0].numpy().astype(np.float32),
                           tok_embs[0].numpy().astype(np.float32))
        return cache[text]

    return encode


class BimanualTaskEnvironment(BimanualEnv):
    """One task's session: reset / step / scripted demos / success scoring."""

    def __init__(self, task_cls, backend: Optional[SimBackend] = None,
                 cameras=("wrist", "wrist2"), image_size: int = 32,
                 episode_length: int = 25, seed: int = 0,
                 max_tick_per_action: int = 40, lang_encoder=None,
                 vlm=None):
        self.backend = backend or KinematicBackend(seed)
        self.task: BimanualTask = task_cls(self.backend)
        self.task.init_task()
        self._lang_encoder = lang_encoder or default_sim_language_encoder()
        self._renderer = SceneRenderer(cameras, image_size,
                                       self.backend.workspace)
        self._cameras = tuple(cameras)
        self._episode_length = episode_length
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._variation = 0
        self._step_count = 0
        self._max_tick = max_tick_per_action
        self._launched = False
        self._episode_target_pos = None
        self._episode_auto_radius = None
        # optional VLM: when set, target_object_world_coords() derives the
        # crop point from the RENDERED front camera through this pipeline
        # (scene_two_robots.py:494 get_observation_vlm -> vlm.py:144-194)
        # instead of the backend's ground-truth object position
        self._vlm = vlm
        self._vlm_renderer = None  # built lazily at VLM_CAMERA_RES
        self._episode_vlm_target = None
        self._episode_vlm_radius = None

    # -- lifecycle ----------------------------------------------------------------------

    def launch(self) -> None:
        self._launched = True

    def shutdown(self) -> None:
        self._launched = False

    def set_variation(self, v: int) -> None:
        self._variation = v % self.task.num_variations

    #: episode-placement retries before giving up, mirroring Scene2Robots'
    #: init_episode retry loop on BoundaryError / WaypointError
    #: (scene_two_robots.py's "attempts < self._MAX_RESET_ATTEMPTS" pattern)
    MAX_RESET_ATTEMPTS = 10

    #: resolution of the dedicated VLM front camera (the reference's
    #: add_highres_front_cam_for_llm boots a separate high-res front camera
    #: just for the VLM, environments_two_robots.py:159)
    VLM_CAMERA_RES = 256

    def reset(self) -> Dict:
        self._step_count = 0
        # the VLM-tagged object position is computed ONCE per episode and
        # cached for every subsequent frame (scene_two_robots.py:319 resets it
        # to None, :585 'if self.target_object_pos is None' latches it on the
        # first observation). Tracking the object per-frame instead poisons
        # training: open_drawer's handle moves ~20 cm when pulled, so the pull
        # keyframe's crop bounds — and with them the discretized trans target —
        # would recenter on the PULLED handle while eval crops once at episode
        # start (rollout_generator.py:213-216), teaching the policy to decode
        # the grasp position where the pull belongs (diagnosed round 4 with
        # tools/probe_hybrid_inputs.py: dt=17 voxels = exactly the pull
        # distance, sign flipping with episode orientation).
        self._episode_target_pos = None
        self._episode_auto_radius = None
        self._episode_vlm_target = None
        self._episode_vlm_radius = None
        self.backend.reset_arms()
        last_err = None
        for _ in range(self.MAX_RESET_ATTEMPTS):
            try:
                self._descriptions = self.task.init_episode(
                    self._variation, self._rng)
                return self._observation_dict()
            except PlacementError as e:
                # placement sampling failed (e.g. sample_disjoint_position
                # exhausted its draws) — resample the episode with fresh noise
                last_err = e
        raise TaskEnvironmentError(
            f"{self.task.name}: init_episode failed after "
            f"{self.MAX_RESET_ATTEMPTS} attempts") from last_err

    def reset_to_demo(self, demo_index: int) -> Dict:
        self._rng = np.random.default_rng(self._seed + demo_index)
        self.set_variation(demo_index)
        return self.reset()

    # -- stepping (action mode semantics) --------------------------------------------

    def step(self, action, which_arm: str) -> Transition:
        action = np.asarray(action, np.float64)
        arm = {"dominant": self.task.dominant_arm(),
               "assistive": "left" if self.task.dominant_arm() == "right"
               else "right"}.get(which_arm, which_arm)

        pos, quat, grip = action[:3], action[3:7], float(action[7])
        ignore_collisions = bool(action[8]) if action.shape[-1] > 8 else False
        ws = self.backend.workspace
        if np.any(pos < ws[:3]) or np.any(pos > ws[3:]):
            # workspace bound check (arm_action_modes.py:324)
            raise InvalidActionError(
                f"target {pos} outside workspace bounds {ws}")

        # plan a path with collision checking; on failure fall back to planning
        # without it (arm_action_modes.py:388-418's try/except semantics). The
        # object this arm is holding rides the TCP and is never an obstacle.
        waypoints = [pos]
        if not ignore_collisions:
            from voxactb_tpu_torch.sim.planning import plan_path

            obstacles = [
                o.aabb() for name in self.backend.object_names()
                for o in [self.backend.get_object(name)]
                if o.grasped_by != arm
            ]
            planned = plan_path(self.backend.arm(arm).tcp_position, pos,
                                obstacles)
            if planned is not None:
                waypoints = planned

        # stepped path execution loop (arm_action_modes.py:425-435)
        for wp in waypoints:
            for _ in range(self._max_tick):
                reached = self.backend.move_arm_towards(
                    arm, wp, quat, max_step=0.05)
                self.backend.step()
                if reached:
                    break
        self.backend.set_gripper(arm, grip)
        self.backend.step()

        self._step_count += 1
        if getattr(self.backend, "arm_collision", False):
            # arm-arm proximity is an episode-ending failure: the dynamics-free
            # backend cannot push arms apart, so treating contact as terminal
            # keeps success rates honest (CoppeliaSim would report a collision)
            return Transition(
                self._observation_dict(), 0.0, True,
                info={"success": False, "arm_collision": True},
            )
        success = self.task.success()
        timeout = self._step_count >= self._episode_length
        return Transition(
            self._observation_dict(),
            REWARD_SCALE if success else 0.0,
            success or timeout,
            info={"success": success},
        )

    # -- observations -------------------------------------------------------------------

    def _frame(self, velocities: Optional[Dict[str, float]] = None
               ) -> SimObservation:
        """One Observation2Robots-shaped frame from current backend state."""
        o = SimObservation()
        cams = self._renderer.render(self.backend)
        for cam in self._cameras:
            setattr(o, f"{cam}_rgb", cams[f"{cam}_rgb"])
            setattr(o, f"{cam}_depth", cams[f"{cam}_depth"])
            setattr(o, f"{cam}_point_cloud", cams[f"{cam}_point_cloud"])
            o.misc[f"{cam}_camera_extrinsics"] = cams[f"{cam}_camera_extrinsics"]
            o.misc[f"{cam}_camera_intrinsics"] = cams[f"{cam}_camera_intrinsics"]
        for arm in ARMS:
            a = self.backend.arm(arm)
            vel = (velocities or {}).get(arm, a.joint_velocity_norm)
            setattr(o, f"gripper_{arm}_pose",
                    np.concatenate([a.tcp_position, a.tcp_quaternion]).astype(
                        np.float32))
            setattr(o, f"gripper_{arm}_open", float(a.gripper_open > 0.5))
            setattr(o, f"gripper_{arm}_joint_positions",
                    np.full(2, 0.04 * a.gripper_open, np.float32))
            setattr(o, f"joint_velocities_{arm}", np.full(7, vel, np.float32))
            setattr(o, f"joint_positions_{arm}", np.zeros(7, np.float32))
        o.ignore_collisions = 1.0
        target = self.task.target_object_name()
        if target and getattr(self.backend, "has_object", lambda n: False)(target):
            if self._episode_target_pos is None:
                # latch at the first frame of the episode (see reset())
                self._episode_target_pos = self.backend.get_object(
                    target).position.astype(np.float32).copy()
                # reference auto radius = largest object dim + 5cm padding
                # (vlm.py:182-192 — the full dim, not the half-extent)
                self._episode_auto_radius = float(
                    self.backend.get_object(target).size.max() + 0.05)
            o.target_object_pos = self._episode_target_pos
            o.auto_crop_radius = self._episode_auto_radius
        return o

    def _observation_dict(self) -> Dict:
        """Policy-facing dict (what the rollout/agents consume)."""
        o = self._frame()
        obs: Dict = {}
        for cam in self._cameras:
            obs[f"{cam}_rgb"] = getattr(o, f"{cam}_rgb")[None]
            obs[f"{cam}_point_cloud"] = getattr(o, f"{cam}_point_cloud")[None]
            obs[f"{cam}_camera_extrinsics"] = o.misc[
                f"{cam}_camera_extrinsics"][None]
            obs[f"{cam}_camera_intrinsics"] = o.misc[
                f"{cam}_camera_intrinsics"][None]
        t = self._step_count
        time_ch = (1.0 - t / max(1, self._episode_length - 1)) * 2.0 - 1.0
        right = np.array([o.gripper_right_open,
                          *o.gripper_right_joint_positions, time_ch, 0.0],
                         np.float32)
        left = np.array([o.gripper_left_open,
                         *o.gripper_left_joint_positions, time_ch], np.float32)
        obs["low_dim_state_right_arm"] = right[None]
        obs["low_dim_state_left_arm"] = left[None]
        obs["low_dim_state"] = np.concatenate([left[:3], right]).astype(
            np.float32)[None]
        obs["gripper_right_pose"] = o.gripper_right_pose
        obs["gripper_left_pose"] = o.gripper_left_pose
        obs["lang_goal"] = self._descriptions[0]
        sent, tok = self._lang_encoder(self._descriptions[0])
        obs["lang_goal_emb"] = sent
        obs["lang_token_embs"] = tok
        return obs

    def preposition_step(self, action, which_arm: str) -> Transition:
        """VoxPoser prologue motion: moves arms but does not consume the learned
        policy's episode budget (envs/base.py contract)."""
        count = self._step_count
        try:
            return self.step(action, which_arm)
        finally:
            self._step_count = count

    # -- VoxAct-B hooks -------------------------------------------------------------------

    @property
    def task_name(self) -> str:
        return type(self.task).__name__

    def target_object_world_coords(self):
        name = self.task.target_object_name()
        if name is None:
            return None
        if self._vlm is not None:
            # pixels-derived crop point, computed ONCE per episode from a
            # DEDICATED high-res front render (the reference boots an extra
            # high-res front camera just for the VLM —
            # environments_two_robots.py:159 add_highres_front_cam_for_llm —
            # and runs the crop from it, scene_two_robots.py:494 +
            # rollout_generator.py:213-216). The detector's perception error
            # (resolution, occlusion, surface-vs-center centroid bias)
            # propagates into the policy eval; no ground truth is consulted.
            if self._episode_vlm_target is None:
                if self._vlm_renderer is None:
                    # steeper viewpoint than the policy's front camera: the
                    # drawer handles hang on the cabinet's +-y sides, and at
                    # the policy camera's 29-degree depression the far-side
                    # handle is fully occluded by the cabinet body
                    self._vlm_renderer = SceneRenderer(
                        ("front",), self.VLM_CAMERA_RES,
                        self.backend.workspace,
                        front_offset=(0.0, -0.7, 1.0))
                cams = self._vlm_renderer.render(self.backend)
                point, radius = self._vlm.get_target_object_world_coords(
                    cams["front_rgb"], cams["front_point_cloud"],
                    self.task.name)
                self._episode_vlm_target = np.asarray(point, np.float32)
                self._episode_vlm_radius = float(radius)
            return self._episode_vlm_target.copy()
        if self._episode_target_pos is not None:
            # the episode-latched position (see reset()) — the same value every
            # stored frame carries, so eval-time crop bounds match training's
            return self._episode_target_pos.copy()
        return self.backend.get_object(name).position.copy()

    def auto_crop_radius(self) -> float:
        name = self.task.target_object_name()
        if name is None:
            return 0.0
        if self._vlm is not None and self._episode_vlm_radius is not None:
            # measured from the detected mask's extents (vlm.py:182-192)
            return self._episode_vlm_radius
        if self._episode_auto_radius is not None:
            return self._episode_auto_radius
        return float(self.backend.get_object(name).size.max() / 2 + 0.05)

    def dominant_arm(self) -> str:
        return self.task.dominant_arm()

    @property
    def env_language_goal(self) -> str:
        return self._descriptions[0]

    @property
    def episode_length(self) -> int:
        return self._episode_length

    # -- scripted demos (scene_two_robots.py:793-2800 machinery) --------------------------

    def get_demo(self, demo_index: int) -> Tuple[List[SimObservation], List[str]]:
        """Record one scripted bimanual demo: walk the task's labeled waypoints,
        emitting a frame per control tick (arms rest at waypoints -> keyframes)."""
        self.reset_to_demo(demo_index)
        frames = [self._frame(velocities={"right": 1.0, "left": 1.0})]
        for wp in self.task.get_waypoints(self.task.dominant_arm()):
            reached = False
            for _ in range(self._max_tick):
                reached = self.backend.move_arm_towards(
                    wp.arm, wp.position, wp.quaternion, max_step=0.05)
                self.backend.step()
                frames.append(self._frame())
                if reached:
                    break
            if wp.gripper_open is not None:
                self.backend.set_gripper(wp.arm, wp.gripper_open)
            for _ in range(wp.dwell):
                self.backend.step()
                frames.append(self._frame(velocities={wp.arm: 0.0}))
        return frames, list(self._descriptions)

    def get_demos(self, amount: int, start_index: int = 0):
        return [self.get_demo(start_index + i) for i in range(amount)]


class SimEnvironment:
    """Environment2Robots counterpart: boots a backend and vends task sessions."""

    def __init__(self, cameras=("wrist", "wrist2"), image_size: int = 32,
                 episode_length: int = 25, seed: int = 0, headless: bool = True,
                 lang_encoder=None):
        self._kw = dict(cameras=cameras, image_size=image_size,
                        episode_length=episode_length, seed=seed,
                        lang_encoder=lang_encoder)
        self._launched = False

    def launch(self) -> None:
        self._launched = True

    def shutdown(self) -> None:
        self._launched = False

    def get_task(self, task_cls) -> BimanualTaskEnvironment:
        if isinstance(task_cls, str):
            from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

            task_cls = TASK_REGISTRY[task_cls]
        env = BimanualTaskEnvironment(task_cls, **self._kw)
        env.launch()
        return env
