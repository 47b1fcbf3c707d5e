"""Reader for the RLBench two-robot demo storage format.

Format (rlbench/utils.py:41-280 + tools/dataset_generator_two_robots.py): per episode a
folder ``<root>/<task>/variation<k>/episodes/episode<i>/`` holding
``low_dim_obs.pkl`` (pickled Demo of Observation2Robots), ``variation_descriptions.pkl``
and per-camera PNG folders (``wrist_rgb/``, ``wrist_depth/`` ... ``front_mask/``).
Depth PNGs encode a fixed-point float in 24-bit RGB with ``DEPTH_SCALE = 2^24 - 1``
(rlbench/backend/const.py:34, backend/utils.py:168), converted to meters via the
per-camera near/far planes stored in ``obs.misc``, and unprojected to world-frame
clouds with the camera intrinsics/extrinsics
(PyRep/pyrep/objects/vision_sensor.py:155-177).

Unpickling does NOT import rlbench: a permissive unpickler materializes any missing
class as a plain attribute container, so reference-generated datasets load without the
reference installed.
"""

from __future__ import annotations

import io
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

DEPTH_SCALE = 2 ** 24 - 1
LOW_DIM_PICKLE = "low_dim_obs.pkl"
VARIATION_DESCRIPTIONS = "variation_descriptions.pkl"
VARIATIONS_FOLDER = "variation%d"
EPISODES_FOLDER = "episodes"
IMAGE_FORMAT = "%d.png"


class _Stub:
    """Attribute container standing in for any unpicklable reference class."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _PermissiveUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,), {"__module__": module})


def permissive_load(path: str):
    with open(path, "rb") as f:
        return _PermissiveUnpickler(io.BytesIO(f.read())).load()


def decode_depth_rgb(depth_rgb: np.ndarray, scale: float = DEPTH_SCALE) -> np.ndarray:
    """24-bit RGB-coded fixed point -> float in [0, 1] (backend/utils.py:168-186)."""
    d = depth_rgb.astype(np.int64)
    return ((d[..., 0] * 256 * 256 + d[..., 1] * 256 + d[..., 2])
            / float(scale)).astype(np.float32)


def encode_depth_rgb(depth01: np.ndarray, scale: float = DEPTH_SCALE) -> np.ndarray:
    """Inverse of :func:`decode_depth_rgb` (for writing datasets/test fixtures)."""
    v = np.round(np.clip(depth01, 0, 1) * scale).astype(np.int64)
    return np.stack([v // (256 * 256) % 256, v // 256 % 256, v % 256],
                    -1).astype(np.uint8)


def pointcloud_from_depth(depth_m: np.ndarray, extrinsics: np.ndarray,
                          intrinsics: np.ndarray) -> np.ndarray:
    """Depth (meters) -> world-frame point cloud [H, W, 3].

    Same math as ``pointcloud_from_depth_and_camera_params``
    (vision_sensor.py:155-177): back-project homogeneous pixel coords scaled by depth
    through the inverse of ``K @ [R^T | -R^T C]``.
    """
    h, w = depth_m.shape
    u = np.arange(w, dtype=np.float64)[None, :].repeat(h, 0)
    v = np.arange(h, dtype=np.float64)[:, None].repeat(w, 1)
    upc = np.stack([u, v, np.ones_like(u)], -1)
    pc = upc * depth_m[..., None].astype(np.float64)

    C = extrinsics[:3, 3:4]
    R = extrinsics[:3, :3]
    world_to_cam = np.concatenate([R.T, -R.T @ C], -1)  # [3,4]
    proj = intrinsics @ world_to_cam
    proj_h = np.concatenate([proj, [[0.0, 0.0, 0.0, 1.0]]], 0)
    inv = np.linalg.inv(proj_h)[:3]  # [3,4]

    pix_h = np.concatenate([pc, np.ones((h, w, 1))], -1)  # [H,W,4]
    world = np.einsum("ij,hwj->hwi", inv, pix_h)
    return world.astype(np.float32)


@dataclass
class LoadedDemo:
    observations: List  # attribute containers with the Observation2Robots fields
    descriptions: List[str]
    variation: int
    path: str
    dominant_arm: Optional[str] = None  # ground truth when the source knows it


class DemoReader:
    """Load stored bimanual demos with decoded images and world-frame clouds."""

    def __init__(self, dataset_root: str, cameras: Sequence[str] = ("wrist", "wrist2"),
                 load_images: bool = True):
        self._root = dataset_root
        self._cameras = tuple(cameras)
        self._load_images = load_images

    def episode_dirs(self, task_name: str, variation: int = 0) -> List[str]:
        """Episode folders for one variation, or all variations when -1
        (rlbench/utils.py:53-64 'all variations' mode)."""
        task_root = os.path.join(self._root, task_name)
        if variation == -1:
            if not os.path.isdir(task_root):
                raise RuntimeError(f"Can't find demos for {task_name} at "
                                   f"{task_root}")
            out = []
            for v in sorted(d for d in os.listdir(task_root)
                            if d.startswith("variation")):
                base = os.path.join(task_root, v, EPISODES_FOLDER)
                if os.path.isdir(base):
                    out += [os.path.join(base, e) for e in sorted(
                        (d for d in os.listdir(base) if d.startswith("episode")),
                        key=lambda s: int(s.replace("episode", "") or 0))]
            return out
        base = os.path.join(task_root, VARIATIONS_FOLDER % variation,
                            EPISODES_FOLDER)
        if not os.path.isdir(base):
            raise RuntimeError(f"Can't find demos for {task_name} at {base}")
        eps = sorted((d for d in os.listdir(base) if d.startswith("episode")),
                     key=lambda s: int(s.replace("episode", "") or 0))
        return [os.path.join(base, e) for e in eps]

    def load(self, task_name: str, amount: int = -1, variation: int = 0,
             from_episode: int = 0) -> List[LoadedDemo]:
        """rlbench/utils.py:41 ``get_stored_demos`` with deterministic selection."""
        dirs = self.episode_dirs(task_name, variation)
        if amount != -1:
            dirs = dirs[from_episode:from_episode + amount]
            if len(dirs) < amount:
                raise RuntimeError(
                    f"asked for {amount} episodes, found {len(dirs)}")
        return [self.load_episode(d, variation) for d in dirs]

    def load_episode(self, episode_dir: str, variation: int = 0) -> LoadedDemo:
        demo = permissive_load(os.path.join(episode_dir, LOW_DIM_PICKLE))
        observations = list(getattr(demo, "_observations", demo))

        desc_path = os.path.join(episode_dir, VARIATION_DESCRIPTIONS)
        descriptions = (permissive_load(desc_path) if os.path.exists(desc_path)
                        else ["unknown task description"])

        if self._load_images:
            self._attach_images(episode_dir, observations)
        return LoadedDemo(observations, list(descriptions), variation, episode_dir)

    def _attach_images(self, episode_dir: str, observations: List) -> None:
        from PIL import Image

        for i, obs in enumerate(observations):
            fname = IMAGE_FORMAT % i
            for cam in self._cameras:
                rgb_p = os.path.join(episode_dir, f"{cam}_rgb", fname)
                depth_p = os.path.join(episode_dir, f"{cam}_depth", fname)
                pcd_p = os.path.join(episode_dir, f"{cam}_pcd", f"{i}.npy")
                if os.path.exists(rgb_p):
                    setattr(obs, f"{cam}_rgb", np.asarray(Image.open(rgb_p)))
                if os.path.exists(pcd_p):
                    # direct point-cloud storage (tools/dataset_generator.py)
                    setattr(obs, f"{cam}_point_cloud",
                            np.load(pcd_p).astype(np.float32))
                elif os.path.exists(depth_p):
                    depth01 = decode_depth_rgb(np.asarray(Image.open(depth_p)))
                    misc = getattr(obs, "misc", {})
                    near = misc.get(f"{cam}_camera_near", 0.0)
                    far = misc.get(f"{cam}_camera_far", 1.0)
                    depth_m = near + depth01 * (far - near)
                    setattr(obs, f"{cam}_depth", depth_m)
                    ext = misc.get(f"{cam}_camera_extrinsics")
                    intr = misc.get(f"{cam}_camera_intrinsics")
                    if ext is not None and intr is not None:
                        setattr(obs, f"{cam}_point_cloud",
                                pointcloud_from_depth(depth_m, np.asarray(ext),
                                                      np.asarray(intr)))


class RealWorldDemoReader(DemoReader):
    """Real-robot recorded demos (rlbench/utils.py:281 ``get_stored_real_world_demos``).

    Differences from sim datasets: a single ``front`` RealSense camera, depth PNGs
    store RAW sensor depth (uint16 millimeters — no 24-bit sim recode), and there is
    no camera misc block — deprojection happens later against the live RealSense
    intrinsics (eval_real.py:167), so depth is attached in meters and no point cloud
    is synthesized here.
    """

    def __init__(self, dataset_root: str, depth_scale: float = 1000.0):
        super().__init__(dataset_root, cameras=("front",), load_images=True)
        self._depth_scale = depth_scale

    def _attach_images(self, episode_dir: str, observations: List) -> None:
        from PIL import Image

        for i, obs in enumerate(observations):
            fname = IMAGE_FORMAT % i
            rgb_p = os.path.join(episode_dir, "front_rgb", fname)
            depth_p = os.path.join(episode_dir, "front_depth", fname)
            if os.path.exists(rgb_p):
                obs.front_rgb = np.asarray(Image.open(rgb_p))
            if os.path.exists(depth_p):
                raw = np.asarray(Image.open(depth_p))
                obs.front_depth = raw.astype(np.float32) / self._depth_scale
