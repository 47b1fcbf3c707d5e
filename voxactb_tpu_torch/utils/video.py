"""Episode video capture.

Counterpart of YARR's ``TaskRecorder`` + ``CircleCameraMotion``
(yarr/utils/video_utils.py:1-74): collect frames during eval episodes, save a clip
per episode. Frames come from any callable (an env camera, the sim renderer, a
rotating virtual viewpoint); encoding uses imageio when available, else .npz.

A copy of ``voxactb_tpu.utils.video``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List

import numpy as np


class CircleCameraMotion:
    """Yields azimuth angles stepping around the scene (video_utils.py:10-30)."""

    def __init__(self, origin, radius: float = 1.2, height: float = 1.4,
                 speed_deg: float = 6.0):
        self.origin = np.asarray(origin, np.float32)
        self.radius = radius
        self.height = height
        self.speed = np.deg2rad(speed_deg)
        self._angle = 0.0

    def step(self) -> np.ndarray:
        self._angle += self.speed
        return self.origin + np.array([
            self.radius * np.cos(self._angle),
            self.radius * np.sin(self._angle),
            self.height,
        ], np.float32)


class TaskRecorder:
    def __init__(self, frame_fn: Callable[[], np.ndarray], fps: int = 30):
        self._frame_fn = frame_fn
        self._fps = fps
        self._frames: List[np.ndarray] = []

    def take_snap(self) -> None:
        self._frames.append(np.asarray(self._frame_fn()).astype(np.uint8))

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not self._frames:
            raise RuntimeError("no frames recorded")
        try:
            import imageio.v2 as imageio
        except ImportError:
            imageio = None
        if imageio is not None:
            out = path if path.endswith(".mp4") else path + ".mp4"
            try:
                imageio.mimwrite(out, self._frames, fps=self._fps)
                self._frames.clear()
                return out
            except Exception as e:
                # encoder unavailable (no ffmpeg plugin installed) or
                # died mid-write: never leave a truncated .mp4 masquerading
                # as the recording; fall back to raw frames, loudly
                if os.path.exists(out):
                    os.remove(out)
                logging.warning("mp4 encode failed (%s: %s); saving raw "
                                "frames instead", type(e).__name__, e)
        out = (path[:-4] if path.endswith(".mp4") else path) + ".npz"
        np.savez_compressed(out, frames=np.stack(self._frames), fps=self._fps)
        self._frames.clear()
        return out
