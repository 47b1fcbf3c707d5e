"""Heuristic keyframe discovery from demonstrations.

Behavioral counterpart of peract/helpers/demo_loading_utils.py:8-331
(``_is_stopped`` :8, ``_is_stopped_2arms`` :33, ``keypoint_discovery`` :63,
``keypoint_discovery_no_duplicate`` :228). A keyframe is a timestep where the arm's
gripper state flips, the episode ends, or the arm has come to rest (joint velocities
~0) outside a cooldown window. The reference's five near-duplicate code paths collapse
to one scanner parameterized by arm mode.

Works on any sequence of observations exposing ``gripper_{right,left}_open``,
``joint_velocities_{right,left}`` and (for the no-duplicate variant)
``gripper_{right,left}_pose`` — e.g. ``BimanualObservation`` or unpickled RLBench demos.

Stop-buffer defaults are behavioral constants from the reference: 4 steps for the
dominant/right arm, 12 for the assistive/left arm (demo_loading_utils.py:88-97).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

RIGHT, LEFT = 0, 1


@dataclass
class KeypointConfig:
    stopping_delta: float = 0.1
    method: str = "heuristic"
    saved_every_last_inserted: int = 0
    use_default_stopped_buffer_timesteps: bool = False
    stopped_buffer_timesteps_overwrite: int = 0
    no_duplicate: bool = False


def _arm_fields(obs, arm: str):
    if arm == "right":
        return obs.gripper_right_open, obs.joint_velocities_right
    return obs.gripper_left_open, obs.joint_velocities_left


def _gripper_no_change(demo, i, arm: str) -> bool:
    """Gripper state stable across i-2..i+1 (demo_loading_utils.py:12-16).

    At i < 2 the indices i-1 / i-2 wrap to the demo's LAST frames — the
    reference evaluates them with Python negative indexing, so exact parity
    keeps the wrap (a demo resting at frames 0-1 whose gripper matches its
    final frames counts as 'no change' there)."""
    if i >= len(demo) - 2:
        return False
    cur = _arm_fields(demo[i], arm)[0]
    return (
        cur == _arm_fields(demo[i + 1], arm)[0]
        and cur == _arm_fields(demo[i - 1], arm)[0]
        and _arm_fields(demo[i - 2], arm)[0] == _arm_fields(demo[i - 1], arm)[0]
    )


def _stopped(demo, i, arm: str, buffer: int, delta: float) -> bool:
    next_is_not_final = i == (len(demo) - 2)
    vel = _arm_fields(demo[i], arm)[1]
    small = vel is not None and np.allclose(vel, 0, atol=delta)
    return (
        buffer <= 0 and small and not next_is_not_final
        and _gripper_no_change(demo, i, arm)
    )


def _buffer_timesteps(arm_for_buffer: str, cfg: KeypointConfig) -> int:
    # ``use_default_stopped_buffer_timesteps`` only takes effect in the
    # dominant/assistive scanner (handled inline there); single-arm 'left' always
    # uses 12 in the reference (demo_loading_utils.py:88-97)
    if cfg.stopped_buffer_timesteps_overwrite:
        return cfg.stopped_buffer_timesteps_overwrite
    return 12 if arm_for_buffer == "left" else 4


def keypoint_discovery(
    demo: Sequence,
    which_arm: str = "right",
    dominant_assistive_arm: str = "",
    cfg: Optional[KeypointConfig] = None,
):
    """Find keyframe indices (and arm labels for multi-arm modes).

    Returns ``List[int]`` for single-arm modes ('right'/'left'), or
    ``(List[int], List[int])`` with labels 0=right / 1=left for 'both', 'multiarm',
    'dominant' and 'assistive' — matching the reference's return shapes.
    """
    cfg = cfg or KeypointConfig()
    if cfg.method != "heuristic":
        raise NotImplementedError(f"keypoint method {cfg.method!r}")

    single = which_arm in ("right", "left")
    da_mode = which_arm in ("dominant", "assistive")
    if da_mode and dominant_assistive_arm not in ("right", "left"):
        raise ValueError("dominant/assistive mode needs dominant_assistive_arm")

    # which arms we scan and which arm's buffer constant each uses
    if single:
        arms = [which_arm]
        buf_for = {which_arm: which_arm}
    elif da_mode:
        arms = ["right", "left"]
        # the tracked arm uses the mode-dependent constant: dominant -> 4, assistive
        # -> 12 (demo_loading_utils.py:88-97); both scanners share it in the reference
        shared = (
            cfg.stopped_buffer_timesteps_overwrite
            or (4 if (which_arm == "dominant"
                      or cfg.use_default_stopped_buffer_timesteps) else 12)
        )
        buf_for = None
    else:  # both / multiarm
        arms = ["right", "left"]
        buf_for = {"right": "right",
                   "left": "left" if which_arm == "multiarm" else "right"}

    buffers = {a: 0 for a in arms}
    keypoints: List[int] = []
    labels: List[int] = []
    prev_open = {a: _arm_fields(demo[0], a)[0] for a in arms}
    prev_pose = {}
    if cfg.no_duplicate and da_mode:
        tracked = dominant_assistive_arm
        prev_pose[tracked] = getattr(demo[0], f"gripper_{tracked}_pose")
    last_inserted_counter = 0

    for i, obs in enumerate(demo):
        stopped = {}
        for a in arms:
            if da_mode:
                bts = shared
            else:
                bts = _buffer_timesteps(buf_for[a], cfg)
            stopped[a] = _stopped(demo, i, a, buffers[a], cfg.stopping_delta)
            buffers[a] = bts if stopped[a] else buffers[a] - 1

        last = i == len(demo) - 1

        def event(a):
            return (
                _arm_fields(obs, a)[0] != prev_open[a] or last or stopped[a]
            )

        if single:
            a = which_arm
            if i != 0 and event(a):
                keypoints.append(i)
                last_inserted_counter = 0
            else:
                last_inserted_counter += 1
            # periodic keyframes for contact-rich tasks (demo_loading_utils.py:186-190)
            if (a == "right" and cfg.saved_every_last_inserted > 0
                    and last_inserted_counter >= cfg.saved_every_last_inserted):
                keypoints.append(i)
                last_inserted_counter = 0
        elif da_mode:
            a = dominant_assistive_arm
            if cfg.no_duplicate and i != 0 and np.allclose(
                getattr(obs, f"gripper_{a}_pose"), prev_pose[a], atol=1e-3
            ):
                # reference parity (demo_loading_utils.py:274-279): the skip
                # does NOT refresh prev_open, so a gripper flip at a stationary
                # pose stays pending and is emitted at the arm's next movement
                # (e.g. hand-over release-then-retreat)
                continue
            if i != 0 and event(a):
                keypoints.append(i)
                labels.append(RIGHT if a == "right" else LEFT)
                if cfg.no_duplicate:
                    prev_pose[a] = getattr(obs, f"gripper_{a}_pose")
        else:  # both / multiarm: either arm's event makes a keyframe; right wins ties
            if i != 0 and (event("right") or event("left")):
                labels.append(RIGHT if event("right") else LEFT)
                keypoints.append(i)

        prev_open = {a: _arm_fields(obs, a)[0] for a in arms}

    # drop the second-to-last keypoint when it's adjacent to the last
    # (demo_loading_utils.py:115-118)
    if len(keypoints) > 1 and keypoints[-1] - 1 == keypoints[-2]:
        keypoints.pop(-2)
        if labels:
            labels.pop(-2)

    if single:
        return keypoints
    return keypoints, labels
