"""SE(3) data augmentation for point clouds + keyframe actions, on the device.

Counterpart of ``voxactb_tpu.ops.augmentation`` (itself the behavioural twin of
``apply_se3_augmentation``, peract/voxel/augmentation.py:68-185, and its
two-robot variant :187-348), as one vectorised program:

- draw ``num_candidates`` i.i.d. perturbations per batch element up front;
- discretize all of them at once;
- pick each element's FIRST in-bounds RANDOM candidate;
- candidate slot 0 is a reserved identity fallback: an element whose random
  draws are all out of bounds degrades to "no augmentation".

Out-of-bounds detection matches the reference: ``point_to_voxel_index`` clamps
only from above, so a negative floor index is the only rejection signal.

Sampling (``sample_candidates``, from an explicit ``torch.Generator``) is split
from application (``apply_se3_candidates``), because torch and JAX random
streams cannot match: a test hands both packages the same candidates.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from voxactb_tpu_torch.ops import geometry as G
from voxactb_tpu_torch.ops.voxelize import reciprocal

MIN_DENOMINATOR = 1e-12


class Se3AugConfig(NamedTuple):
    """Knobs from PERACT_BC.yaml:48-52 (aug_xyz / aug_rpy / resolution)."""

    trans_range: tuple = (0.125, 0.125, 0.125)  # fraction of scene bounds per axis
    rot_range_deg: tuple = (0.0, 0.0, 45.0)     # +/- degrees per axis
    rot_resolution_deg: int = 5                  # discrete augmentation rotation steps
    num_candidates: int = 16                     # vectorized rejection-sampling width


def _unclamped_voxel_floor(point: torch.Tensor, voxel_size: int,
                           bounds: torch.Tensor) -> torch.Tensor:
    """floor bin index WITHOUT lower clamp: negative => out of bounds (reject).
    ``/ (N + 1e-12)`` is the compiled JAX program's multiplication by the f32
    reciprocal of N, which keeps the indices exact against it."""
    bb_mins = bounds[..., 0:3]
    res = (bounds[..., 3:6] - bb_mins) * reciprocal(voxel_size)
    idx = torch.floor((point - bb_mins) / (res + MIN_DENOMINATOR)).to(torch.int32)
    return torch.clamp(idx, max=voxel_size - 1)


def draw_rows(draw, b: int, rows: Optional[Tuple[int, int]] = None, axis: int = 0):
    """``draw(n)`` for the whole batch, then this call's ``b`` rows along
    ``axis``: ``rows = (offset, total)`` places them in a global batch of
    ``total`` (a data-parallel rank draws what the one-process step draws and
    keeps its own rows); None: the batch is the whole batch."""
    if rows is None:
        return draw(b)
    offset, total = rows
    return draw(total).narrow(axis, offset, b)


def sample_candidates(generator: Optional[torch.Generator], cfg: Se3AugConfig,
                      bounds: torch.Tensor, b: int,
                      rows: Optional[Tuple[int, int]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[K, B, 3]`` translation shifts + ``[K, B, 3, 3]`` rotation matrices on
    ``bounds``' device; slot 0 = identity. ``generator`` lives on that device;
    ``rows`` as ``draw_rows``'."""
    k = cfg.num_candidates
    dev = bounds.device
    f32 = torch.float32
    trans_range = (bounds[:, 3:6] - bounds[:, 0:3]) * torch.tensor(
        cfg.trans_range, dtype=f32, device=dev)
    rand = lambda n: torch.rand((k, n, 3), generator=generator, device=dev,  # noqa: E731
                                dtype=f32)
    u = draw_rows(rand, b, rows, axis=1) * 2.0 - 1.0
    trans = trans_range[None] * u

    # discrete rotation steps at the augmentation resolution (augmentation.py:128-141)
    steps = torch.tensor([int(r // cfg.rot_resolution_deg) for r in cfg.rot_range_deg],
                         dtype=f32, device=dev)
    # uniform integers in [-steps, steps], per axis
    draw = torch.floor(draw_rows(rand, b, rows, axis=1) * (2.0 * steps + 1.0)) - steps
    draw = torch.minimum(draw, steps)
    euler_rad = draw * cfg.rot_resolution_deg * (math.pi / 180.0)
    # the reference composes Rx(roll)@Ry(pitch)@Rz(yaw) (pytorch3d
    # euler_angles_to_matrix(.., "XYZ"), augmentation.py:142), which equals
    # transpose(Rz(-yaw)@Ry(-pitch)@Rx(-roll))
    rot = G.euler_xyz_to_rotmat(-euler_rad).transpose(-1, -2)

    trans = torch.cat([torch.zeros((1, b, 3), dtype=f32, device=dev), trans[1:]], 0)
    eye = torch.eye(3, dtype=f32, device=dev).expand(1, b, 3, 3)
    return trans, torch.cat([eye, rot[1:]], 0)


def _perturb_pose(gripper_pose, trans_shift, rot_mat):
    """Keyframe pose [B,7] (xyz + xyzw quat) -> perturbed (trans [K,B,3], quat
    [K,B,4]): rotate the gripper frame about itself, then translate
    (R_new = R_g @ R_shift; t_new = t_g + t_shift, augmentation.py:146-148)."""
    t_g = gripper_pose[:, :3]
    r_g = G.quat_to_rotmat(gripper_pose[:, 3:7])
    r_new = torch.einsum("bij,kbjl->kbil", r_g, rot_mat)
    t_new = t_g[None] + trans_shift
    quat = G.canonicalize_quaternion(G.rotmat_to_quat(r_new))
    return t_new, quat


class Se3AugResult(NamedTuple):
    trans_indices: torch.Tensor      # [B, 3] int32
    rot_grip_indices: torch.Tensor   # [B, 4] int32 (3 rot bins + grip bit)
    pcds: tuple                      # perturbed point clouds, same shapes as input
    # two-robot extras (None in single-arm mode)
    trans_indices_left: Optional[torch.Tensor] = None
    rot_grip_indices_left: Optional[torch.Tensor] = None


def apply_se3_candidates(
    trans_shift: torch.Tensor,
    rot_mat: torch.Tensor,
    pcds: Sequence[torch.Tensor],
    action_gripper_pose: torch.Tensor,
    action_rot_grip: torch.Tensor,
    bounds: torch.Tensor,
    *,
    voxel_size: int,
    rot_resolution_deg: int,
    action_gripper_pose_left: Optional[torch.Tensor] = None,
    action_rot_grip_left: Optional[torch.Tensor] = None,
    batch_bounds: Optional[torch.Tensor] = None,
) -> Se3AugResult:
    """Apply the first valid of the candidates ``trans_shift [K,B,3]`` /
    ``rot_mat [K,B,3,3]`` (slot 0 the identity) to clouds and action(s).
    ``batch_bounds``: the ``[B', 6]`` bounds of the whole batch this one is
    part of, whose extremes clamp the shifted anchor (default ``bounds``)."""
    b = action_gripper_pose.shape[0]
    bounds = torch.broadcast_to(bounds.to(torch.float32), (b, 6))
    two_robot = action_gripper_pose_left is not None

    t_right, q_right = _perturb_pose(action_gripper_pose, trans_shift, rot_mat)
    floor_right = _unclamped_voxel_floor(t_right, voxel_size, bounds[None])
    valid = (floor_right >= 0).all(-1)  # [K, B]
    if two_robot:
        t_left, q_left = _perturb_pose(action_gripper_pose_left, trans_shift, rot_mat)
        floor_left = _unclamped_voxel_floor(t_left, voxel_size, bounds[None])
        valid = valid & (floor_left >= 0).all(-1)

    # first valid RANDOM candidate per element; identity slot 0 only as a
    # fallback when every random draw lands out of bounds
    any_random_valid = valid[1:].any(0)
    first = torch.argmax(valid[1:].to(torch.int32), 0)  # first maximum wins
    chosen = torch.where(any_random_valid, 1 + first, torch.zeros_like(first))

    def pick(x):  # [K, B, ...] -> [B, ...]
        idx = chosen.reshape((1, b) + (1,) * (x.ndim - 2)).expand((1,) + x.shape[1:])
        return torch.gather(x, 0, idx)[0]

    sel_shift = pick(trans_shift)
    sel_rot = pick(rot_mat)

    def make_result(floor, quat, grip_src):
        idx = pick(floor).clamp(0, voxel_size - 1)
        rot_bins = G.quaternion_to_discrete_euler(pick(quat), rot_resolution_deg)
        grip = grip_src[:, 3:4].to(torch.int32)
        return idx, torch.cat([rot_bins, grip], -1)

    trans_idx, rot_grip = make_result(floor_right, q_right, action_rot_grip)
    trans_idx_l = rot_grip_l = None
    if two_robot:
        trans_idx_l, rot_grip_l = make_result(floor_left, q_left, action_rot_grip_left)

    # Perturb clouds about the (right) gripper origin with the clamped
    # translation (perturb_se3, augmentation.py:7-65): the shifted gripper
    # position is clamped into the global min/max of the batch bounds.
    anchor = action_gripper_pose[:, :3]
    whole = bounds if batch_bounds is None else batch_bounds.to(torch.float32).reshape(-1, 6)
    lo = whole[:, 0:3].amin(0)
    hi = whole[:, 3:6].amax(0)
    shifted_anchor = torch.minimum(torch.maximum(anchor + sel_shift, lo), hi)

    out_pcds = []
    for p in pcds:
        flat = p.reshape(b, -1, 3)
        # the reference right-multiplies row vectors by the homogeneous shift
        # matrix, i.e. applies R^T to points centred on the gripper
        centered = flat - anchor[:, None]
        rotated = torch.einsum("bpi,bij->bpj", centered, sel_rot)
        out_pcds.append((rotated + shifted_anchor[:, None]).reshape(p.shape))

    return Se3AugResult(trans_idx, rot_grip, tuple(out_pcds), trans_idx_l, rot_grip_l)


def apply_se3_augmentation(
    generator: Optional[torch.Generator],
    pcds: Sequence[torch.Tensor],
    action_gripper_pose: torch.Tensor,
    action_rot_grip: torch.Tensor,
    bounds: torch.Tensor,
    *,
    voxel_size: int,
    rot_resolution_deg: int,
    cfg: Se3AugConfig = Se3AugConfig(),
    action_gripper_pose_left: Optional[torch.Tensor] = None,
    action_rot_grip_left: Optional[torch.Tensor] = None,
    rows: Optional[Tuple[int, int]] = None,
    batch_bounds: Optional[torch.Tensor] = None,
) -> Se3AugResult:
    """Jointly perturb point clouds and keyframe action(s).

    Args:
      generator: a ``torch.Generator`` on the tensors' device (None: the
        device's default generator).
      pcds: per-camera ``[B, H, W, 3]`` (or ``[B, P, 3]``) world-frame clouds.
      action_gripper_pose: ``[B, 7]`` keyframe gripper pose (xyz + xyzw quaternion).
      action_rot_grip: ``[B, 4]`` previous discrete rot bins + grip bit (only
        the grip bit is reused; rot bins are re-derived from the perturbed pose).
      bounds: ``[B, 6]`` metric scene bounds.
      action_gripper_pose_left / action_rot_grip_left: supply both for the
        two-robot behaviour (augmentation.py:187-348): ONE shared perturbation
        per element, valid only if BOTH arms' perturbed actions stay in
        bounds, clouds rotated about the RIGHT gripper.
      rows / batch_bounds: a part of a larger batch (a data-parallel rank's
        rows): the candidates are drawn for the whole batch and these rows
        kept (``draw_rows``), and the whole batch's bounds clamp the anchor.
    """
    b = action_gripper_pose.shape[0]
    bounds = torch.broadcast_to(bounds.to(torch.float32), (b, 6))
    trans_shift, rot_mat = sample_candidates(generator, cfg, bounds, b, rows)
    return apply_se3_candidates(
        trans_shift, rot_mat, pcds, action_gripper_pose, action_rot_grip, bounds,
        voxel_size=voxel_size, rot_resolution_deg=rot_resolution_deg,
        action_gripper_pose_left=action_gripper_pose_left,
        action_rot_grip_left=action_rot_grip_left, batch_bounds=batch_bounds)
