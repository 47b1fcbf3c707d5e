"""Rotation / discretization geometry on tensors.

Counterpart of ``voxactb_tpu.ops.geometry``. Conventions match it and the
reference: quaternions are ``xyzw``; euler angles are extrinsic x-y-z
(``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)``); discrete rotations are
``round((euler_deg + 180) / resolution) % num_bins``.
"""

from __future__ import annotations

import math

import torch

from voxactb_tpu_torch.ops.voxelize import reciprocal

MIN_DENOMINATOR = 1e-12


def normalize_quaternion(quat: torch.Tensor) -> torch.Tensor:
    return quat / torch.linalg.norm(quat, dim=-1, keepdim=True)


def canonicalize_quaternion(quat: torch.Tensor) -> torch.Tensor:
    """Normalize and flip sign so the scalar part w (last component) is >= 0
    (launch_utils.py:199-201, augmentation.py:168-170)."""
    quat = normalize_quaternion(quat)
    return torch.where(quat[..., 3:4] < 0, -quat, quat)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion(s) -> 3x3 rotation matrix (broadcasts over leading axes)."""
    q = normalize_quaternion(quat)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> xyzw quaternion, branch-free (Shepperd's method):
    all four candidates are formed and the strongest selected with argmax."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), -1)

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    sw = safe_sqrt(qw2) * 2.0
    sx = safe_sqrt(qx2) * 2.0
    sy = safe_sqrt(qy2) * 2.0
    sz = safe_sqrt(qz2) * 2.0

    cand_w = torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, sw / 4.0], -1)
    cand_x = torch.stack([sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], -1)
    cand_y = torch.stack([(m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy, (m02 - m20) / sy], -1)
    cand_z = torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0, (m10 - m01) / sz], -1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], -2)
    quat = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    return normalize_quaternion(quat)


def euler_xyz_to_rotmat(euler_rad: torch.Tensor) -> torch.Tensor:
    """Extrinsic xyz euler (radians, [roll, pitch, yaw]) -> rotation matrix."""
    a, b, c = euler_rad[..., 0], euler_rad[..., 1], euler_rad[..., 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    m = torch.stack([
        cb * cc, sa * sb * cc - ca * sc, ca * sb * cc + sa * sc,
        cb * sc, sa * sb * sc + ca * cc, ca * sb * sc - sa * cc,
        -sb, sa * cb, ca * cb,
    ], -1)
    return m.reshape(euler_rad.shape[:-1] + (3, 3))


def rotmat_to_euler_xyz(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> extrinsic xyz euler angles in radians ([roll, pitch,
    yaw]); pitch through the asin branch, as scipy away from gimbal lock."""
    pitch = torch.asin(torch.clamp(-m[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(m[..., 2, 1], m[..., 2, 2])
    yaw = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    return torch.stack([roll, pitch, yaw], -1)


def quat_to_euler_xyz_deg(quat: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion -> extrinsic xyz euler in degrees."""
    return rotmat_to_euler_xyz(quat_to_rotmat(quat)) * (180.0 / math.pi)


def euler_xyz_deg_to_quat(euler_deg: torch.Tensor) -> torch.Tensor:
    return rotmat_to_quat(euler_xyz_to_rotmat(euler_deg * (math.pi / 180.0)))


def quaternion_to_discrete_euler(quat: torch.Tensor, resolution_deg: float
                                 ) -> torch.Tensor:
    """Discretize a rotation into per-axis bins (helpers/utils.py:92-97):
    ``round((euler + 180) / resolution)`` with the full-turn bin wrapped to 0.
    int32 in [0, 360 / resolution). ``/ resolution`` is the compiled JAX
    program's multiplication by the f32 reciprocal."""
    num_bins = round(360.0 / resolution_deg)
    euler = quat_to_euler_xyz_deg(quat) + 180.0
    disc = torch.round(euler * reciprocal(resolution_deg)).to(torch.int32)
    return torch.where(disc == num_bins, torch.zeros_like(disc), disc)


def discrete_euler_to_quaternion(disc: torch.Tensor, resolution_deg: float
                                 ) -> torch.Tensor:
    """Discrete per-axis rotation bins -> xyzw quaternion (helpers/utils.py:100-102)."""
    euler_deg = disc.to(torch.float32) * resolution_deg - 180.0
    return euler_xyz_deg_to_quat(euler_deg)


def point_to_voxel_index(point: torch.Tensor, voxel_size: int,
                         coord_bounds: torch.Tensor) -> torch.Tensor:
    """Metric point -> integer voxel index clipped into the grid (clamped at 0
    from below as in the JAX package)."""
    bb_mins = coord_bounds[..., 0:3]
    res = (coord_bounds[..., 3:6] - bb_mins) * reciprocal(voxel_size)
    idx = torch.floor((point - bb_mins) / (res + MIN_DENOMINATOR))
    return idx.clamp(0, voxel_size - 1).to(torch.int32)


def attention_coordinate(voxel_index: torch.Tensor, voxel_size: int,
                         coord_bounds: torch.Tensor) -> torch.Tensor:
    """Voxel index -> metric point at the voxel centre:
    ``bounds_min + res * idx + res / 2`` (qattention_peract_bc_agent.py:724)."""
    res = (coord_bounds[..., 3:6] - coord_bounds[..., 0:3]) * reciprocal(voxel_size)
    return (coord_bounds[..., 0:3] + res * voxel_index.to(torch.float32)
            + res / 2.0)


def scene_bounds_from_crop(crop_point, radius: float) -> torch.Tensor:
    """Crop point +- radius -> scene bounds [x0,y0,z0,x1,y1,z1], the crop point
    rounded to 2 decimals first (``get_new_scene_bounds_based_on_crop``,
    helpers/utils.py:32-40). ``round(x, 2)`` is ``round(x * 100) / 100`` in
    f32, half to even, as ``jnp.round`` computes it."""
    p = torch.as_tensor(crop_point, dtype=torch.float32)
    p = torch.round(p * 100.0) / 100.0
    return torch.cat([p - radius, p + radius], -1)
