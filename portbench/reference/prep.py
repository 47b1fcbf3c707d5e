"""The plain reference's input side: voxelizer, geometry, SE(3) augmentation
and the attention dropout mask, in float32 PyTorch.

A frozen copy of the Q-attention pipeline's published semantics (PerAct's
``VoxelGrid.coords_to_bounding_voxel_grid``, ``apply_se3_augmentation`` and
the rotation helpers, as the port computes them), kept here so that the
benchmark judges the port against code the port cannot change. It imports
nothing of the port.

Where the port multiplies by an f32 reciprocal in place of a division by a
constant, this copy does the same, so that voxel bins and rotation bins agree
exactly; every other value is judged by a tolerance.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

F32 = torch.float32
MIN_DENOMINATOR = 1e-12


def reciprocal(n: float) -> torch.Tensor:
    return torch.tensor(1.0 / float(n), dtype=F32)


# -- observations -> voxel grid --------------------------------------------------


def normalize_rgb(x: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [-1, 1]."""
    return (x.to(F32) * reciprocal(255.0)) * 2.0 - 1.0


def flatten_cameras(rgbs: Sequence[torch.Tensor], pcds: Sequence[torch.Tensor]):
    """Per-camera ``[B, H, W, 3]`` -> ``(coords [B, P, 3], feats [B, P, 3])``."""
    b = rgbs[0].shape[0]
    coords = torch.cat([p.reshape(b, -1, 3) for p in pcds], 1)
    feats = torch.cat([r.reshape(b, -1, r.shape[-1]) for r in rgbs], 1)
    return coords, feats


def voxelize(coords: torch.Tensor, feats: torch.Tensor, bounds: torch.Tensor,
             n: int) -> torch.Tensor:
    """Scatter-mean into ``[B, N, N, N, 10]``: mean xyz | mean rgb | index / N
    | occupancy. Points outside the bounds land in a one-voxel border that is
    cropped away."""
    b, p, _ = coords.shape
    dims = n + 2
    dev = coords.device
    bounds = torch.broadcast_to(bounds.to(F32), (b, 6))
    mins = bounds[:, None, 0:3]
    res = (bounds[:, None, 3:6] - mins) * reciprocal(n)
    denom = res + torch.tensor(MIN_DENOMINATOR, dtype=F32)
    idx = torch.floor((coords.to(F32) - (mins - res)) / denom).clamp(0, n + 1).to(torch.int64)
    flat = (idx[..., 0] * dims + idx[..., 1]) * dims + idx[..., 2]
    flat = flat + torch.arange(b, device=dev)[:, None] * dims ** 3
    vals = torch.cat([coords.to(F32), feats.to(F32),
                      torch.ones((b, p, 1), dtype=F32, device=dev)], -1)
    sums = torch.zeros((b * dims ** 3, vals.shape[-1]), dtype=F32, device=dev)
    sums.index_add_(0, flat.reshape(-1), vals.reshape(b * p, -1))
    mean = sums / torch.clamp(sums[:, -1:], min=1.0)
    grid = mean.reshape(b, dims, dims, dims, -1)[:, 1:-1, 1:-1, 1:-1]
    occupancy = (grid[..., -1:] > 0).to(F32)
    r = torch.arange(n, dtype=F32, device=dev)
    index = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1) * reciprocal(n)
    return torch.cat([grid[..., :-1], index.expand(b, n, n, n, 3), occupancy], -1)


# -- rotations --------------------------------------------------------------------


def normalize_quaternion(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(quat):
    """xyzw -> 3x3."""
    x, y, z, w = normalize_quaternion(quat).unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def rotmat_to_quat(m):
    """3x3 -> xyzw (Shepperd's method: the strongest of four candidates)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    sq = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                      1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    best = torch.argmax(sq, -1)
    sw, sx, sy, sz = (torch.sqrt(torch.clamp(sq[..., i], min=1e-12)) * 2.0 for i in range(4))
    cands = torch.stack([
        torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, sw / 4], -1),
        torch.stack([sx / 4, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], -1),
        torch.stack([(m01 + m10) / sy, sy / 4, (m12 + m21) / sy, (m02 - m20) / sy], -1),
        torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, sz / 4, (m10 - m01) / sz], -1),
    ], -2)
    quat = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    return normalize_quaternion(quat)


def euler_to_rotmat(e):
    """Extrinsic xyz euler (radians) -> ``Rz @ Ry @ Rx``."""
    a, b, c = e[..., 0], e[..., 1], e[..., 2]
    ca, sa, cb, sb, cc, sc = a.cos(), a.sin(), b.cos(), b.sin(), c.cos(), c.sin()
    m = torch.stack([
        cb * cc, sa * sb * cc - ca * sc, ca * sb * cc + sa * sc,
        cb * sc, sa * sb * sc + ca * cc, ca * sb * sc - sa * cc,
        -sb, sa * cb, ca * cb], -1)
    return m.reshape(e.shape[:-1] + (3, 3))


def quat_to_euler_deg(quat):
    m = quat_to_rotmat(quat)
    pitch = torch.asin(torch.clamp(-m[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(m[..., 2, 1], m[..., 2, 2])
    yaw = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    return torch.stack([roll, pitch, yaw], -1) * (180.0 / math.pi)


def quat_to_bins(quat, resolution: float):
    """``round((euler_deg + 180) / resolution)``, the full turn wrapped to 0."""
    num = round(360.0 / resolution)
    disc = torch.round((quat_to_euler_deg(quat) + 180.0) * reciprocal(resolution))
    disc = disc.to(torch.int32)
    return torch.where(disc == num, torch.zeros_like(disc), disc)


def bins_to_quat(bins, resolution: float):
    euler = bins.to(F32) * resolution - 180.0
    return rotmat_to_quat(euler_to_rotmat(euler * (math.pi / 180.0)))


def voxel_centre(index, n: int, bounds):
    """Voxel index -> the metric point at its centre."""
    res = (bounds[..., 3:6] - bounds[..., 0:3]) * reciprocal(n)
    return bounds[..., 0:3] + res * index.to(F32) + res / 2.0


def decode_action(trans_idx, rot_bins, grip, collision, n: int, bounds, resolution):
    """The continuous action ``xyz | quaternion xyzw | grip | collision``."""
    return torch.cat([voxel_centre(trans_idx, n, bounds), bins_to_quat(rot_bins, resolution),
                      grip.to(F32)[..., None], collision.to(F32)[..., None]], -1)


def crop_bounds(point, radius: float) -> torch.Tensor:
    """Crop point (rounded to 2 decimals) +- radius."""
    p = torch.round(torch.as_tensor(point, dtype=F32) * 100.0) * reciprocal(100)
    return torch.cat([p - radius, p + radius], -1)


# -- SE(3) augmentation -----------------------------------------------------------


def _floor_index(point, n: int, bounds):
    """Voxel floor index, clamped only from above: negative means outside."""
    res = (bounds[..., 3:6] - bounds[..., 0:3]) * reciprocal(n)
    idx = torch.floor((point - bounds[..., 0:3]) / (res + MIN_DENOMINATOR)).to(torch.int32)
    return torch.clamp(idx, max=n - 1)


AUG_CANDIDATES = 16


def augment(generator, pcds, gripper_pose, grip_bits, bounds, *, n: int,
            resolution: float, trans_range, rot_range_deg, rot_step_deg: int,
            candidates: int = AUG_CANDIDATES):
    """Draw ``candidates`` perturbations per sample from ``generator`` (two
    ``rand`` calls of ``[K, B, 3]``: translations, then rotation steps),
    keep each sample's first in-bounds random one (slot 0 is the identity,
    the fallback), and apply it to the action and the clouds. Returns
    ``(trans_idx [B, 3], rot_grip [B, 4], pcds)``."""
    b = gripper_pose.shape[0]
    dev = bounds.device
    bounds = torch.broadcast_to(bounds.to(F32), (b, 6))
    span = (bounds[:, 3:6] - bounds[:, 0:3]) * torch.tensor(trans_range, dtype=F32, device=dev)
    shift = span[None] * (torch.rand((candidates, b, 3), generator=generator, device=dev,
                                     dtype=F32) * 2.0 - 1.0)
    steps = torch.tensor([int(r // rot_step_deg) for r in rot_range_deg], dtype=F32,
                         device=dev)
    u = torch.rand((candidates, b, 3), generator=generator, device=dev, dtype=F32)
    draw = torch.minimum(torch.floor(u * (2.0 * steps + 1.0)) - steps, steps)
    rot = euler_to_rotmat(-(draw * rot_step_deg * (math.pi / 180.0))).transpose(-1, -2)
    shift = torch.cat([torch.zeros((1, b, 3), dtype=F32, device=dev), shift[1:]], 0)
    rot = torch.cat([torch.eye(3, dtype=F32, device=dev).expand(1, b, 3, 3), rot[1:]], 0)

    t_new = gripper_pose[None, :, :3] + shift
    r_new = torch.einsum("bij,kbjl->kbil", quat_to_rotmat(gripper_pose[:, 3:7]), rot)
    q_new = normalize_quaternion(rotmat_to_quat(r_new))
    q_new = torch.where(q_new[..., 3:4] < 0, -q_new, q_new)
    floor = _floor_index(t_new, n, bounds[None])
    valid = (floor >= 0).all(-1)
    first = torch.argmax(valid[1:].to(torch.int32), 0)
    chosen = torch.where(valid[1:].any(0), 1 + first, torch.zeros_like(first))
    rows = torch.arange(b, device=dev)
    trans_idx = floor[chosen, rows].clamp(0, n - 1)
    rot_grip = torch.cat([quat_to_bins(q_new[chosen, rows], resolution),
                          grip_bits.reshape(b, 1).to(torch.int32)], -1)

    anchor = gripper_pose[:, :3]
    lo, hi = bounds[:, 0:3].amin(0), bounds[:, 3:6].amax(0)
    moved = torch.minimum(torch.maximum(anchor + shift[chosen, rows], lo), hi)
    out = []
    for p in pcds:
        flat = p.reshape(b, -1, 3) - anchor[:, None]
        out.append((torch.einsum("bpi,bij->bpj", flat, rot[chosen, rows])
                    + moved[:, None]).reshape(p.shape))
    return trans_idx, rot_grip, out


# -- attention dropout ------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def padded_extents(tq: int, tk: int, q_block: int = 512) -> Tuple[int, int]:
    """The sequence extents that index the mask: Tq rounded up to the query
    block (to 8 below one block), Tk to 128."""
    if tq < q_block:
        q_block = -(-tq // 8) * 8
    return -(-tq // q_block) * q_block, -(-tk // 128) * 128


def keep_mask(seed: torch.Tensor, batch: int, heads: int, tq: int, tk: int,
              dropout: float) -> torch.Tensor:
    """``[B, H, Tq, Tk]`` bool: the elements attention dropout keeps. The
    murmur3 finalizer of ``seed ^ element index`` (index over the padded
    extents, heads flat over the batch), kept where the hash is at least
    ``round(dropout * 2^32)``."""
    tq_pad, tk_pad = padded_extents(tq, tk)
    dev = seed.device
    i64 = torch.int64
    head = torch.arange(batch * heads, dtype=i64, device=dev)[:, None, None]
    row = torch.arange(tq, dtype=i64, device=dev)[None, :, None]
    col = torch.arange(tk, dtype=i64, device=dev)[None, None, :]
    index = (head * tq_pad + row) * tk_pad + col
    x = (index & _M32) ^ (seed.to(i64) & _M32) ^ _mul32(index >> 32, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    threshold = min(int(round(dropout * 4294967296.0)), 4294967295)
    return (x >= threshold).reshape(batch, heads, tq, tk)
