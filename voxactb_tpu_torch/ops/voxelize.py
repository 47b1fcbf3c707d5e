"""Point-cloud -> dense voxel-feature-grid scatter-mean (plain PyTorch).

Counterpart of ``voxactb_tpu.ops.voxelize`` (itself the behavioural twin of
``VoxelGrid.coords_to_bounding_voxel_grid``, peract/voxel/voxel_grid.py:148-198):
points are binned with ``floor((p - (mins - res)) / (res + eps))`` into an
(N+2)^3 grid whose one-voxel border collects out-of-bounds points; one
``index_add_`` accumulates value sums and counts together (the trailing ones
channel is the count); the border is cropped off. Bounds are a runtime
``[B, 6]`` tensor, so per-sample VLM crops flow through here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

MIN_DENOMINATOR = 1e-12


def reciprocal(n: float) -> torch.Tensor:
    """f32 ``1 / n``. XLA compiles a division by a constant as a multiplication
    by its f32 reciprocal (``range / (N + 1e-12)`` becomes ``range * f32(1/N)``),
    so the port multiplies wherever the JAX package divides by a constant."""
    return torch.tensor(1.0 / float(n), dtype=torch.float32)


def bin_points(coords: torch.Tensor, coord_bounds: torch.Tensor, voxel_size: int
               ) -> torch.Tensor:
    """``[B, P, 3]`` points -> ``[B, P, 3]`` int64 indices into the (N+2)^3 grid.

    The f32 operation sequence is the compiled JAX package's (ops/voxelize.py:
    67-77), so indices agree exactly; index 0 and N+1 are the out-of-bounds
    border.
    """
    n = voxel_size
    b = coords.shape[0]
    bounds = torch.broadcast_to(coord_bounds.to(torch.float32), (b, 6))
    bb_mins = bounds[:, None, 0:3]
    bb_ranges = bounds[:, None, 3:6] - bb_mins
    res = bb_ranges * reciprocal(n)
    denom = res + torch.tensor(MIN_DENOMINATOR, dtype=torch.float32)
    idx = torch.floor((coords.to(torch.float32) - (bb_mins - res)) / denom)
    return idx.clamp(0, n + 1).to(torch.int64)


def voxelize(coords: torch.Tensor, coord_features: torch.Tensor,
             coord_bounds: torch.Tensor, *, voxel_size: int) -> torch.Tensor:
    """Scatter-mean point features into a dense bounded voxel grid.

    Args:
      coords: ``[B, P, 3]`` world-frame points.
      coord_features: ``[B, P, F]`` per-point features (RGB in [-1, 1]).
      coord_bounds: ``[B, 6]`` or ``[1, 6]`` bounds ``[x0,y0,z0,x1,y1,z1]``.
      voxel_size: N.

    Returns:
      ``[B, N, N, N, 3 + F + 3 + 1]`` float32, channels last:
      mean xyz (3) | mean features (F) | voxel index / N (3) | occupancy (1).
    """
    b, p, _ = coords.shape
    f = coord_features.shape[-1]
    n = voxel_size
    dims = n + 2
    dev = coords.device

    idx = bin_points(coords, coord_bounds, n)
    flat = (idx[..., 0] * dims + idx[..., 1]) * dims + idx[..., 2]
    flat = flat + torch.arange(b, device=dev)[:, None] * dims ** 3

    vals = torch.cat([coords.to(torch.float32), coord_features.to(torch.float32),
                      torch.ones((b, p, 1), dtype=torch.float32, device=dev)], -1)
    scattered = torch.zeros((b * dims ** 3, 3 + f + 1), dtype=torch.float32,
                            device=dev)
    scattered.index_add_(0, flat.reshape(-1), vals.reshape(b * p, 3 + f + 1))
    count = scattered[:, -1:]
    mean = scattered / torch.clamp(count, min=1.0)

    grid = mean.reshape(b, dims, dims, dims, 3 + f + 1)[:, 1:-1, 1:-1, 1:-1]
    occupancy = (grid[..., -1:] > 0).to(torch.float32)
    r = torch.arange(n, dtype=torch.float32, device=dev)
    index_grid = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1) * reciprocal(n)
    index_feat = torch.broadcast_to(index_grid[None], (b, n, n, n, 3))
    return torch.cat([grid[..., :-1], index_feat, occupancy], -1)


def flatten_camera_observations(rgbs: Sequence[torch.Tensor],
                                pcds: Sequence[torch.Tensor]
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-camera ``[B, H, W, 3]`` rgb/point clouds -> ``(coords [B, P, 3],
    features [B, P, 3])`` with ``P = sum(H_i * W_i)``."""
    b = rgbs[0].shape[0]
    coords = torch.cat([p.reshape(b, -1, 3) for p in pcds], 1)
    feats = torch.cat([r.reshape(b, -1, r.shape[-1]) for r in rgbs], 1)
    return coords, feats
