"""``jax.image.resize(x, shape, "linear")`` in PyTorch.

JAX resizes each axis whose size changes by a contraction with a weight
matrix built from a triangle kernel on half-pixel sample positions. Going up,
that is plain half-pixel bilinear interpolation; going down, the kernel
widens by the shrink factor (``antialias=True``, JAX's default), a triangle
filter that ``F.interpolate(mode="bilinear")`` without antialiasing does not
apply. Building JAX's weight matrices covers both directions with one
formula, in f32 as JAX does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def weight_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """``[n_in, n_out]`` f32 weights of one axis (``compute_weight_mat`` of
    ``jax._src.image.scale`` with zero translation)."""
    f32 = torch.float32
    inv_scale = float(np.float32(n_in / n_out))
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None]).abs()
    w = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x`` (float) resized to ``shape``, axis by axis over the axes whose
    size changes."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match x {tuple(x.shape)}")
    for d, n in enumerate(shape):
        if x.shape[d] != n:
            w = weight_matrix(x.shape[d], n, x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x
