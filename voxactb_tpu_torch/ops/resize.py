"""``jax.image.resize(x, shape, "linear")`` in PyTorch.

JAX resizes each axis whose size changes by a contraction with a weight
matrix built from a triangle kernel on half-pixel sample positions. Going up,
that is plain half-pixel bilinear interpolation; going down, the kernel
widens by the shrink factor (``antialias=True``, JAX's default), a triangle
filter that ``F.interpolate(mode="bilinear")`` without antialiasing does not
apply. Building JAX's weight matrices covers both directions with one
formula, in f32 as JAX does. ``resize_cubic`` is ``method="cubic"``: the same
matrices with Keys' cubic kernel (a = -0.5) in place of the triangle.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x, min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """``_fill_keys_cubic_kernel`` of ``jax._src.image.scale``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def weight_matrix(n_in: int, n_out: int, device=None, kernel=_triangle) -> torch.Tensor:
    """``[n_in, n_out]`` f32 weights of one axis (``compute_weight_mat`` of
    ``jax._src.image.scale`` with zero translation)."""
    f32 = torch.float32
    inv_scale = float(np.float32(n_in / n_out))
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None]).abs()
    w = kernel(x / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x: torch.Tensor, shape: Sequence[int], kernel) -> torch.Tensor:
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match x {tuple(x.shape)}")
    for d, n in enumerate(shape):
        if x.shape[d] != n:
            w = weight_matrix(x.shape[d], n, x.device, kernel).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


def resize_linear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x`` (float) resized to ``shape``, axis by axis over the axes whose
    size changes."""
    return _resize(x, shape, _triangle)


def resize_cubic(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "cubic")``, as ``resize_linear``."""
    return _resize(x, shape, _keys_cubic)
