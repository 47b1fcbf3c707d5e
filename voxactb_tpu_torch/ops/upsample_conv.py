"""Phase-decomposed trilinear-upsample + conv (plain PyTorch; cuDNN conv).

Counterpart of ``voxactb_tpu.ops.upsample_conv``. The x``scale`` trilinear
upsample (half-pixel centres, edge clamped) is a fixed linear map with at most
2 taps per axis, so composed with a learned k^3 kernel it becomes ``scale^3``
phase-specific 3^3 kernels applied at the LOW resolution:

    y[s*q + r] = sum_{delta in {-1,0,1}^3} W'_r[delta] . x[q + delta]

i.e. one k3 conv at D^3 with Cin -> scale^3 * Cout channels, then a
depth-to-space reshape. Identical to resize+conv in the interior; at the two
outermost output voxels per face the composition clamps at the coarse grid
(``reference_upsample_conv`` is the exact resize+conv).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from voxactb_tpu_torch.models.blocks import (
    conv3d_f32acc, edge_pad, to_ncdhw, to_ndhwc)


@functools.lru_cache()
def _phase_tap_matrix(scale: int, ksize: int) -> np.ndarray:
    """T[r, k, d]: weight of input cell (q + d - 1) in output phase r via conv tap k."""
    pad = ksize // 2
    t = np.zeros((scale, ksize, 3), np.float64)
    for r in range(scale):
        for k in range(ksize):
            m = r + k - pad
            qq, rr = divmod(m, scale)
            c = (rr + 0.5) / scale - 0.5
            lo = int(np.floor(c))
            w_hi = c - lo
            for tap_off, w in ((lo, 1.0 - w_hi), (lo + 1, w_hi)):
                if w == 0.0:
                    continue
                d = max(-1, min(1, qq + tap_off))
                t[r, k, d + 1] += w
    return t


def compose_upsample_kernel(kernel: torch.Tensor, scale: int) -> torch.Tensor:
    """``[k,k,k,Cin,Cout]`` -> ``[3,3,3,Cin, scale^3*Cout]`` composite kernel.

    Three single-axis contractions in the JAX package's order (kernel axis 0,
    then 1, then 2 against the tap matrix), each summed in f32 and rounded to
    the kernel's dtype, as XLA's dot chain does; at bf16 the composite is then
    bit-identical to the JAX package's.
    """
    k = kernel.shape[0]
    dt, f32 = kernel.dtype, torch.float32
    t = torch.as_tensor(_phase_tap_matrix(scale, k), device=kernel.device).to(dt).to(f32)
    w = kernel
    for _ in range(3):
        # [u, ..., (a, d)...] -> [..., (a, d)..., a', d']
        w = torch.tensordot(w.to(f32), t, dims=([0], [1])).to(dt)
    cin, cout = kernel.shape[3], kernel.shape[4]
    # [i, o, a, d, b, e, c, f] -> [d, e, f, i, a, b, c, o]
    w = w.permute(3, 5, 7, 0, 2, 4, 6, 1).reshape(3, 3, 3, cin, scale ** 3 * cout)
    return w


def upsample_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  scale: int) -> torch.Tensor:
    """trilinear x``scale`` then conv(kernel, replicate pad), fused.

    x: ``[B, D, D, D, Cin]``; kernel ``[k,k,k,Cin,Cout]``; returns
    ``[B, sD, sD, sD, Cout]`` in ``x.dtype``.
    """
    b, d = x.shape[0], x.shape[1]
    k = kernel.shape[0]
    if scale < k // 2 + 1:
        return reference_upsample_conv(x, kernel, bias, scale)
    cout = kernel.shape[-1]
    comp = compose_upsample_kernel(kernel, scale).to(x.dtype)
    xp = edge_pad(to_ncdhw(x), 1)
    y = conv3d_f32acc(xp, comp.permute(4, 3, 0, 1, 2), 1)  # [B, s^3*Cout, D, D, D]
    y = y.reshape(b, scale, scale, scale, cout, d, d, d)
    y = y.permute(0, 5, 1, 6, 2, 7, 3, 4).reshape(
        b, d * scale, d * scale, d * scale, cout)
    return (y + bias).to(x.dtype)


def reference_upsample_conv(x: torch.Tensor, kernel: torch.Tensor,
                            bias: torch.Tensor, scale: int) -> torch.Tensor:
    """The exact semantics: trilinear resize (half-pixel centres) + edge-pad conv."""
    b, d = x.shape[0], x.shape[1]
    up = F.interpolate(to_ncdhw(x).to(torch.float32), scale_factor=scale,
                       mode="trilinear", align_corners=False).to(x.dtype)
    pad = kernel.shape[0] // 2
    y = conv3d_f32acc(edge_pad(up, pad), kernel.permute(4, 3, 0, 1, 2), 1)
    return (to_ndhwc(y) + bias).to(x.dtype)
