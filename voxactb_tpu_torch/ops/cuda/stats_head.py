"""K6: standalone soft-argmax (T = 0.01) and global max of a cubic grid.

Replaces ``voxactb_tpu/ops/pallas/stats_head.py::stats_head``. Its arithmetic
is the TPU kernel's own, not ``softargmax_stats_3d``'s: the logits are
``x / 0.01`` (compiled as ``x * 100``), the running max is of the logits and
the weights are ``exp(logits - max)``; positions are ``(idx / (n-1)) * 2 - 1``
(one rounding, as XLA fuses it), not ``linspace``; the expectations are the
weighted sums times ``1 / sum``; the global max is the max of ``x``, kept
apart. The kernel (``csrc/stats_head.cu``) is bounded by bytes on an H100: at
``[1, 100^3, 64]`` bf16 it reads 128 MB for about 0.4 GFLOP.
"""

from __future__ import annotations

import ctypes

import torch

from voxactb_tpu_torch.ops.cuda import LAUNCHES

_ROWS_PER_BLOCK = 1024  # csrc/stats_head.cu kRowsPerBlock
_CHANNELS = (64, 128, 192)


def grid_positions(n: int, device) -> torch.Tensor:
    """``[n^3, 3]`` positions ``(lin[h], lin[d], lin[w])`` of the rows of a
    cubic grid with ``lin(i) = (i * f32(1/(n-1))) * 2 - 1`` rounded once —
    the reference's meshgrid-'xy' quirk (E[x] integrates the h index)."""
    idx = torch.arange(n ** 3, device=device, dtype=torch.int64)
    inv = float(torch.tensor(1.0 / max(n - 1, 1), dtype=torch.float32))
    lin = lambda i: (i.to(torch.float64) * inv * 2.0 - 1.0).to(torch.float32)  # noqa: E731
    d, h, w = lin(idx // (n * n)), lin((idx // n) % n), lin(idx % n)
    return torch.stack([h, d, w], -1)


def stats_head_reference(x: torch.Tensor):
    """Plain version: ``x [B,n,n,n,C]`` (any float dtype) -> ``(kp [B,3C] f32,
    gmax [B,C] f32)`` with ``kp`` in (x, y, z) triplets, channel major."""
    b, d, h, w, c = x.shape
    if not d == h == w:
        raise ValueError(f"stats_head expects a cubic grid, got {tuple(x.shape)}")
    flat = x.reshape(b, d ** 3, c).to(torch.float32)
    logits = flat * 100.0  # "/ 0.01" as XLA compiles it
    m = logits.amax(1, keepdim=True)
    p = torch.exp(logits - m)
    pos = grid_positions(d, x.device)
    sums = torch.einsum("bsc,sk->bck", p, pos)
    kp = sums * (1.0 / p.sum(1))[..., None]
    return kp.reshape(b, 3 * c), flat.amax(1)


def stats_head(x: torch.Tensor):
    """Same arguments and returns as ``stats_head_reference``; CPU tensors
    take the plain version. The kernel takes bf16 or f32 and C in 64, 128,
    192."""
    if not x.is_cuda:
        return stats_head_reference(x)
    from voxactb_tpu_torch.ops.cuda.build import check, library, stream_ptr

    b, n, h, w, c = x.shape
    if (not n == h == w or c not in _CHANNELS or n ** 3 >= 2 ** 31
            or x.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"stats_head kernel takes a cubic [B,n,n,n,C] grid with C in "
                         f"{_CHANNELS}, bf16 or f32; got {tuple(x.shape)} {x.dtype}")
    dev = x.device
    x = x.contiguous()
    p = -(-n ** 3 // _ROWS_PER_BLOCK)
    part = torch.empty((b, p, 6, c), dtype=torch.float32, device=dev)
    kp = torch.empty((b, 3 * c), dtype=torch.float32, device=dev)
    gmax = torch.empty((b, c), dtype=torch.float32, device=dev)

    lib = library("stats_head")
    fn = lib.voxactb_stats_head
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, ci, ci, ci, vp, vp, vp, vp]
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), b, n, c,
             part.data_ptr(), kp.data_ptr(), gmax.data_ptr(), stream_ptr(dev))
    check(lib, "stats_head", err)
    LAUNCHES["stats_head"] += 1
    return kp, gmax
