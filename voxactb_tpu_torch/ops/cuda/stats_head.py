"""K6: standalone soft-argmax (T = 0.01) and global max of a cubic grid.

Replaces ``voxactb_tpu/ops/pallas/stats_head.py::stats_head``. Its arithmetic
is the TPU kernel's own, not ``softargmax_stats_3d``'s: the logits are
``x / 0.01`` (compiled as ``x * 100``), the running max is of the logits and
the weights are ``exp(logits - max)``; positions are ``(idx / (n-1)) * 2 - 1``
(one rounding, as XLA fuses it), not ``linspace``; the expectations are the
weighted sums times ``1 / sum``; the global max is the max of ``x``. The
kernel (``csrc/stats_head.cu``) is bounded by bytes on an H100: at
``[1, 100^3, 64]`` bf16 it reads 128 MB. Persistent CTAs (``stats_head_grid``)
take tiles of ``tile_rows`` rows in turns and each writes one partial; the
last CTA to arrive of each group of ``kGroupCtas`` merges the group's, the
last of those the sample's, in the same launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.build import header_constant

_CHANNELS = (64, 128, 192)
_CTAS_PER_SM = header_constant("stats_head.cu", "kCtasPerSm")
_MAX_THREADS = header_constant("stats_head.cu", "kMaxThreads")
_ROWS_PER_THREAD = header_constant("stats_head.cu", "kRowsPerThread")
_GROUP_CTAS = header_constant("stats_head.cu", "kGroupCtas")
# faults planted through the real kernel (chip_smoke.py)
FAULTS = {"skip_cta": header_constant("stats_head.cu", "kFaultSkipCta"),
          "no_rescale": header_constant("stats_head.cu", "kFaultNoRescale"),
          "stale_counter": header_constant("stats_head.cu", "kFaultStaleCounter")}


def row_lanes(c: int, itemsize: int) -> int:
    """L, the kernel's row lanes: a row is ``c * itemsize / 16`` vectors of
    16 bytes, one per thread, and a CTA holds the largest power of two of
    rows that fits ``kMaxThreads`` threads."""
    groups = c * itemsize // 16
    return 1 << ((_MAX_THREADS // groups).bit_length() - 1)


def tile_rows(c: int, itemsize: int) -> int:
    """Rows of a tile: ``kRowsPerThread`` rows per row lane; thread (r, v)
    holds vector v of the tile's rows r, r + L, r + 2L, ..."""
    return _ROWS_PER_THREAD * row_lanes(c, itemsize)


def stats_head_grid(b: int, n: int, c: int, itemsize: int, sms: int) -> int:
    """G, the persistent CTAs per sample: all of them resident at once,
    ``kCtasPerSm`` per SM over the batch, and at most one per tile. CTA g of
    a sample takes its tiles g, g + G, ..."""
    tiles = -(-n ** 3 // tile_rows(c, itemsize))
    return max(1, min(tiles, _CTAS_PER_SM * sms // b))


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
    192.

    Every launch on a stream shares one workspace (arrival counters and
    partials), whatever its shape, and relies on each earlier launch having
    set every counter it raised back to 0: a counter left raised would leave
    no CTA last, and ``kp`` and ``gmax`` unwritten. Launches with a planted
    fault take a workspace of their own."""
    if not x.is_cuda:
        return stats_head_reference(x)
    b, c = x.shape[0], x.shape[-1]
    kp = torch.empty((b, 3 * c), dtype=torch.float32, device=x.device)
    gmax = torch.empty((b, c), dtype=torch.float32, device=x.device)
    _launch(x, kp, gmax, None)
    return kp, gmax


class _Plan(NamedTuple):
    """What a launch needs besides its pointers and stream, worked out once
    per (shape, dtype, device)."""
    g: int            # CTAs per sample
    counters: int     # arrival counters: per sample, its own and its groups'
    part_floats: int  # partials: per sample, its CTAs' and its groups'
    bf16: int
    lib: ctypes.CDLL
    fn: object


_PLANS = {}
# (device, stream, faulted) -> (arrival counters int32, partials f32), grown
# to the largest launch seen; the kernel leaves the counters at 0
_WORKSPACE = {}


def _plan(x: torch.Tensor) -> _Plan:
    key = (x.shape, x.dtype, x.device)
    plan = _PLANS.get(key)
    if plan is None:
        from voxactb_tpu_torch.ops.cuda.build import check, entry, sm_count

        b, n, h, w, c = x.shape
        if (not n == h == w or c not in _CHANNELS or n ** 3 >= 2 ** 31
                or x.dtype not in (torch.bfloat16, torch.float32)):
            raise ValueError(f"stats_head kernel takes a cubic [B,n,n,n,C] grid with C in "
                             f"{_CHANNELS}, bf16 or f32; got {tuple(x.shape)} {x.dtype}")
        g = stats_head_grid(b, n, c, x.element_size(), sm_count(x.device))
        groups = -(-g // _GROUP_CTAS)
        bf16 = int(x.dtype == torch.bfloat16)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib, prepare = entry("stats_head", "voxactb_stats_head_prepare", [ci, ci])
        with torch.cuda.device(x.device):
            check(lib, "stats_head", prepare(c, bf16))
        plan = _PLANS[key] = _Plan(
            g, b * (1 + groups), b * (g + groups) * 5 * c, bf16,
            *entry("stats_head", "voxactb_stats_head",
                   [vp, ci, ci, ci, ci, ci, vp, vp, vp, vp, ci, vp]))
    return plan


def _workspace(dev: torch.device, stream: int, plan: _Plan, faulted: bool):
    key = (dev, stream, faulted)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < plan.counters or ws[1].numel() < plan.part_floats:
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = _WORKSPACE[key] = (
            torch.zeros(max(plan.counters, have[0]), dtype=torch.int32, device=dev),
            torch.empty(max(plan.part_floats, have[1]), dtype=torch.float32, device=dev))
    return ws


def reset_workspace() -> None:
    """Drop the cached counters and partials, the faulted launches' too
    (which a planted stale-counter fault leaves raised)."""
    _WORKSPACE.clear()


def launch_stats_head(x: torch.Tensor, kp: torch.Tensor, gmax: torch.Tensor,
                      fault: str | None = None) -> None:
    """One launch of the kernel on the CUDA tensor ``x`` into ``kp [B, 3C]``
    and ``gmax [B, C]``, contiguous f32 on ``x``'s device. ``fault`` plants
    one of ``FAULTS``, in the faulted launches' own workspace."""
    b, c = x.shape[0], x.shape[-1]
    for name, t, shape in (("kp", kp, (b, 3 * c)), ("gmax", gmax, (b, c))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"stats_head: {name} must be a contiguous f32 {list(shape)} on "
                             f"{x.device}; got {tuple(t.shape)} {t.dtype} on {t.device}")
    _launch(x, kp, gmax, fault)


def _launch(x: torch.Tensor, kp: torch.Tensor, gmax: torch.Tensor, fault: str | None) -> None:
    from voxactb_tpu_torch.ops.cuda.build import check, stream_ptr, tma_operand

    plan = _plan(x)
    x = tma_operand(x)  # contiguous, 16-byte aligned for the vector loads
    b, n, c = x.shape[0], x.shape[1], x.shape[-1]
    stream = stream_ptr(x.device)
    arrivals, part = _workspace(x.device, stream, plan, fault is not None)
    err = plan.fn(x.data_ptr(), plan.bf16, b, n, c, plan.g, part.data_ptr(),
                  arrivals.data_ptr(), kp.data_ptr(), gmax.data_ptr(),
                  FAULTS[fault] if fault else 0, stream)
    check(plan.lib, "stats_head", err)
    LAUNCHES["stats_head"] += 1
