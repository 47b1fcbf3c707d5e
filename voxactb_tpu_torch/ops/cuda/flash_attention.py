"""K2: inference attention softmax(q k^T + key mask) v, head dims up to 128.

Replaces ``voxactb_tpu/ops/pallas/flash_attention.py::flash_attention``. The
kernel (``csrc/flash_attention.cu`` on ``csrc/attention_fwd.cuh``) is bounded
by operations on an H100 (about 60 GFLOP per act at 100^3, B = 1). Numerics
follow the TPU kernel: f32 logits of bf16 operands, whole-row max and sum, P
normalised before its bf16 cast, f32 accumulation of P v, bf16 out. The
kernel folds the row sum online in its first pass over the keys (and, when it
splits the keys over a cluster of CTAs, merges the splits' partial sums), so
it sums in another f32 order than the plain version's full-row sum; a P entry
on a bf16 rounding boundary can then round the other way.

A schedule is ``(rows, splits)``: 64 or 128 query rows per block, and 1 to 8
CTAs sharing a row block's key tiles. ``choose_schedule`` is the wrapper's
choice from the shapes and the card's SM count.

The kernel is built for head dims 64 and 128 (``HEAD_DIMS``); the wrapper
zero-pads a head of at most 64 to 64 and one of 65-128 to 128
(``head_dim.padded_call``, exact) and raises above 128. Head dim 128 takes
the one schedule ``(64, 1)``.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple, Union

import torch

from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.head_dim import kernel_head_dim, padded_call

HEAD_DIMS = (64, 128)  # the kernel's head dims; narrower heads are zero-padded
WIDE_SCHEDULE = (64, 1)  # the one schedule of head dim 128
KEY_TILE = 128   # keys per tile of the kernel
MAX_SPLITS = 8   # CTAs per cluster
ROWS = (64, 128)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain version: ``[BH, Tq, hd] x [BH, Tk, hd] -> [BH, Tq, hd]`` in
    ``v.dtype``; q is pre-scaled by the caller."""
    bf = torch.bfloat16
    logits = torch.matmul(q.to(bf).to(torch.float32),
                          k.to(bf).to(torch.float32).transpose(-1, -2))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(-1, keepdim=True)
    attn = (p / s).to(v.dtype)
    return torch.matmul(attn.to(torch.float32),
                        v.to(bf).to(torch.float32)).to(v.dtype)


def choose_schedule(bh: int, tq: int, tk: int, sms: int) -> Tuple[int, int]:
    """The kernel's schedule ``(rows, splits)`` for ``[bh, tq] x [bh, tk]`` on a
    card of ``sms`` SMs. Where 64-row blocks fill at least half the SMs the
    keys are not split and blocks take 64 rows (on an H100 a little faster
    than 128 at the act's self, cross and decoder shapes). Elsewhere 128-row
    blocks split their keys over as many CTAs as fit the SMs, at most one per
    key tile and at most 6, or 8 where 6 would leave half the SMs idle: 16
    clusters of 7 or 8 run slower than 16 of 6 on an H100 (the cross shape at
    batch 1), 9 of 8 faster than 9 of 6 (the 50^3 decoder shape).
    ``chip_smoke.py`` times every schedule at the act's shapes."""
    n_tiles = -(-tk // KEY_TILE)
    if 2 * bh * -(-tq // 64) >= sms or n_tiles == 1:
        return 64, 1
    blocks = bh * -(-tq // 128)
    splits = min(6, n_tiles, sms // blocks)
    if 2 * blocks * splits < sms:
        splits = min(MAX_SPLITS, n_tiles, sms // blocks)
    return 128, max(1, splits)


def all_schedules(tk: int) -> List[Tuple[int, int]]:
    """Every schedule the kernel takes for ``tk`` keys."""
    n_tiles = -(-tk // KEY_TILE)
    return [(rows, splits) for rows in ROWS
            for splits in range(1, min(MAX_SPLITS, n_tiles) + 1)]


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGS = [_VP] * 4 + [_CI] * 6 + [_VP]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    schedule: Union[int, Tuple[int, int]] = 0) -> torch.Tensor:
    """``[BH, Tq, hd] x [BH, Tk, hd] -> [BH, Tq, hd]``, hd at most 128; q must
    be PRE-SCALED by ``hd ** -0.5``. CPU tensors take the plain version.

    ``schedule`` is the kernel's ``(rows, splits)``, or 0 for
    ``choose_schedule``'s (head dims above 64: ``WIDE_SCHEDULE``)."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v)
    width = kernel_head_dim(q.shape[-1], HEAD_DIMS, "flash_attention")
    return padded_call(_launch, (q, k, v), width, schedule=schedule)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            schedule: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """The kernel at a head dim of ``HEAD_DIMS``."""
    from voxactb_tpu_torch.ops.cuda.build import (check, entry, sm_count, stream_ptr,
                                                  tma_operand)

    bh, tq, hd = q.shape
    tk = k.shape[1]
    if hd not in HEAD_DIMS or k.shape != (bh, tk, hd) or v.shape != (bh, tk, hd):
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS} and "
                         f"matching k/v; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if v.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention kernel takes bf16 operands, got {v.dtype}")
    wide = hd == HEAD_DIMS[-1]
    rows, splits = schedule or (WIDE_SCHEDULE if wide else
                                choose_schedule(bh, tq, tk, sm_count(q.device)))
    if rows not in ROWS or not 1 <= splits <= min(MAX_SPLITS, -(-tk // KEY_TILE)) or (
            wide and (rows, splits) != WIDE_SCHEDULE):
        raise ValueError(f"flash_attention kernel: no schedule {schedule} for Tk = {tk} "
                         f"at head dim {hd}; it takes "
                         f"{[WIDE_SCHEDULE] if wide else all_schedules(tk)}")
    bf = torch.bfloat16
    if q.dtype != bf or k.dtype != bf:
        q, k = q.to(bf), k.to(bf)
    q, k, v = tma_operand(q), tma_operand(k), tma_operand(v)
    out = torch.empty_like(q)
    lib, fn = entry("flash_attention", "voxactb_flash_attention", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, tq, tk, rows,
             splits, hd, stream_ptr(q.device))
    check(lib, "flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out
