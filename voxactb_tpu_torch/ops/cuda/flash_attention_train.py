"""K4: trainable attention with saved log-sum-exp and hash dropout, head dim 64.

Replaces ``voxactb_tpu/ops/pallas/flash_attention.py::flash_attention_train``
(TPU kernels ``_train_fwd_kernel`` / ``_train_bwd_kernel``). The kernels
(``csrc/flash_attention_train.cu``: one forward, and a dQ and a dK/dV kernel
for the backward) are bounded by operations on an H100. A
``torch.autograd.Function`` joins forward and backward; saved for the backward
are q, k, v, the seed and the row log-sum-exp, never the probabilities.

Beside the kernels stands the plain version, ``flash_attention_train_reference``,
an ``autograd.Function`` too, whose backward is written out with the same mask
and the same rounding points as the TPU kernel. CPU tensors take it; on a CUDA
tensor the wrappers launch the kernels or raise.

The dropout mask is a pure function of ``(seed, head, row, column)``:
``keep_mask`` reproduces the TPU kernel's ``_hash_keep`` bit for bit wherever
the element index ``((head * tq_pad) + row) * tk_pad + col`` is below 2^32,
which covers every shape in the repo (the largest, 64 heads of 2048 x 2048, is
2^28). Beyond that the TPU kernel's uint32 index wraps and its mask repeats;
here the index is 64 bits wide and its high word is mixed into the hash, so
the mask stays decorrelated but no longer equals the TPU kernel's.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from voxactb_tpu_torch.ops.cuda import LAUNCHES

_HD = 64
_M32 = 0xFFFFFFFF
Q_BLOCK = 512  # the TPU kernel's default query block: part of the mask index


def dropout_threshold(dropout: float) -> int:
    """Keep an element where its hash >= this (``_thr``)."""
    return min(int(round(dropout * 4294967296.0)), 4294967295)


def padded_extents(tq: int, tk: int, q_block: int = Q_BLOCK) -> Tuple[int, int]:
    """``(tq_pad, tk_pad)`` of the TPU kernel (``_pad_shapes``): Tq rounded up
    to the query block (Tq rounded up to 8 when it is below one block), Tk
    rounded up to 128."""
    if tq < q_block:
        q_block = -(-tq // 8) * 8
    return -(-tq // q_block) * q_block, -(-tk // 128) * 128


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` on int64 tensors holding values below 2^32,
    without overflowing int64."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def keep_mask(seed: torch.Tensor, bh: int, tq: int, tk: int, dropout: float,
              q_block: int = Q_BLOCK) -> torch.Tensor:
    """``[bh, tq, tk]`` bool: the elements dropout keeps (murmur3 finalizer of
    ``seed ^ index``, kept where the hash >= ``dropout_threshold``), in torch
    integer arithmetic on ``seed``'s device."""
    tq_pad, tk_pad = padded_extents(tq, tk, q_block)
    dev = seed.device
    i64 = torch.int64
    head = torch.arange(bh, dtype=i64, device=dev)[:, None, None]
    row = torch.arange(tq, dtype=i64, device=dev)[None, :, None]
    col = torch.arange(tk, dtype=i64, device=dev)[None, None, :]
    index = (head * tq_pad + row) * tk_pad + col
    x = (index & _M32) ^ (seed.to(i64) & _M32) ^ _mul32(index >> 32, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= dropout_threshold(dropout)


def _keep_scale(seed, q, k, dropout: float, q_block: int):
    """f32 ``keep / (1 - dropout)``, or None without dropout."""
    if dropout <= 0.0:
        return None
    keep = keep_mask(seed, q.shape[0], q.shape[1], k.shape[1], dropout, q_block)
    return keep.to(torch.float32) * (1.0 / (1.0 - dropout))


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def plain_forward(q, k, v, seed, dropout: float, q_block: int = Q_BLOCK):
    """``(out [BH, Tq, hd] in v.dtype, lse [BH, Tq] f32)`` of the plain
    version: f32 logits of bf16 operands, probabilities normalised in f32,
    dropout applied, then cast to bf16 for the f32-accumulated product."""
    logits = torch.matmul(_f32(q), _f32(k).transpose(-1, -2))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(-1, keepdim=True)
    lse = (m + torch.log(s))[..., 0]
    attn = p / s
    ks = _keep_scale(seed, q, k, dropout, q_block)
    if ks is not None:
        attn = attn * ks
    out = torch.matmul(_f32(attn), _f32(v)).to(v.dtype)
    return out, lse


def plain_backward(q, k, v, lse, d_out, seed, dropout: float, q_block: int = Q_BLOCK):
    """``(dq, dk, dv)`` of the plain version, written out as the TPU backward
    kernel: P recomputed from lse, the row term ``sum(P * dP)`` taken from the
    resident P and dP, dS and A rounded to bf16 before their products."""
    qf, kf, vf, dof = _f32(q), _f32(k), _f32(v), _f32(d_out)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) - lse[..., None])
    da = torch.matmul(dof, vf.transpose(-1, -2))
    ks = _keep_scale(seed, q, k, dropout, q_block)
    a, dp = (p, da) if ks is None else (p * ks, da * ks)
    r = (p * dp).sum(-1, keepdim=True)
    ds = _f32(p * (dp - r))
    dq = torch.matmul(ds, kf).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype)
    dv = torch.matmul(_f32(a).transpose(-1, -2), dof).to(v.dtype)
    return dq, dk, dv


class _PlainTrainAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, dropout, q_block):
        out, lse = plain_forward(q, k, v, seed, dropout, q_block)
        ctx.save_for_backward(q, k, v, seed, lse)
        ctx.dropout, ctx.q_block = dropout, q_block
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, seed, lse = ctx.saved_tensors
        dq, dk, dv = plain_backward(q, k, v, lse, d_out, seed, ctx.dropout, ctx.q_block)
        return dq, dk, dv, None, None, None


def flash_attention_train_reference(q, k, v, seed, *, dropout: float = 0.0,
                                    q_block: int = Q_BLOCK) -> torch.Tensor:
    """Plain version of ``flash_attention_train`` (any head dim, any device)."""
    return _PlainTrainAttention.apply(q, k, v, _seed_tensor(seed, q.device),
                                      float(dropout), q_block)


# -- the kernels -----------------------------------------------------------------


def _seed_tensor(seed, device) -> torch.Tensor:
    """The seed as one int64 on ``device`` (a Python int is copied there; a
    tensor drawn on the device stays there, so no sync is needed)."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64).reshape(())
    return torch.tensor(int(seed) & _M32, dtype=torch.int64, device=device)


def _check_operands(q, k, v):
    bh, tq, hd = q.shape
    tk = k.shape[1]
    if hd != _HD or k.shape != (bh, tk, hd) or v.shape != (bh, tk, hd):
        raise ValueError(f"flash_attention_train kernel takes head dim 64 and matching "
                         f"k/v; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("flash_attention_train kernel takes bf16 operands, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    return bh, tq, tk


def _mask_args(tq: int, tk: int, dropout: float):
    tq_pad, tk_pad = padded_extents(tq, tk)
    return (ctypes.c_uint32(dropout_threshold(dropout) if dropout > 0.0 else 0),
            ctypes.c_float(1.0 / (1.0 - dropout)), tq_pad, tk_pad)


def flash_attention_train_forward(q, k, v, seed: torch.Tensor, dropout: float):
    """Launch the forward kernel: ``(out bf16 [BH, Tq, 64], lse f32 [BH, Tq])``.
    CPU tensors take ``plain_forward``."""
    if not q.is_cuda:
        return plain_forward(q, k, v, seed, dropout)
    from voxactb_tpu_torch.ops.cuda.build import check, library, stream_ptr

    bh, tq, tk = _check_operands(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    lib = library("flash_attention_train")
    fn = lib.voxactb_flash_attention_train_fwd
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 6 + [ci, ci, ci, ctypes.c_uint32, ctypes.c_float, ci, ci, vp]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seed.data_ptr(), out.data_ptr(),
             lse.data_ptr(), bh, tq, tk, *_mask_args(tq, tk, dropout),
             stream_ptr(q.device))
    check(lib, "flash_attention_train", err)
    LAUNCHES["flash_attention_train_fwd"] += 1
    return out, lse


def flash_attention_train_backward(q, k, v, lse, d_out, seed: torch.Tensor,
                                   dropout: float):
    """Launch the backward kernels: ``(dq, dk, dv)`` in bf16. CPU tensors take
    ``plain_backward``."""
    if not q.is_cuda:
        return plain_backward(q, k, v, lse, d_out, seed, dropout)
    from voxactb_tpu_torch.ops.cuda.build import check, library, stream_ptr

    bh, tq, tk = _check_operands(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    d_out = d_out.to(torch.bfloat16).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    lib = library("flash_attention_train")
    fn = lib.voxactb_flash_attention_train_bwd
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 10 + [ci, ci, ci, ctypes.c_uint32, ctypes.c_float, ci, ci, vp]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), lse.data_ptr(),
             seed.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
             bh, tq, tk, *_mask_args(tq, tk, dropout),
             stream_ptr(q.device))
    check(lib, "flash_attention_train", err)
    LAUNCHES["flash_attention_train_bwd"] += 1
    return dq, dk, dv


class _KernelTrainAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, dropout):
        out, lse = flash_attention_train_forward(q, k, v, seed, dropout)
        ctx.save_for_backward(q, k, v, seed, lse)
        ctx.dropout = dropout
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, seed, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_train_backward(q, k, v, lse, d_out, seed,
                                                    ctx.dropout)
        return dq, dk, dv, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed, *,
                          dropout: float = 0.0) -> torch.Tensor:
    """Differentiable ``[BH, Tq, 64] x [BH, Tk, 64] -> [BH, Tq, 64]`` in bf16;
    q must be PRE-SCALED by ``dim_head ** -0.5``. ``seed`` (an int, or an
    integer tensor holding a value below 2^32) derives the dropout mask and is
    ignored when ``dropout == 0``; gradients flow to q, k and v. CPU tensors
    take the plain version."""
    if not q.is_cuda:
        return flash_attention_train_reference(q, k, v, seed, dropout=dropout)
    bf = torch.bfloat16
    return _KernelTrainAttention.apply(q.to(bf), k.to(bf), v.to(bf),
                                       _seed_tensor(seed, q.device), float(dropout))
