"""K4: trainable attention with saved log-sum-exp and hash dropout, head dims up to 128.

Replaces ``voxactb_tpu/ops/pallas/flash_attention.py::flash_attention_train``
(TPU kernels ``_train_fwd_kernel`` / ``_train_bwd_kernel``). The kernels
(``csrc/flash_attention_train.cu``: one forward, and a dQ and a dK/dV kernel
for the backward, on wgmma with TMA-fed tiles) are bounded by operations on an
H100. A ``torch.autograd.Function`` joins forward and backward; saved for the
backward are q, k, v, the seed, the row log-sum-exp and, with dropout, the
keep mask as bits (``keep_bits``: the forward hashes, the backward only reads),
never the probabilities.

Beside the kernels stands the plain version, ``flash_attention_train_reference``,
an ``autograd.Function`` too, whose backward is written out with the same mask
and the same rounding points as the TPU kernel. CPU tensors take it; on a CUDA
tensor the wrappers launch the kernels or raise. ``keep_bits`` packs the mask
as the forward kernel saves it (the plain side of that output), and
``plain_backward`` reads the mask from such bits where given.

The dropout mask is a pure function of ``(seed, head, row, column)``:
``keep_mask`` reproduces the TPU kernel's ``_hash_keep`` bit for bit wherever
the element index ``((head * tq_pad) + row) * tk_pad + col`` is below 2^32,
which covers every shape in the repo (the largest, 64 heads of 2048 x 2048, is
2^28). Beyond that the TPU kernel's uint32 index wraps and its mask repeats;
here the index is 64 bits wide and its high word is mixed into the hash, so
the mask stays decorrelated but no longer equals the TPU kernel's.

``head`` is the flat index of the head in the GLOBAL ``[B, H]`` batch of
heads (``MaskIndex``): a call that holds only some of the samples (a data
rank) or some of the heads (a tensor-parallel rank) names where its rows sit,
so that every rank draws the rows of the one-process mask. The default is the
call's own flat index.

The kernels are built for head dims 64 and 128 (``HEAD_DIMS``). The launchers
zero-pad q, k, v and dO of a head of at most 64 to 64 and of 65-128 to 128
(``head_dim.padded_call``) and slice out, dQ, dK and dV back: exact, since the
log-sum-exp, the row term and the mask (indexed by the padded sequence
extents, never the head dim) do not depend on the head dim. Above 128 they
raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.head_dim import kernel_head_dim, padded_call

HEAD_DIMS = (64, 128)  # the kernels' head dims; narrower heads are zero-padded
_M32 = 0xFFFFFFFF
Q_BLOCK = 512  # the TPU kernel's default query block: part of the mask index


class MaskIndex(NamedTuple):
    """Where a call's ``bh = b_local * heads_local`` rows of heads sit in the
    global ``[B, heads_global]`` batch: local row ``i`` is global head
    ``(batch_offset + i // heads_local) * heads_global + head_offset + i %
    heads_local``. The default maps every row to itself."""

    heads_local: int = 1
    heads_global: int = 1
    batch_offset: int = 0
    head_offset: int = 0

    @property
    def base(self) -> int:
        """The global index of local row 0."""
        return self.batch_offset * self.heads_global + self.head_offset


LOCAL = MaskIndex()


def global_heads(bh: int, index: MaskIndex, device) -> torch.Tensor:
    """``[bh]`` int64: the global flat head index of each local row."""
    i = torch.arange(bh, dtype=torch.int64, device=device)
    hl = index.heads_local
    return index.base + (i // hl) * index.heads_global + i % hl


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
              q_block: int = Q_BLOCK, *, index: MaskIndex = LOCAL) -> torch.Tensor:
    """``[bh, tq, tk]`` bool: the elements dropout keeps (murmur3 finalizer of
    ``seed ^ index``, kept where the hash >= ``dropout_threshold``), in torch
    integer arithmetic on ``seed``'s device; the rows' heads placed by
    ``index``."""
    tq_pad, tk_pad = padded_extents(tq, tk, q_block)
    dev = seed.device
    i64 = torch.int64
    head = global_heads(bh, index, dev)[:, None, None]
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


def keep_bits(seed: torch.Tensor, bh: int, tq: int, tk: int, dropout: float,
              q_block: int = Q_BLOCK, *, index: MaskIndex = LOCAL) -> torch.Tensor:
    """``keep_mask`` packed as the forward kernel saves it: ``[bh, tq,
    ceil(tk / 32)]`` int32 holding uint32 words, bit j of word w for column
    ``32 w + j``, bits past ``tk`` zero."""
    keep = keep_mask(seed, bh, tq, tk, dropout, q_block, index=index)
    words = -(-tk // 32)
    keep = torch.nn.functional.pad(keep, (0, 32 * words - tk))
    weight = torch.ones(32, dtype=torch.int64, device=keep.device) << torch.arange(
        32, dtype=torch.int64, device=keep.device)
    packed = (keep.reshape(bh, tq, words, 32).to(torch.int64) * weight).sum(-1)
    return (packed - ((packed >> 31) << 32)).to(torch.int32)


def unpack_keep_bits(bits: torch.Tensor, tk: int) -> torch.Tensor:
    """``[bh, tq, tk]`` bool from ``keep_bits``' words."""
    shift = torch.arange(32, dtype=torch.int32, device=bits.device)
    keep = (bits[..., None] >> shift) & 1
    return keep.reshape(*bits.shape[:-1], -1)[..., :tk].to(torch.bool)


def _keep_scale(seed, q, k, dropout: float, q_block: int, bits=None, index=LOCAL):
    """f32 ``keep / (1 - dropout)``, or None without dropout; the mask from
    ``bits`` where given, else hashed from ``seed``."""
    if dropout <= 0.0:
        return None
    if bits is not None:
        keep = unpack_keep_bits(bits, k.shape[1])
    else:
        keep = keep_mask(seed, q.shape[0], q.shape[1], k.shape[1], dropout, q_block,
                         index=index)
    return keep.to(torch.float32) * (1.0 / (1.0 - dropout))


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def plain_forward(q, k, v, seed, dropout: float, q_block: int = Q_BLOCK, *,
                  index: MaskIndex = LOCAL):
    """``(out [BH, Tq, hd] in v.dtype, lse [BH, Tq] f32)`` of the plain
    version: f32 logits of bf16 operands, probabilities normalised in f32,
    dropout applied, then cast to bf16 for the f32-accumulated product."""
    logits = torch.matmul(_f32(q), _f32(k).transpose(-1, -2))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(-1, keepdim=True)
    lse = (m + torch.log(s))[..., 0]
    attn = p / s
    ks = _keep_scale(seed, q, k, dropout, q_block, index=index)
    if ks is not None:
        attn = attn * ks
    out = torch.matmul(_f32(attn), _f32(v)).to(v.dtype)
    return out, lse


def plain_backward(q, k, v, lse, d_out, seed, dropout: float, q_block: int = Q_BLOCK,
                   *, bits=None, index: MaskIndex = LOCAL):
    """``(dq, dk, dv)`` of the plain version, written out as the TPU backward
    kernel: P recomputed from lse, the row term ``sum(P * dP)`` taken from the
    resident P and dP, dS and A rounded to bf16 before their products. The
    mask comes from ``bits`` (``keep_bits``) where given, else from ``seed``."""
    qf, kf, vf, dof = _f32(q), _f32(k), _f32(v), _f32(d_out)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) - lse[..., None])
    da = torch.matmul(dof, vf.transpose(-1, -2))
    ks = _keep_scale(seed, q, k, dropout, q_block, bits, index)
    a, dp = (p, da) if ks is None else (p * ks, da * ks)
    r = (p * dp).sum(-1, keepdim=True)
    ds = _f32(p * (dp - r))
    dq = torch.matmul(ds, kf).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype)
    dv = torch.matmul(_f32(a).transpose(-1, -2), dof).to(v.dtype)
    return dq, dk, dv


class _PlainTrainAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, dropout, q_block, index):
        out, lse = plain_forward(q, k, v, seed, dropout, q_block, index=index)
        ctx.save_for_backward(q, k, v, seed, lse)
        ctx.dropout, ctx.q_block, ctx.index = dropout, q_block, index
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, seed, lse = ctx.saved_tensors
        dq, dk, dv = plain_backward(q, k, v, lse, d_out, seed, ctx.dropout, ctx.q_block,
                                    index=ctx.index)
        return dq, dk, dv, None, None, None, None


def flash_attention_train_reference(q, k, v, seed, *, dropout: float = 0.0,
                                    q_block: int = Q_BLOCK,
                                    index: MaskIndex = LOCAL) -> torch.Tensor:
    """Plain version of ``flash_attention_train`` (any head dim, any device)."""
    return _PlainTrainAttention.apply(q, k, v, _seed_tensor(seed, q.device),
                                      float(dropout), q_block, MaskIndex(*index))


# -- the kernels -----------------------------------------------------------------


def _seed_tensor(seed, device) -> torch.Tensor:
    """The seed as one int64 on ``device`` (a Python int is copied there; a
    tensor drawn on the device stays there, so no sync is needed)."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64).reshape(())
    return torch.tensor(int(seed) & _M32, dtype=torch.int64, device=device)


def _check_operands(q, k, v):
    """``(bh, tq, tk, width)``: the shapes, and the kernels' head dim that q, k
    and v are padded to; raises on what the kernels do not take."""
    bh, tq, hd = q.shape
    tk = k.shape[1]
    width = kernel_head_dim(hd, HEAD_DIMS, "flash_attention_train")
    if k.shape != (bh, tk, hd) or v.shape != (bh, tk, hd):
        raise ValueError(f"flash_attention_train kernel takes matching q/k/v; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("flash_attention_train kernel takes bf16 operands, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    return bh, tq, tk, width


def _entry(name: str, argtypes):
    """The library's C entry point ``voxactb_flash_attention_train_<name>``
    with its argument types set (once per loaded library)."""
    from voxactb_tpu_torch.ops.cuda.build import entry

    return entry("flash_attention_train", f"voxactb_flash_attention_train_{name}", argtypes)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_VP] * 7 + [_CI, _CI, _CI, ctypes.c_uint32, ctypes.c_float, _CI, _CI, _CI,
                         _CI, ctypes.c_longlong, _CI, _VP]
_BWD_ARGS = [_VP] * 10 + [_CI, _CI, _CI, ctypes.c_float, _CI, _VP]


def _mask_args(tq: int, tk: int, dropout: float):
    tq_pad, tk_pad = padded_extents(tq, tk)
    return (ctypes.c_uint32(dropout_threshold(dropout) if dropout > 0.0 else 0),
            ctypes.c_float(1.0 / (1.0 - dropout)), tq_pad, tk_pad)


def flash_attention_train_forward(q, k, v, seed: torch.Tensor, dropout: float,
                                  index: MaskIndex = LOCAL):
    """Launch the forward kernel: ``(out bf16 [BH, Tq, hd], lse f32 [BH, Tq],
    keep bits [BH, Tq, ceil(Tk / 32)] int32 or None without dropout)``, hd at
    most 128, the mask's heads placed by ``index``. CPU tensors take
    ``plain_forward`` and ``keep_bits``."""
    if not q.is_cuda:
        out, lse = plain_forward(q, k, v, seed, dropout, index=index)
        bits = (keep_bits(seed, q.shape[0], q.shape[1], k.shape[1], dropout, index=index)
                if dropout > 0.0 else None)
        return out, lse, bits
    width = _check_operands(q, k, v)[3]
    return padded_call(_launch_forward, (q, k, v), width, seed, dropout, index,
                       sliced=(0,))


def _launch_forward(q, k, v, seed: torch.Tensor, dropout: float,
                    index: MaskIndex = LOCAL):
    from voxactb_tpu_torch.ops.cuda.build import check, stream_ptr, tma_operand

    bh, tq, tk, hd = _check_operands(q, k, v)
    q, k, v = tma_operand(q), tma_operand(k), tma_operand(v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    bits = (torch.empty((bh, tq, -(-tk // 32)), dtype=torch.int32, device=q.device)
            if dropout > 0.0 else None)
    lib, fn = _entry("fwd", _FWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seed.data_ptr(), out.data_ptr(),
             lse.data_ptr(), None if bits is None else bits.data_ptr(), bh, tq, tk,
             *_mask_args(tq, tk, dropout), index.heads_local, index.heads_global,
             ctypes.c_longlong(index.base), hd, stream_ptr(q.device))
    check(lib, "flash_attention_train", err)
    LAUNCHES["flash_attention_train_fwd"] += 1
    return out, lse, bits


def flash_attention_train_backward(q, k, v, lse, d_out, bits, dropout: float):
    """Launch the backward kernels: ``(dq, dk, dv)`` in bf16, with the keep
    mask read from the forward's ``bits`` (None without dropout), hd at most
    128. CPU tensors take ``plain_backward``."""
    if (bits is None) != (dropout <= 0.0):
        raise ValueError("flash_attention_train backward takes keep bits exactly when "
                         f"dropout > 0 (dropout {dropout}, bits "
                         f"{'absent' if bits is None else 'given'})")
    if not q.is_cuda:
        return plain_backward(q, k, v, lse, d_out, None, dropout, bits=bits)
    width = _check_operands(q, k, v)[3]
    return padded_call(_launch_backward, (q, k, v, d_out.to(torch.bfloat16)), width, lse,
                       bits, dropout, sliced=(0, 1, 2))


def _launch_backward(q, k, v, d_out, lse, bits, dropout: float):
    from voxactb_tpu_torch.ops.cuda.build import check, stream_ptr, tma_operand

    bh, tq, tk, hd = _check_operands(q, k, v)
    if bits is not None and (bits.shape != (bh, tq, -(-tk // 32))
                             or bits.dtype != torch.int32):
        raise ValueError(f"keep bits of shape {tuple(bits.shape)} and {bits.dtype} do "
                         f"not fit q {tuple(q.shape)}, k {tuple(k.shape)}")
    q, k, v = tma_operand(q), tma_operand(k), tma_operand(v)
    d_out = tma_operand(d_out)
    lse = lse.contiguous()
    bits = None if bits is None else bits.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    lib, fn = _entry("bwd", _BWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), lse.data_ptr(),
             None if bits is None else bits.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), delta.data_ptr(), bh, tq, tk,
             ctypes.c_float(1.0 / (1.0 - dropout)), hd, stream_ptr(q.device))
    check(lib, "flash_attention_train", err)
    LAUNCHES["flash_attention_train_bwd"] += 1
    return dq, dk, dv


class _KernelTrainAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, dropout, index):
        out, lse, bits = flash_attention_train_forward(q, k, v, seed, dropout, index)
        ctx.save_for_backward(q, k, v, seed, lse, bits)
        ctx.dropout = dropout
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, _, lse, bits = ctx.saved_tensors
        dq, dk, dv = flash_attention_train_backward(q, k, v, lse, d_out, bits,
                                                    ctx.dropout)
        return dq, dk, dv, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed, *,
                          dropout: float = 0.0, index: MaskIndex = LOCAL) -> torch.Tensor:
    """Differentiable ``[BH, Tq, hd] x [BH, Tk, hd] -> [BH, Tq, hd]`` in bf16,
    hd at most 128; q must be PRE-SCALED by ``hd ** -0.5``. ``seed`` (an int, or an
    integer tensor holding a value below 2^32) derives the dropout mask and is
    ignored when ``dropout == 0``; ``index`` places the rows' heads in the
    global batch of heads; gradients flow to q, k and v. CPU tensors take the
    plain version."""
    index = MaskIndex(*index)
    if not q.is_cuda:
        return flash_attention_train_reference(q, k, v, seed, dropout=dropout, index=index)
    bf = torch.bfloat16
    return _KernelTrainAttention.apply(q.to(bf), k.to(bf), v.to(bf),
                                       _seed_tensor(seed, q.device), float(dropout), index)
