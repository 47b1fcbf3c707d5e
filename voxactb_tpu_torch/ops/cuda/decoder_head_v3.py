"""K8: decoder tail with the x5 upsample computed inside.

Replaces ``voxactb_tpu/ops/pallas/decoder_head_v3.py::decoder_head_v3``:
K3's function (``decoder_head``) with u0 made from the post-``conv_in`` slab
h ``[B,s,s,s,C]`` (s = N / 5) as

    u0 = lrelu(bf16(phase-conv(edge-pad(h), table) + b_up))

where the phase-weight table is the x5 trilinear upsample composed with the
learned k5 ``out_kernel`` in f32 and rounded to the compute dtype ONCE (the
XLA path, ``ops/upsample_conv.compose_upsample_kernel``, rounds after each
axis, and adds a bf16 bias), h is edge-padded on all three axes, and the
lrelu of u0 multiplies by the f32 slope. The compute dtype is d0's.

The kernel (``csrc/decoder_head_v3.cu``) is bounded by operations on an H100:
at 100^3, B = 1 the phase conv is 221 GFLOP and the tail's u conv 442. The
phase conv is a GEMM (``csrc/phase_gemm.cuh``) over bricks of 4 x 4 x 4 cells
and blocks of two phases (``phase_gemm_items``).
"""

from __future__ import annotations

import ctypes

import torch

from voxactb_tpu_torch.models.blocks import conv3d_f32acc, edge_pad, to_ncdhw, to_ndhwc
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.decoder_head import (
    check_tail_operands, decoder_head_reference, tail_outputs, tail_weights,
    trans_stats_grid)
from voxactb_tpu_torch.ops.cuda.graphs import derived, weight
from voxactb_tpu_torch.ops.upsample_conv import phase_taps

_SCALE = 5
# csrc/phase_gemm.cuh: bricks of kQ^3 cells, kBricksPerItem bricks and
# kPhasesPerItem phases per work item
_BRICK_CELLS = 4
_BRICKS_PER_ITEM = 4
_PHASES_PER_ITEM = 2


def phase_gemm_items(b, s, ctas):
    """The phase GEMM's work split over ``ctas`` persistent CTAs on a
    ``[B,s,s,s]`` slab: for each CTA the items it takes, each as ``(bricks,
    phases)``. Bricks of 4 x 4 x 4 cells are numbered x fastest, then y, z,
    sample (``(sample, z0, y0, x0)``, cut at s when stored); item ``i`` is
    bricks ``4 (i // 63) ..`` (those that exist) and phases ``2 (i % 63),
    2 (i % 63) + 1`` below 125; CTA ``c`` takes items ``[c I / ctas, (c + 1)
    I / ctas)`` of the ``I``."""
    ne = -(-s // _BRICK_CELLS)
    nb = b * ne ** 3
    blocks = -(-_SCALE ** 3 // _PHASES_PER_ITEM)
    n_items = -(-nb // _BRICKS_PER_ITEM) * blocks

    def brick(i):
        x, i = i % ne, i // ne
        y, i = i % ne, i // ne
        z, smp = i % ne, i // ne
        return smp, z * _BRICK_CELLS, y * _BRICK_CELLS, x * _BRICK_CELLS

    def item(i):
        q, pb = divmod(i, blocks)
        bricks = [brick(j) for j in range(_BRICKS_PER_ITEM * q,
                                          min(_BRICKS_PER_ITEM * (q + 1), nb))]
        phases = [p for p in range(_PHASES_PER_ITEM * pb, _PHASES_PER_ITEM * (pb + 1))
                  if p < _SCALE ** 3]
        return bricks, phases

    return [[item(i) for i in range(n_items * c // ctas, n_items * (c + 1) // ctas)]
            for c in range(ctas)]


def phase_weight_table(up_kernel: torch.Tensor, scale: int = _SCALE) -> torch.Tensor:
    """``[k,k,k,Cin,Cout]`` learned upsample kernel -> ``[scale, scale, 9 Cin,
    3 scale Cout]`` table in the kernel's dtype: rows (dz, dy, ci), columns
    (dx, rx, co), the leading axes (rz, ry). The tap matrix and the kernel in
    one contraction, as ``decoder_head_v3.py::_phase_weight_table``."""
    k = up_kernel.shape[0]
    cin, cout = up_kernel.shape[3], up_kernel.shape[4]
    t = phase_taps(scale, k, up_kernel.device).to(up_kernel.dtype)
    w8 = torch.einsum("aud,bve,cwf,uvwio->defiabco", t, t, t, up_kernel)
    # [dz, dy, dx, ci, rz, ry, rx, co] -> [rz, ry, dz, dy, ci, dx, rx, co]
    w = w8.permute(4, 5, 0, 1, 3, 2, 6, 7)
    return w.reshape(scale, scale, 9 * cin, 3 * scale * cout)


def _table_taps(table: torch.Tensor) -> torch.Tensor:
    """``[5,5,9C,15C]`` -> ``[5,5,3,3,C,3,5,C]`` (rz, ry, dz, dy, ci, dx, rx, co)."""
    c = table.shape[-1] // (3 * _SCALE)
    return table.reshape(_SCALE, _SCALE, 3, 3, c, 3, _SCALE, c)


def phase_gemm_table(table: torch.Tensor) -> torch.Tensor:
    """``[5,5,9C,15C]`` -> the phase GEMM's K-major B ``[27, 125 C, C]`` bf16:
    tap (dz, dy, dx), output column (rz, ry, rx, co), ci."""
    c = table.shape[-1] // (3 * _SCALE)
    return _table_taps(table).permute(2, 3, 5, 0, 1, 6, 7, 4).to(torch.bfloat16).reshape(
        27, _SCALE ** 3 * c, c)


def upsample_from_table(h: torch.Tensor, table: torch.Tensor, up_bias: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """u0 ``[B,5s,5s,5s,C]`` from h ``[B,s,s,s,C]``: the phase conv of the
    edge-padded h in ``dtype`` (f32 sums), plus the f32 bias, rounded to
    ``dtype``, then the lrelu with the f32 slope, rounded once."""
    b, s, c = h.shape[0], h.shape[1], h.shape[-1]
    n = _SCALE * s
    # [(rz, ry, rx, co), ci, dz, dy, dx]: a k3 conv with 125 C output channels
    w = _table_taps(table).permute(0, 1, 6, 7, 4, 2, 3, 5).reshape(
        _SCALE ** 3 * c, c, 3, 3, 3)
    y = conv3d_f32acc(edge_pad(to_ncdhw(h.to(dtype)), 1), w.to(dtype), 1)
    y = y.reshape(b, _SCALE, _SCALE, _SCALE, c, s, s, s).permute(
        0, 5, 1, 6, 2, 7, 3, 4).reshape(b, n, n, n, c)
    u0 = (y + up_bias.to(torch.float32)).to(dtype)
    return torch.where(u0 >= 0, u0, (u0.to(torch.float32) * 0.02).to(dtype))


def decoder_head_v3_reference(d0, h, up_kernel, up_bias, wf, bf, wt, bt):
    """Plain version, in d0's dtype. d0 ``[B,N,N,N,C]``; h ``[B,N/5,N/5,N/5,C]``;
    up_kernel ``[5,5,5,C,C]``; up_bias ``[C]``; wf, bf, wt, bt as
    ``decoder_head`` -> ``(trans [B,N,N,N,T] f32, kp [B,3C] f32, gmax [B,C]
    f32)``."""
    dt = d0.dtype
    table = phase_weight_table(up_kernel.to(torch.float32)).to(dt)
    u0 = upsample_from_table(h, table, up_bias, dt)
    return decoder_head_reference(d0, u0, wf, bf, wt, bt)


def edge_pad_slab(h: torch.Tensor) -> torch.Tensor:
    """h ``[B,s,s,s,C]`` edge-padded by one on all three axes, channels last."""
    return to_ndhwc(edge_pad(to_ncdhw(h), 1)).contiguous()


def decoder_head_v3(d0, h, up_kernel, up_bias, wf, bf, wt, bt):
    """Same arguments and returns as ``decoder_head_v3_reference``; CPU
    tensors take the plain version, CUDA tensors the kernel (bf16 d0 and h
    only), with the table composed in f32 from the f32 ``up_kernel``."""
    if not d0.is_cuda:
        return decoder_head_v3_reference(d0, h, up_kernel, up_bias, wf, bf, wt, bt)
    table = derived(phase_weight_table, weight(up_kernel, torch.float32))
    return launch_decoder_head_v3(d0, edge_pad_slab(h), table, up_bias, wf, bf, wt, bt)[:3]


def launch_decoder_head_v3(d0, hp, table, up_bias, wf, bf, wt, bt):
    """The kernel on the edge-padded slab ``hp [B,s+2,s+2,s+2,C]`` and the
    ``[5,5,9C,15C]`` phase table (rounded to bf16 here): ``(trans, kp, gmax,
    u0)``, with the u0 grid ``[B,N,N,N,C]`` bf16 that its phase GEMM wrote."""
    from voxactb_tpu_torch.ops.cuda.build import check, entry, sm_count, stream_ptr, tma_operand

    check_tail_operands("decoder_head_v3", d0, wf, wt, hp)
    b, n, c = d0.shape[0], d0.shape[1], d0.shape[-1]
    s = n // _SCALE
    if n % _SCALE or hp.shape != (b, s + 2, s + 2, s + 2, c) or table.shape != (
            _SCALE, _SCALE, 9 * c, 3 * _SCALE * c):
        raise ValueError(f"decoder_head_v3 kernel takes N % 5 == 0, hp [B,N/5+2,...,C] "
                         f"and a [5,5,9C,15C] table; got d0 {tuple(d0.shape)}, hp "
                         f"{tuple(hp.shape)}, table {tuple(table.shape)}")
    t_heads = wt.shape[0]
    dev = d0.device
    f32, bf16 = torch.float32, torch.bfloat16
    d0c, hpc = d0.contiguous(), hp.contiguous()
    ktab = tma_operand(derived(phase_gemm_table, table))
    upb = up_bias.to(f32).contiguous()
    wf_bf, bf_f, wt_bf, bt_f = derived(tail_weights, wf, bf, wt, bt)
    wf_bf = tma_operand(wf_bf)
    lin = torch.linspace(-1.0, 1.0, n, dtype=f32, device=dev)

    g_ctas = trans_stats_grid(b, n, sm_count(dev))
    u0 = torch.empty((b, n ** 3, c), dtype=bf16, device=dev)
    u = torch.empty((b, n ** 3, c), dtype=bf16, device=dev)
    part, trans, kp, gmax = tail_outputs(b, n, c, t_heads, g_ctas, dev)

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib, fn = entry("decoder_head_v3", "voxactb_decoder_head_v3",
                    [vp] * 9 + [ci] * 4 + [vp] * 7)
    err = fn(d0c.data_ptr(), hpc.data_ptr(), ktab.data_ptr(),
             upb.data_ptr(), wf_bf.data_ptr(), bf_f.data_ptr(), wt_bf.data_ptr(),
             bt_f.data_ptr(), lin.data_ptr(), b, n, t_heads, g_ctas, u0.data_ptr(),
             u.data_ptr(), part.data_ptr(), trans.data_ptr(), kp.data_ptr(),
             gmax.data_ptr(), stream_ptr(dev))
    check(lib, "decoder_head_v3", err)
    LAUNCHES["decoder_head_v3"] += 1
    LAUNCHES["decoder_phase_gemm"] += 1
    LAUNCHES["decoder_tail_conv"] += 1
    LAUNCHES["decoder_tail_trans_stats"] += 1
    return trans, kp, gmax, u0.reshape(b, n, n, n, c)
