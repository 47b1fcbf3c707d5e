"""K8's phase GEMM (voxactb_tpu_torch/csrc/phase_gemm.cuh): its work split
(``phase_gemm_items``) stores every (cell, phase) of u0 once, and a plain
PyTorch model of its schedule (4 x 4 x 4-cell bricks gathered from their
clamped halo of the edge-padded slab, the K-major table that the wrapper
builds, f32 sums over taps and k16 steps, + bias, bf16, the f32-slope lrelu)
lands within one bf16 ulp of ``upsample_from_table`` and, followed by the plain
tail, holds against the JAX package's decoder_head_v3 kernel in interpret
mode at C = 64. The same model fed a table with its ry and rx phases swapped
misses it: the planted fault that chip_smoke.py runs through the kernel is
visible."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.decoder_head_v3 import decoder_head_v3 as jv3
from voxactb_tpu_torch.ops.cuda.decoder_head import decoder_head_reference
from voxactb_tpu_torch.ops.cuda.decoder_head_v3 import (
    edge_pad_slab, phase_gemm_items, phase_gemm_table, phase_weight_table,
    upsample_from_table)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("s", [2, 3, 4, 10, 20])
def test_phase_gemm_items_store_every_cell_and_phase_once(s, b):
    for ctas in (1, 7, 132):
        count = np.zeros((b, s, s, s, 125), np.int32)
        for items in phase_gemm_items(b, s, ctas):
            for bricks, phases in items:
                assert len(bricks) <= 4 and len(phases) <= 2
                for smp, z0, y0, x0 in bricks:
                    for p in phases:
                        count[smp, z0:z0 + 4, y0:y0 + 4, x0:x0 + 4, p] += 1
        assert (count == 1).all()


def phase_gemm_schedule(h, table, up_bias):
    """A plain model of the kernel: u0 ``[B,5s,5s,5s,C]`` bf16 from h
    ``[B,s,s,s,C]`` bf16, the ``[5,5,9C,15C]`` f32 table and the f32 bias."""
    b, s, c = h.shape[0], h.shape[1], h.shape[-1]
    f32 = torch.float32
    hp = edge_pad_slab(h).to(f32)  # [B, s+2, s+2, s+2, C]
    ktab = phase_gemm_table(table).to(f32)  # [27, 125 C, C]
    ne = -(-s // 4)
    nb = b * ne ** 3
    bricks = next(iter(phase_gemm_items(b, s, 1)))  # one CTA: every item in order
    origins = sorted({o for bs, _ in bricks for o in bs})
    assert len(origins) == nb
    o = torch.tensor(origins)
    ax = [(o[:, 1 + a, None] + torch.arange(6)).clamp(max=s + 1) for a in range(3)]
    halo = hp[o[:, 0, None, None, None], ax[0][:, :, None, None], ax[1][:, None, :, None],
              ax[2][:, None, None, :]]  # [nb, 6, 6, 6, C]
    acc = torch.zeros(nb, 4, 4, 4, 125 * c, dtype=f32)
    for tap in range(27):
        dz, dy, dx = tap // 9, tap // 3 % 3, tap % 3
        rows = halo[:, dz:dz + 4, dy:dy + 4, dx:dx + 4]
        for kk in range(4):
            ks = slice(16 * kk, 16 * kk + 16)
            acc = acc + rows[..., ks] @ ktab[tap][:, ks].T
    pre = (acc.reshape(nb, 4, 4, 4, 125, c) + up_bias.to(f32)).to(torch.bfloat16)
    act = torch.where(pre >= 0, pre, (pre.to(f32) * 0.02).to(torch.bfloat16))
    n = 5 * s
    u0 = torch.empty(b, n, n, n, c, dtype=torch.bfloat16)
    for i, (smp, z0, y0, x0) in enumerate(origins):
        ez, ey, ex = min(4, s - z0), min(4, s - y0), min(4, s - x0)
        blk = act[i, :ez, :ey, :ex].reshape(ez, ey, ex, 5, 5, 5, c)
        u0[smp, 5 * z0:5 * (z0 + ez), 5 * y0:5 * (y0 + ey), 5 * x0:5 * (x0 + ex)] = blk.permute(
            0, 3, 1, 4, 2, 5, 6).reshape(5 * ez, 5 * ey, 5 * ex, c)
    return u0


def _case(t_heads, n, b, c=64):
    rng = np.random.default_rng(500 + 10 * n + 3 * b + t_heads)
    s = n // 5
    d0 = rng.normal(size=(b, n, n, n, c)).astype(np.float32)
    h = rng.normal(size=(b, s, s, s, c)).astype(np.float32)
    upk = (rng.normal(size=(5, 5, 5, c, c)) * 0.04).astype(np.float32)
    upb = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    wf = (rng.normal(size=(3, 3, 3, 2 * c, c)) * 0.05).astype(np.float32)
    bf = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    wt = (rng.normal(size=(t_heads, 3, 3, 3, c, 1)) * 0.05).astype(np.float32)
    bt = (rng.normal(size=(t_heads,)) * 0.1).astype(np.float32)
    return d0, h, upk, upb, wf, bf, wt, bt


def _jax_v3(d0, h, upk, upb, wf, bf, wt, bt):
    return [np.asarray(a) for a in jv3(
        jnp.asarray(d0, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16),
        *map(jnp.asarray, (upk, upb, wf, bf, wt, bt)), interpret=True)]


def _model_v3(case, table_fn=phase_weight_table):
    d0, h, upk, upb, wf, bf, wt, bt = (torch.tensor(a) for a in case)
    tb = torch.bfloat16
    table = table_fn(upk)
    u0 = phase_gemm_schedule(h.to(tb), table, upb)
    return u0, decoder_head_reference(d0.to(tb), u0, wf, bf, wt, bt)


@pytest.mark.parametrize("t_heads", [1, 2])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n", [10, 15])
def test_phase_gemm_schedule_matches_pallas_kernel(n, b, t_heads):
    case = _case(t_heads, n, b)
    trans_ref, kp_ref, gmax_ref = _jax_v3(*case)
    u0, (trans, kp, gmax) = _model_v3(case)
    # the phase GEMM's u0 within one bf16 ulp of the plain phase conv's: both
    # round the same 1728-term f32 sum once, in another order. On the
    # negative side the f32 slope and a second rounding carry an ulp of the
    # pre-activation into up to 1.5 ulp of u0; where the sum cancels to near 0
    # the order's f32 noise (about 1e-6 on terms of about 1) is more than an
    # ulp, hence the absolute 2^-20 of the largest |u0|
    table = phase_weight_table(torch.tensor(case[2])).to(torch.bfloat16)
    u0_plain = upsample_from_table(torch.tensor(case[1]).to(torch.bfloat16), table,
                                   torch.tensor(case[3]), torch.bfloat16).float()
    diff = (u0.float() - u0_plain).abs()
    ulps = torch.where(u0_plain < 0, 1.5, 1.0)
    assert (diff <= ulps * 2.0 ** -7 * u0_plain.abs()
            + 2.0 ** -20 * u0_plain.abs().max()).all()
    assert (diff > 0).float().mean() < 1e-3
    assert trans.shape == (b, n, n, n, t_heads)
    # test_torch_decoder_head_v3.py's bf16 tolerances: u0 and u are f32 sums
    # in another order rounded to bf16, carried into the f32 trans sum
    t_max, g_max = np.abs(trans_ref).max(), np.abs(gmax_ref).max()
    np.testing.assert_allclose(trans.numpy(), trans_ref, atol=2e-3 * t_max, rtol=0)
    np.testing.assert_allclose(gmax.numpy(), gmax_ref, atol=2.0 ** -7 * g_max, rtol=0)
    np.testing.assert_allclose(kp.numpy(), kp_ref, atol=1e-4, rtol=0)
    assert (trans.numpy().reshape(b, -1, t_heads).argmax(1)
            == trans_ref.reshape(b, -1, t_heads).argmax(1)).all()


def _swapped_ry_rx(up_kernel, scale=5):
    """chip_smoke.py's ``phase_table_ry_rx_swapped`` fault."""
    t = phase_weight_table(up_kernel, scale)
    rows, c = t.shape[2], t.shape[3] // (3 * scale)
    return t.reshape(scale, scale, rows, 3, scale, c).transpose(1, 4).reshape(t.shape)


def test_swapped_phases_miss_pallas_kernel():
    case = _case(1, 10, 1)
    trans_ref = _jax_v3(*case)[0]
    _, (trans, _, _) = _model_v3(case, _swapped_ry_rx)
    assert np.abs(trans.numpy() - trans_ref).max() > 2e-3 * np.abs(trans_ref).max()
