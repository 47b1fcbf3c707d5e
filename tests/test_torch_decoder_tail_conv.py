"""The decoder tail's u conv (voxactb_tpu_torch/csrc/tail_conv.cuh), which K3
and K8 launch: its brick geometry (``brick_grid``) covers every output voxel
once, and a plain PyTorch model of its schedule (output bricks, a clamped
halo, the source and tap order, f32 sums), followed by the plain tail, holds
against the JAX package's decoder_head_v2 kernel in interpret mode. The same
model with a zero-padded halo misses it at the boundary: the planted fault
that chip_smoke.py runs through the kernel is visible."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.decoder_head_v2 import decoder_head_v2
from voxactb_tpu_torch.models.blocks import lrelu
from voxactb_tpu_torch.ops.cuda.decoder_head import (
    brick_grid, brick_origin, decoder_head_reference, tail_conv_reference, tail_from_u)

_BRICK = (4, 8, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n", [10, 13, 37, 50, 100])
def test_brick_grid_covers_every_voxel_once(n, b):
    grid = brick_grid(b, n)
    assert grid == (b, -(-n // 4), -(-n // 8), -(-n // 8))
    count = np.zeros((b, n, n, n), np.int32)
    for i in range(int(np.prod(grid))):
        s, z0, y0, x0 = brick_origin(i, grid)
        assert z0 < n and y0 < n and x0 < n
        count[s, z0:z0 + 4, y0:y0 + 8, x0:x0 + 8] += 1
    assert (count == 1).all()


def brick_schedule_conv(d0, u0, wf, bf, clamp=True):
    """A plain model of the kernel's schedule: every output brick of
    ``brick_grid`` (partial ones computed whole and cut) from its
    6 x 10 x 10 halo, gathered with every index clamped to [0, N - 1]
    (``clamp=False``: zeros outside the grid); per brick the f32 sum over
    the source (d0, then u0), then the taps (dy, dx) with dz innermost, each
    tap a [256, 64] x [64, 64] product; then acc + bf in f32, one rounding to
    d0's dtype and the lrelu. Returns u ``[B,N,N,N,64]``."""
    b, n, c = d0.shape[0], d0.shape[1], d0.shape[-1]
    f32 = torch.float32
    srcs = [x.to(f32) for x in (d0, u0)]
    w = wf.to(d0.dtype).to(f32).reshape(3, 3, 3, 2 * c, c)
    grid = brick_grid(b, n)
    nbr = int(np.prod(grid))
    origins = torch.tensor([brick_origin(i, grid) for i in range(nbr)])
    # halo index of every brick along each axis: [nbr, 6] / [nbr, 10]
    axes = [origins[:, 1 + a, None] + torch.arange(e + 2) - 1 for a, e in enumerate(_BRICK)]
    inside = [(ix >= 0) & (ix < n) for ix in axes]
    axes = [ix.clamp(0, n - 1) for ix in axes]
    sample = origins[:, 0, None, None, None]
    zi, yi, xi = axes[0][:, :, None, None], axes[1][:, None, :, None], axes[2][:, None, None, :]
    mask = (inside[0][:, :, None, None] & inside[1][:, None, :, None]
            & inside[2][:, None, None, :])[..., None].to(f32)
    acc = torch.zeros(nbr, *_BRICK, c, dtype=f32)
    bz, by, bx = _BRICK
    for half, src in enumerate(srcs):
        halo = src[sample, zi, yi, xi]  # [nbr, 6, 10, 10, C]
        if not clamp:
            halo = halo * mask
        for dy in range(3):
            for dx in range(3):
                for dz in range(3):
                    rows = halo[:, dz:dz + bz, dy:dy + by, dx:dx + bx]
                    acc = acc + rows @ w[dz, dy, dx, half * c:(half + 1) * c]
    pre = acc + bf.to(f32)
    ub = lrelu(pre.to(d0.dtype))
    u = torch.empty(b, n, n, n, c, dtype=d0.dtype)
    for i in range(nbr):
        s, z0, y0, x0 = origins[i].tolist()
        ez, ey, ex = min(bz, n - z0), min(by, n - y0), min(bx, n - x0)
        u[s, z0:z0 + ez, y0:y0 + ey, x0:x0 + ex] = ub[i, :ez, :ey, :ex]
    return u


def _case(t_heads, n, b, c=64):
    rng = np.random.default_rng(100 * n + 10 * b + t_heads)
    d0 = rng.normal(size=(b, n, n, n, c)).astype(np.float32)
    u0 = rng.normal(size=(b, n, n, n, c)).astype(np.float32)
    wf = (rng.normal(size=(3, 3, 3, 2 * c, c)) * 0.05).astype(np.float32)
    bf = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    wt = (rng.normal(size=(t_heads, 3, 3, 3, c, 1)) * 0.05).astype(np.float32)
    bt = (rng.normal(size=(t_heads,)) * 0.1).astype(np.float32)
    return d0, u0, wf, bf, wt, bt


def _jax_tail(d0, u0, wf, bf, wt, bt):
    return [np.asarray(a) for a in decoder_head_v2(
        jnp.asarray(d0, jnp.bfloat16), jnp.asarray(u0, jnp.bfloat16), jnp.asarray(wf),
        jnp.asarray(bf), jnp.asarray(wt), jnp.asarray(bt), interpret=True)]


def _torch_operands(d0, u0, wf, bf, wt, bt):
    tb = torch.bfloat16
    return (torch.tensor(d0).to(tb), torch.tensor(u0).to(tb), torch.tensor(wf),
            torch.tensor(bf), torch.tensor(wt), torch.tensor(bt))


@pytest.mark.parametrize("t_heads", [1, 2])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n", [10, 13])
def test_brick_schedule_matches_pallas_kernel(n, b, t_heads):
    case = _case(t_heads, n, b)
    trans_ref, kp_ref, gmax_ref = _jax_tail(*case)
    d0, u0, wf, bf, wt, bt = _torch_operands(*case)
    u = brick_schedule_conv(d0, u0, wf, bf)
    trans, kp, gmax = tail_from_u(u, wt, bt)
    assert trans.dtype == torch.float32 and trans.shape == (b, n, n, n, t_heads)
    # the tolerances of test_torch_decoder_head.py: u from 3456-term f32 sums
    # in another order, rounded to bf16 (a sum on a rounding boundary moves u
    # by one ulp); trans is then a 1728-term f32 sum
    np.testing.assert_allclose(trans.numpy(), trans_ref,
                               atol=2e-3 * np.abs(trans_ref).max(), rtol=0)
    np.testing.assert_allclose(kp.numpy(), kp_ref, atol=1e-4)
    np.testing.assert_allclose(gmax.numpy(), gmax_ref, atol=2.0 ** -7 * np.abs(gmax_ref).max())
    assert (trans.numpy().reshape(b, -1, t_heads).argmax(1)
            == trans_ref.reshape(b, -1, t_heads).argmax(1)).all()
    # the plain conv the wrapper takes on the CPU agrees with the schedule's u
    u_plain = tail_conv_reference(d0, u0, wf, bf)
    assert (u.float() - u_plain.float()).abs().max() <= 2.0 ** -7 * u_plain.float().abs().max()


@pytest.mark.parametrize("n", [10, 13])
def test_zero_padded_halo_misses_pallas_kernel(n):
    """The planted ``zero_padded_halo`` fault: zeros for the clamp at the
    grid's faces move trans there beyond the tolerance, and only there."""
    case = _case(1, n, 1)
    trans_ref = _jax_tail(*case)[0]
    d0, u0, wf, bf, wt, bt = _torch_operands(*case)
    trans = tail_from_u(brick_schedule_conv(d0, u0, wf, bf, clamp=False), wt, bt)[0].numpy()
    tol = 2e-3 * np.abs(trans_ref).max()
    err = np.abs(trans - trans_ref)
    assert err.max() > tol
    # two voxels in from every face neither u nor trans sees the padding
    assert err[:, 2:-2, 2:-2, 2:-2].max() <= tol


def test_reference_is_conv_then_tail():
    d0, u0, wf, bf, wt, bt = _torch_operands(*_case(2, 10, 1))
    got = decoder_head_reference(d0, u0, wf, bf, wt, bt)
    want = tail_from_u(tail_conv_reference(d0, u0, wf, bf), wt, bt)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
