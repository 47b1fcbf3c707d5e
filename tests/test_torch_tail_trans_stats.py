"""The decoder tail's trans/stats pass (voxactb_tpu_torch/csrc/decoder_tail.cuh),
which K3 and K8 launch after their u conv: its launch geometry
(``trans_stats_grid`` over ``brick_grid``'s bricks) covers every voxel once,
and a plain PyTorch model of its schedule (a clamped 6 x 10 x 10 halo per
brick, the trans sums per k half with the dz taps side by side, the two-pass
soft-argmax fold per half plane of a brick, the merges per CTA and then in
``stats_combine``'s order) holds against the JAX package's decoder_head_v2
kernel in interpret mode and against the plain ``tail_from_u``. The same
model with a zero-filled halo misses the JAX kernel at the faces: the planted
fault that chip_smoke.py runs through the kernel is visible."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.decoder_head_v2 import decoder_head_v2
from voxactb_tpu_torch.ops.cuda.decoder_head import (
    brick_grid, brick_origin, head_weights, tail_conv_reference, tail_from_u,
    trans_stats_grid)

_BRICK = (4, 8, 8)
_INV_T = 100.0       # csrc/common.cuh kInvTemperature
_COMBINE_GROUPS = 16  # csrc/common.cuh stats_combine: 1024 threads / 64 channels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ctas(b, n, sms):
    """``{(sample, g): [brick index, ...]}``: the bricks each CTA walks."""
    grid = brick_grid(b, n)
    per = int(np.prod(grid[1:]))
    g_ctas = trans_stats_grid(b, n, sms)
    return {(s, g): [s * per + p for p in range(g, per, g_ctas)]
            for s in range(b) for g in range(g_ctas)}


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n", [10, 13, 37, 50, 100])
def test_trans_stats_grid_covers_every_voxel_once(n, b):
    grid = brick_grid(b, n)
    for sms in (1, 5, 132):
        count = np.zeros((b, n, n, n), np.int32)
        ctas = _ctas(b, n, sms)
        assert len(ctas) == b * trans_stats_grid(b, n, sms)
        for (s, _), bricks in ctas.items():
            assert bricks, "a CTA without bricks leaves an empty partial"
            for i in bricks:
                smp, z0, y0, x0 = brick_origin(i, grid)
                assert smp == s
                count[s, z0:z0 + 4, y0:y0 + 8, x0:x0 + 8] += 1
        assert (count == 1).all()


def _merge(a, b):
    """``stat_merge`` of two (m, s, wx, wd, wz) tuples of f32 tensors."""
    m = torch.maximum(a[0], b[0])

    def corr(mo):
        c = torch.exp((mo - m) * _INV_T)
        return torch.where(torch.isfinite(c), c, torch.zeros_like(c))

    ca, cb = corr(a[0]), corr(b[0])
    return (m,) + tuple(x * ca + y * cb for x, y in zip(a[1:], b[1:]))


def _empty(c):
    inf = torch.full((c,), -float("inf"))
    return (inf,) + tuple(torch.zeros(c) for _ in range(4))


def trans_stats_schedule(u, wt, bt, sms=132, clamp=True):
    """A plain model of the kernel on u ``[B,N,N,N,C]`` bf16: trans ``[B,N,N,N,T]``
    f32, kp ``[B,3C]``, gmax ``[B,C]``. ``clamp=False``: zeros outside the
    grid in the halo instead of the clamped neighbours."""
    b, n, c = u.shape[0], u.shape[1], u.shape[-1]
    f32 = torch.float32
    t_heads = wt.shape[0]
    w = head_weights(wt, bt)[0].to(f32).reshape(3, 3, 3, c, t_heads)
    bias = bt.to(f32)
    lin = torch.linspace(-1.0, 1.0, n, dtype=f32)
    uf = u.to(f32)
    grid = brick_grid(b, n)
    nbr = int(np.prod(grid))
    origins = torch.tensor([brick_origin(i, grid) for i in range(nbr)])
    axes = [origins[:, 1 + a, None] + torch.arange(e + 2) - 1 for a, e in enumerate(_BRICK)]
    inside = [(ix >= 0) & (ix < n) for ix in axes]
    axes = [ix.clamp(0, n - 1) for ix in axes]
    zi, yi, xi = axes[0][:, :, None, None], axes[1][:, None, :, None], axes[2][:, None, None, :]
    halo = uf[origins[:, 0, None, None, None], zi, yi, xi]  # [nbr, 6, 10, 10, C]
    if not clamp:
        halo = halo * (inside[0][:, :, None, None] & inside[1][:, None, :, None]
                       & inside[2][:, None, None, :])[..., None].to(f32)
    bz, by, bx = _BRICK
    # per k half: each halo plane times the taps dz = 0..2 side by side; then
    # output plane z sums tap dz of halo plane z + dz, over the halves and dz
    halves = []
    for kh in range(2):
        prod = torch.zeros(nbr, bz + 2, by, bx, 3, t_heads, dtype=f32)
        for dy in range(3):
            for dx in range(3):
                for kk in (2 * kh, 2 * kh + 1):
                    ks = slice(16 * kk, 16 * kk + 16)
                    rows = halo[:, :, dy:dy + by, dx:dx + bx, ks]
                    prod = prod + torch.einsum("nzyxk,dkt->nzyxdt", rows, w[:, dy, dx, ks])
        halves.append(prod)
    acc = torch.zeros(nbr, bz, by, bx, t_heads, dtype=f32)
    for prod in halves:
        for dz in range(3):
            acc = acc + prod[:, dz:dz + bz, ..., dz, :]
    trans = torch.empty(b, n, n, n, t_heads, dtype=f32)
    for i in range(nbr):
        s, z0, y0, x0 = origins[i].tolist()
        ez, ey, ex = min(bz, n - z0), min(by, n - y0), min(bx, n - x0)
        trans[s, z0:z0 + ez, y0:y0 + ey, x0:x0 + ex] = acc[i, :ez, :ey, :ex] + bias

    # statistics: warp w folds rows 4 (w // 4) .. + 3 of plane z0 + w % 4 of
    # each of its CTA's bricks: the max, then the sums, merged into its
    # running Stat
    kp, gmax = torch.empty(b, 3 * c), torch.empty(b, c)
    for s in range(b):
        parts = []
        for (smp, _), bricks in _ctas(b, n, sms).items():
            if smp != s:
                continue
            warps = [_empty(c) for _ in range(2 * bz)]
            for i in bricks:
                _, z0, y0, x0 = origins[i].tolist()
                ex = min(bx, n - x0)
                for w_ in range(2 * bz):
                    z, ya = z0 + w_ % 4, y0 + 4 * (w_ // 4)
                    ey = min(4, n - ya)
                    if z >= n or ey <= 0:
                        continue
                    plane = uf[s, z, ya:ya + ey, x0:x0 + ex]  # [ey, ex, C]
                    m = plane.amax((0, 1))
                    e = torch.exp((plane - m) * _INV_T)
                    rows = e.sum(1)  # [ey, C], summed over x
                    rows_x = (e * lin[x0:x0 + ex, None]).sum(1)
                    tot = rows.sum(0)
                    blk = (m, tot, (rows * lin[ya:ya + ey, None]).sum(0), tot * lin[z],
                           rows_x.sum(0))
                    warps[w_] = _merge(warps[w_], blk)
            st = warps[0]
            for w_ in range(1, 2 * bz):
                st = _merge(st, warps[w_])
            parts.append(st)
        groups = []
        for g in range(_COMBINE_GROUPS):
            st = _empty(c)
            for p in range(g, len(parts), _COMBINE_GROUPS):
                st = _merge(st, parts[p])
            groups.append(st)
        st = groups[0]
        for g in range(1, _COMBINE_GROUPS):
            st = _merge(st, groups[g])
        m, tot, wx, wd, wz = st
        kp[s] = torch.stack([wx / tot, wd / tot, wz / tot], -1).reshape(-1)
        gmax[s] = m
    return trans, kp, gmax


def _case(t_heads, n, b, c=64):
    rng = np.random.default_rng(300 + 100 * n + 10 * b + t_heads)
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


def _u_and_heads(d0, u0, wf, bf, wt, bt):
    tb = torch.bfloat16
    u = tail_conv_reference(torch.tensor(d0).to(tb), torch.tensor(u0).to(tb),
                            torch.tensor(wf), torch.tensor(bf))
    return u, torch.tensor(wt), torch.tensor(bt)


@pytest.mark.parametrize("t_heads", [1, 2])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n", [10, 13])
def test_trans_stats_schedule_matches_pallas_kernel(n, b, t_heads):
    case = _case(t_heads, n, b)
    trans_ref, kp_ref, gmax_ref = _jax_tail(*case)
    u, wt, bt = _u_and_heads(*case)
    trans, kp, gmax = trans_stats_schedule(u, wt, bt, sms=3)
    assert trans.dtype == torch.float32 and trans.shape == (b, n, n, n, t_heads)
    # test_torch_decoder_tail_conv.py's tolerances: u from 3456-term f32 sums
    # in another order, rounded to bf16, then trans a 1728-term f32 sum
    np.testing.assert_allclose(trans.numpy(), trans_ref,
                               atol=2e-3 * np.abs(trans_ref).max(), rtol=0)
    np.testing.assert_allclose(kp.numpy(), kp_ref, atol=1e-4)
    np.testing.assert_allclose(gmax.numpy(), gmax_ref, atol=2.0 ** -7 * np.abs(gmax_ref).max())
    assert (trans.numpy().reshape(b, -1, t_heads).argmax(1)
            == trans_ref.reshape(b, -1, t_heads).argmax(1)).all()
    # on the same u, the plain version the wrapper takes on the CPU differs
    # from the schedule by f32 summation order only
    p_trans, p_kp, p_gmax = tail_from_u(u, wt, bt)
    np.testing.assert_allclose(trans.numpy(), p_trans.numpy(),
                               atol=1e-5 * p_trans.abs().max().item(), rtol=0)
    np.testing.assert_allclose(kp.numpy(), p_kp.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(gmax, p_gmax)


@pytest.mark.parametrize("n", [10, 13])
def test_zero_filled_trans_halo_misses_pallas_kernel(n):
    """The planted ``zero_ringed_u`` fault: zeros for the clamp at the grid's
    faces move trans there beyond the tolerance, and only there."""
    case = _case(1, n, 1)
    trans_ref = _jax_tail(*case)[0]
    u, wt, bt = _u_and_heads(*case)
    trans = trans_stats_schedule(u, wt, bt, clamp=False)[0].numpy()
    tol = 2e-3 * np.abs(trans_ref).max()
    err = np.abs(trans - trans_ref)
    assert err.max() > tol
    assert err[:, 1:-1, 1:-1, 1:-1].max() <= tol
