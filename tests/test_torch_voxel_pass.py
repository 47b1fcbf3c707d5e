"""The fronts' voxel pass (voxactb_tpu_torch/csrc/voxel_pass.cuh), which K1's
ff_voxel and K5's es_voxel run: its persistent tiling (``voxel_pass_grid``)
covers every voxel once, and a plain PyTorch model of its statistics (per
CTA the tiles g, g + G, ... in order; per tile the channel max first, the
running sums rescaled to it, one exponential per element by exp2 with 1 / T
and log2(e) folded into one constant; one partial per CTA; stats_combine's
merge of the partials) holds against the JAX package's encoder_stats and
fused front kernels in interpret mode. The same model with the 'xy'
positions swapped misses, the planted fault that chip_smoke.py runs through
the kernels. The kernel's shortcut for empty voxels (only the index / N
products) gives the in-order f32 sum's bits."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_blocks import _softargmax_f64

from voxactb_tpu.ops.pallas.encoder_stats import encoder_stats as jax_encoder_stats
from voxactb_tpu.ops.pallas.front_fused import front_fused as jax_front_fused
from voxactb_tpu_torch.ops.cuda.encoder_stats import (
    VOX_TILE, encoder_stats_reference, voxel_pass_grid)
from voxactb_tpu_torch.ops.voxelize import voxelize

SMS = 132  # an H100's SMs
CTAS_PER_SM = 2
COMBINE_GROUPS = 1024 // 64  # stats_combine: 1024 threads, 64 channels
EXP2_SCALE = np.float32(100.0 * math.log2(math.e))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("n", [5, 10, 13, 50, 100])
def test_persistent_tiling_covers_every_voxel_once(n, b):
    g = voxel_pass_grid(b, n, SMS)
    tiles = -(-n ** 3 // VOX_TILE)
    assert 1 <= g <= tiles and g * b <= CTAS_PER_SM * SMS  # one wave, no idle CTA
    count = np.zeros(tiles * VOX_TILE, np.int32)
    for cta in range(g):
        for i in range(cta, tiles, g):
            count[i * VOX_TILE:(i + 1) * VOX_TILE] += 1
    assert (count[:n ** 3] == 1).all()


def test_grid_constants_are_read_from_the_headers():
    """The wrappers size their grids from the constants the kernels compile
    with: the voxel pass's rows on threads 0-63 and positions on 64-127
    (its static_assert), the patchify's 16-byte chunks over its threads."""
    from voxactb_tpu_torch.ops.cuda.build import header_constant
    from voxactb_tpu_torch.ops.cuda.encoder_stats import _VOX_CTAS_PER_SM
    from voxactb_tpu_torch.ops.cuda.front_fused import PATCH_ROWS, PATCH_TAPS

    assert header_constant("voxel_pass.cuh", "kThreads") == 2 * VOX_TILE
    assert _VOX_CTAS_PER_SM == CTAS_PER_SM
    assert PATCH_TAPS == 125
    assert PATCH_ROWS * 8 % header_constant("front_patchify.cuh", "kThreads") == 0
    with pytest.raises(LookupError):
        header_constant("voxel_pass.cuh", "kNoSuchConstant")


def _merge(a, b):
    """stat_merge (common.cuh): the pair's max, each side's sums rescaled by
    exp((m - max) / T), 0 where that is not finite."""
    m = torch.maximum(a[0], b[0])
    ca, cb = (torch.nan_to_num(torch.exp((x[0] - m) * 100.0), nan=0.0, posinf=0.0)
              for x in (a, b))
    return [m] + [x * ca + y * cb for x, y in zip(a[1:], b[1:])]


def tiled_stats_model(d0, sms=SMS, swap_xy=False):
    """kp ``[B, 3C]`` and gmax ``[B, C]`` of d0 as the kernel schedules them:
    CTA g of G takes tiles g, g + G, ... of 64 voxels; per tile the channel
    max mt, the running max m' = max(m, mt), the sums rescaled by 2^((m - m')
    k) and e = 2^(d k - m' k) added (k = log2(e) / T); one partial (m, s,
    wx, wd, wz) per CTA; then stats_combine: group j of 16 merges partials j,
    j + 16, ..., group 0 merges the groups. ``swap_xy`` weights x with the
    dim-0 position and d with the dim-1 one."""
    b, n, c = d0.shape[0], d0.shape[1], d0.shape[-1]
    n3 = n ** 3
    flat = d0.reshape(b, n3, c).to(torch.float32)
    lin = torch.linspace(-1.0, 1.0, n)
    v = torch.arange(n3)
    px, pd, pz = lin[v // n % n], lin[v // (n * n)], lin[v % n]
    if swap_xy:
        px, pd = pd, px
    g = voxel_pass_grid(b, n, sms)
    tiles = -(-n3 // VOX_TILE)
    k = torch.tensor(EXP2_SCALE)
    parts = []
    for cta in range(g):
        m = torch.full((b, c), -math.inf)
        s, wx, wd, wz = (torch.zeros(b, c) for _ in range(4))
        for i in range(cta, tiles, g):
            sl = slice(i * VOX_TILE, min((i + 1) * VOX_TILE, n3))
            x = flat[:, sl]
            mn = torch.maximum(m, x.amax(1))
            corr = torch.exp2((m - mn) * k)
            e = torch.exp2(x * k - (mn * k)[:, None])
            s = s * corr + e.sum(1)
            wx = wx * corr + (e * px[sl, None]).sum(1)
            wd = wd * corr + (e * pd[sl, None]).sum(1)
            wz = wz * corr + (e * pz[sl, None]).sum(1)
            m = mn
        parts.append([m, s, wx, wd, wz])
    groups = []
    for j in range(min(COMBINE_GROUPS, g)):
        st = parts[j]
        for p in parts[j + COMBINE_GROUPS::COMBINE_GROUPS]:
            st = _merge(st, p)
        groups.append(st)
    st = groups[0]
    for other in groups[1:]:
        st = _merge(st, other)
    m, s, wx, wd, wz = st
    kp = torch.stack([wx / s, wd / s, wz / s], -1).reshape(b, 3 * c)
    return kp, m


def _case(n, seed, b=2, c=64):
    """A voxel-grid-like input (means, index / N, occupancy) and the
    preprocess conv's weights at init-like scales."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=(b, n, n, n, 10)).astype(np.float32)
    x[..., 9] = rng.integers(0, 2, size=(b, n, n, n))
    w1 = (rng.normal(size=(10, c)) * 0.3).astype(np.float32)
    b1 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, w1, b1


def _hold(d0, kp, gmax, ref_kp, ref_gmax):
    """gmax exact; kp within 8x the f32 bound that test_torch_blocks.py's
    _softargmax_f64 derives (test_torch_encoder_stats.py holds the two
    packages to each other so); returns the kp error and that tolerance."""
    _, _, bound = _softargmax_f64(d0.float().numpy())
    tol = 8 * bound.max()
    np.testing.assert_array_equal(gmax.numpy(), ref_gmax)
    err = np.abs(kp.numpy() - ref_kp).max()
    assert err <= tol
    return err, tol


@pytest.mark.parametrize("n", [5, 10])
def test_tiled_model_matches_pallas_encoder_stats(n):
    x, w1, b1 = _case(n, 20 + n)
    _, kp_ref, gmax_ref = (np.asarray(a, np.float32) for a in jax_encoder_stats(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1), jnp.asarray(b1), interpret=True))
    d0, _, _ = encoder_stats_reference(torch.tensor(x), torch.tensor(w1), torch.tensor(b1))
    kp, gmax = tiled_stats_model(d0)
    _hold(d0, kp, gmax, kp_ref, gmax_ref)
    # fewer CTAs than tiles: several tiles per CTA and rescales between them
    kp, gmax = tiled_stats_model(d0, sms=1)
    _hold(d0, kp, gmax, kp_ref, gmax_ref)


@pytest.fixture(scope="module")
def front_case():
    """K1's inputs at N = 10, C = 64, the plain d0 of the voxelized clouds and
    the JAX fused front's outputs in interpret mode."""
    n, c, p = 10, 64, 2048
    rng = np.random.default_rng(13)
    coords = rng.uniform(-0.6, 1.3, (2, p, 3)).astype(np.float32)
    feats = rng.uniform(-1, 1, (2, p, 3)).astype(np.float32)
    bounds = np.array([[-0.5, -0.5, 0.2, 1.2, 1.2, 1.4],
                       [-0.4, -0.6, 0.1, 1.0, 1.1, 1.5]], np.float32)
    w1 = (rng.normal(size=(10, c)) * 0.3).astype(np.float32)
    b1 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    wp = (rng.normal(size=(5, 5, 5, c, c)) * 0.05).astype(np.float32)
    j = jax_front_fused(*[jnp.asarray(a) for a in (coords, feats, bounds, w1, b1, wp)],
                        voxel_size=n, row_cap=p, interpret=True)
    grid = voxelize(torch.tensor(coords), torch.tensor(feats), torch.tensor(bounds),
                    voxel_size=n)
    d0, _, _ = encoder_stats_reference(grid, torch.tensor(w1), torch.tensor(b1))
    return dict(d0=d0, jax=[np.asarray(t, np.float32) for t in j[:4]])


def test_tiled_model_matches_pallas_front_fused(front_case):
    d0 = front_case["d0"]
    np.testing.assert_array_equal(d0.float().numpy(), front_case["jax"][0])
    kp, gmax = tiled_stats_model(d0)
    _hold(d0, kp, gmax, front_case["jax"][2], front_case["jax"][3])


def test_swapped_xy_positions_miss(front_case):
    d0 = front_case["d0"]
    _, tol = _hold(d0, *tiled_stats_model(d0), front_case["jax"][2], front_case["jax"][3])
    kp, _ = tiled_stats_model(d0, swap_xy=True)
    assert np.abs(kp.numpy() - front_case["jax"][2]).max() > tol


def test_empty_voxel_products_leave_the_sum_unchanged():
    """The kernel takes only the index / N products (k = 6-8) of a row whose
    means and occupancy are +-0: the f32 sum over k = 0..9 in order from +0
    with the zero products is the same float, sign of zero included."""
    rng = np.random.default_rng(4)
    rows = np.zeros((4096, 10), np.float32)
    rows[:, 6:9] = rng.integers(0, 100, (4096, 3)) / np.float32(100)
    signs = rng.integers(0, 2, (4096, 10)).astype(bool)
    rows = np.where(signs & (rows == 0), np.float32(-0.0), rows)  # +-0 entries
    w = rng.normal(size=(10, 64)).astype(np.float32)
    w[0] = np.float32(-0.0)  # products of every sign of zero
    full = np.zeros((4096, 64), np.float32)
    for k in range(10):
        full = full + rows[:, k:k + 1] * w[k]
    skipped = np.zeros((4096, 64), np.float32)
    for k in range(6, 9):
        skipped = skipped + rows[:, k:k + 1] * w[k]
    assert np.array_equal(full.view(np.uint32), skipped.view(np.uint32))
