"""K6's schedule (voxactb_tpu_torch/csrc/stats_head.cu): its persistent grid
(``stats_head_grid``) gives every row of every sample to exactly one CTA in
one wave, its multiply-shift division by n is exact, and a plain PyTorch
model of the kernel (per thread the max of its rows of a tile first, the
running sums rescaled where that raises the running max, one exponential
per element by exp2 with 1 / T and log2(e) folded into one constant; the row
lanes merged per channel, P parts each taking every P-th lane in order, then
part 0 the others; the partials of each group of 16 CTAs merged the same
way, and then the groups') holds against the JAX package's
stats_head kernel in interpret mode. Models of the planted faults that
chip_smoke.py runs through the kernel (CTA 0's tiles skipped, the merge
without its rescale) miss."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.stats_head import stats_head as jax_stats_head
from voxactb_tpu_torch.ops.cuda.build import header_constant
from voxactb_tpu_torch.ops.cuda.stats_head import (
    FAULTS, grid_positions, row_lanes, stats_head_grid, stats_head_reference, tile_rows)

SMS = 132  # an H100's SMs
CTAS_PER_SM = 2
GROUP_CTAS = 16  # kGroupCtas
# kExp2Scale: 100 * log2(e), both f32, the product rounded to f32
EXP2_SCALE = np.float32(np.float32(100.0) * np.float32(math.log2(math.e)))
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_torch_stats_head.py's bound on kp against the JAX kernel
KP_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("c", [64, 128, 192])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n", [10, 50])
def test_grid_gives_every_row_to_one_cta(n, b, c, itemsize):
    lanes, tr = row_lanes(c, itemsize), tile_rows(c, itemsize)
    groups = c * itemsize // 16
    assert groups * lanes <= header_constant("stats_head.cu", "kMaxThreads") < 2 * groups * lanes
    # thread (r, v) holds rows r, r + L, ... of a tile: the tile's rows once
    per_thread = tr // lanes
    assert sorted(r + lanes * q for r in range(lanes) for q in range(per_thread)) == \
        list(range(tr))
    g = stats_head_grid(b, n, c, itemsize, SMS)
    tiles = -(-n ** 3 // tr)
    assert 1 <= g <= tiles and g * b <= CTAS_PER_SM * SMS  # one wave, no idle CTA
    count = np.zeros(tiles * tr, np.int32)
    for cta in range(g):
        for i in range(cta, tiles, g):
            count[i * tr:(i + 1) * tr] += 1
    assert (count[:n ** 3] == 1).all()


def test_decoder_grid_fills_the_card():
    """[1, 20^3, 128] bf16 runs on 125 CTAs (8 before the redesign), and the
    batch-8 grid on every slot of one wave."""
    assert stats_head_grid(1, 20, 128, 2, SMS) == 125
    assert 8 * stats_head_grid(8, 20, 128, 2, SMS) == CTAS_PER_SM * SMS
    assert header_constant("stats_head.cu", "kCtasPerSm") == CTAS_PER_SM
    assert header_constant("stats_head.cu", "kGroupCtas") == GROUP_CTAS
    assert sorted(FAULTS.values()) == [1, 2, 3]


def _magic(n):
    """The kernel's v / n = (v * magic) >> shift."""
    shift = 32 + (n - 1).bit_length()
    return -(-(1 << shift) // n), shift


@pytest.mark.parametrize("n", [1, 2, 3, 7, 10, 20, 50, 100, 127, 1000, 1290])
def test_multiply_shift_division_is_exact(n):
    magic, shift = _magic(n)
    assert magic < 1 << 33  # v * magic fits in 64 bits for v < 2^31
    rows = n ** 3
    rng = np.random.default_rng(n)
    vs = {0, 1, n - 1, n, n * n - 1, n * n, rows - 1, rows - n, 2 ** 31 - 1}
    vs |= {int(v) for v in rng.integers(0, rows, 2000)}
    vs |= {int(k) * n + d for k in rng.integers(0, n * n, 200) for d in (-1, 0, 1)}
    for v in sorted(u for u in vs if u >= 0):
        assert (v * magic) >> shift == v // n
    # the second division, of v / n by n, gives v / n^2
    for v in sorted(u for u in vs if 0 <= u < rows):
        assert (((v * magic) >> shift) * magic) >> shift == v // (n * n)


def _fields(shape):
    """(m, s, wx, wd, wz): empty statistics, common.cuh's ``Stat``."""
    return [torch.full(shape, -math.inf)] + [torch.zeros(shape) for _ in range(4)]


def _merge(a, b, rescale=True):
    """common.cuh's ``stat_merge_ex2``: each side rescaled to the larger max
    M by 2^(m k - M k) (the fused multiply-add as one rounding of the f64
    value), 1 on the side that holds it (not at all without the rescale)."""
    mx = torch.maximum(a[0], b[0])
    mk = (mx * torch.tensor(EXP2_SCALE)).double()
    one = torch.ones_like(mx)

    def corr(m):
        arg = (m.double() * float(EXP2_SCALE) - mk).float()
        return torch.where(m == mx, one, torch.exp2(arg)) if rescale else one

    ca, cb = corr(a[0]), corr(b[0])
    return [mx] + [x * ca + y * cb for x, y in zip(a[1:], b[1:])]


def _merge_entries(entries, parts, rescale=True):
    """merge_entries: of entries ``[K, ...]`` (per field), part p of P merges
    entries p, p + P, ... in order; then part 0 merges parts 1 .. P-1 in
    order."""
    count = entries[0].shape[0]
    res = []
    for p in range(parts):
        st = _fields(entries[0].shape[1:])
        for k in range(p, count, parts):
            st = _merge(st, [f[k] for f in entries], rescale)
        res.append(st)
    st = res[0]
    for other in res[1:]:
        st = _merge(st, other, rescale)
    return st


def schedule_model(x, sms=SMS, fault=None):
    """kp ``[B, 3C]`` and gmax ``[B, C]`` of ``x [B,n,n,n,C]`` as the kernel
    schedules them: G persistent CTAs per sample, CTA g taking tiles g, g + G,
    ...; thread (lane r, channels) folds rows r, r + L, ... of a tile: its
    max first, the sums rescaled by 2^(m k - m' k) where that raises the
    running max m k (``stat_raise``), then e = 2^(x k - m' k) per element
    (k = log2(e) / T; the
    fused multiply-add as one rounding of the f64 value); the lanes' entries
    merged per channel into one partial per CTA (P = kThreads / C parts, part
    p taking entries p, p + P, ... in order, then part 0 the other parts);
    each group of kGroupCtas CTAs' partials merged so, then the groups'
    partials; kp = sums * (1 / s). ``fault``:
    "skip_cta" (CTA 0 folds no tile) or "no_rescale" (the merges of
    partials add unrescaled sums)."""
    b, n, c = x.shape[0], x.shape[1], x.shape[-1]
    itemsize = x.element_size()
    lanes, tr = row_lanes(c, itemsize), tile_rows(c, itemsize)
    rows = n ** 3
    g = stats_head_grid(b, n, c, itemsize, sms)
    tiles = -(-rows // tr)
    flat = x.reshape(b, rows, c).to(torch.float32)
    pos = grid_positions(n, "cpu")  # (lin[h], lin[d], lin[w]) per row
    k = torch.tensor(EXP2_SCALE)
    st = _fields((g, b, lanes, c))
    mk = torch.full((g, b, lanes, c), -math.inf)  # the running max times k
    ctas = torch.arange(g)
    offs = torch.arange(lanes)[:, None] + lanes * torch.arange(tr // lanes)  # [L, Q]
    for it in range(-(-tiles // g)):
        i = ctas + it * g
        active = i < tiles
        if fault == "skip_cta":
            active[0] = False
        v = i[:, None, None] * tr + offs                     # [G, L, Q]
        valid = ((v < rows) & active[:, None, None])[:, None, ..., None]
        vc = v.clamp(max=rows - 1)
        xt = torch.where(valid, flat[:, vc].transpose(0, 1), -math.inf)  # [G, B, L, Q, C]
        mt = xt.amax(3)
        nk = mt * k
        up = nk > mk
        corr = torch.exp2(mk - nk)
        st = [torch.maximum(st[0], mt)] + [torch.where(up, f * corr, f) for f in st[1:]]
        mk = torch.where(up, nk, mk)
        arg = (xt.double() * k.double() - mk[:, :, :, None].double()).float()
        e = torch.where(valid, torch.exp2(arg), 0.0)
        p = pos[vc][:, None, :, :, None, :]                  # [G, 1, L, Q, 1, 3]
        st[1] = st[1] + e.sum(3)
        for j in range(3):
            st[2 + j] = st[2 + j] + (e * p[..., j]).sum(3)
    # the lanes, one entry each, per channel; P = kThreads / C parts
    parts = c * itemsize // 16 * lanes // c
    part = _merge_entries([f.permute(2, 0, 1, 3) for f in st], parts)  # [G, B, C]
    rescale = fault != "no_rescale"
    groups = [_merge_entries([f[j:j + GROUP_CTAS] for f in part], parts, rescale)
              for j in range(0, g, GROUP_CTAS)]
    st = _merge_entries([torch.stack(f) for f in zip(*groups)], parts, rescale)
    m, s, wx, wd, wz = st
    inv = 1.0 / s
    return torch.stack([wx * inv, wd * inv, wz * inv], -1).reshape(b, 3 * c), m


def _case(n, c, dt, b=2):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(1000 * n + c)
    x = jnp.asarray((rng.normal(size=(b, n, n, n, c)) * 0.05).astype(np.float32), jdt)
    return x, torch.tensor(np.asarray(x, np.float32)).to(tdt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("c", [64, 128, 192])
@pytest.mark.parametrize("n", [8, 10, 20])
def test_schedule_model_matches_pallas_kernel(n, c, dt):
    jx, x = _case(n, c, dt)
    kp_ref, gmax_ref = (np.asarray(a) for a in jax_stats_head(jx, interpret=True))
    kp, gmax = schedule_model(x)
    np.testing.assert_allclose(kp.numpy(), kp_ref, atol=KP_ATOL, rtol=0)
    np.testing.assert_array_equal(gmax.numpy(), gmax_ref)
    if n == 10:
        # one SM: two CTAs per sample, many tiles each, rescales between them
        kp, gmax = schedule_model(x, sms=1)
        np.testing.assert_allclose(kp.numpy(), kp_ref, atol=KP_ATOL, rtol=0)
        np.testing.assert_array_equal(gmax.numpy(), gmax_ref)


@pytest.mark.parametrize("n,c,dt", [(10, 64, "bfloat16"), (20, 128, "bfloat16"),
                                    (10, 192, "float32")])
def test_fault_models_miss(n, c, dt):
    """The faults as chip_smoke.py plants them: CTA 0's tiles skipped, on the
    grid with a row above every channel's max in tile 0 (CTA 0's first); the
    last CTA's merge without its rescale. Both miss the plain version by far
    more than the bound the model holds; the model without a fault holds it."""
    _, x = _case(n, c, dt)
    hot = x.clone()
    hot[:, 0, 0, 0, :] = x.amax(dim=(1, 2, 3)) + 1
    for grid, fault in ((hot, "skip_cta"), (x, "no_rescale")):
        kp_ref, gmax_ref = stats_head_reference(grid)
        kp, gmax = schedule_model(grid)
        assert (kp - kp_ref).abs().max() <= KP_ATOL and torch.equal(gmax, gmax_ref)
        kp, _ = schedule_model(grid, fault=fault)
        assert (kp - kp_ref).abs().max() > 100 * KP_ATOL, fault
