"""The front's k5/s5 patchify (voxactb_tpu_torch/csrc/front_patchify.cuh),
which K1 launches and the dense path's ``front_patchify`` launches alone: its
stream-K schedule (``patchify_segments``) covers every (patch row, tap) once,
and a plain PyTorch model of that schedule (segment partials summed over taps
in order, the split tiles' partials added in CTA order, the front edge
clamped) holds against ``patchify_pre`` and against the ``patch`` of the JAX
package's fused front kernel in interpret mode. The same model with a
zero-padded front edge misses, at edge patches only: the planted fault that
chip_smoke.py runs through the kernel is visible. On the CPU
``front_patchify`` with the bias and lrelu is the model's ``patchify``
bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.front_fused import front_fused as jax_front_fused
from voxactb_tpu_torch.agents.qfunction import build_encoder
from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.models.blocks import lrelu
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.front_fused import (
    PATCH_ROWS, PATCH_TAPS, front_fused_reference, front_patchify, patchify_grid,
    patchify_pre, patchify_segments)

SMS = 132  # an H100's SMs: the kernel's G


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n", [10, 15, 50, 100])
def test_schedule_covers_every_row_and_tap_once(n, b):
    tiles, steps, g = patchify_grid(b, n, SMS)
    m = b * (n // 5) ** 3
    assert tiles == -(-m // PATCH_ROWS) and steps == tiles * PATCH_TAPS and g == min(SMS, steps)
    count = np.zeros((tiles * PATCH_ROWS, PATCH_TAPS), np.int32)
    slots = set()
    for c, tile, tap0, tap1, slot in patchify_segments(b, n, SMS):
        assert 0 <= tap0 < tap1 <= PATCH_TAPS and 0 <= c < g
        count[tile * PATCH_ROWS:(tile + 1) * PATCH_ROWS, tap0:tap1] += 1
        if slot is not None:  # a CTA's partials: at most its first and last tile
            assert (c, slot) not in slots
            slots.add((c, slot))
    assert (count[:m] == 1).all()


def gather_taps(d0, zero_front=False):
    """A of the patchify GEMM: ``[B s^3, 125, C]``, row (b, oz, oy, ox), tap
    (kz, ky, kx), each source index 5 o + k - 2 clamped to 0 at the front
    (``zero_front``: zeros there instead)."""
    b, n, c = d0.shape[0], d0.shape[1], d0.shape[-1]
    s = n // 5
    idx = (5 * torch.arange(s)[:, None] + torch.arange(5)[None, :] - 2)  # [s, 5]
    inside = (idx >= 0).to(torch.float32)
    idx = idx.clamp(min=0)
    zi = idx[:, None, None, :, None, None]
    yi = idx[None, :, None, None, :, None]
    xi = idx[None, None, :, None, None, :]
    a = d0.to(torch.float32)[:, zi, yi, xi]  # [B, s, s, s, 5, 5, 5, C]
    if zero_front:
        mask = (inside[:, None, None, :, None, None] * inside[None, :, None, None, :, None]
                * inside[None, None, :, None, None, :])
        a = a * mask[None, ..., None]
    return a.reshape(b * s ** 3, PATCH_TAPS, c)


def schedule_model(d0, wp, sms=SMS, zero_front=False):
    """A plain model of the kernel: per segment of ``patchify_segments`` the
    f32 sum over its taps in order of [128, C] x [C, C] products (the last
    tile's rows past M compute on the last row), whole tiles stored, split
    tiles summed from their partials in CTA order. Returns ``[B,s,s,s,C]``."""
    b, n, c = d0.shape[0], d0.shape[1], d0.shape[-1]
    s = n // 5
    m = b * s ** 3
    tiles, _, _ = patchify_grid(b, n, sms)
    a = gather_taps(d0, zero_front)
    a = torch.cat([a, a[-1:].expand(tiles * PATCH_ROWS - m, -1, -1)])
    w = wp.to(d0.dtype).to(torch.float32).reshape(PATCH_TAPS, c, c)
    out = torch.zeros(tiles * PATCH_ROWS, c)
    parts = {}
    for cta, tile, tap0, tap1, slot in patchify_segments(b, n, sms):
        rows = a[tile * PATCH_ROWS:(tile + 1) * PATCH_ROWS]
        acc = torch.zeros(PATCH_ROWS, c)
        for tap in range(tap0, tap1):
            acc = acc + rows[:, tap] @ w[tap]
        if slot is None:
            out[tile * PATCH_ROWS:(tile + 1) * PATCH_ROWS] = acc
        else:
            parts.setdefault(tile, []).append(acc)  # CTA order
    for tile, accs in parts.items():
        total = torch.zeros(PATCH_ROWS, c)
        for acc in accs:
            total = total + acc
        out[tile * PATCH_ROWS:(tile + 1) * PATCH_ROWS] = total
    return out[:m].reshape(b, s, s, s, c)


def reorder_bound(d0, wp):
    """Twice the f32 error bound of an 8000-term sum, gamma_K sum |a w| with
    K = 125 C: two sums of the same bf16 products (exact in f32) in other
    orders differ by at most this."""
    k = PATCH_TAPS * d0.shape[-1]
    gamma = k * 2.0 ** -24 / (1 - k * 2.0 ** -24)
    return 2 * gamma * patchify_pre(d0.abs(), wp.abs())


def _case(n, b, seed, c=64):
    """d0 as the 1x1 conv's lrelu leaves it (bf16, small negative tail) and
    patchify weights at init scale."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, n, n, c)).astype(np.float32)
    d0 = torch.tensor(np.where(x >= 0, x, 0.02 * x)).to(torch.bfloat16)
    wp = torch.tensor((rng.normal(size=(5, 5, 5, c, c)) * 0.05).astype(np.float32))
    return d0, wp


@pytest.mark.parametrize("n,b,sms", [(10, 1, SMS), (10, 2, 7), (15, 2, SMS), (20, 1, 40)])
def test_schedule_model_matches_patchify_pre(n, b, sms):
    d0, wp = _case(n, b, n + b)
    got = schedule_model(d0, wp, sms)
    ref = patchify_pre(d0, wp)
    assert ((got - ref).abs() <= reorder_bound(d0, wp)).all()


def edge_patches(s):
    """[s, s, s] mask of the patches on a front face (some o == 0)."""
    o = torch.arange(s)
    return (o[:, None, None] == 0) | (o[None, :, None] == 0) | (o[None, None, :] == 0)


@pytest.mark.parametrize("n,b", [(10, 2), (15, 1)])
def test_zero_front_edge_model_misses_at_edge_patches_only(n, b):
    d0, wp = _case(n, b, 3 * n + b)
    ref = patchify_pre(d0, wp)
    bound = reorder_bound(d0, wp)
    miss = (schedule_model(d0, wp, zero_front=True) - ref).abs() > bound
    edge = edge_patches(n // 5)[None, ..., None].expand_as(miss)
    assert miss[edge].any() and not miss[~edge].any()


@pytest.fixture(scope="module")
def jax_case():
    """K1's inputs at N = 10, C = 64, and the JAX fused front's outputs in
    interpret mode (a row capacity that drops nothing)."""
    n, c, p = 10, 64, 2048
    rng = np.random.default_rng(11)
    coords = rng.uniform(-0.6, 1.3, (2, p, 3)).astype(np.float32)
    feats = rng.uniform(-1, 1, (2, p, 3)).astype(np.float32)
    bounds = np.array([[-0.5, -0.5, 0.2, 1.2, 1.2, 1.4],
                       [-0.4, -0.6, 0.1, 1.0, 1.1, 1.5]], np.float32)
    w1 = (rng.normal(size=(10, c)) * 0.3).astype(np.float32)
    b1 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    wp = (rng.normal(size=(5, 5, 5, c, c)) * 0.05).astype(np.float32)
    args = (coords, feats, bounds, w1, b1, wp)
    j = jax_front_fused(*[jnp.asarray(a) for a in args], voxel_size=n, row_cap=p,
                        interpret=True)
    assert (np.asarray(j[4]) == 0).all()
    d0 = front_fused_reference(*(torch.tensor(a) for a in args), voxel_size=n)[0]
    return dict(d0=d0, wp=torch.tensor(wp), jax=[np.asarray(t, np.float32) for t in j[:4]])


def test_schedule_model_matches_pallas_front_patch(jax_case):
    """The TPU kernel pre-sums the kz = 0, 1, 2 weights of the front z plane
    in f32 before its bf16 cast (front_fused.py:336-338), so its oz = 0
    patches differ by that rounding: at most 2^-8 sum |d0| (|w0| + |w1| +
    |w2|), bounded here by 2^-8 sum |d0||w| over all taps. Every other patch
    is the same bf16 products summed in another f32 order."""
    d0, wp = jax_case["d0"], jax_case["wp"]
    np.testing.assert_array_equal(d0.float().numpy(), jax_case["jax"][0])
    got = schedule_model(d0, wp)
    diff = (got - torch.tensor(jax_case["jax"][1])).abs()
    bound = reorder_bound(d0, wp)
    assert (diff[:, 1:] <= bound[:, 1:]).all()
    assert (diff[:, :1] <= bound[:, :1] + 2.0 ** -8 * patchify_pre(d0.abs(), wp.abs())[:, :1]).all()


@pytest.fixture(scope="module")
def model_patchify():
    """The patchify Conv3D of a small act-path model, at f32 and bf16."""
    tiny = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
                latent_heads=2, latent_dim_head=16, cross_dim_head=16)
    return {dt: build_encoder(MethodConfig(compute_dtype=dt, **tiny), device="cpu",
                              seed=5).patchify for dt in ("float32", "bfloat16")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_front_patchify_with_epilogue_is_the_models_patchify(model_patchify, dtype):
    conv = model_patchify[dtype]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, 10, 10, 64)).astype(np.float32)
    d0 = torch.tensor(np.where(x >= 0, x, 0.02 * x)).to(dt)
    before = dict(LAUNCHES)
    with torch.no_grad():
        got = lrelu((front_patchify(d0, conv.kernel_dhwio()) + conv.bias).to(dt))
        ref = conv(d0)
    assert LAUNCHES == before  # the CPU takes the plain version
    assert got.dtype == ref.dtype and torch.equal(got, ref)
