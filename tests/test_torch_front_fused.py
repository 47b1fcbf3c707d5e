"""K1 (voxactb_tpu_torch/ops/cuda/front_fused.py): the plain version the
wrapper takes on the CPU against the JAX package's fused front kernel in
interpret mode (with a row capacity that drops nothing) and against the XLA
ops it replaces. The CUDA kernel itself is held to this plain version on the
card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.front_fused import front_fused as jax_front_fused
from voxactb_tpu.ops.voxelize import voxelize as jax_voxelize
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.front_fused import front_fused, front_fused_reference

N, C, P = 10, 16, 2048


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    coords = rng.uniform(-0.6, 1.3, (2, P, 3)).astype(np.float32)
    feats = rng.uniform(-1, 1, (2, P, 3)).astype(np.float32)
    bounds = np.array([[-0.5, -0.5, 0.2, 1.2, 1.2, 1.4],
                       [-0.4, -0.6, 0.1, 1.0, 1.1, 1.5]], np.float32)
    w1 = (rng.normal(size=(10, C)) * 0.3).astype(np.float32)
    b1 = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    wp = (rng.normal(size=(5, 5, 5, C, C)) * 0.05).astype(np.float32)
    args = (coords, feats, bounds, w1, b1, wp)
    t = tuple(torch.tensor(a) for a in args)
    got = front_fused_reference(*t, voxel_size=N)
    return dict(args=args, torch_args=t, got=got)


def _xla_oracle(args):
    """d0 / stats / patchify through the XLA ops the kernel replaces, as
    tests/test_front_fused.py builds them (bf16 compute)."""
    from voxactb_tpu.models.blocks import softargmax_stats_3d

    coords, feats, bounds, w1, b1, wp = args
    grid = jax_voxelize(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(bounds),
                        voxel_size=N)
    x = jnp.asarray(grid, jnp.bfloat16)
    pre = jnp.einsum("bdhwc,cf->bdhwf", x, jnp.asarray(w1, jnp.bfloat16),
                     preferred_element_type=jnp.float32) + b1
    pre = pre.astype(jnp.bfloat16)
    d0 = jnp.where(pre >= 0, pre, pre * 0.02)
    kp, gmax = softargmax_stats_3d(d0)
    k, s, b = 5, N // 5, 2
    xp = jnp.pad(d0, ((0, 0),) + ((2, 0),) * 3 + ((0, 0),), mode="edge")[:, :N, :N, :N]
    xp = xp.reshape(b, s, k, s, k, s, k, C).transpose(0, 1, 3, 5, 2, 4, 6, 7)
    patch = jnp.einsum("bpk,kf->bpf", xp.reshape(b, s ** 3, k ** 3 * C),
                       jnp.asarray(wp, jnp.bfloat16).reshape(k ** 3 * C, C),
                       preferred_element_type=jnp.float32)
    return (np.asarray(d0, np.float32), np.asarray(patch).reshape(b, s, s, s, C),
            np.asarray(kp), np.asarray(gmax))


def test_plain_version_matches_xla_oracle(case):
    d0, patch, kp, gmax, overflow = case["got"]
    r_d0, r_patch, r_kp, r_gmax = _xla_oracle(case["args"])
    assert d0.dtype == torch.bfloat16 and d0.shape == (2, N, N, N, C)
    # same rounding points; the voxel means differ only in f32 sum order
    np.testing.assert_array_equal(d0.float().numpy(), r_d0)
    np.testing.assert_array_equal(gmax.numpy(), r_gmax)
    # torch.linspace vs jnp.linspace (one ulp at some points), f32 sum order
    np.testing.assert_allclose(kp.numpy(), r_kp, atol=1e-5)
    # 2000-term f32 sums of the same bf16 products in another order
    np.testing.assert_allclose(patch.numpy(), r_patch, atol=1e-4, rtol=1e-5)
    assert (overflow.numpy() == 0).all()


def test_plain_version_matches_pallas_kernel(case):
    """The TPU kernel pre-sums the patchify weights of its front rows in f32
    before the bf16 cast (front_fused.py:336-338), so its patch differs from
    the XLA path by that rounding; everything else agrees tightly."""
    d0, patch, kp, gmax, overflow = case["got"]
    j = jax_front_fused(*[jnp.asarray(a) for a in case["args"]], voxel_size=N,
                        row_cap=P, interpret=True)
    assert (np.asarray(j[4]) == 0).all()  # nothing dropped at this capacity
    np.testing.assert_array_equal(d0.float().numpy(), np.asarray(j[0], np.float32))
    np.testing.assert_allclose(kp.numpy(), np.asarray(j[2]), atol=1e-5)
    np.testing.assert_array_equal(gmax.numpy(), np.asarray(j[3]))
    np.testing.assert_allclose(patch.numpy(), np.asarray(j[1]), atol=5e-2, rtol=2e-2)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch(case):
    before = dict(LAUNCHES)
    out = front_fused(*case["torch_args"], voxel_size=N)
    for a, b in zip(out, case["got"]):
        assert torch.equal(a, b)
    assert LAUNCHES == before


def test_empty_cloud_is_finite():
    """Every point outside the bounds: all voxels empty, no NaN."""
    rng = np.random.default_rng(0)
    coords = torch.full((1, 64, 3), 99.0)
    out = front_fused_reference(
        coords, torch.zeros((1, 64, 3)), torch.tensor([[0., 0., 0., 1., 1., 1.]]),
        torch.tensor(rng.normal(size=(10, C)).astype(np.float32)), torch.zeros(C),
        torch.tensor(rng.normal(size=(5, 5, 5, C, C)).astype(np.float32)), voxel_size=N)
    for t in out[:4]:
        assert torch.isfinite(t.float()).all()
