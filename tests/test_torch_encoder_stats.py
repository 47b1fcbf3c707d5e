"""K5 (voxactb_tpu_torch/ops/cuda/encoder_stats.py): the plain version the
wrapper takes on the CPU against the JAX package's encoder_stats kernel in
interpret mode, on a dense voxel grid with the act path's widths (10 input
channels, C = 64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_blocks import _softargmax_f64

from voxactb_tpu.ops.pallas.encoder_stats import encoder_stats as jax_encoder_stats
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.encoder_stats import encoder_stats, encoder_stats_reference


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _case(n, seed, b=2, c=64):
    """A voxel-grid-like input (means, index / N, occupancy) and the
    preprocess conv's weights at init-like scales."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=(b, n, n, n, 10)).astype(np.float32)
    x[..., 9] = rng.integers(0, 2, size=(b, n, n, n))
    w1 = (rng.normal(size=(10, c)) * 0.3).astype(np.float32)
    b1 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, w1, b1


@pytest.mark.parametrize("n", [5, 10])
def test_plain_version_matches_pallas_kernel(n):
    x, w1, b1 = _case(n, n)
    # the model hands the kernel the grid in the compute dtype
    d0_ref, kp_ref, gmax_ref = (np.asarray(a, np.float32) for a in jax_encoder_stats(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1), jnp.asarray(b1), interpret=True))
    d0, kp, gmax = encoder_stats_reference(torch.tensor(x), torch.tensor(w1),
                                           torch.tensor(b1))
    assert d0.dtype == torch.bfloat16 and d0.shape == (2, n, n, n, 64)
    # d0: a 10-term f32 sum of exact products rounded to bf16, in another
    # order: equal, or one bf16 ulp apart in under 1% of the elements
    d0 = d0.float().numpy()
    diff = np.abs(d0 - d0_ref)
    ulp = np.maximum(np.abs(d0_ref), 1e-30) * 2.0 ** -7
    assert (diff <= ulp).all() and (diff > 0).mean() < 1e-2
    # the statistics of d0, each package held to the float64 formula within 6x
    # the f32 error bound that test_torch_blocks.py::test_softargmax_stats_3d
    # derives, and the two to 8x (the global max is exact)
    kp64, m64, bound = _softargmax_f64(d0)
    bound = bound.max()
    np.testing.assert_allclose(kp.numpy(), kp64, atol=6 * bound, rtol=0)
    np.testing.assert_allclose(kp_ref, kp64, atol=6 * bound, rtol=0)
    np.testing.assert_allclose(kp.numpy(), kp_ref, atol=8 * bound, rtol=0)
    np.testing.assert_array_equal(gmax.numpy(), m64.astype(np.float32))
    np.testing.assert_array_equal(gmax.numpy(), gmax_ref)


def test_bf16_grid_gives_the_same_d0():
    """The kernel rounds an f32 grid to bf16 itself: an f32 grid and the same
    grid already in bf16 give the same d0."""
    x, w1, b1 = (torch.tensor(a) for a in _case(5, 3))
    a = encoder_stats_reference(x, w1, b1)
    b = encoder_stats_reference(x.to(torch.bfloat16), w1, b1)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_cpu_wrapper_takes_plain_version():
    x, w1, b1 = (torch.tensor(a) for a in _case(5, 4))
    before = dict(LAUNCHES)
    for a, b in zip(encoder_stats(x, w1, b1), encoder_stats_reference(x, w1, b1)):
        assert torch.equal(a, b)
    assert LAUNCHES == before
