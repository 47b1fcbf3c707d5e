"""K6 (voxactb_tpu_torch/ops/cuda/stats_head.py): the plain version the
wrapper takes on the CPU against the JAX package's stats_head kernel in
interpret mode, at the widths the act path gives it (C = 64 for d0 and u,
128 for the decoder grid, 192 for the two-head variant's) in bf16 and f32; a
peaked feature finds its voxel; the port's train forward refuses the flag."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.stats_head import stats_head as jax_stats_head
from voxactb_tpu_torch.models.perceiver import PerceiverVoxelLangEncoder
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.stats_head import stats_head, stats_head_reference


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("c", [64, 128, 192])
def test_plain_version_matches_pallas_kernel(c, dt):
    jdt, tdt = DTYPES[dt]
    n = 8
    rng = np.random.default_rng(c)
    x = jnp.asarray((rng.normal(size=(2, n, n, n, c)) * 0.05).astype(np.float32), jdt)
    kp_ref, gmax_ref = (np.asarray(a) for a in jax_stats_head(x, interpret=True))
    kp, gmax = stats_head_reference(torch.tensor(np.asarray(x, np.float32)).to(tdt))
    assert kp.dtype == gmax.dtype == torch.float32
    assert kp.shape == (2, 3 * c) and gmax.shape == (2, c)
    # the same arithmetic (logits x * 100, their running max, one-rounding
    # positions, sums times 1 / sum); the n^3-term f32 sums run in another
    # order, which at T = 0.01 moves a keypoint by a few 1e-6 at n = 8 (the
    # bound test_torch_blocks.py::test_softargmax_stats_3d derives)
    np.testing.assert_allclose(kp.numpy(), kp_ref, atol=1e-5, rtol=0)
    # the max has no arithmetic in it
    np.testing.assert_array_equal(gmax.numpy(), gmax_ref)


def test_peaked_feature_finds_location():
    """A single hot voxel puts the expected position on its coordinates, with
    the reference's axis quirk: E[x] = lin[h], E[y] = lin[d], E[z] = lin[w]
    (tests/test_pallas_stats.py:23-35 on the port)."""
    n, c = 8, 4
    x = np.zeros((1, n, n, n, c), np.float32)
    x[0, 2, 5, 7, :] = 1.0  # d = 2, h = 5, w = 7
    kp, gmax = stats_head_reference(torch.tensor(x))
    kp = kp.numpy().reshape(c, 3)
    lin = np.linspace(-1, 1, n)
    np.testing.assert_allclose(kp[:, 0], lin[5], atol=1e-3)
    np.testing.assert_allclose(kp[:, 1], lin[2], atol=1e-3)
    np.testing.assert_allclose(kp[:, 2], lin[7], atol=1e-3)
    np.testing.assert_allclose(gmax.numpy()[0], 1.0, atol=1e-6)


def test_cpu_wrapper_takes_plain_version():
    x = torch.tensor(np.random.default_rng(1).normal(size=(2, 6, 6, 6, 64)),
                     dtype=torch.float32).to(torch.bfloat16)
    before = dict(LAUNCHES)
    for a, b in zip(stats_head(x), stats_head_reference(x)):
        assert torch.equal(a, b)
    assert LAUNCHES == before


def test_train_forward_refuses_pallas_stats():
    """The kernel has no backward (jax.grad through the JAX kernel fails too):
    a train-mode forward with the flag raises and names it, never taking the
    plain statistics in its place."""
    g = torch.Generator().manual_seed(0)
    model = PerceiverVoxelLangEncoder(depth=1, voxel_size=10, num_latents=8, latent_dim=16,
                                      latent_heads=1, latent_dim_head=8, cross_dim_head=8,
                                      pallas_stats=True, generator=g)
    args = (torch.zeros(1, 10, 10, 10, 10), torch.zeros(1, 4), None,
            torch.zeros(1, 77, 512))
    with pytest.raises(NotImplementedError, match="pallas_stats"):
        model(*args, train=True, dropout_seeds=model.draw_dropout_seeds(g))
    with torch.no_grad():
        out = model(*args)
    assert torch.isfinite(out["trans"]).all()
