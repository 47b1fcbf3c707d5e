"""The rest of ``ops/geometry`` of the port against the JAX package (CPU):
integer outputs exact, floats to f32 rounding. The JAX functions are jitted,
as the train step runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops import geometry as JG
from voxactb_tpu_torch.ops import geometry as G


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_to_rotmat_and_canonicalize_match_jax():
    q = _quats(np.random.default_rng(0), 500) * 1.7  # not unit: both normalise
    ref = np.asarray(jax.jit(JG.quat_to_rotmat)(jnp.asarray(q)))
    np.testing.assert_allclose(G.quat_to_rotmat(torch.tensor(q)).numpy(), ref, atol=2e-6)
    ref = np.asarray(jax.jit(JG.canonicalize_quaternion)(jnp.asarray(q)))
    got = G.canonicalize_quaternion(torch.tensor(q)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6)
    assert (got[:, 3] >= 0).all()


@pytest.mark.parametrize("resolution", [5, 15])
def test_quaternion_to_discrete_euler_is_exact(resolution):
    """Random rotations and every bin centre: the integer bins are equal."""
    rng = np.random.default_rng(resolution)
    bins = 360 // resolution
    disc = np.stack(np.meshgrid(np.arange(0, bins, 3), np.arange(bins // 4 + 1, 3 * bins // 4, 4),
                                np.arange(0, bins, 5), indexing="ij"), -1).reshape(-1, 3)
    centres = np.asarray(jax.jit(lambda d: JG.discrete_euler_to_quaternion(d, resolution))(
        jnp.asarray(disc, jnp.int32)))
    q = np.concatenate([_quats(rng, 2000), centres]).astype(np.float32)
    ref = np.asarray(jax.jit(lambda q: JG.quaternion_to_discrete_euler(q, resolution))(
        jnp.asarray(q)))
    got = G.quaternion_to_discrete_euler(torch.tensor(q), resolution)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.min() >= 0 and got.max() < bins
    # and back: a bin centre away from gimbal lock discretises to itself
    np.testing.assert_array_equal(got.numpy()[-len(disc):], disc)


def test_scene_bounds_from_crop_matches_jax():
    rng = np.random.default_rng(1)
    p = rng.uniform(-1, 2, size=(200, 3)).astype(np.float32)
    p[:5] = [[0.125, 0.135, 0.145], [0.005, -0.005, 0.015], [1.0, 0.0, -1.0],
             [0.2349999, 0.2350001, 0.3], [0.555, 0.565, 0.575]]
    ref = np.asarray(JG.scene_bounds_from_crop(p, 0.3))
    got = G.scene_bounds_from_crop(p, 0.3).numpy()
    assert got.shape == (200, 6)
    # bit-equal: jnp.round's "/ 100" compiles to a multiplication by the f32
    # reciprocal, which the port computes too (the division lands an ulp off
    # for about a third of these points, and the rollout hands act the bits)
    np.testing.assert_array_equal(got, ref)
    # the same two-decimal crop point under both
    np.testing.assert_array_equal(np.round((got[:, :3] + got[:, 3:]) * 50),
                                  np.round((ref[:, :3] + ref[:, 3:]) * 50))
    np.testing.assert_array_equal(G.scene_bounds_from_crop(p[0], 0.3).numpy(), got[0])
