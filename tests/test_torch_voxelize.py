"""voxelize, flatten_camera_observations and the act-path geometry of the port
against the JAX package on the same numpy-seeded inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops import geometry as JG
from voxactb_tpu.ops.voxelize import flatten_camera_observations as jax_flatten
from voxactb_tpu.ops.voxelize import voxelize as jax_voxelize
from voxactb_tpu_torch.ops import geometry as G
from voxactb_tpu_torch.ops.voxelize import (
    bin_points, flatten_camera_observations, voxelize)

# mixed per-sample bounds: a scene volume, a VLM crop, a degenerate-ish thin box
BOUNDS = np.array([[-0.8, -1.0, 0.1, 1.2, 1.0, 2.1],
                   [-0.1, -0.3, 0.5, 0.5, 0.3, 1.1],
                   [0.0, 0.0, 0.0, 1.0, 1.0, 0.05]], np.float32)


def _cloud(rng, b=3, p=3000):
    coords = rng.uniform(-1.0, 2.2, (b, p, 3)).astype(np.float32)
    # points exactly on voxel boundaries of sample 0 stress the floor
    res = (BOUNDS[0, 3:] - BOUNDS[0, :3]) / 16
    coords[0, :200] = (BOUNDS[0, :3] + res * rng.integers(0, 17, (200, 3))).astype(
        np.float32)
    feats = rng.uniform(-1, 1, (b, p, 3)).astype(np.float32)
    return coords, feats


@pytest.mark.parametrize("n", [10, 16])
def test_voxelize_matches_jax(n):
    rng = np.random.default_rng(n)
    coords, feats = _cloud(rng)
    ref = np.asarray(jax_voxelize(jnp.asarray(coords), jnp.asarray(feats),
                                  jnp.asarray(BOUNDS), voxel_size=n))
    got = voxelize(torch.tensor(coords), torch.tensor(feats), torch.tensor(BOUNDS),
                   voxel_size=n).numpy()
    assert got.shape == ref.shape == (3, n, n, n, 10)
    # occupancy and the index channels are exact
    np.testing.assert_array_equal(got[..., 9], ref[..., 9])
    np.testing.assert_array_equal(got[..., 6:9], ref[..., 6:9])
    # means: f32 sums taken in another order by index_add_ and XLA's scatter
    np.testing.assert_allclose(got[..., :6], ref[..., :6], atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("n", [50, 100])
def test_bin_indices_exact_against_compiled_jax(n):
    """The integer bins are those of the compiled JAX binning bit for bit
    (XLA turns ``/ (N + 1e-12)`` into a multiplication by the f32 reciprocal),
    with per-sample and broadcast bounds."""
    rng = np.random.default_rng(n)
    coords, _ = _cloud(rng)

    @jax.jit
    def jax_bins(c, bounds):
        bb = jnp.broadcast_to(bounds, (3, 6))
        mins = bb[:, None, 0:3]
        res = (bb[:, None, 3:6] - mins) / (float(n) + 1e-12)
        return jnp.clip(jnp.floor((c - (mins - res)) / (res + 1e-12)), 0, n + 1)

    for bounds in (BOUNDS, BOUNDS[:1]):
        ref = np.asarray(jax_bins(jnp.asarray(coords), jnp.asarray(bounds)))
        got = bin_points(torch.tensor(coords), torch.tensor(bounds), n).numpy()
        np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_flatten_camera_observations_exact():
    rng = np.random.default_rng(2)
    rgbs = [rng.uniform(-1, 1, (2, 8, 6, 3)).astype(np.float32) for _ in range(2)]
    pcds = [rng.uniform(-1, 1, (2, 8, 6, 3)).astype(np.float32) for _ in range(2)]
    rc, rf = jax_flatten([jnp.asarray(r) for r in rgbs], [jnp.asarray(p) for p in pcds])
    c, f = flatten_camera_observations([torch.tensor(r) for r in rgbs],
                                       [torch.tensor(p) for p in pcds])
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(f.numpy(), np.asarray(rf))


def test_discrete_euler_to_quaternion_matches_jax():
    rng = np.random.default_rng(3)
    disc = rng.integers(0, 72, (500, 3)).astype(np.int32)
    ref = np.asarray(JG.discrete_euler_to_quaternion(jnp.asarray(disc), 5))
    got = G.discrete_euler_to_quaternion(torch.tensor(disc), 5).numpy()
    # sin/cos of the two libraries may differ in the last f32 bit
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(4)
    euler = rng.uniform(-3.1, 3.1, (200, 3)).astype(np.float32)
    m_ref = np.asarray(JG.euler_xyz_to_rotmat(jnp.asarray(euler)))
    m = G.euler_xyz_to_rotmat(torch.tensor(euler))
    np.testing.assert_allclose(m.numpy(), m_ref, atol=2e-6)
    np.testing.assert_allclose(G.rotmat_to_quat(torch.tensor(m_ref)).numpy(),
                               np.asarray(JG.rotmat_to_quat(jnp.asarray(m_ref))),
                               atol=2e-6)
    np.testing.assert_allclose(
        G.euler_xyz_deg_to_quat(torch.tensor(euler * 50)).numpy(),
        np.asarray(JG.euler_xyz_deg_to_quat(jnp.asarray(euler * 50))), atol=2e-6)


def test_voxel_index_and_attention_coordinate_match_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.2, 2.5, (3, 50, 3)).astype(np.float32)
    b = BOUNDS[:, None, :]
    ref = np.asarray(JG.point_to_voxel_index(jnp.asarray(pts), 50, jnp.asarray(b)))
    got = G.point_to_voxel_index(torch.tensor(pts), 50, torch.tensor(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    idx = rng.integers(0, 50, (3, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        G.attention_coordinate(torch.tensor(idx), 50, torch.tensor(BOUNDS)).numpy(),
        np.asarray(JG.attention_coordinate(jnp.asarray(idx), 50, jnp.asarray(BOUNDS))))
