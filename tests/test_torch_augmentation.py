"""SE(3) augmentation of the port against the JAX package (CPU). Random
streams cannot match across the packages, so the candidates (``[K,B,3]``
shifts, ``[K,B,3,3]`` rotations) are sampled once by the JAX package and
injected into both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops import augmentation as JA
from voxactb_tpu_torch.ops import augmentation as A

BOUNDS = np.asarray([-0.3, -0.5, 0.6, 0.7, 0.5, 1.6], np.float32)
N = 20


def _poses(rng, b, lo=(-0.3, -0.5, 0.6), hi=(0.7, 0.5, 1.6)):
    q = rng.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([rng.uniform(lo, hi, (b, 3)), q], -1).astype(np.float32)


def _rot_grip(rng, b):
    return np.concatenate([rng.integers(0, 72, (b, 3)), rng.integers(0, 2, (b, 1))],
                          -1).astype(np.int32)


def _jax_apply(cands, pcds, pose, rg, bounds, pose_l=None, rg_l=None):
    """The JAX package's augmentation on injected candidates."""
    orig = JA._sample_candidates
    JA._sample_candidates = lambda rng, cfg, bounds, b: tuple(map(jnp.asarray, cands))
    try:
        return JA.apply_se3_augmentation(
            jax.random.key(0), [jnp.asarray(p) for p in pcds], jnp.asarray(pose),
            jnp.asarray(rg), jnp.asarray(bounds), voxel_size=N, rot_resolution_deg=5,
            action_gripper_pose_left=None if pose_l is None else jnp.asarray(pose_l),
            action_rot_grip_left=None if rg_l is None else jnp.asarray(rg_l))
    finally:
        JA._sample_candidates = orig


def _torch_apply(cands, pcds, pose, rg, bounds, pose_l=None, rg_l=None):
    t = torch.tensor
    return A.apply_se3_candidates(
        t(cands[0]), t(cands[1]), [t(p) for p in pcds], t(pose), t(rg), t(bounds),
        voxel_size=N, rot_resolution_deg=5,
        action_gripper_pose_left=None if pose_l is None else t(pose_l),
        action_rot_grip_left=None if rg_l is None else t(rg_l))


def _candidates(seed, bounds, b, cfg=JA.Se3AugConfig()):
    shift, rot = JA._sample_candidates(jax.random.key(seed), cfg, jnp.asarray(bounds), b)
    return np.array(shift), np.array(rot)


def _assert_same(got, ref, two_robot):
    np.testing.assert_array_equal(got.trans_indices.numpy(), np.asarray(ref.trans_indices))
    np.testing.assert_array_equal(got.rot_grip_indices.numpy(),
                                  np.asarray(ref.rot_grip_indices))
    assert got.trans_indices.dtype == torch.int32
    for a, r in zip(got.pcds, ref.pcds):
        assert tuple(a.shape) == tuple(r.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5)
    if two_robot:
        np.testing.assert_array_equal(got.trans_indices_left.numpy(),
                                      np.asarray(ref.trans_indices_left))
        np.testing.assert_array_equal(got.rot_grip_indices_left.numpy(),
                                      np.asarray(ref.rot_grip_indices_left))
    else:
        assert got.trans_indices_left is None and got.rot_grip_indices_left is None


@pytest.mark.parametrize("mode", ["single_arm", "two_robot"])
def test_injected_candidates_match_jax(mode):
    """Indices exact, clouds to 1e-5, over several batches with per-sample
    bounds; poses near a face so that many candidates are rejected."""
    rng = np.random.default_rng(len(mode))
    b = 16
    for seed in range(4):
        bounds = np.tile(BOUNDS, (b, 1))
        bounds[:, :3] += rng.uniform(-0.05, 0.05, (b, 3)).astype(np.float32)
        pose = _poses(rng, b, lo=(-0.3, -0.5, 0.6), hi=(-0.1, 0.5, 1.6))
        rg = _rot_grip(rng, b)
        pcds = [rng.uniform(-0.5, 1.5, (b, 6, 7, 3)).astype(np.float32),
                rng.uniform(-0.5, 1.5, (b, 30, 3)).astype(np.float32)]
        cands = _candidates(seed, bounds, b)
        extra = ()
        if mode == "two_robot":
            extra = (_poses(rng, b), _rot_grip(rng, b))
        ref = _jax_apply(cands, pcds, pose, rg, bounds, *extra)
        got = _torch_apply(cands, pcds, pose, rg, bounds, *extra)
        _assert_same(got, ref, mode == "two_robot")
        # some element was moved, and some candidate was rejected
        assert (np.asarray(ref.trans_indices) >= 0).all()
    assert not np.allclose(got.pcds[0].numpy(), pcds[0])


def test_identity_fallback_when_every_random_candidate_is_out_of_bounds():
    rng = np.random.default_rng(5)
    b = 4
    bounds = np.tile(BOUNDS, (b, 1))
    pose = _poses(rng, b)
    rg = _rot_grip(rng, b)
    pcd = rng.uniform(-0.5, 1.5, (b, 20, 3)).astype(np.float32)
    shift, rot = _candidates(0, bounds, b)
    shift[1:] = -10.0  # every random draw leaves the grid from below
    ref = _jax_apply((shift, rot), [pcd], pose, rg, bounds)
    got = _torch_apply((shift, rot), [pcd], pose, rg, bounds)
    _assert_same(got, ref, False)
    np.testing.assert_allclose(got.pcds[0].numpy(), pcd, atol=1e-6)
    want = np.clip(np.floor((pose[:, :3] - BOUNDS[:3]) / ((BOUNDS[3:] - BOUNDS[:3]) / N)),
                   0, N - 1)
    np.testing.assert_array_equal(got.trans_indices.numpy(), want)
    # the first valid random candidate wins over later ones and over slot 0
    shift[3] = 0.01
    shift[7] = 0.02
    got = _torch_apply((shift, rot), [pcd], pose, rg, bounds)
    ref = _jax_apply((shift, rot), [pcd], pose, rg, bounds)
    _assert_same(got, ref, False)
    sel_rot = np.einsum("bij,bjk->bik", rot[3].transpose(0, 2, 1), rot[3])
    np.testing.assert_allclose(sel_rot, np.tile(np.eye(3), (b, 1, 1)), atol=1e-5)


def test_unclamped_floor_is_exact_against_compiled_jax():
    """The compiled JAX program multiplies by the f32 reciprocal of N where the
    source divides by ``N + 1e-12``; the port does the same, so bin indices are
    equal on points at and around the voxel faces."""
    rng = np.random.default_rng(6)
    for n in (10, 20, 50, 100):
        bounds = np.asarray([[-0.1, -0.3, 0.5, 0.5, 0.3, 1.1]], np.float32)
        res = (bounds[:, 3:] - bounds[:, :3]) / n
        k = rng.integers(-2, n + 2, (4000, 3))
        pts = (bounds[:, :3] + k * res + rng.choice([0.0, 1e-7, -1e-7, 3e-4], (4000, 3))
               ).astype(np.float32)
        ref = np.asarray(jax.jit(lambda p, b: JA._unclamped_voxel_floor(p, n, b))(
            jnp.asarray(pts), jnp.asarray(bounds)))
        got = A._unclamped_voxel_floor(torch.tensor(pts), n, torch.tensor(bounds)).numpy()
        np.testing.assert_array_equal(got, ref)
        assert (got < 0).any() and (got == n - 1).any()


def test_own_sampling_keeps_actions_in_bounds_and_slot_zero_identity():
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(7)
    b = 64
    bounds = torch.tensor(np.tile(BOUNDS, (b, 1)))
    cfg = A.Se3AugConfig(rot_range_deg=(10.0, 0.0, 45.0))
    shift, rot = A.sample_candidates(g, cfg, bounds, b)
    assert shift.shape == (16, b, 3) and rot.shape == (16, b, 3, 3)
    assert torch.equal(shift[0], torch.zeros(b, 3))
    assert torch.equal(rot[0], torch.eye(3).expand(b, 3, 3))
    span = (BOUNDS[3:] - BOUNDS[:3]) * 0.125
    assert (shift.abs().numpy() <= span + 1e-6).all() and shift[1:].abs().max() > 0.05
    # proper rotations; yaw within +-45 deg in 5 deg steps, pitch never drawn
    np.testing.assert_allclose(torch.linalg.det(rot).numpy(), 1.0, atol=1e-5)
    eye = torch.einsum("kbij,kblj->kbil", rot, rot)
    np.testing.assert_allclose(eye.numpy(), np.tile(np.eye(3), (16, b, 1, 1)), atol=1e-5)
    # Rx(roll) @ Rz(yaw) with no pitch: R[0, 2] = 0, yaw = atan2(-R[0,1], R[0,0])
    yaw = torch.rad2deg(torch.atan2(-rot[..., 0, 1], rot[..., 0, 0])).numpy()
    np.testing.assert_allclose(rot[..., 0, 2].numpy(), 0.0, atol=1e-6)
    assert np.abs(yaw).max() <= 45.0 + 1e-3
    np.testing.assert_allclose(yaw / 5.0, np.round(yaw / 5.0), atol=1e-3)
    assert len(np.unique(np.round(yaw / 5.0))) == 19

    pose = torch.tensor(_poses(rng, b))
    rg = torch.tensor(_rot_grip(rng, b))
    pcd = torch.tensor(rng.uniform(-0.5, 1.5, (b, 8, 8, 3)).astype(np.float32))
    moved = 0
    for _ in range(5):
        out = A.apply_se3_augmentation(g, [pcd], pose, rg, bounds, voxel_size=N,
                                       rot_resolution_deg=5)
        t, r = out.trans_indices, out.rot_grip_indices
        assert t.dtype == torch.int32 and r.dtype == torch.int32
        assert (t >= 0).all() and (t < N).all()
        assert (r[:, :3] >= 0).all() and (r[:, :3] < 72).all()
        assert torch.equal(r[:, 3], rg[:, 3])
        assert out.pcds[0].shape == pcd.shape
        moved += int((out.pcds[0] != pcd).any())
    assert moved == 5
    # the same generator state gives the same augmentation
    a = A.apply_se3_augmentation(torch.Generator().manual_seed(3), [pcd], pose, rg, bounds,
                                 voxel_size=N, rot_resolution_deg=5)
    c = A.apply_se3_augmentation(torch.Generator().manual_seed(3), [pcd], pose, rg, bounds,
                                 voxel_size=N, rot_resolution_deg=5)
    assert torch.equal(a.pcds[0], c.pcds[0]) and torch.equal(a.trans_indices, c.trans_indices)
