"""PerceiverVoxelLangEncoder of the port against the JAX module on the same
flax parameter tree and numpy-seeded inputs (CPU): f32 for the single-arm
module with and without the arm head and for the two-head variant, and bf16.
The trees are numpy-seeded values in the module's own structure (its init
traced with ``jax.eval_shape``), carried across by the weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.models.perceiver import PerceiverVoxelLangEncoder as JaxEncoder
from voxactb_tpu_torch.models.perceiver import PerceiverVoxelLangEncoder
from voxactb_tpu_torch.weights import load_flax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

SMALL = dict(depth=2, voxel_size=10, num_latents=32, latent_dim=64, im_channels=8,
             cross_dim_head=16, latent_heads=2, latent_dim_head=16, final_dim=8,
             num_rotation_classes=72)


def random_params(module, seed, *xs):
    """A parameter tree of the module's structure (``jax.eval_shape`` of its
    init, no compile) filled with numpy-seeded values at init-like scales."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *map(jnp.asarray, xs))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1])
        if "kernel" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(size=leaf.shape).astype(np.float32) / np.sqrt(fan_in)
        if "scale" in name:
            return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return rng.normal(size=leaf.shape).astype(np.float32)  # latents, pos_encoding

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _inputs(rng, b, low_dim):
    return (rng.normal(size=(b, 10, 10, 10, 10)).astype(np.float32),
            rng.normal(size=(b, low_dim)).astype(np.float32),
            rng.normal(size=(b, 1024)).astype(np.float32),
            rng.normal(size=(b, 77, 512)).astype(np.float32))


@pytest.mark.parametrize("variant", ["plain", "arm_pred", "two_heads"])
def test_module_matches_jax_f32(variant):
    kw = dict(SMALL, low_dim_size=4)
    if variant == "arm_pred":
        kw.update(arm_pred=True, low_dim_size=7)
    elif variant == "two_heads":
        kw.update(num_proprio=2, two_arm_heads=True)
    rng = np.random.default_rng(len(variant))
    xs = _inputs(rng, 2, kw["low_dim_size"] * kw.get("num_proprio", 1))
    jm = JaxEncoder(**kw)
    params = random_params(jm, 1, *xs)
    ref = jax.jit(jm.apply)(params, *map(jnp.asarray, xs))
    tm = PerceiverVoxelLangEncoder(**kw).eval()
    load_flax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tm(*map(torch.tensor, xs))
    assert set(got) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        g = got[k].numpy()
        assert g.shape == r.shape and g.dtype == np.float32, k
        # f32 sums in another order through two attention layers
        np.testing.assert_allclose(g, r, atol=1e-4 * max(1.0, np.abs(r).max()), rtol=0,
                                   err_msg=k)
        if k.startswith("trans"):
            assert (g.reshape(2, -1).argmax(-1) == r.reshape(2, -1).argmax(-1)).all()


def test_module_bf16_within_rounding_of_jax():
    """bf16 end to end: the port rounds where the JAX module rounds; one-ulp
    differences from f32 sum orders (a 512-wide dense, the k3 convs) carry
    through the random-weight network, so outputs agree to a few percent of
    their range."""
    rng = np.random.default_rng(9)
    kw = dict(SMALL, low_dim_size=4)
    xs = _inputs(rng, 2, 4)
    jm = JaxEncoder(**kw, dtype=jnp.bfloat16)
    params = random_params(jm, 2, *xs)
    ref = jax.jit(jm.apply)(params, *map(jnp.asarray, xs))
    tm = PerceiverVoxelLangEncoder(**kw, dtype=torch.bfloat16).eval()
    load_flax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tm(*map(torch.tensor, xs))
    for k in ref:
        r = np.asarray(ref[k], np.float32)
        np.testing.assert_allclose(got[k].float().numpy(), r,
                                   atol=0.05 * max(1.0, np.abs(r).max()), rtol=0,
                                   err_msg=k)
