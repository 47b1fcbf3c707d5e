"""Backward passes of the port's building blocks against ``jax.grad`` of the
JAX package's, on numpy-seeded inputs (CPU).

At f32 the two differ in summation order only. At bf16 both round the
cotangent to bf16 before the transposed convolutions and round ``dx`` / ``dk``
once from f32 sums, so a gradient may land one bf16 ulp away where its f32 sum
sits on a rounding boundary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from voxactb_tpu.models import blocks as JB
from voxactb_tpu.models import perceiver as JP
from voxactb_tpu.ops import upsample_conv as JU
from voxactb_tpu_torch.models import blocks as B
from voxactb_tpu_torch.models import perceiver as P
from voxactb_tpu_torch.ops import upsample_conv as U
from voxactb_tpu_torch.weights import load_flax_params, tensors_to_flax_tree

BF = (jnp.bfloat16, torch.bfloat16)
F32 = (jnp.float32, torch.float32)


def _assert_bf16_close(got, ref, share):
    """Within one bf16 ulp everywhere (2^-7 of the value's own size covers the
    ulp on either side of a binade edge; values below 2^-7 of the largest get
    the ulp of that floor, since their f32 sums cancel), and different at all
    in less than ``share`` of the elements."""
    diff = np.abs(got - ref)
    ulp = np.maximum(np.abs(ref), np.abs(ref).max() * 2.0 ** -7) * 2.0 ** -7
    assert (diff <= ulp).all(), float((diff / ulp).max())
    assert (diff > 0).mean() < share, float((diff > 0).mean())


@pytest.mark.parametrize("dt", [F32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,stride", [(3, 1), (5, 5), (1, 1)])
def test_conv3d_f32acc_grads_match_jax(dt, k, stride):
    rng = np.random.default_rng(k + stride)
    n = 10 + 2 * (k // 2)
    x = rng.normal(size=(2, n, n, n, 6)).astype(np.float32)
    w = (rng.normal(size=(k, k, k, 6, 4)) / np.sqrt(6 * k ** 3)).astype(np.float32)
    n_out = (n - k) // stride + 1
    g = rng.normal(size=(2, n_out, n_out, n_out, 4)).astype(np.float32)

    def jloss(x, w):
        y = JB._conv_f32acc(x, w, (stride,) * 3, ("NDHWC", "DHWIO", "NDHWC"))
        assert y.dtype == jnp.float32
        return jnp.sum(y * g)

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, dt[0]), jnp.asarray(w, dt[0]))
    tx = torch.tensor(x).to(dt[1]).permute(0, 4, 1, 2, 3).requires_grad_()
    tw = torch.tensor(w).to(dt[1]).permute(4, 3, 0, 1, 2).requires_grad_()
    y = B.conv3d_f32acc(tx, tw, stride)
    assert y.dtype == torch.float32
    (y * torch.tensor(g).permute(0, 4, 1, 2, 3)).sum().backward()
    assert tx.grad.dtype == dt[1] and tw.grad.dtype == dt[1]
    dx = tx.grad.permute(0, 2, 3, 4, 1).float().numpy()
    dw = tw.grad.permute(2, 3, 4, 1, 0).float().numpy()
    rdx, rdw = np.asarray(jdx, np.float32), np.asarray(jdw, np.float32)
    if dt is F32:
        np.testing.assert_allclose(dx, rdx, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(dw, rdw, atol=1e-5 * max(1.0, np.abs(rdw).max()),
                                   rtol=1e-5)
    else:
        _assert_bf16_close(dx, rdx, 0.02)
        _assert_bf16_close(dw, rdw, 0.02)


def _module_grads(jmod, tmod, x, g, dt):
    """Parameter and input gradients of sum(module(x) * g), both packages, on
    the same flax parameters."""
    params = jmod.init(jax.random.key(0), jnp.asarray(x))
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))

    def jloss(p, x):
        return jnp.sum(jmod.apply(p, x).astype(jnp.float32) * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.tensor(x).requires_grad_()
    (tmod(tx).float() * torch.tensor(g)).sum().backward()
    got = tensors_to_flax_tree(tmod, {k: p.grad for k, p in tmod.named_parameters()})
    ref = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jgp)
    return got, ref, tx.grad.numpy(), np.asarray(jgx, np.float32)


def _assert_trees(got, ref, tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_g) == len(flat_r)
    for path, a in flat_g:
        b = flat_r[path]
        np.testing.assert_allclose(a, b, atol=tol * max(1.0, np.abs(b).max()), rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("dt,tol", [(F32, 1e-5), (BF, 1e-1)], ids=["f32", "bf16"])
def test_conv3d_upsample_module_grads_reach_out_kernel(dt, tol):
    """Through conv_in, the three round-to-dtype contractions of
    ``compose_upsample_kernel`` and the composite conv. bf16: cotangents are
    rounded at every stage of both packages in their own orders, and XLA's
    CPU backend sums bf16 reductions in bf16 (see ``test_block_grads_match_jax``);
    10% of the largest gradient of a leaf."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 2, 2, 2, 6)).astype(np.float32)
    g = rng.normal(size=(1, 10, 10, 10, 4)).astype(np.float32)
    got, ref, gx, rgx = _module_grads(JB.Conv3DUpsample(4, 5, 5, "lrelu", dtype=dt[0]),
                                      B.Conv3DUpsample(6, 4, 5, 5, "lrelu", dtype=dt[1]),
                                      x, g, dt)
    assert np.abs(got["params"]["out_kernel"]).max() > 0
    _assert_trees(got, ref, tol)
    np.testing.assert_allclose(gx, rgx, atol=tol * np.abs(rgx).max())


def test_compose_upsample_kernel_gradient_f32():
    rng = np.random.default_rng(3)
    k = (rng.normal(size=(5, 5, 5, 4, 3)) * 0.1).astype(np.float32)
    g = rng.normal(size=(3, 3, 3, 4, 125 * 3)).astype(np.float32)
    ref = jax.grad(lambda k: jnp.sum(JU.compose_upsample_kernel(k, 5) * g))(jnp.asarray(k))
    tk = torch.tensor(k).requires_grad_()
    (U.compose_upsample_kernel(tk, 5) * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dt,tol", [(F32, 1e-5), (BF, 1e-1)], ids=["f32", "bf16"])
@pytest.mark.parametrize("block", ["dense_lrelu", "layernorm", "feedforward", "conv3d"])
def test_block_grads_match_jax(block, dt, tol):
    """Dense + lrelu, LayerNorm, the GEGLU feed-forward (tanh gelu) and Conv3D
    differentiate with the rounding points they have. bf16: cotangents round
    to bf16 between the ops, and XLA's CPU backend sums a bias gradient (the
    transpose of a bf16 broadcast, 60 terms here) in bf16 where torch sums in
    f32, which costs it sqrt(60) ulps of 2^-8 (3%) as a random walk and more in
    an unlucky order: 10% of a leaf's largest gradient."""
    rng = np.random.default_rng(len(block))
    if block == "conv3d":
        x = rng.normal(size=(2, 6, 6, 6, 5)).astype(np.float32)
        jmod, tmod = JB.Conv3D(4, 3, 1, "lrelu", zshift_2d=False, dtype=dt[0]), \
            B.Conv3D(5, 4, 3, 1, "lrelu", dtype=dt[1])
        g = rng.normal(size=(2, 6, 6, 6, 4)).astype(np.float32)
    else:
        x = rng.normal(size=(3, 20, 32)).astype(np.float32)
        jmod, tmod, width = {
            "dense_lrelu": (JB.DenseBlock(24, "lrelu", dt[0]),
                            B.DenseBlock(32, 24, "lrelu", dtype=dt[1]), 24),
            "layernorm": (fnn.LayerNorm(epsilon=1e-5, dtype=dt[0]),
                          B.LayerNorm(32, dtype=dt[1]), 32),
            "feedforward": (JP.FeedForward(32, dtype=dt[0]),
                            P.FeedForward(32, dtype=dt[1]), 32)}[block]
        g = rng.normal(size=(3, 20, width)).astype(np.float32)
    got, ref, gx, rgx = _module_grads(jmod, tmod, x, g, dt)
    _assert_trees(got, ref, tol)
    np.testing.assert_allclose(gx, rgx, atol=tol * np.abs(rgx).max())
